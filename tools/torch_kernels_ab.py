#!/usr/bin/env python3
"""Time the port's K7, K2, K3, K4, K8, K9, K10, K11, K12 and K14 kernels of
one checkout on one CUDA card.

    python3 tools/torch_kernels_ab.py ROOT [NAME [KERNELS]]

imports ``otter_tpu_torch`` from the checkout at ROOT (so two trees, such as
a commit and its parent unpacked side by side, can be compared: run them in
turns, A B B A, in one session on one card) and prints the card line, then
one JSON line per set with its mean kernel time and a hash of its result
(KERNELS, a comma-separated subset such as ``K8``, limits the sets):

* K7 (``edit_banded``) at k = 63 (1,024 pairs of 1.5-1.8 kb), 1023 (256 of
  2.5-3 kb), 4095 (32 of 5-6 kb) and 32767 (2 of 7-8 kb), reads with N
  bases at 0.2% substitutions;
* K2 (``myers_striped``) on reassignment-shaped jobs (a 0.4-1.4 kb read
  against a 1.5-2.4 kb allele, its missing end free): 300, 1,035 (the
  hifi-tr-1.5k launch) and 16,384 (the timing set of ``chip_smoke.py``)
  jobs; where the checkout's wrapper takes ``group``, also at every G;
* K3 (``myers_banded``) on 8,128 pairs of 2.3-2.5 kb reads at k = 63 (the
  shape of ``chip_smoke.py``'s timing set), and at the reference-default
  region's rungs: 9,900 same-allele pairs of 10 kb reads at k = 63 and
  10,000 cross-allele pairs (a 300 bp length gap) at k = 511;
* K4 (``myers_banded_ef``) on 4,096 reassignment jobs past 2 kb (a 2.1-2.4
  kb read against a 2.4-2.6 kb allele, its end free) at k = 63, and on
  2,048 reads of a 10.3 kb allele that miss up to 2 kb of its start (tb
  up to 2,000) at k = 63; where the checkout's wrapper takes ``group``,
  K3 and K4 also at every G the window allows, and K4 is given its
  widest free begin where the wrapper takes ``tb_max``;
* K8 (``kde_scaled``) on the three sets of ``chip_smoke.py``
  (hifi-tr-1.5k's batch of 32 regions x 4,950 values, the refscale region
  1 x 19,900, the largest batch 256 x 19,900) over the 401-cell grid, the
  hash over (m, s); where the checkout's wrapper takes ``warps``, also at
  every W and cells a thread C, with the launch its rule picks;
* K9 (``edit_banded_ends_free``) on jobs shaped like the route-coverage
  cell's passes (a 1.5-1.8 kb read with N bases against one 200-450 bp
  shorter, the pattern's end free past the difference; ``chip_smoke.py``'s
  ``reassignment_shaped_jobs``) at k = 512: 64 jobs (``chip_smoke.py``'s
  timing set) and 10 (the cell's largest pass); and 2 two-sided jobs of
  10-10.4 kb reads (``chip_smoke.py``'s ``ends_free_jobs``) at k = 1023,
  2047, 4095 and 8191 (with k = 512, every P-warp instance); with the
  kernel and instance each k takes where the checkout has
  ``ends_free_shape``. The jobs come from the generators of the
  ``chip_smoke.py`` beside this tool, whichever tree is timed;
* K11 (``linkage``) on ``chip_smoke.py``'s tie-free matrices at n = 129
  and 1,001 (seed 11), with the route each takes where the checkout has
  ``linkage_plan``;
* K12 (``poa_heaviest``) on seeded graphs of hifi-tr-1.5k's shape (64
  graphs of ~1.75 k nodes) and of the refscale region's (one of ~13.1 k
  nodes and ~11.5 k levels), with the route where the checkout has
  ``stream_fits``;
* K10 (``kmer_counts``) on the allele batches genotype64 and genotype500
  hand it (k = 3; ``chip_smoke.py``'s cohorts, made in a temporary
  directory and genotyped with ``OTTER_TPU_KMER_DEVICE=1``) and on
  genotype64's first 256 alleles at k = 8 (device-memory histograms);
* K14 (``kde_pairs``) on the JAX bench regions leg's batch (11,904 pairs
  over 128 regions, its K7 distances) and at hifi-tr-1.5k's 160,429 pairs
  over 32 regions (``chip_smoke.py``'s ``regions_leg_batch`` and
  ``hifi_pair_inputs``), the grouping given; beside it the grouping
  (``group_pairs``) and the grouping + kernel.

Inputs come from fixed seeds, so equal hashes mean equal results. Needs a
card; nothing is written but K10's cohorts, in a temporary directory.
"""

from __future__ import annotations

import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def acgt(rs, n: int) -> str:
    return ACGT[rs.integers(0, 4, n)].tobytes().decode()


def substitute(rs, s: str, err: float) -> str:
    c = bytearray(s.encode())
    for i in np.nonzero(rs.random(len(c)) < err)[0]:
        c[i] = ACGT[rs.integers(0, 4)]
    return c.decode()


def with_n(rs, s: str, k: int) -> str:
    c = bytearray(s.encode())
    for i in rs.integers(0, len(c), k):
        c[i] = ord("N")
    return c.decode()


# K8's sets, as chip_smoke.py's KDE_SETS: (name, regions, values a region)
KDE_SETS = (("hifi-tr-1.5k batch", 32, 4950), ("refscale region", 1, 19900),
            ("largest batch", 256, 19900))


def smoke_jobs():
    """chip_smoke.py of this tool's own checkout, for its K9 job generators,
    so that every tree timed gets the same jobs."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k9_sets():
    """(name, jobs, k) of K9's sets, from fixed seeds."""
    cs = smoke_jobs()
    for n_jobs in (64, 10):
        jobs = cs.reassignment_shaped_jobs(np.random.default_rng(512), n_jobs)
        yield f"K9 k 512, {n_jobs} reassignment-shaped jobs", jobs, 512
    for k in (1023, 2047, 4095, 8191):
        jobs = cs.ends_free_jobs(np.random.default_rng(k), 2, 10000, 10400,
                                 min(k - 16, 5000))
        yield f"K9 k {k}, 2 two-sided jobs of 10 kb", jobs, k


def kde_sets(torch, dev, reps_for):
    """K8 launches of KDE_SETS from fixed seeds: pair distances shaped like
    a two-allele locus (two thirds near 0.004, a third near 0.17), the
    bandwidths 0.01 and 0.015 in turns, chip_smoke.py's inputs."""
    from otter_tpu_torch.ops.kde import kde_grid

    xs = torch.from_numpy(kde_grid(0.0025).astype(np.float32)).to(dev)
    for what, R, n in KDE_SETS:
        rs = np.random.default_rng(R * 100003 + n)
        near = rs.normal(0.004, 0.0015, (R, n - n // 3))
        far = rs.normal(0.17, 0.01, (R, n // 3))
        n_pad = 1 << (n - 1).bit_length()
        V = np.zeros((R, n_pad), dtype=np.float32)
        V[:, :n] = np.clip(np.concatenate([near, far], axis=1), 0.0, 1.0)
        bw = np.where(np.arange(R) % 2, 0.015, 0.01).astype(np.float32)
        args = [torch.from_numpy(a).to(dev)
                for a in (V, np.full(R, n, dtype=np.int32), bw)] + [xs]
        yield f"K8 {what}, {R} x {n}", args, n, reps_for(R * n)


def k11_sets():
    """(n, D) of K11's sets: chip_smoke.py's kernel_k11 matrices, tie-free
    (a permutation of n (n - 1) / 2 distinct values) at n = 129 and 1,001
    from seed 11, in that order."""
    rs = np.random.default_rng(11)
    for n in (129, 1001):
        m = n * (n - 1) // 2
        cond = (rs.permutation(m) + 1.0) / (m + 1.0)
        sq = np.zeros((n, n), dtype=np.float32)
        sq[np.triu_indices(n, 1)] = cond
        yield n, sq + sq.T


def own_synth():
    """``otter_tpu_torch/utils/synth.py`` of this tool's own checkout, for
    its graph generator, so that every tree timed gets the same graphs (its
    package imports resolve to the timed tree's, which every tree has)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "otter_tpu_torch", "utils", "synth.py")
    spec = importlib.util.spec_from_file_location(
        "otter_tpu_torch.utils.own_synth", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k12_sets():
    """(name, graphs) of K12's sets, from fixed seeds: 64 graphs shaped
    like hifi-tr-1.5k's (1.5-1.83 k backbone nodes, ~1.75 k nodes, ~1.9 k
    edges, up to ~1.87 k levels) and one like the refscale region's (11.4 k
    backbone, ~13.1 k nodes, ~16.6 k edges, ~11.5 k levels)."""
    poa_shaped_graph = own_synth().poa_shaped_graph
    rs = np.random.default_rng(12)
    yield "K12 64 graphs of hifi-tr-1.5k's shape", [
        poa_shaped_graph(rs, int(rs.integers(1500, 1831)), 60, 40, 40)
        for _ in range(64)]
    yield "K12 1 graph of the refscale region's shape", [
        poa_shaped_graph(rs, 11400, 1600, 80, 1800)]


def k10_sets(cs, torch):
    """(name, seqs, offsets, k) of K10's sets: the batch genotype64's and
    genotype500's cohorts (``chip_smoke.py``'s seeds) hand K10 on the card,
    and genotype64's first 256 alleles at k = 8."""
    from otter_tpu_torch.kernels import kmer_counts as K10

    batches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, n, r, seed in (("genotype64", 64, 32, 5),
                                 ("genotype500", 500, 8, 23)):
            d = os.path.join(tmp, name)
            os.makedirs(d)
            bam, bed, fa = own_synth().cohort_fixture(d, n, r, seed)
            with cs.Settings(OTTER_TPU_KMER_DEVICE="1"), \
                    cs.Recorder(K10, "kmer_counts") as rec:
                cs.genotype_text(bam, bed, fa)
            batches[name] = rec.calls[0]
    for name, (seqs, offsets, k) in batches.items():
        yield f"K10 {name}'s batch, k {k}", seqs, offsets, k
    seqs, offsets = batches["genotype64"][:2]
    yield ("K10 genotype64's first 256 alleles, k 8",
           seqs[: int(offsets[256])].contiguous(), offsets[:257].contiguous(),
           8)


def k14_sets(cs, torch, dev, K7):
    """(name, args) of K14's sets: the regions leg's batch with its K7
    distances and hifi-tr-1.5k's pairs, from fixed seeds, the grid's 401
    points last."""
    from otter_tpu_torch.kernels.kde_pairs import linspace_grid

    xs = torch.from_numpy(linspace_grid(401)).to(dev)
    a, bp, mn, rid, valid, bw, k, _L = cs.regions_leg_batch(
        np.random.default_rng(14))
    d = K7.edit_banded(*(torch.from_numpy(x).to(dev) for x in (a, bp, mn)),
                       k)
    yield "K14 regions leg, 11,904 pairs over 128 regions", [d] + [
        torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        for x in (mn[:, 0], mn[:, 1], rid, valid, bw)] + [xs]
    yield "K14 hifi-tr-1.5k pairs, 160,429 over 32 regions", \
        cs.hifi_pair_inputs(np.random.default_rng(1514), dev) + [xs]


def refscale_reads():
    """100 reads of each of two 10 kb alleles (the second 300 bp longer) at
    0.2% substitutions, from a fixed seed."""
    rs = np.random.default_rng(21)
    a = acgt(rs, 10000)
    b = a + "CAG" * 100
    ra = [substitute(rs, a, 0.002) for _ in range(100)]
    rb = [substitute(rs, b, 0.002) for _ in range(100)]
    return ra, rb


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    name = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(root)
    only = set(sys.argv[3].split(",")) if len(sys.argv) > 3 else None
    sys.path.insert(0, root)
    import torch

    from otter_tpu_torch.kernels import _build
    from otter_tpu_torch.kernels import edit_banded as K7
    from otter_tpu_torch.kernels import kde_scaled as K8
    from otter_tpu_torch.kernels import myers_banded as K34
    from otter_tpu_torch.kernels import myers_striped as K2
    from otter_tpu_torch.kernels.myers_pallas import int32_tensor

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    _build.load()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(0.02 * 1.98e9))  # let the host queue the runs
        t0.record()
        for _ in range(reps):
            out = fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps, out

    def emit(what, ms, out, **kw):
        outs = out if isinstance(out, tuple) else (out,)
        h = hashlib.sha1(b"".join(o.cpu().numpy().tobytes()
                                  for o in outs)).hexdigest()[:12]
        print(json.dumps({"tree": name, "set": what, **kw,
                          "ms": round(ms, 4), "hash": h}), flush=True)

    def wanted(kernel):
        return only is None or kernel in only

    if wanted("K8"):
        sweep = "warps" in inspect.signature(K8.kde_scaled_cuda).parameters
        for what, args, n, reps in kde_sets(
                torch, dev,
                lambda evals: min(200, max(20, int(4e9 // (evals * 401))))):
            kw = {}
            if sweep:
                W, C, blocks, threads = K8.kde_scaled_geometry(
                    args[0].shape[0], args[0].shape[1], n, args[3].shape[0])
                kw = {"rule": {"W": W, "C": C, "blocks": blocks,
                               "threads": threads}}
            ms, out = time_ms(lambda: K8.kde_scaled_cuda(*args, n_max=n),
                              reps)
            emit(what, ms, out, W="auto", **kw)
            for C in (getattr(K8, "CELLS", ()) if sweep else ()):
                for W in K8.WARPS:
                    ms, out = time_ms(lambda: K8.kde_scaled_cuda(
                        *args, n_max=n, warps=W, cells=C), reps)
                    emit(what, ms, out, W=W, C=C)
    if wanted("K11"):
        from otter_tpu_torch.kernels import linkage as K11

        for n, sq in k11_sets():
            D = torch.from_numpy(sq)[None].to(dev)
            kw = ({"route": list(K11.linkage_plan(n))}
                  if hasattr(K11, "linkage_plan") else {})
            ms, out = time_ms(lambda: K11.linkage_cuda(D), 5)
            emit(f"K11 n {n}, tie-free", ms, out,
                 us_step=round(1e3 * ms / (n - 1), 3), **kw)
    if wanted("K12"):
        from otter_tpu_torch.kernels import poa_heaviest as K12

        for what, graphs in k12_sets():
            batch = K12.pack_graphs(graphs).to(dev)
            kw = ({"route": "stream" if K12.stream_fits(batch) else "global"}
                  if hasattr(K12, "stream_fits") else {})
            levels = batch.max_depth + 1
            ms, out = time_ms(lambda: K12.poa_heaviest_cuda(batch), 20)
            emit(what, ms, out, levels=levels, nodes=batch.node_of.shape[0],
                 edges=int(batch.in_ptr[-1]),
                 us_level=round(1e3 * ms / levels, 4), **kw)
    if wanted("K10"):
        from otter_tpu_torch.kernels import kmer_counts as K10

        for what, seqs, offsets, k in k10_sets(smoke_jobs(), torch):
            ms, out = time_ms(lambda: K10.kmer_counts_cuda(seqs, offsets, k),
                              50)
            emit(what, ms, out, alleles=offsets.shape[0] - 1,
                 bytes=seqs.shape[0])
    if wanted("K14"):
        from otter_tpu_torch.kernels import kde_pairs as K14

        for what, args in k14_sets(smoke_jobs(), torch, dev, K7):
            group = K14.group_pairs(args[3], args[4], args[5].shape[0])
            group_ms, _ = time_ms(lambda: K14.group_pairs(
                args[3], args[4], args[5].shape[0]), 20)
            step_ms, _ = time_ms(lambda: K14.kde_pairs_cuda(*args), 20)
            ms, out = time_ms(lambda: K14.kde_pairs_cuda(*args,
                                                         grouped=group), 20)
            emit(what, ms, out, group_ms=round(group_ms, 4),
                 step_ms=round(step_ms, 4))
    if wanted("K7"):
        for k, n_pairs, lo, hi, reps in ((63, 1024, 1500, 1800, 3),
                                         (1023, 256, 2500, 3000, 2),
                                         (4095, 32, 5000, 6000, 1),
                                         (32767, 2, 7000, 8000, 1)):
            rs = np.random.default_rng(k)
            pairs = []
            for _ in range(n_pairs):
                s = with_n(rs, acgt(rs, int(rs.integers(lo, hi + 1))), 3)
                pairs.append((s, with_n(rs, substitute(rs, s, 0.002), 2)))
            a = [int32_tensor(x, dev) for x in K7.pack_banded(pairs, k)]
            ms, out = time_ms(lambda: K7.edit_banded(*a, k), reps)
            emit(f"K7 k {k}, {n_pairs} pairs of {lo}-{hi}", ms, out)

    if wanted("K9"):
        for what, jobs, k in k9_sets():
            a = [int32_tensor(x, dev)
                 for x in K7.pack_ends_free(jobs, range(len(jobs)), k)]
            kw = ({"shape": K7.ends_free_shape(k)}
                  if hasattr(K7, "ends_free_shape") else {})
            ms, out = time_ms(lambda: K7.edit_banded_ends_free(*a, k), 5)
            emit(what, ms, out, **kw)

    if wanted("K2"):
        for n_jobs in (300, 1035, 16384):
            rs = np.random.default_rng(n_jobs)
            alleles = [acgt(rs, int(rs.integers(1500, 2401)))
                       for _ in range(64)]
            oriented, tbs, tes = [], [], []
            for q in range(n_jobs):
                al = alleles[q % 64]
                cut = int(rs.integers(400, 1401))
                oriented.append((substitute(rs, al[:cut], 0.002), al))
                tbs.append(0)
                tes.append(len(al) - cut)
            args = K2.oriented_inputs(oriented, tbs, tes, dev)
            ms, out = time_ms(lambda: K2.myers_striped(*args), 3)
            emit(f"K2 {n_jobs} jobs", ms, out, G="auto")
            for G in getattr(K2, "GROUPS", ()):
                ms, out = time_ms(
                    lambda: K2.myers_striped_cuda(*args, group=G), 3)
                emit(f"K2 {n_jobs} jobs", ms, out, G=G)

    def banded(what, oriented, tbs, tes, k, ef):
        pool, ip, it, nl, ml, tb, te, nw, tl = K2.oriented_inputs(
            oriented, tbs, tes, dev)
        kw = {}
        if ef:
            fn = K34.myers_banded_ef_cuda
            args = (pool, ip, it, nl, ml, tb, te, k, nw, tl)
            if "tb_max" in inspect.signature(fn).parameters:
                kw = {"tb_max": max(tbs)}
        else:
            fn = K34.myers_banded_cuda
            args = (pool, ip, it, nl, ml, k, nw, tl)
        ms, out = time_ms(lambda: fn(*args, **kw), 3)
        emit(what, ms, out, G="auto")
        if "group" in inspect.signature(fn).parameters:
            window = K34.banded_window(k, max(tbs) if ef else 0)
            for G in K34.GROUPS:
                if G * K34.QMAX >= window:
                    ms, out = time_ms(lambda: fn(*args, group=G, **kw), 3)
                    emit(what, ms, out, G=G)

    if wanted("K3"):
        rs = np.random.default_rng(63)
        reads = []
        for _ in range(32):
            s = acgt(rs, int(rs.integers(2300, 2501)))
            reads += [substitute(rs, s, 0.002) for _ in range(4)]
        iu, ju = np.triu_indices(len(reads), 1)
        pick = rs.choice(len(iu), size=min(8192, len(iu)), replace=False)
        pairs = [(reads[i], reads[j]) if len(reads[i]) <= len(reads[j])
                 else (reads[j], reads[i])
                 for i, j in zip(iu[pick], ju[pick])]
        zero = [0] * len(pairs)
        banded(f"K3 k 63, {len(pairs)} pairs of 2.3-2.5 kb", pairs, zero,
               zero, 63, False)

        ra, rb = refscale_reads()
        iu, ju = np.triu_indices(100, 1)
        same = [(r[i], r[j]) for r in (ra, rb) for i, j in zip(iu, ju)]
        cross = [(x, y) for x in ra for y in rb]
        for k, pairs in ((63, same), (511, cross)):
            zero = [0] * len(pairs)
            banded(f"K3 k {k}, {len(pairs)} refscale pairs of 10 kb", pairs,
                   zero, zero, k, False)

    if wanted("K4"):
        rs = np.random.default_rng(4096)
        alleles = [acgt(rs, int(rs.integers(2400, 2601)))
                   for _ in range(64)]
        jobs, tes = [], []
        for q in range(4096):
            al = alleles[q % 64]
            cut = int(rs.integers(2100, 2401))
            jobs.append((substitute(rs, al[:cut], 0.002), al))
            tes.append(len(al) - cut)
        banded("K4 k 63, 4096 reassignment jobs of 2.1-2.4 kb", jobs,
               [0] * len(jobs), tes, 63, True)
        jobs, tbs = [], []
        allele = refscale_reads()[1][0]
        for q in range(2048):
            cut = int(rs.integers(0, 2001))
            jobs.append((substitute(rs, allele[cut:], 0.002), allele))
            tbs.append(cut)
        banded("K4 k 63, 2048 jobs of 10 kb with tb 0-2000", jobs, tbs,
               [0] * len(jobs), 63, True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
