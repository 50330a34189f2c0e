#!/usr/bin/env python3
"""Time the port's K7, K2, K3 and K4 kernels of one checkout on one CUDA
card.

    python3 tools/torch_kernels_ab.py ROOT [NAME]

imports ``otter_tpu_torch`` from the checkout at ROOT (so two trees, such as
a commit and its parent unpacked side by side, can be compared: run them in
turns, A B B A, in one session on one card) and prints the card line, then
one JSON line per set with its mean kernel time and a hash of its result:

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
  widest free begin where the wrapper takes ``tb_max``.

Inputs come from fixed seeds, so equal hashes mean equal results. Needs a
card; nothing is written.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import subprocess
import sys

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


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    name = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(root)
    sys.path.insert(0, root)
    import torch

    from otter_tpu_torch.kernels import _build
    from otter_tpu_torch.kernels import edit_banded as K7
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
        h = hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()[:12]
        print(json.dumps({"tree": name, "set": what, **kw,
                          "ms": round(ms, 4), "hash": h}), flush=True)

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

    for n_jobs in (300, 1035, 16384):
        rs = np.random.default_rng(n_jobs)
        alleles = [acgt(rs, int(rs.integers(1500, 2401))) for _ in range(64)]
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

    rs = np.random.default_rng(63)
    reads = []
    for _ in range(32):
        s = acgt(rs, int(rs.integers(2300, 2501)))
        reads += [substitute(rs, s, 0.002) for _ in range(4)]
    iu, ju = np.triu_indices(len(reads), 1)
    pick = rs.choice(len(iu), size=min(8192, len(iu)), replace=False)
    pairs = [(reads[i], reads[j]) if len(reads[i]) <= len(reads[j])
             else (reads[j], reads[i]) for i, j in zip(iu[pick], ju[pick])]
    zero = [0] * len(pairs)
    banded(f"K3 k 63, {len(pairs)} pairs of 2.3-2.5 kb", pairs, zero, zero,
           63, False)

    rs = np.random.default_rng(21)
    a = acgt(rs, 10000)
    b = a + "CAG" * 100
    ra = [substitute(rs, a, 0.002) for _ in range(100)]
    rb = [substitute(rs, b, 0.002) for _ in range(100)]
    iu, ju = np.triu_indices(100, 1)
    same = [(r[i], r[j]) for r in (ra, rb) for i, j in zip(iu, ju)]
    cross = [(x, y) for x in ra for y in rb]
    for k, pairs in ((63, same), (511, cross)):
        zero = [0] * len(pairs)
        banded(f"K3 k {k}, {len(pairs)} refscale pairs of 10 kb", pairs,
               zero, zero, k, False)

    rs = np.random.default_rng(4096)
    alleles = [acgt(rs, int(rs.integers(2400, 2601))) for _ in range(64)]
    jobs, tes = [], []
    for q in range(4096):
        al = alleles[q % 64]
        cut = int(rs.integers(2100, 2401))
        jobs.append((substitute(rs, al[:cut], 0.002), al))
        tes.append(len(al) - cut)
    banded("K4 k 63, 4096 reassignment jobs of 2.1-2.4 kb", jobs,
           [0] * len(jobs), tes, 63, True)
    jobs, tbs = [], []
    for q in range(2048):
        cut = int(rs.integers(0, 2001))
        jobs.append((substitute(rs, rb[0][cut:], 0.002), rb[0]))
        tbs.append(cut)
    banded("K4 k 63, 2048 jobs of 10 kb with tb 0-2000", jobs, tbs,
           [0] * len(jobs), 63, True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
