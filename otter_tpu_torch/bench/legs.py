"""The bench's legs: the counterparts of the JAX package's ``bench.py``
legs, at its sizes, each run on the device it is given and returning the
fields ``bench.py`` reported under the same names (``BENCH_r05.json``).

- ``bench_kernel``: the Myers distance engine (K1) on
  ``synth.pair_workload`` (groups of 13 related 1 kb reads, all vs all, 1%
  and 5% error), with the one-core native rate as the baseline
  (``vs_baseline`` = rate / (32 x that rate): the reference's 32-thread
  ceiling), the larger of ``bench_cpu_single``'s live rate and the pinned
  one (``calibrate.py``), as the JAX bench takes it;
- ``bench_regions``: ``e2e.bench_assemble``'s fixture at 128 regions
  against the host mode, and the genotype leg;
- ``bench_cohort``, ``bench_refscale_leg``, ``bench_ont_leg``: the
  ``e2e`` legs, each in a temporary directory;
- ``bench_device_kernels``: the consensus cigars of 2.3 kb ONT-like
  members on K5/K6 against the native affine ladder.
"""

from __future__ import annotations

import os
import random
import tempfile
import time

import numpy as np

from . import e2e

# the reference's max thread count (src/otter_opts.cpp:93)
REFERENCE_THREADS = 32
# K1's n_words buckets (4, 8, 16, 32, 64 words) by the pattern's length
_NW_THRESHOLDS = np.asarray([128, 256, 512, 1024], dtype=np.int64)
_POW2S = np.asarray([128 << s for s in range(16)], dtype=np.int64)


def text_bucket(mx: np.ndarray) -> np.ndarray:
    """The JAX Myers kernels' text length bucket of each length: 128, or
    the length rounded up to an eighth of its power of two (at least 16)."""
    mx = np.asarray(mx, dtype=np.int64)
    p = _POW2S[np.searchsorted(_POW2S, np.maximum(mx, 1), side="left")]
    step = np.maximum(16, p // 8)
    return np.where(p <= 128, 128, -(-mx // step) * step)


def bucket_cells(seqs, xi, yi) -> int:
    """The DP cells the JAX engine counts for Myers pool pairs
    (``EditDistanceEngine.cells`` on the TPU, ``bench.py``'s
    ``edit_dp_cell_updates_per_sec``): each pair's pattern bucket (n_words
    x 32) times its text bucket, over the pairs of distinct, non-empty
    sequences. The port's engine counts m x n instead: 1.37 times fewer on
    the leg's 65,536 pairs of ~1 kb."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    xi = np.asarray(xi, dtype=np.int64)
    yi = np.asarray(yi, dtype=np.int64)
    lx, ly = lens[xi], lens[yi]
    keep = (xi != yi) & (lx > 0) & (ly > 0)
    mn = np.minimum(lx, ly)[keep]
    mx = np.maximum(lx, ly)[keep]
    nw = 4 << np.searchsorted(_NW_THRESHOLDS, mn, side="left")
    return int((nw * 32 * text_bucket(mx)).sum())


def bench_cpu_single(pairs, reps: int = 5):
    """One-core native rate: (best cells/s, distances, each rep's rate)."""
    from ..native import edit_distance_batch

    rates, dists = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        dists, cells = edit_distance_batch(pairs, 1)
        rates.append(cells / (time.perf_counter() - t0))
    return max(rates), dists, rates


def bench_kernel(n_pairs: int = 65536, device: str = "cuda", reps: int = 6,
                 cpu_reps: int = 5, length: int = 1024) -> dict:
    """The distance engine's rate on ``pair_workload(n_pairs, length)``
    (seed 20260817) through ``distances_indexed``, the assemble path's own
    call: one warm pass, then the best of ``reps``. ``value`` counts the
    JAX engine's cells (``bucket_cells``), ``dp_mn_cells_per_sec`` the
    port engine's (m x n). The first 256 distances must equal the one-core
    native run's. ``vs_baseline`` divides by the larger of its best rate
    and the pin for reads of ``length`` (``calibrate.cpu_denominator``)."""
    import torch

    from ..kernels.edit_engine import EditDistanceEngine
    from ..utils.synth import pair_workload
    from . import calibrate

    pairs, seqs, xi, yi = pair_workload(random.Random(20260817),
                                        n_pairs=n_pairs, length=length)
    eng = EditDistanceEngine(device)
    eng.distances_indexed(seqs, xi, yi)  # warm
    best = None
    times = []
    for _ in range(reps):
        eng.cells = 0
        t0 = time.perf_counter()
        dists = eng.distances_indexed(seqs, xi, yi)
        dt = time.perf_counter() - t0
        times.append(dt)
        if best is None or dt < best[0]:
            best = (dt, eng.cells, dists)
    dt, mn_cells, dists = best
    cpu_rate, cpu_d, cpu_rates = bench_cpu_single(pairs[:256], cpu_reps)
    if not np.array_equal(dists[:256], cpu_d):
        raise RuntimeError("kernel leg: the engine's distances differ from "
                           "the native one-core run's")
    rate = bucket_cells(seqs, xi, yi) / dt
    denom, pin = calibrate.cpu_denominator(cpu_rate, length)
    return {
        "metric": "edit_dp_cell_updates_per_sec",
        "value": round(rate, 1),
        "unit": "cells/s",
        "vs_baseline": round(rate / (REFERENCE_THREADS * denom), 3),
        "platform": torch.device(device).type,
        "dp_mn_cells_per_sec": round(mn_cells / dt, 1),
        "cpu_1core_cells_per_sec": round(cpu_rate, 1),
        "cpu_1core_reps": [round(r, 1) for r in cpu_rates],
        "cpu_1core_pinned": None if pin is None else round(pin, 1),
        "cpu_1core_denominator": round(denom, 1),
        "kernel_rep_times_s": [round(t, 4) for t in times],
        "loadavg": list(os.getloadavg()),
        "pair_alignments_per_sec": round(len(pairs) / dt, 1),
        "bench_pairs": n_pairs,
    }


def bench_regions(n_regions: int = 128, device: str = "cuda",
                  reps: int = 3, genotype_reps: int = 3) -> dict:
    """assemble regions/s on ``region_fixture(n_regions)`` (best of
    ``reps`` after a warm run) against the host mode, byte for byte, and
    the genotype leg on its alleles."""
    with tempfile.TemporaryDirectory() as tmp:
        bam, bed, times, text, dt_host, out_host = e2e.assemble_vs_host(
            tmp, n_regions, device, reps)
        dt = min(times)
        result = {
            "regions_per_sec": round(n_regions / dt, 2),
            "regions_vs_host_oracle": round(dt_host / dt, 2),
            "regions_outputs_identical": text == out_host,
            "regions_times": e2e._stats(times),
        }
        result.update(e2e.bench_genotype(tmp, bam, bed, n_regions,
                                         device=device, reps=genotype_reps))
    return result


def bench_cohort(device: str = "cuda", reps64: int = 5, reps500: int = 3,
                 sizes64=(64, 32), sizes500=(500, 8)) -> dict:
    """The genotype64 and genotype500 cohort legs."""
    with tempfile.TemporaryDirectory() as tmp:
        out = e2e.bench_genotype_cohort(tmp, *sizes64, device=device,
                                        reps=reps64)
    with tempfile.TemporaryDirectory() as tmp:
        out.update(e2e.bench_genotype_cohort500(tmp, *sizes500,
                                                device=device, reps=reps500))
    return out


def bench_refscale_leg(device: str = "cuda", **kw) -> dict:
    """``e2e.bench_refscale`` in a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        return e2e.bench_refscale(tmp, device, **kw)


def bench_ont_leg(device: str = "cuda", **kw) -> dict:
    """``e2e.bench_ont`` in a temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        return e2e.bench_ont(tmp, device, **kw)


def device_jobs(n: int = 256, length: int = 2300, err: float = 0.07):
    """``bench.py``'s consensus jobs (seed 20260820): a random ``length``
    bp pattern and a copy at error ``err`` (0.4 / 0.3 / 0.3), no frees."""
    rng = random.Random(20260820)

    def rand_seq(k: int) -> str:
        return "".join(rng.choice("ACGT") for _ in range(k))

    def mut(s: str) -> str:
        o = []
        for ch in s:
            x = rng.random()
            if x < err * 0.4:
                o.append(rng.choice([b for b in "ACGT" if b != ch]))
            elif x < err * 0.7:
                o.extend([ch, rng.choice("ACGT")])
            elif x >= err:
                o.append(ch)
        return "".join(o)

    jobs = []
    for _ in range(n):
        p = rand_seq(length)
        jobs.append((p, mut(p), 0, 0, 0, 0))
    return jobs


def bench_device_kernels(device: str = "cuda", reps: int = 3,
                         sizes=((256, ""), (32, "_small")),
                         length: int = 2300) -> dict:
    """Consensus cigars of ONT-like members (2.3 kb, 7% error: K6 at k =
    255) on the card (``affine_cigars_tb``, best of ``reps`` after a warm
    run) against the threaded native ladder on the same jobs with the
    same exact distance hints (``edit_ends_free_batch``), cigar for cigar;
    at 256 jobs and at 32."""
    from ..kernels.affine_tb import affine_cigars_tb
    from ..ops.align_batch import affine_cigars_multi, edit_ends_free_batch

    all_jobs = device_jobs(max(n for n, _tag in sizes), length)
    all_hints = [int(d) for d in edit_ends_free_batch(all_jobs)]
    out = {}
    for size, tag in sizes:
        jobs, hints = all_jobs[:size], all_hints[:size]
        affine_cigars_tb(jobs, device, dist_hints=hints)  # warm
        best, times, cigs = None, [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            cigs, _failed = affine_cigars_tb(jobs, device, dist_hints=hints)
            dt = time.perf_counter() - t0
            times.append(round(dt, 4))
            best = dt if best is None else min(best, dt)
        n_done = sum(1 for c in cigs if c)
        t0 = time.perf_counter()
        cigs_nat = affine_cigars_multi(jobs, dist_hints=hints)
        dt_nat = time.perf_counter() - t0
        out[f"device_affine{tag}_cigars_per_sec"] = round(n_done / best, 1)
        out[f"native_affine{tag}_cigars_per_sec"] = round(
            len(jobs) / dt_nat, 1)
        out[f"device_affine{tag}_jobs_done"] = n_done
        out[f"device_affine{tag}_rep_times_s"] = times
        out[f"device_affine{tag}_parity"] = all(
            c == w for c, w in zip(cigs, cigs_nat) if c)
    # the JAX bench named its retired device POA here; the port's K12
    # route is opt-in and measured by chip_smoke.py phase 9
    out["device_poa_status"] = ("opt-in: OTTER_TPU_POA_DEVICE=1 runs the "
                                "heaviest-path DP on K12; PERF.md section 6")
    return out
