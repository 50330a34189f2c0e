"""Gaussian KDE over pairwise distances + windowed peak/valley detection.

Parity with reference src/ankde.cpp: kernel (1/sqrt(2 pi)) exp(-x^2/2)
(:8-11), bandwidth scaling (:13-16), density mean over values (:18-23), and
``maximas`` alternating peak/valley detection over windowed sums (:25-62).

Host path runs in float64 for bit-parity with the C++ double math; the
device path (parallel/mesh.py::kde_tree_step) batches the grid evaluation
on TPU with a deterministic tree reduction, region-sharded over the mesh,
and kde_decision_certified (below) guarantees byte-identical decisions.
"""

from __future__ import annotations

import math
import os
from typing import List, Tuple

import numpy as np

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * 3.14159265358979323846)


def kde_grid(dinterval: float) -> np.ndarray:
    """The reference's accumulated grid ``for(x=0; x<=1; x+=dinterval)``
    (src/otterclust.cpp:26) — floating accumulation included, so the grid
    points match the C++ loop bit-for-bit."""
    xs = []
    x = 0.0
    while x <= 1.0:
        xs.append(x)
        x += dinterval
    return np.asarray(xs, dtype=np.float64)


def kde_densities(values: np.ndarray, bandwidth: float, xs: np.ndarray) -> np.ndarray:
    """f(x) = mean over v of (1/h) N((x-v)/h), normalized to sum 1
    (src/otterclust.cpp:25-34)."""
    values = np.asarray(values, dtype=np.float64)
    h = float(bandwidth)
    z = (xs[:, None] - values[None, :]) / h
    dens = np.sum(_INV_SQRT_2PI * np.exp(-(z * z) / 2.0), axis=1) / (h * len(values))
    total = float(np.sum(dens))
    return dens / total


def kde_densities_batched(value_lists, bandwidths, xs: np.ndarray):
    """Many regions' kde_densities in bucketed numpy calls — byte-identical
    to per-region kde_densities: regions are grouped by value count so every
    np.sum reduces rows of the same length (same pairwise-summation
    grouping), and all elementwise ops are the same float64 ops."""
    out = [None] * len(value_lists)
    by_n: dict = {}
    for i, v in enumerate(value_lists):
        by_n.setdefault(len(v), []).append(i)
    # cap the transient z buffer at ~1e6 doubles per slice: the elementwise
    # passes (sub/div/square/exp/scale) then stay cache-resident instead of
    # streaming a hundreds-of-MB temp through memory for every pass
    tasks = []
    for n, idxs in by_n.items():
        step = max(1, int(1e6 / max(1, 401 * n)))
        for c0 in range(0, len(idxs), step):
            tasks.append((n, idxs[c0 : c0 + step]))

    def _run(task):
        n, sl = task
        V = np.asarray([value_lists[i] for i in sl], dtype=np.float64)
        H = np.asarray([bandwidths[i] for i in sl],
                       dtype=np.float64)[:, None, None]
        # in-place chain; every op is the same float64 op as the
        # per-region oracle ((x-v)/h, square, halve+negate, exp,
        # *1/sqrt(2pi), row-sum, /(h*n)) so results stay bit-identical
        z = xs[None, :, None] - V[:, None, :]
        z /= H
        z *= z
        z /= -2.0
        np.exp(z, out=z)
        z *= _INV_SQRT_2PI
        dens = np.sum(z, axis=2)
        dens /= H[:, :, 0] * n
        total = np.sum(dens, axis=1, keepdims=True)
        dens = dens / total
        for r, i in enumerate(sl):
            out[i] = dens[r]

    # slices are independent and write disjoint out slots; numpy's ufunc
    # inner loops release the GIL, so a thread pool scales with cores
    # while keeping results bit-identical to the sequential run
    if len(tasks) > 1:
        import os
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(8, os.cpu_count() or 1,
                                    len(tasks))) as ex:
            list(ex.map(_run, tasks))
    else:
        for t in tasks:
            _run(t)
    return out


def _windowed_sums(densities: np.ndarray, radius: int) -> np.ndarray:
    """Windowed sums at every grid cell, adding terms in EXACTLY the
    reference's order (d[i], then d[i-1]..d[i-r+1], then d[i+1]..d[i+r-1])
    so float64 accumulation is bit-identical (ankde.cpp:31-44). Accepts a
    (G,) grid or an (R, G) batch of grids (the shifts run along the last
    axis, so every row's accumulation order is identical to the 1-D call)."""
    d = np.asarray(densities, dtype=np.float64)
    sums = d.copy()
    for j in range(1, radius):
        shifted = np.zeros_like(d)
        shifted[..., j:] = d[..., :-j]
        sums += shifted
    for j in range(1, radius):
        shifted = np.zeros_like(d)
        shifted[..., :-j] = d[..., j:]
        sums += shifted
    return sums


def kde_maximas_scan_ref(radius: int, densities: np.ndarray
                         ) -> Tuple[List[Tuple[int, float]],
                                    List[Tuple[int, float]]]:
    """Reference sequential scan (ankde.cpp:25-62) — the oracle for the
    vectorized kde_maximas below (randomized-equivalence tested)."""
    maxs: List[Tuple[int, float]] = []
    mins: List[Tuple[int, float]] = []
    n = len(densities)
    sums = _windowed_sums(densities, radius)
    find_maxima = True
    last_sum = 0.0
    last_sum_i = 1
    for i in range(1, n - 1):
        s = float(sums[i])
        if find_maxima:
            if s < last_sum:
                find_maxima = False
                maxs.append((last_sum_i, last_sum))
        else:
            if s > last_sum:
                find_maxima = True
                mins.append((last_sum_i, last_sum))
        last_sum = s
        last_sum_i = i
    if find_maxima:
        maxs.append((last_sum_i, last_sum))
    return maxs, mins


def kde_maximas(radius: int, densities: np.ndarray
                ) -> Tuple[List[Tuple[int, float]], List[Tuple[int, float]]]:
    """Alternating maxima/minima of windowed density sums (ankde.cpp:25-62).

    The window at i sums densities[i-j] and densities[i+j] for j in
    [1, radius) (clamped to the array), plus densities[i] itself.

    Vectorized: the scan's events are exactly the sign changes of the
    nonzero steps of sums[1..n-2] (initial hunting direction 'up', so a
    leading fall is a change too); plateaus record the LAST index before
    the change, which is where the step compares. Identical output to
    kde_maximas_scan_ref for any input, ties/plateaus included.
    """
    n = len(densities)
    if n < 3:
        return kde_maximas_scan_ref(radius, densities)
    sums = _windowed_sums(densities, radius)
    x = sums[1 : n - 1]
    steps = np.sign(np.diff(x))
    nz = np.nonzero(steps)[0]  # step q compares x[q+1-?]... see below
    maxs: List[Tuple[int, float]] = []
    mins: List[Tuple[int, float]] = []
    if len(nz):
        sgn = steps[nz]
        prev = np.concatenate(([1.0], sgn[:-1]))
        ev = sgn != prev
        # step at diff-index q compares x[q+1] vs x[q]; an event there
        # records the previous value x[q] at absolute grid index q+1
        ev_q = nz[ev]
        ev_sgn = sgn[ev]
        for q, sg in zip(ev_q, ev_sgn):
            pair = (int(q) + 1, float(x[q]))
            (maxs if sg < 0 else mins).append(pair)
        find_maxima = sgn[-1] > 0
    else:
        find_maxima = True
    if find_maxima:
        maxs.append((n - 2, float(x[-1])))
    return maxs, mins


# -- float32 device-KDE certification -----------------------------------------
#
# The clustering decision (ops/cluster.py::otter_find_clustering_dist)
# consumes ONLY (a) the alternating-extrema scan over adjacent windowed-sum
# comparisons and (b) peak-density comparisons against the 0.01 near-tie
# thresholds. Its output (DecisionBound) is built purely from extrema
# INDICES, so if every one of those comparisons provably decides the same
# way for the device float32 densities as for the float64 oracle, the final
# clustering output is byte-identical. kde_decision_certified checks every
# comparison's margin against a modeled f32 error bound; uncertain regions
# are recomputed with the float64 oracle by the caller.

# Relative per-cell error model for parallel/mesh.py::kde_tree_step:
# deterministic binary-tree pair reduction (<= log2(n_pad)+2 adds, ~1e-6),
# f32 exp/rounding of (x-v)/h terms (z*delta_z <= ~16 * 1.2e-5 for the
# terms that can dominate a positive cell), normalization divide. 2e-4 is
# >5x the worst modeled case.
_F32_REL_ERR = 2e-4


def _kde_dens_unnormalized(values: np.ndarray, bandwidth: float,
                           xs_subset: np.ndarray) -> np.ndarray:
    """kde_densities' per-cell value BEFORE grid normalization, evaluated at
    a subset of grid cells. Bit-identical to the corresponding cells of the
    full-grid call: each cell reduces over the same length-n values axis
    (same numpy pairwise-summation tree) with the same elementwise f64
    ops."""
    values = np.asarray(values, dtype=np.float64)
    h = float(bandwidth)
    z = (xs_subset[:, None] - values[None, :]) / h
    return np.sum(_INV_SQRT_2PI * np.exp(-(z * z) / 2.0), axis=1) \
        / (h * len(values))


_TINY_D = 1e-150


def kde_scaled_reconstruct(mexp: np.ndarray, mant: np.ndarray,
                           values: np.ndarray, bandwidth: float):
    """(d64, u64): normalized f64 densities from the scaled device KDE
    (parallel/mesh.py::kde_tree_step_scaled) plus per-cell relative-error
    based uncertainty bounds vs the float64 oracle (kde_densities).

    Hybrid reconstruction: density_c = C·exp(m_c)·s_c with
    C = (1/√2π)/(h·n) carries the f32 rounding of z² (exp(m) relative
    error ≤ ~2.4e-7·|m|) plus ~1e-6 from the mantissa tree-sum — fine for
    normal-range cells, but useless in the deep inter-cluster valleys
    where the oracle's comparisons live on denormal-scale margins. Cells
    whose reconstruction falls below 1e-150 are therefore REPLACED by the
    oracle's own unnormalized density, recomputed exactly on the host
    (few cells × few values — nanoseconds): their values then deviate
    from the oracle's normalized grid only by the shared normalization
    factor (comparison-invariant) and quotient rounding, so their
    uncertainty is ~1e-15·d and exact zeros are the oracle's exact zeros.
    Device cells keep u = (1e-6·|m| + 1.5e-4)·d (>4x the modeled error,
    including the ~5e-5 normalization-total deviation)."""
    m = np.asarray(mexp, dtype=np.float64)
    s = np.asarray(mant, dtype=np.float64)
    n_vals = len(values)
    if n_vals == 0:
        return None, None
    c = _INV_SQRT_2PI / (float(bandwidth) * n_vals)
    with np.errstate(under="ignore"):
        raw = c * np.exp(np.where(m < -745.0, -np.inf, m)) * s
    tiny = raw < _TINY_D
    if np.any(tiny):
        xs = kde_grid(0.0025)[: len(raw)]
        raw = raw.copy()
        raw[tiny] = _kde_dens_unnormalized(values, bandwidth, xs[tiny])
    total = float(raw.sum())
    if not np.isfinite(total) or total <= 0.0:
        return None, None, None
    d = raw / total
    # u_cmp: cell-level error only — the normalization total T deviates
    # from the oracle's by a COMMON factor, which cannot flip a comparison
    # between two cells, so it is excluded here. Components (f32 device
    # path): z/value-cast/z^2 rounding scales with |m| (~8e-7|m| modeled),
    # exp argument subtraction + tree-sum + exp ulp (~2e-6 modeled);
    # 3e-6|m| + 2e-5 is >4x the worst modeled case. Tiny cells are the
    # oracle's own recomputed f64 numbers: only quotient rounding remains.
    u_cmp = np.where(tiny, 1e-15 * d, (3e-6 * np.abs(m) + 2e-5) * d)
    # u_abs additionally carries the T deviation (<= max dominant-cell
    # relative error ~1e-4) for the comparisons against the absolute 0.01
    # near-tie threshold
    u_abs = u_cmp + 1e-4 * d
    return d, u_cmp, u_abs


def kde_decision_certified_scaled(mexp: np.ndarray, mant: np.ndarray,
                                  values: np.ndarray, bandwidth: float,
                                  radius: int):
    """(ok, d64): certify the scaled device KDE against the float64 oracle
    decision and return the reconstructed densities when certified.

    Same decision surface as kde_decision_certified (the alternating
    windowed-sum scan + the >2-peak 0.01 near-tie comparisons,
    otterclust.cpp:20-116): every adjacent windowed-sum comparison must
    have a margin exceeding the windowed uncertainty (or be an exact
    equality of provably-identical values — sub-1e-150 cells are the
    oracle's own recomputed numbers, so zero plateaus and deep valleys
    compare equal-vs-equal or with genuine margins), and no >2-peak
    pairwise density difference may approach the 0.01 near-tie threshold
    within tolerance. Anything else returns False and the caller recomputes
    with the full float64 oracle, so clustering output is byte-identical
    either way."""
    d, u_cmp, u_abs = kde_scaled_reconstruct(mexp, mant, values, bandwidth)
    if d is None:
        return False, None
    n = len(d)
    sums = _windowed_sums(d, radius)
    usums = _windowed_sums(u_cmp, radius)
    a = sums[1 : n - 2]
    b = sums[2 : n - 1]
    tol = usums[1 : n - 2] + usums[2 : n - 1]
    gap = np.abs(b - a)
    ok = (gap > tol) | ((gap == 0.0) & (tol == 0.0))
    if not np.all(ok):
        return False, None
    if not _peaks_certified(d, u_abs, radius):
        return False, None
    return True, d


def _peaks_certified(d: np.ndarray, u_abs: np.ndarray, radius: int) -> bool:
    """The >2-peak 0.01 near-tie comparisons of the decision surface
    (otterclust.cpp:51-115): no pairwise peak-density difference may approach
    the threshold within the windowed absolute-uncertainty tolerance."""
    maxs, _mins = kde_maximas(radius, d)
    if len(maxs) <= 2:
        return True
    idxs = np.asarray([i for i, _v in maxs], dtype=np.int64)
    vals = np.asarray([v for _i, v in maxs], dtype=np.float64)
    diff = np.abs(vals[:, None] - vals[None, :])
    usums_abs = _windowed_sums(u_abs, radius)
    tolm = usums_abs[idxs][:, None] + usums_abs[idxs][None, :]
    iu = np.triu_indices(len(vals), k=1)
    return not np.any(np.abs(diff[iu] - 0.01) <= tolm[iu])


def kde_decision_certified_scaled_batch(scaled_list, value_lists, bandwidths,
                                        radius: int):
    """Vectorized kde_decision_certified_scaled over many regions.

    One (R, G) pass performs the reconstruction, windowed sums, and margin
    checks for the whole batch; results are bit-identical to the per-region
    call for every region (elementwise f64 ops are identical per cell, the
    row reduction of a C-contiguous last axis uses the same pairwise
    summation tree as the 1-D call, and _windowed_sums shifts along the last
    axis in the same order). Regions with sub-1e-150 cells (oracle-recompute
    path) fall back to the scalar call; the >2-peak near-tie check runs
    per surviving region (rare, loop only over events).

    Returns a list of (ok, d64-or-None) like the scalar function."""
    R = len(scaled_list)
    results: list = [(False, None)] * R
    if R == 0:
        return results
    G = len(scaled_list[0][0])
    gen = [r for r in range(R)
           if len(scaled_list[r][0]) == G and len(value_lists[r]) > 0]
    for r in range(R):
        if r not in gen:  # ragged grid or empty values: scalar path
            results[r] = kde_decision_certified_scaled(
                scaled_list[r][0], scaled_list[r][1], value_lists[r],
                bandwidths[r], radius)
    if not gen:
        return results
    M = np.stack([np.asarray(scaled_list[r][0], dtype=np.float64)
                  for r in gen])
    S = np.stack([np.asarray(scaled_list[r][1], dtype=np.float64)
                  for r in gen])
    nv = np.asarray([len(value_lists[r]) for r in gen], dtype=np.float64)
    bw = np.asarray([bandwidths[r] for r in gen], dtype=np.float64)
    c = _INV_SQRT_2PI / (bw * nv)
    with np.errstate(under="ignore"):
        raw = c[:, None] * np.exp(np.where(M < -745.0, -np.inf, M)) * S
    tiny = raw < _TINY_D
    # vectorized tiny-cell oracle recompute (the scalar path's
    # _kde_dens_unnormalized per region): every tiny (row, cell) reduces
    # over that region's n values — flat-gathered and grouped by n so one
    # numpy call covers a whole group, each element reducing the same
    # contiguous length-n axis (same pairwise tree, same elementwise f64
    # ops) as the scalar call
    if np.any(tiny):
        xs = kde_grid(0.0025)[:G]
        rows_any = [int(bi) for bi in np.nonzero(np.any(tiny, axis=1))[0]]

        def _recompute_row(bi: int) -> None:
            # provably-zero cells need no recompute: when every value is
            # > 39h away, every f64 Gaussian term's exponent is < -746 —
            # past the denormal cutoff (ln 2^-1074 = -744.4) — so each
            # term, the sum, and the oracle's own recomputed cell are all
            # EXACTLY +0.0 (skipping them is bit-identical, not an
            # approximation). Typically prunes the deep tails/valleys,
            # which are most of a unimodal region's tiny cells.
            vals_r = np.asarray(value_lists[gen[bi]], dtype=np.float64)
            n_val = len(vals_r)
            h = float(bw[bi])
            cols = np.nonzero(tiny[bi])[0]
            sv = np.sort(vals_r)
            x = xs[cols]
            pos = np.searchsorted(sv, x)
            dl = np.where(pos > 0, x - sv[np.maximum(pos - 1, 0)], np.inf)
            dr = np.where(pos < n_val, sv[np.minimum(pos, n_val - 1)] - x,
                          np.inf)
            dead = np.minimum(dl, dr) > 39.0 * h
            raw[bi, cols[dead]] = 0.0
            live = cols[~dead]
            if not len(live):
                return
            # in-place elementwise chain; every op bit-identical to
            # _kde_dens_unnormalized (sub, /h, square, *-0.5 == neg-/2,
            # exp, *C, contiguous row-sum, /(h*n)). The exp runs on the
            # FULL row: entries with z^2/2 > 745.2 underflow to exactly
            # +0.0 (the old near-mask's skipped value), so no masking —
            # and no fancy-index gather/scatter over the big matrix
            z = xs[live][:, None] - vals_r[None, :]
            z /= h
            z *= z
            z *= -0.5
            with np.errstate(under="ignore"):
                np.exp(z, out=z)
            z *= _INV_SQRT_2PI
            raw[bi, live] = np.sum(z, axis=1) / (h * n_val)

        # regions are independent and numpy's ufunc loops release the GIL
        if len(rows_any) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(8, os.cpu_count() or 1,
                                        len(rows_any))) as ex:
                list(ex.map(_recompute_row, rows_any))
        else:
            for bi in rows_any:
                _recompute_row(bi)
    total = np.sum(raw, axis=1)
    bad = ~np.isfinite(total) | (total <= 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        d = raw / total[:, None]
        u_cmp = np.where(tiny, 1e-15 * d, (3e-6 * np.abs(M) + 2e-5) * d)
        u_abs = u_cmp + 1e-4 * d
    sums = _windowed_sums(np.where(bad[:, None], 0.0, d), radius)
    usums = _windowed_sums(np.where(bad[:, None], 0.0, u_cmp), radius)
    a = sums[:, 1 : G - 2]
    b = sums[:, 2 : G - 1]
    tol = usums[:, 1 : G - 2] + usums[:, 2 : G - 1]
    gap = np.abs(b - a)
    okm = (gap > tol) | ((gap == 0.0) & (tol == 0.0))
    row_ok = np.all(okm, axis=1)
    for bi, r in enumerate(gen):
        if bad[bi]:
            results[r] = (False, None)
        elif not row_ok[bi]:
            results[r] = (False, None)
        elif not _peaks_certified(d[bi], u_abs[bi], radius):
            results[r] = (False, None)
        else:
            results[r] = (True, d[bi])
    return results


def kde_decision_certified(dens_f32: np.ndarray, values: np.ndarray,
                           bandwidth: float, radius: int,
                           rel: float = _F32_REL_ERR) -> bool:
    """True iff the float32 density grid provably yields the same clustering
    decision as the float64 oracle (see module comment above)."""
    d = np.asarray(dens_f32, dtype=np.float64)
    n = len(d)
    xs = kde_grid(0.0025)[:n]
    # Sub-threshold cells (f32 underflow/denormal fringe — f64 may still be
    # positive there, so value comparisons are meaningless) are safe ONLY in
    # a provably monotone tail: all data strictly beyond the windows on one
    # side makes every windowed-sum term strictly monotone in f64 (no scan
    # event possible), and we separately require the f32 sums not to wobble
    # there. A sub-threshold cell BETWEEN data clusters (a deep valley) is
    # uncertifiable: the f64 scan could place the valley minimum anywhere in
    # the dead zone.
    sub = d < 1e-35
    vmin = float(np.min(values)) if len(values) else 0.0
    vmax = float(np.max(values)) if len(values) else 0.0
    span = radius * 0.0025
    right_tail = xs - span > vmax
    left_tail = xs + span < vmin
    if np.any(sub & ~(right_tail | left_tail)):
        return False
    sums = _windowed_sums(d, radius)
    # every comparison of the alternating scan is between adjacent windowed
    # sums (plus the initial compare against 0.0, safe for any s >= 0);
    # pairs touching a sub-threshold cell instead require the f32 sums to
    # follow the provable f64 direction (non-increasing on the right tail,
    # non-decreasing on the left) so neither precision records an event
    a = sums[1 : n - 2]
    b = sums[2 : n - 1]
    pair_sub = sub[1 : n - 2] | sub[2 : n - 1]
    gap = np.abs(b - a)
    scale = a + b
    margin_ok = (gap > rel * scale) | (scale == 0.0)
    dir_ok = np.where(right_tail[2 : n - 1], b <= a,
                      np.where(left_tail[1 : n - 2], b >= a, False))
    if not np.all(np.where(pair_sub, dir_ok, margin_ok)):
        return False
    # >2 peaks: the insertion sort and the adjacent-peak merge compare peak
    # windowed sums against the 0.01 near-tie threshold (cluster.py)
    maxs, _mins = kde_maximas(radius, d)
    if len(maxs) > 2:
        vals = np.asarray([v for _i, v in maxs], dtype=np.float64)
        diff = np.abs(vals[:, None] - vals[None, :])
        tol = rel * (vals[:, None] + vals[None, :])
        iu = np.triu_indices(len(vals), k=1)
        if np.any(np.abs(diff[iu] - 0.01) <= tol[iu]):
            return False
    return True
