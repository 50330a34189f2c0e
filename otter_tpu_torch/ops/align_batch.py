"""Batched banded gap-affine alignment of many (pattern, text) jobs.

rapid_consensus aligns every cluster member against its medoid backbone
(src/analignments.cpp:266-282); this module runs those alignments as a
band-escalation ladder, on the native C++ engine or as one vectorized
banded DP over the member batch (members on the batch axis), then walks
each member's traceback. Semantics — scores, free
ends, and tie-breaking — are identical to ops/align_np.py (cross-checked in
tests), so consensus output is unchanged.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .. import native
from .align_np import (
    GAP_EXT,
    GAP_OPEN,
    MISMATCH,
    _BIG,
    _codes,
    affine_align_ends_free_cigar,
    band_validity_cap,
    edit_align_cigar_len,
)


class _MemberView:
    """[i, j] indexing into one member's banded matrix."""

    def __init__(self, arr: np.ndarray, k: int):
        self.arr = arr
        self.k = k
        self.W = arr.shape[1]

    def __getitem__(self, ij):
        i, j = ij
        w = j - i + (self.k + 1)
        if 0 <= w < self.W:
            return self.arr[i, w]
        return _BIG


def _end_cell(H: _MemberView, m: int, n: int, pe: int, te: int):
    best = (int(H[m, n]), m, n)
    for j in range(n - 1, max(0, n - te) - 1, -1):
        s = int(H[m, j])
        if s < best[0]:
            best = (s, m, j)
    for i in range(m - 1, max(0, m - pe) - 1, -1):
        s = int(H[i, n])
        if s < best[0]:
            best = (s, i, n)
    return best


def _traceback(H, E, F, a, b, m, n, ei, ej) -> str:
    """Shared banded/full traceback. When given _MemberView wrappers, the
    band arithmetic is inlined on raw python lists for speed (the walk is
    the per-member serial hot loop)."""
    if isinstance(H, _MemberView):
        return _traceback_banded(H.arr, E.arr, F.arr, H.k, a, b, m, n, ei, ej)
    ops = []
    ops.extend("I" * (n - ej))
    ops.extend("D" * (m - ei))
    i, j = ei, ej
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            h = H[i, j]
            if i == 0:
                ops.extend("I" * j)
                break
            if j == 0:
                ops.extend("D" * i)
                break
            if h == F[i, j]:
                state = "F"
                continue
            if h == E[i, j]:
                state = "E"
                continue
            sub = 0 if a[i - 1] == b[j - 1] else MISMATCH
            ops.append("M" if sub == 0 else "X")
            i -= 1
            j -= 1
        elif state == "F":
            ops.append("D")
            if F[i, j] == F[i - 1, j] + GAP_EXT and i > 1:
                i -= 1
            else:
                i -= 1
                state = "H"
        else:
            ops.append("I")
            if E[i, j] == E[i, j - 1] + GAP_EXT and j > 1:
                j -= 1
            else:
                j -= 1
                state = "H"
    return "".join(reversed(ops))


def _traceback_banded(Ha, Ea, Fa, k, a, b, m, n, ei, ej) -> str:
    """Inlined banded traceback (no per-access method dispatch)."""
    Hl = Ha
    El = Ea
    Fl = Fa
    W = Ha.shape[1]
    kp1 = k + 1
    al = a.tolist()
    bl = b.tolist()
    ops = []
    ops.extend("I" * (n - ej))
    ops.extend("D" * (m - ei))
    i, j = ei, ej
    state = "H"
    big = _BIG
    while i > 0 or j > 0:
        w = j - i + kp1
        if state == "H":
            h = Hl[i, w] if 0 <= w < W else big
            if i == 0:
                ops.extend("I" * j)
                break
            if j == 0:
                ops.extend("D" * i)
                break
            if h == (Fl[i, w] if 0 <= w < W else big):
                state = "F"
                continue
            if h == (El[i, w] if 0 <= w < W else big):
                state = "E"
                continue
            ops.append("M" if al[i - 1] == bl[j - 1] else "X")
            i -= 1
            j -= 1
        elif state == "F":
            ops.append("D")
            wf = w + 1  # (i-1, j) in row i-1 coords
            cur = Fl[i, w] if 0 <= w < W else big
            up = Fl[i - 1, wf] if 0 <= wf < W else big
            if cur == up + GAP_EXT and i > 1:
                i -= 1
            else:
                i -= 1
                state = "H"
        else:
            ops.append("I")
            wl = w - 1
            cur = El[i, w] if 0 <= w < W else big
            left = El[i, wl] if 0 <= wl < W else big
            if cur == left + GAP_EXT and j > 1:
                j -= 1
            else:
                j -= 1
                state = "H"
    return "".join(reversed(ops))


# keep the batch's H/E/F footprint bounded (int64 x 3 matrices)
_MEM_BUDGET_BYTES = 512 * 1024 * 1024


def _banded_batch_multi(patterns: List[np.ndarray], texts: List[np.ndarray],
                        k: int, pb: np.ndarray, tb: np.ndarray):
    """Per-member patterns variant: H/E/F (B, m_max+1, W); rows beyond a
    member's pattern end freeze (score extraction at i=m stays valid because
    frozen rows keep row-m band coordinates; traceback never reads i>m)."""
    B = len(patterns)
    m = np.array([len(p) for p in patterns], dtype=np.int64)
    m_max = int(m.max())
    W = 2 * (k + 1)
    I32 = np.int32
    ax = np.full((B, m_max), -2, dtype=I32)
    for bi, p in enumerate(patterns):
        ax[bi, : len(p)] = p
    n = np.array([len(t) for t in texts], dtype=I32)[:, None]
    nmax = int(n.max())
    bx = np.full((B, nmax + W + 2), -1, dtype=I32)
    for bi, t in enumerate(texts):
        bx[bi, : len(t)] = t
    # rows 1..m_max are fully written every iteration (frozen rows copy the
    # previous row), so only row 0 needs initialization — np.empty avoids
    # page-faulting ~100MB of _BIG fills per chunk
    H = np.empty((B, m_max + 1, W), dtype=I32)
    E = np.empty((B, m_max + 1, W), dtype=I32)
    F = np.empty((B, m_max + 1, W), dtype=I32)
    E[:, 0, :] = _BIG
    F[:, 0, :] = _BIG
    w_idx = np.arange(W, dtype=I32)[None, :]
    ew = (GAP_EXT * w_idx).astype(I32)
    j0 = (w_idx - (k + 1)).astype(I32)
    tb2 = tb[:, None].astype(I32)
    pb2 = pb[:, None].astype(I32)
    m2 = m[:, None].astype(I32)
    H[:, 0, :] = np.where(
        (j0 >= 0) & (j0 <= n),
        np.where(j0 <= tb2, 0, GAP_OPEN + GAP_EXT * (j0 - tb2)), _BIG)
    big_col = np.full((B, 1), _BIG, dtype=I32)
    for i in range(1, m_max + 1):
        j = i + j0
        lo = i - (k + 1) - 1
        if lo >= 0:
            b_win = bx[:, lo : lo + W]
        else:
            b_win = np.concatenate(
                [np.full((B, -lo), -1, dtype=I32), bx[:, : W + lo]],
                axis=1)
        a_col = ax[:, i - 1 : i]
        sub = np.where(b_win == a_col, I32(0), I32(MISMATCH))
        Hup = np.concatenate([H[:, i - 1, 1:], big_col], axis=1)
        Fup = np.concatenate([F[:, i - 1, 1:], big_col], axis=1)
        F_row = np.minimum(Hup + I32(GAP_OPEN + GAP_EXT), Fup + I32(GAP_EXT))
        diag = H[:, i - 1, :] + sub
        Bv = np.minimum(diag, F_row)
        hb = np.where(i <= pb2, I32(0),
                      (GAP_OPEN + GAP_EXT * (i - pb2)).astype(I32))
        Bv = np.where(j == 0, hb, Bv)
        invalid = (j < 0) | (j > n)
        Bv = np.where(invalid, I32(_BIG), Bv)
        scan = np.minimum.accumulate(Bv - ew, axis=1)
        E_row = np.empty((B, W), dtype=I32)
        E_row[:, 0] = _BIG
        E_row[:, 1:] = scan[:, :-1] + ew[:, 1:] + I32(GAP_OPEN)
        E_row = np.where(invalid, I32(_BIG), E_row)
        H_row = np.minimum(Bv, E_row)
        H_row = np.where(j == 0, hb, H_row)
        H_row = np.where(invalid, I32(_BIG), H_row)
        F_row = np.where(invalid, I32(_BIG), F_row)
        # freeze members whose pattern already ended
        keep = (i <= m2)
        H[:, i, :] = np.where(keep, H_row, H[:, i - 1, :])
        E[:, i, :] = np.where(keep, E_row, E[:, i - 1, :])
        F[:, i, :] = np.where(keep, F_row, F[:, i - 1, :])
    return H, E, F, m, n[:, 0]


def _native_ladder(jobs, out: List[str], groups: dict) -> List[str]:
    """Band-escalation ladder over the native C++ engine
    (native/otter_native.cpp::otter_affine_banded_batch). Members at the
    full-matrix threshold run with k = max(m, n) — band covers every cell,
    so the result is unconditionally exact; others use the same validity
    check + escalation as the numpy ladder. Cigars are bit-identical to the
    numpy/scalar paths (same recurrences, end-cell preference, traceback
    tie-breaking)."""
    while groups:
        k = min(groups)
        members = groups.pop(k)
        njobs = [jobs[i] for i in members]
        ks: List[int] = []
        exact: List[bool] = []
        for i in members:
            p, t = jobs[i][0], jobs[i][1]
            if 2 * (k + 1) >= len(t) + 2:
                ks.append(max(len(p), len(t)))
                exact.append(True)
            else:
                ks.append(k)
                exact.append(False)
        cigs, scores = native.affine_banded_cigar_batch(njobs, ks)
        for bi, idx in enumerate(members):
            p, t, pbv, pev, tbv, tev = jobs[idx]
            if exact[bi] or (scores[bi] < band_validity_cap(
                    len(p), len(t), pbv, pev, tbv, tev, ks[bi])):
                out[idx] = cigs[bi]
            else:
                groups.setdefault(2 * k, []).append(idx)
    return out


def affine_cigars_multi(jobs: Sequence[Tuple[str, str, int, int, int, int]],
                        dist_hints=None) -> List[str]:
    """Cigars for (pattern, text, pb, pe, tb, te) jobs with *different*
    patterns, batched by band size. Exact scalar parity; escalating members
    fall back to the scalar path.

    dist_hints: per-job exact (ends-free) edit distances e. The affine score
    of the e-edit path costs at most 8e (mismatch 4; a length-L gap 6+2L),
    and band validity needs k > (score-6)/2 + reach, so seeding
    k ~ 2.5e + reach (typical score ~5e) lands near the final band in one
    or two tries instead of climbing from 32. Exactness is unaffected: the
    validity check still escalates until the banded score is provably
    optimal.
    """
    out: List[str] = [""] * len(jobs)
    remaining_idx = list(range(len(jobs)))
    use_native = native.enabled("AFFINE")
    groups: dict = {}
    for idx in remaining_idx:
        p, t, pb, pe, tb, te = jobs[idx]
        reach = max(abs(len(t) - len(p)), pb, pe, tb, te)
        target = reach + 16
        if dist_hints is not None and dist_hints[idx] is not None:
            target = max(target, (5 * int(dist_hints[idx])) // 2 + reach)
        k = 32
        while k < target:
            k *= 2
        if not use_native and 2 * (k + 1) >= len(t) + 2:
            out[idx] = affine_align_ends_free_cigar(p, t, pb, pe, tb, te,
                                                    k_start=k)
        else:
            groups.setdefault(k, []).append(idx)
    if use_native:
        return _native_ladder(jobs, out, groups)
    # batched band-escalation ladder: members whose band proves too narrow
    # move to the next k group instead of falling back to the (much slower)
    # per-member scalar path
    while groups:
        k = min(groups)
        members = groups.pop(k)
        m_max = max(len(jobs[i][0]) for i in members)
        per_member = 3 * (m_max + 1) * (2 * (k + 1)) * 4  # int32 H/E/F
        chunk = max(1, _MEM_BUDGET_BYTES // max(1, per_member))
        for c0 in range(0, len(members), chunk):
            sub_idx = members[c0 : c0 + chunk]
            pats = [_codes(jobs[i][0]) for i in sub_idx]
            texts = [_codes(jobs[i][1]) for i in sub_idx]
            pb = np.array([jobs[i][2] for i in sub_idx], dtype=np.int64)
            tb = np.array([jobs[i][4] for i in sub_idx], dtype=np.int64)
            H, E, F, m, n = _banded_batch_multi(pats, texts, k, pb, tb)
            for bi, idx in enumerate(sub_idx):
                p, t, pbv, pev, tbv, tev = jobs[idx]
                Hv = _MemberView(H[bi], k)
                Ev = _MemberView(E[bi], k)
                Fv = _MemberView(F[bi], k)
                score, ei, ej = _end_cell(Hv, int(m[bi]), int(n[bi]), pev, tev)
                if score < band_validity_cap(int(m[bi]), int(n[bi]),
                                             pbv, pev, tbv, tev, k):
                    out[idx] = _traceback(Hv, Ev, Fv, pats[bi], texts[bi],
                                          int(m[bi]), int(n[bi]), ei, ej)
                else:
                    k2 = 2 * k
                    if 2 * (k2 + 1) >= len(t) + 2:
                        out[idx] = affine_align_ends_free_cigar(
                            p, t, pbv, pev, tbv, tev, k_start=k2)
                    else:
                        groups.setdefault(k2, []).append(idx)
    return out


def _ends_free_banded_numpy(jobs, members, k: int) -> np.ndarray:
    """One fixed-k banded ends-free pass over ``members`` (numpy inner loop
    of edit_ends_free_batch). Returns per-member best scores; band validity
    is the caller's check."""
    W = 2 * (k + 1)
    B = len(members)
    pats = [_codes(jobs[i][0]).astype(np.int64) for i in members]
    txts = [_codes(jobs[i][1]).astype(np.int64) for i in members]
    m = np.array([len(p) for p in pats], dtype=np.int64)
    n = np.array([len(t) for t in txts], dtype=np.int64)[:, None]
    m_max = int(m.max())
    ax = np.full((B, m_max), -2, dtype=np.int64)
    for bi, p in enumerate(pats):
        ax[bi, : len(p)] = p
    nmax = int(n.max())
    bx = np.full((B, nmax + W + 2), -1, dtype=np.int64)
    for bi, t in enumerate(txts):
        bx[bi, : len(t)] = t
    pb_ = np.array([jobs[i][2] for i in members], dtype=np.int64)[:, None]
    pe_ = np.array([jobs[i][3] for i in members], dtype=np.int64)[:, None]
    tb_ = np.array([jobs[i][4] for i in members], dtype=np.int64)[:, None]
    te_ = np.array([jobs[i][5] for i in members], dtype=np.int64)[:, None]
    m2 = m[:, None]
    w_idx = np.arange(W, dtype=np.int64)[None, :]
    j0 = w_idx - (k + 1)
    prev = np.where((j0 >= 0) & (j0 <= n),
                    np.maximum(0, j0 - tb_), _BIG)
    prev = prev.astype(np.int64)
    # best over allowed end cells: last column (j == n, i >= m - pe)
    # tracked as rows advance; last row handled at the end
    col0 = n[:, 0] + (k + 1)  # w of j==n at row 0
    valid0 = (pe_[:, 0] >= m) & (col0 >= 0) & (col0 < W)
    best_last_col = np.where(
        valid0, prev[np.arange(B), np.clip(col0, 0, W - 1)],
        np.int64(1 << 60))
    for i in range(1, m_max + 1):
        j = i + j0
        lo = i - (k + 1) - 1
        if lo >= 0:
            b_win = bx[:, lo : lo + W]
        else:
            b_win = np.concatenate(
                [np.full((B, -lo), -1, dtype=np.int64), bx[:, : W + lo]],
                axis=1)
        a_col = ax[:, i - 1 : i]
        sub = (b_win != a_col).astype(np.int64)
        up = np.concatenate(
            [prev[:, 1:], np.full((B, 1), _BIG, dtype=np.int64)],
            axis=1) + 1
        v = np.minimum(up, prev + sub)
        v = np.where(j == 0, np.maximum(0, i - pb_), v)
        v = np.where((j < 0) | (j > n), _BIG, v)
        cur = np.minimum.accumulate(v - w_idx, axis=1) + w_idx
        cur = np.where((j < 0) | (j > n), _BIG, cur)
        keep = i <= m2
        prev = np.where(keep, cur, prev)
        # last-column candidates for rows i with m - i <= pe
        wcol = n[:, 0] - i + (k + 1)
        active = (i <= m) & (m - i <= pe_[:, 0]) & (wcol >= 0) & (wcol < W)
        colvals = np.where(active,
                           cur[np.arange(B), np.clip(wcol, 0, W - 1)],
                           np.int64(1 << 60))
        best_last_col = np.minimum(best_last_col, colvals)
    # last-row minimum over j in [n - te, n]
    jrow = np.arange(W, dtype=np.int64)[None, :]
    jmap = m2 + jrow - (k + 1)
    rowvals = np.where((jmap >= np.maximum(0, n - te_)) & (jmap <= n),
                       prev, np.int64(1 << 60))
    best = np.minimum(best_last_col, rowvals.min(axis=1))
    return best


def edit_ends_free_batch(jobs: Sequence[Tuple[str, str, int, int, int, int]],
                         banded_runner=None) -> np.ndarray:
    """Batched unit-cost ends-free edit distances, exact parity with
    ops.align_np.edit_distance_ends_free. Jobs: (pattern, text, pb, pe,
    tb, te). Banded with doubling; validity: a path leaving the +-k band
    needs > k - reach non-free indels, so score <= k - reach is exact.

    banded_runner(jobs, members, k) -> best overrides the fixed-k inner
    pass (the engine's mesh path runs it as a pair-sharded jnp dispatch,
    kernels/edit_pallas.py::edit_banded_ends_free_jnp); the validity check
    here still guarantees exactness regardless of the runner."""
    from .align_np import edit_distance_ends_free

    out = np.zeros(len(jobs), dtype=np.int64)
    groups: dict = {}
    for idx, (p, t, pb, pe, tb, te) in enumerate(jobs):
        reach = max(abs(len(t) - len(p)), pb, pe, tb, te)
        k = 32
        while k < reach + 16:
            k *= 2
        if 2 * (k + 1) >= len(t) + 2 or not p or not t:
            out[idx] = edit_distance_ends_free(p, t, pb, pe, tb, te)
        else:
            groups.setdefault(k, []).append(idx)
    # batched escalation: band-insufficient members retry at the next k
    while groups:
        k = min(groups)
        members = groups.pop(k)
        if banded_runner is not None:
            best = banded_runner(jobs, members, k)
        else:
            best = _ends_free_banded_numpy(jobs, members, k)
        for bi, idx in enumerate(members):
            p, t, pbv, pev, tbv, tev = jobs[idx]
            reach = max(abs(len(t) - len(p)), pbv, pev, tbv, tev)
            if int(best[bi]) <= k - reach:
                out[idx] = int(best[bi])
            else:
                k2 = 2 * k
                if 2 * (k2 + 1) >= len(t) + 2:
                    out[idx] = edit_distance_ends_free(p, t, pbv, pev,
                                                       tbv, tev)
                else:
                    groups.setdefault(k2, []).append(idx)
    return out
def _is_subsequence(small: str, big: str) -> bool:
    """True iff ``small`` is a subsequence of ``big`` (iff their edit
    distance equals len(big) - len(small))."""
    it = iter(big)
    return all(ch in it for ch in small)


def edit_cigar_cols_batch(pairs: Sequence[Tuple[str, str]],
                          dists: Sequence[int]) -> List[Tuple[int, int]]:
    """Batched (edit distance, alignment column count) for
    WFAlignerEdit(Alignment) — compare's hot op (src/compare.cpp:60-61).

    Vectorizes align_np.edit_align_cigar_len's composite lexicographic DP
    over the pair batch: pairs are bucketed by (band, padded row count) and
    each bucket runs ONE banded numpy DP over (B, W) arrays instead of B
    python DP loops. ``dists`` are known-exact edit distances (the pooled
    device engine output), so each pair's band is max(|m-n|+1, d) — its
    final ladder rung — and the scalar exactness check (edit <= k) passes
    by construction; any pair that still fails it (a wrong hint) falls back
    to the scalar DP. Integer arithmetic is identical to the scalar path,
    so results are byte-identical.

    pairs must be (pattern, text) with pattern the longer string (the
    caller applies compare.cpp's subj/query ordering).
    """
    out: List[Tuple[int, int]] = [None] * len(pairs)  # type: ignore
    K = np.int64(1 << 22)
    step = K + 1
    INF = np.int64(1 << 56)
    buckets: dict = {}
    for idx, ((p, t), d) in enumerate(zip(pairs, dists)):
        m, n = len(p), len(t)
        if m < n:
            raise ValueError("pattern must be the longer string")
        if m == 0:
            out[idx] = (0, 0)  # m >= n, so both empty
            continue
        # closed forms VERIFIED independently of the hint (a wrong hint
        # must never corrupt results, only cost work):
        if d == 0 and p == t:
            out[idx] = (0, m)
            continue
        if int(d) == m - n and _is_subsequence(t, p):
            # pure-indel optimum: X = 0, indels = m - n exactly, no DP
            out[idx] = (m - n, m)
            continue
        k = max(abs(m - n) + 1, int(d))
        kp = 7
        while kp < k:
            kp *= 2
        mp = 64
        while mp < m:
            mp *= 2
        buckets.setdefault((kp, mp), []).append(idx)
    for (k, mp), members in buckets.items():
        W = 2 * (k + 1)
        B = len(members)
        m_arr = np.empty(B, dtype=np.int64)
        n_arr = np.empty(B, dtype=np.int64)
        m_max = 0
        n_max = 0
        for bi, idx in enumerate(members):
            p, t = pairs[idx]
            m_arr[bi] = len(p)
            n_arr[bi] = len(t)
            m_max = max(m_max, len(p))
            n_max = max(n_max, len(t))
        a_arr = np.full((B, m_max), -2, dtype=np.int64)
        L = k + 2 + n_max + W + 2
        bpad = np.full((B, L), -1, dtype=np.int64)
        for bi, idx in enumerate(members):
            p, t = pairs[idx]
            a_arr[bi, : len(p)] = _codes(p)
            bpad[bi, k + 2 : k + 2 + len(t)] = _codes(t)
        w_idx = np.arange(W, dtype=np.int64)
        j0 = w_idx - (k + 1)
        wshift = w_idx * step
        prev = np.where((j0[None, :] >= 0) & (j0[None, :] <= n_arr[:, None]),
                        j0[None, :] * step, INF)
        inf_col = np.full((B, 1), INF, dtype=np.int64)
        for i in range(1, m_max + 1):
            b_win = bpad[:, i : i + W]
            sub = np.where(b_win == a_arr[:, i - 1 : i], 0, K)
            up = np.concatenate([prev[:, 1:], inf_col], axis=1) + step
            v = np.minimum(up, prev + sub)
            j = i + j0
            v = np.where(j[None, :] == 0, np.int64(i) * step, v)
            v = np.where((j[None, :] < 0) | (j[None, :] > n_arr[:, None]),
                         INF, v)
            new = np.minimum.accumulate(v - wshift[None, :], axis=1) \
                + wshift[None, :]
            active = (i <= m_arr)[:, None]
            prev = np.where(active, new, prev)
        wf = (n_arr - m_arr + (k + 1)).astype(np.int64)
        cand = prev[np.arange(B), wf]
        edit = cand // K
        for bi, idx in enumerate(members):
            if int(edit[bi]) <= k and int(cand[bi]) < int(INF):
                c = int(cand[bi])
                e = c // int(K)
                indels = c - e * int(K)
                m, n = int(m_arr[bi]), int(n_arr[bi])
                out[idx] = (e, (m + n + indels) // 2)
            else:  # wrong hint: scalar ladder from scratch (exact)
                p, t = pairs[idx]
                out[idx] = edit_align_cigar_len(p, t)
    return out
