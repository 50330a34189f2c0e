"""Host reference aligners (numpy), semantics-compatible with WFA2-lib usage.

The reference uses WFA2-lib in two modes (src/assemble.cpp:49-50):
  * ``WFAlignerEdit(Score)``  — unit-cost edit distance, score-only, with
    End2End and EndsFree variants (src/analignments.cpp:70,88-96).
    WFA2 distance metrics report *positive* scores, so edit score ==
    Levenshtein distance.
  * ``WFAlignerGapAffine(4,6,2, Alignment)`` — mismatch 4, gap-open 6,
    gap-extend 2 (gap of length L costs 6 + 2L), match 0; used only for its
    per-column cigar string (chars M/X/I/D), consumed by local_realignment
    (analignments.cpp:37) and the PPOA builder (anppoa.hpp:112).

Wavefront alignment extends matches greedily along diagonals, which
right-aligns edits after maximal match runs. Our tracebacks reproduce that
by preferring gap operations over diagonal steps on score ties (see
tests/test_align.py and the PPOA golden tests for calibration).

These are the exactness oracles; the batched TPU kernels in
otter_tpu/kernels are tested against them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_BIG = np.int32(1 << 28)


def _codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8)


def edit_distance(x: str, y: str) -> int:
    """Unit-cost Levenshtein distance (WFAlignerEdit alignEnd2End score)."""
    if x == y:
        return 0
    a, b = _codes(x), _codes(y)
    m, n = len(a), len(b)
    if m == 0:
        return n
    if n == 0:
        return m
    js = np.arange(n + 1, dtype=np.int64)
    prev = js.copy()
    cur = np.empty(n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        sub = (b != a[i - 1]).astype(np.int64)
        v = np.empty(n + 1, dtype=np.int64)
        v[0] = i
        np.minimum(prev[1:] + 1, prev[:-1] + sub, out=v[1:])
        # resolve the in-row horizontal dependency with a prefix-min scan:
        # cur[j] = min_{j'<=j} v[j'] + (j - j')
        cur = np.minimum.accumulate(v - js) + js
        prev, cur = cur, prev
    return int(prev[n])


def edit_distance_ends_free(pattern: str, text: str,
                            pb: int, pe: int, tb: int, te: int) -> int:
    """Edit distance with free leading/trailing gaps.

    WFA2 ``alignEndsFree(pattern, pb, pe, text, tb, te)``: up to ``pb``/``pe``
    pattern chars and ``tb``/``te`` text chars may be skipped for free at the
    begin/end. Implemented as DP boundary conditions: D[0][j] = max(0, j-tb),
    D[i][0] = max(0, i-pb); final score = min over allowed end cells.
    """
    a, b = _codes(pattern), _codes(text)
    m, n = len(a), len(b)
    js = np.arange(n + 1, dtype=np.int64)
    prev = np.maximum(0, js - tb)
    best_last_col = np.int64(1 << 60)
    if pe >= m:
        best_last_col = prev[n]
    for i in range(1, m + 1):
        sub = (b != a[i - 1]).astype(np.int64)
        v = np.empty(n + 1, dtype=np.int64)
        v[0] = max(0, i - pb)
        np.minimum(prev[1:] + 1, prev[:-1] + sub, out=v[1:])
        cur = np.minimum.accumulate(v - js) + js
        if m - i <= pe and cur[n] < best_last_col:
            best_last_col = cur[n]
        prev = cur
    lo = max(0, n - te)
    best_last_row = int(prev[lo:].min())
    return int(min(best_last_row, best_last_col))


# ---------------------------------------------------------------------------
# Gap-affine alignment with WFA-compatible per-column cigar
# ---------------------------------------------------------------------------

MISMATCH, GAP_OPEN, GAP_EXT = 4, 6, 2


def band_validity_cap(m: int, n: int, pb: int, pe: int, tb: int, te: int,
                      k: int) -> int:
    """Minimum possible score of any ends-free gap-affine path that touches
    a cell OUTSIDE the banded DP's diagonal window j - i in [-(k+1), k].

    A banded score strictly below this cap is provably the global optimum —
    and every globally optimal path then lies entirely inside the band, so
    the banded traceback is *band-independent*: any wider band (or the full
    matrix) walks the identical cigar. This makes ladder stopping points and
    the device kernel's fixed buckets interchangeable without output drift.

    Derivation: only I/D moves change the diagonal d = j - i; matches and
    mismatches keep it. A path starts at d in [-pb, tb] (free begins are
    start-cell choices, not moves) and ends at d in [n-m-te, n-m+pe] (free
    ends likewise). Touching d >= k+1 therefore needs total insertions
    >= (k+1) - tb and, to re-enter an allowed end diagonal, total deletions
    >= (k+1) - (n-m+pe) when that is positive (a path may END above the
    band when the free-end range reaches past it, needing no return gap).
    I-runs and D-runs are distinct gap runs, each paying GAP_OPEN, and every
    gap char pays GAP_EXT. Symmetrically for exits below (d <= -(k+2)).
    The cap is the cheaper escape. When a free start diagonal itself lies
    outside the band the cap is 0 (nothing is provable).

    This is tight in the reach directions and strictly dominates the old
    conservative bound GAP_OPEN + GAP_EXT*(k+1-reach): the exact regime
    where e.g. a 100 bp net deletion (score 206) is provable at k=127
    (cap 328) instead of forcing a k=256 escalation.
    """
    a_up = (k + 1) - tb
    a_dn = (k + 2) - pb
    if a_up <= 0 or a_dn <= 0:
        return 0
    b_up = max(0, (k + 1) - (n - m + pe))
    c_up = GAP_OPEN * (2 if b_up > 0 else 1) + GAP_EXT * (a_up + b_up)
    b_dn = max(0, (n - m - te) + (k + 2))
    c_dn = GAP_OPEN * (2 if b_dn > 0 else 1) + GAP_EXT * (a_dn + b_dn)
    return min(c_up, c_dn)


def _affine_matrices(a: np.ndarray, b: np.ndarray,
                     pb: int = 0, tb: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full H/E/F DP matrices (int64), rows fully vectorized.

    E = gap consuming text (I ops), F = gap consuming pattern (D ops). Free
    begin-gaps enter via boundaries. The in-row E dependency is resolved
    with a prefix-min scan using the no-chaining property: an optimal
    horizontal gap never passes *through* another horizontal gap (closing
    and reopening costs an extra GAP_OPEN), so
        E[i][j] = min_{j'<j} (B[i][j'] + GAP_OPEN + GAP_EXT*(j-j'))
    where B = min(diag, F, boundary) excludes E itself.
    """
    m, n = len(a), len(b)
    # rows 1..m fully written in the loop; only boundaries need real init
    H = np.empty((m + 1, n + 1), dtype=np.int64)
    E = np.empty((m + 1, n + 1), dtype=np.int64)
    F = np.empty((m + 1, n + 1), dtype=np.int64)
    E[0, :] = _BIG
    F[0, :] = _BIG
    H[0, 0] = 0
    js_all = np.arange(n + 1, dtype=np.int64)
    js = js_all[1:]
    # leading text gap: free up to tb, affine-penalized beyond
    H[0, 1:] = np.where(js <= tb, 0, GAP_OPEN + GAP_EXT * (js - tb))
    is_ = np.arange(1, m + 1)
    H[1:, 0] = np.where(is_ <= pb, 0, GAP_OPEN + GAP_EXT * (is_ - pb))
    ej = GAP_EXT * js_all
    for i in range(1, m + 1):
        sub = np.where(b == a[i - 1], 0, MISMATCH).astype(np.int64)
        F_row = np.minimum(H[i - 1, :] + GAP_OPEN + GAP_EXT,
                           F[i - 1, :] + GAP_EXT)
        diag = H[i - 1, :-1] + sub
        B = np.empty(n + 1, dtype=np.int64)
        B[0] = H[i, 0]
        np.minimum(diag, F_row[1:], out=B[1:])
        # E[i][j] = min_{j'<j}(B[j'] - e*j') + e*j + open
        scan = np.minimum.accumulate(B - ej)
        E_row = np.empty(n + 1, dtype=np.int64)
        E_row[0] = _BIG
        E_row[1:] = scan[:-1] + ej[1:] + GAP_OPEN
        H_row = np.minimum(B, E_row)
        H_row[0] = B[0]
        H[i, :] = H_row
        E[i, :] = E_row
        F[i, :] = F_row
    return H, E, F


def _affine_end_cell(H: np.ndarray, m: int, n: int,
                     pe: int, te: int) -> Tuple[int, int, int]:
    """Best allowed end cell (score, i, j). Prefers the longest alignment
    (max j then max i) on ties, matching WFA's furthest-reaching behavior."""
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


def _affine_matrices_banded(a: np.ndarray, b: np.ndarray, k: int,
                            pb: int = 0, tb: int = 0):
    """Banded H/E/F in band coordinates w = j - i + (k+1), W = 2k+2 wide.

    Same recurrences as _affine_matrices restricted to diagonals |j-i| <= k;
    cells outside the band are _BIG. Returns (H, E, F) of shape (m+1, W).
    """
    m, n = len(a), len(b)
    W = 2 * (k + 1)
    # rows 1..m fully written in the loop; only row 0 needs real init
    H = np.empty((m + 1, W), dtype=np.int64)
    E = np.empty((m + 1, W), dtype=np.int64)
    F = np.empty((m + 1, W), dtype=np.int64)
    E[0, :] = _BIG
    F[0, :] = _BIG
    w_idx = np.arange(W, dtype=np.int64)
    ew = GAP_EXT * w_idx
    j0 = w_idx - (k + 1)
    H[0] = np.where(
        (j0 >= 0) & (j0 <= n),
        np.where(j0 <= tb, 0, GAP_OPEN + GAP_EXT * (j0 - tb)), _BIG)
    bx = np.concatenate([b.astype(np.int64), np.full(W + 2, -1, dtype=np.int64)])
    for i in range(1, m + 1):
        j = i + j0  # per-lane text column
        valid = (j >= 1) & (j <= n)
        # text chars b[j-1] for this row's band: contiguous slice
        lo = i - (k + 1) - 1  # j-1 at w=0
        if lo >= 0:
            b_win = bx[lo : lo + W]
        else:
            b_win = np.concatenate(
                [np.full(-lo, -1, dtype=np.int64), bx[: W + lo]])
        sub = np.where(b_win == a[i - 1], 0, MISMATCH)
        # F from (i-1, j) = prev row band coord w+1
        Hup = np.concatenate([H[i - 1, 1:], [_BIG]])
        Fup = np.concatenate([F[i - 1, 1:], [_BIG]])
        F_row = np.minimum(Hup + GAP_OPEN + GAP_EXT, Fup + GAP_EXT)
        diag = H[i - 1] + sub
        B = np.minimum(diag, F_row)
        # boundary j == 0 (band coord w = k+1-i)
        hb = 0 if i <= pb else GAP_OPEN + GAP_EXT * (i - pb)
        B = np.where(j == 0, hb, B)
        B = np.where((j < 0) | (j > n), _BIG, B)
        # E scan within the row (w and j differ by a constant)
        scan = np.minimum.accumulate(B - ew)
        E_row = np.empty(W, dtype=np.int64)
        E_row[0] = _BIG
        E_row[1:] = scan[:-1] + ew[1:] + GAP_OPEN
        E_row = np.where(valid, E_row, _BIG)
        E_row = np.minimum(E_row, _BIG)
        H_row = np.minimum(B, E_row)
        H_row = np.where(j == 0, hb, H_row)
        H_row = np.where((j < 0) | (j > n), _BIG, H_row)
        H[i] = H_row
        E[i] = E_row
        F[i] = np.where(valid | (j == 0), F_row, _BIG)
    return H, E, F


class _BandView:
    """Adapter exposing banded arrays with full-matrix [i, j] indexing so
    the traceback code is shared between full and banded modes."""

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


def affine_align_ends_free_cigar(pattern: str, text: str,
                                 pb: int = 0, pe: int = 0,
                                 tb: int = 0, te: int = 0,
                                 k_start: int = 32) -> str:
    """Per-column cigar (M/X/I/D chars) of the gap-affine alignment.

    I consumes text, D consumes pattern (WFA convention as consumed by
    PPOA::insert_alignment, anppoa.hpp:112-241). Free end gaps appear in the
    cigar as ordinary I/D runs (WFA includes them in the alignment path).
    Traceback prefers I/D over diagonal steps on ties, which reproduces
    WFA's right-aligned edit placement.
    """
    a, b = _codes(pattern), _codes(text)
    m, n = len(a), len(b)
    # adaptive banding: any path leaving the +-k diagonal band costs at
    # least band_validity_cap(...), so a banded score below the cap is
    # exact (and band-independent — see the cap's docstring). Otherwise
    # double k; fall back to the full matrices when the band stops being
    # smaller.
    reach = max(abs(n - m), pb, pe, tb, te)
    # k_start lets batched callers hand over the band at which their ladder
    # already failed, skipping the re-climb
    k = max(32, k_start)
    while k < reach + 16:
        k *= 2
    while True:
        full = 2 * (k + 1) >= n + 2
        if full:
            H, E, F = _affine_matrices(a, b, pb=pb, tb=tb)
            score, ei, ej = _affine_end_cell(H, m, n, pe, te)
            break
        Hb, Eb, Fb = _affine_matrices_banded(a, b, k, pb=pb, tb=tb)
        H = _BandView(Hb, k)
        E = _BandView(Eb, k)
        F = _BandView(Fb, k)
        score, ei, ej = _affine_end_cell(H, m, n, pe, te)
        if score < band_validity_cap(m, n, pb, pe, tb, te, k):
            break
        k *= 2
    ops = []
    # trailing free gaps included in the cigar
    ops.extend("I" * (n - ej))
    ops.extend("D" * (m - ei))
    i, j = ei, ej
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            h = H[i, j]
            if i == 0:
                # leading text gap (possibly free)
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
                i -= 1  # stay in gap (prefer extension)
            else:
                i -= 1
                state = "H"
        else:  # E
            ops.append("I")
            if E[i, j] == E[i, j - 1] + GAP_EXT and j > 1:
                j -= 1
            else:
                j -= 1
                state = "H"
    return "".join(reversed(ops))


def affine_align_cigar(pattern: str, text: str) -> str:
    """End-to-end gap-affine cigar (WFAlignerGapAffine alignEnd2End)."""
    return affine_align_ends_free_cigar(pattern, text, 0, 0, 0, 0)


def edit_align_cigar_len(pattern: str, text: str,
                         dist_hint: int | None = None) -> Tuple[int, int]:
    """(edit distance, alignment column count) for WFAlignerEdit(Alignment)
    as consumed by compare (src/compare.cpp:60-61: getAlignmentScore and
    getAlignmentCigar().size()).

    Among edit-optimal alignments WFA's greedy diagonal extension maximizes
    match/mismatch columns, so we break ties by maximizing diagonal steps
    (equivalently minimizing indel steps) with a composite lexicographic DP.

    ``dist_hint``: a known-exact edit distance (e.g. from the pooled device
    engine) seeds the band ladder at its final rung, so the composite DP
    runs ONCE instead of doubling up. The exactness check (edit <= k) is
    unchanged, so a wrong hint only costs an extra rung, never correctness:
    the banded DP's result at a sufficient band is band-independent.
    """
    a, b = _codes(pattern), _codes(text)
    m, n = len(a), len(b)
    K = np.int64(1 << 22)  # > m + n for any realistic allele
    step = K + 1
    # banded with doubling (exact when the edit part of the composite <= k)
    composite = None
    k = max(63, abs(m - n) + 1)
    if dist_hint is not None:
        k = max(k, int(dist_hint))
    while True:
        W = 2 * (k + 1)
        if W >= n + 2:
            break  # full-width fallback below
        w_idx = np.arange(W, dtype=np.int64)
        j0 = w_idx - (k + 1)
        prev = np.where((j0 >= 0) & (j0 <= n), j0 * step, 1 << 56)
        bpad = np.concatenate(
            [np.full(k + 2, -1, dtype=np.int64), b.astype(np.int64),
             np.full(W + 2, -1, dtype=np.int64)])
        for i in range(1, m + 1):
            # b[j-1] for j = i + j0: bpad index (j-1) + (k+2) = i + w_idx
            j = i + j0
            b_win = bpad[i : i + W]
            sub = np.where(b_win == a[i - 1], 0, K)
            up = np.concatenate([prev[1:], [1 << 56]]) + step
            v = np.minimum(up, prev + sub)
            v = np.where(j == 0, i * step, v)
            v = np.where((j < 0) | (j > n), 1 << 56, v)
            prev = np.minimum.accumulate(v - w_idx * step) + w_idx * step
        wf = n - m + (k + 1)
        cand = int(prev[wf]) if 0 <= wf < W else (1 << 56)
        if cand // K <= k:
            composite = cand
            break
        k = 2 * k + 1
    if composite is None:
        js = np.arange(n + 1, dtype=np.int64)
        prev = js * step
        for i in range(1, m + 1):
            sub = np.where(b == a[i - 1], 0, K).astype(np.int64)
            v = np.empty(n + 1, dtype=np.int64)
            v[0] = i * step
            np.minimum(prev[1:] + step, prev[:-1] + sub, out=v[1:])
            prev = np.minimum.accumulate(v - js * step) + js * step
        composite = int(prev[n])
    edit = composite // K
    # careful: composite = edit*K + indels, and indels < K
    indels = composite - edit * K
    # adjust if indels accounting spilled (each indel adds K+1: 1 edit + 1 indel)
    # composite = (X + I + D)*K + (I + D); solve: indels = composite % K only
    # valid because I + D <= m + n < K
    cols = (m + n + indels) // 2
    return edit, cols
