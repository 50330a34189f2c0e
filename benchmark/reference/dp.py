"""Exact dynamic programs of the reference, batched in plain PyTorch.

``edit_distances``: unit-cost Levenshtein distance of many pairs, the
rows of a band of diagonals advanced for a whole batch at once, the
in-row dependency resolved by a prefix-min scan. A band of k diagonals
either side of [0, n - m] proves its score when the score is below
(n - m) + 2 (k + 1): any path that leaves the band pays that much. A pair
whose score does not prove out runs again at twice the band, up to the
full matrix.

``affine_cigars``: the per-column cigar (M/X/I/D) of the gap-affine
alignment (mismatch 4, gap 6 + 2 L) with free end gaps, the banded DP,
band ladder and traceback of ``otter_tpu_torch/ops/align_batch.py`` and
``ops/align_np.py`` at commit eda140f (the semantics of WFA2's
``WFAlignerGapAffine`` as otter uses it), rewritten from numpy to torch
tensors for the DP; the end cell and the traceback are the originals.

``edit_distances_ends_free``: the recurrence of
``ops/align_np.py::edit_distance_ends_free`` (WFA2's ``alignEndsFree``
with unit costs) for many jobs at once, a row of every job a step in
torch.

None of these reads the program's kernels, caches or results.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

BIG = 1 << 28
MISMATCH, GAP_OPEN, GAP_EXT = 4, 6, 2
# a batch's DP tensors stay under this many int32 cells
_CELL_BUDGET = 1 << 27


def _codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("latin-1"), dtype=np.uint8)


def _pad_rows(seqs: Sequence[np.ndarray], width: int, fill: int,
              lead: int = 0) -> np.ndarray:
    out = np.full((len(seqs), lead + width), fill, dtype=np.int32)
    for r, s in enumerate(seqs):
        out[r, lead : lead + len(s)] = s
    return out


# -- unit-cost edit distance --------------------------------------------------


def _banded_edit(pats: List[np.ndarray], txts: List[np.ndarray], k: int,
                 device) -> np.ndarray:
    """Band scores D[m][n] of (pattern, text) pairs with len(pattern) <=
    len(text), over the diagonals [-k, max(n - m) + k]."""
    B = len(pats)
    m = np.array([len(p) for p in pats], dtype=np.int64)
    n = np.array([len(t) for t in txts], dtype=np.int64)
    W = int((n - m).max()) + 2 * k + 1
    m_max = int(m.max())
    off = k + 1
    a = torch.as_tensor(_pad_rows(pats, m_max, 250), device=device)
    b = torch.as_tensor(_pad_rows(txts, m_max + W + 2, 251, lead=off),
                        device=device)
    w = torch.arange(W, device=device, dtype=torch.int32)
    d = (w - k)[None, :]                        # diagonal j - i of a lane
    prev = torch.where(d >= 0, d, torch.full_like(d, BIG)).expand(B, W)
    prev = prev.contiguous()
    up = torch.full((B, W), BIG, device=device, dtype=torch.int32)
    out = torch.zeros(B, device=device, dtype=torch.int32)
    rows: Dict[int, List[int]] = {}
    for p, mp in enumerate(m.tolist()):
        rows.setdefault(mp, []).append(p)
    cap = {i: (torch.as_tensor(ps, device=device),
               torch.as_tensor((n[ps] - m[ps] + k).astype(np.int64),
                               device=device))
           for i, ps in rows.items()}
    for i in range(1, m_max + 1):
        # text char j - 1 of every lane (j = i + w - k): b[:, off + j - 1]
        lo = off + i - 1 - k
        sub = b[:, lo : lo + W] != a[:, i - 1 : i]
        up[:, :-1] = prev[:, 1:]
        t = torch.minimum(prev + sub, up + 1)
        if i <= k:
            t[:, : k - i] = BIG     # j < 0
            t[:, k - i] = i         # j == 0
        prev = torch.cummin(t - w, dim=1).values + w
        got = cap.get(i)
        if got is not None:
            out[got[0]] = prev[got[0], got[1]]
    return out.cpu().numpy().astype(np.int64)


def edit_distances(pairs: Sequence[Tuple[str, str]], device,
                   k0: int = 32) -> np.ndarray:
    """Exact unit-cost edit distance of every (x, y) pair."""
    res = np.zeros(len(pairs), dtype=np.int64)
    todo = []
    for p, (x, y) in enumerate(pairs):
        if x == y:
            continue
        if len(x) > len(y):
            x, y = y, x
        if not x:
            res[p] = len(y)
            continue
        todo.append((p, _codes(x), _codes(y)))
    k_of = {p: k0 for p, _a, _b in todo}
    while todo:
        # a batch a band (k, and the width rounded up to a power of two),
        # its pairs by pattern length, cut where the rows grow too wide or
        # the patterns half as long again: a batch's rows run to its
        # longest pattern
        groups: Dict[Tuple[int, int], list] = {}
        for e in todo:
            k = k_of[e[0]]
            w = len(e[2]) - len(e[1]) + 2 * k + 1
            groups.setdefault((k, 1 << (w - 1).bit_length()), []).append(e)
        retry = []
        for (k, _wb), group in sorted(groups.items()):
            group.sort(key=lambda e: len(e[1]))
            start = 0
            while start < len(group):
                end, width = start, 0
                rows = 1.5 * len(group[start][1]) + 32
                while end < len(group):
                    w = len(group[end][2]) - len(group[end][1]) + 2 * k + 1
                    if ((end - start + 1) * max(width, w) > _CELL_BUDGET // 8
                            or len(group[end][1]) > rows):
                        break
                    width = max(width, w)
                    end += 1
                end = max(end, start + 1)
                chunk = group[start:end]
                start = end
                scores = _banded_edit([e[1] for e in chunk],
                                      [e[2] for e in chunk], k, device)
                for (p, a, b), s in zip(chunk, scores.tolist()):
                    if s < len(b) - len(a) + 2 * (k + 1) or k >= len(b):
                        res[p] = s
                    else:
                        k_of[p] = 2 * k
                        retry.append((p, a, b))
        todo = retry
    return res


def edit_distances_ends_free(jobs: Sequence[Tuple[str, str, int, int, int,
                                                   int]],
                             device) -> np.ndarray:
    """Edit distance with free leading / trailing gaps of every (pattern,
    text, pb, pe, tb, te) job: up to pb / pe pattern and tb / te text
    characters skipped for free at the begin / end. The full matrix of a
    batch of jobs advances a row at a time; each job's answer is read at
    its own last row and column."""
    res = np.zeros(len(jobs), dtype=np.int64)
    # a batch's rows run to its longest pattern: batches of patterns
    # within half as long again, cut where the rows grow too wide
    order = sorted(range(len(jobs)), key=lambda p: len(jobs[p][0]))
    start = 0
    while start < len(order):
        end, width = start, 0
        rows = 1.5 * len(jobs[order[start]][0]) + 32
        while end < len(order):
            w = len(jobs[order[end]][1]) + 1
            if ((end - start + 1) * max(width, w) > _CELL_BUDGET // 8
                    or len(jobs[order[end]][0]) > rows):
                break
            width = max(width, w)
            end += 1
        end = max(end, start + 1)
        chunk = order[start:end]
        start = end
        res[chunk] = _ends_free_batch([jobs[p] for p in chunk], device)
    return res


def _ends_free_batch(jobs, device) -> np.ndarray:
    B = len(jobs)
    pats = [_codes(j[0]) for j in jobs]
    txts = [_codes(j[1]) for j in jobs]
    m_np = np.array([len(p) for p in pats], dtype=np.int64)
    n_np = np.array([len(t) for t in txts], dtype=np.int64)
    M, N = int(m_np.max()), int(n_np.max())
    t64 = dict(device=device, dtype=torch.int32)
    a = torch.as_tensor(_pad_rows(pats, max(M, 1), 250), device=device)
    b = torch.as_tensor(_pad_rows(txts, max(N, 1), 251), device=device)
    m, n = torch.as_tensor(m_np, **t64), torch.as_tensor(n_np, **t64)
    pb, pe, tb, te = (torch.as_tensor([j[k] for j in jobs], **t64)
                      for k in (2, 3, 4, 5))
    js = torch.arange(N + 1, **t64)[None, :]
    rows = torch.arange(B, **t64)
    big = torch.full((B,), 1 << 30, **t64)
    prev = torch.clamp(js - tb[:, None], min=0)
    best_col = torch.where(pe >= m, prev[rows, n], big)
    lo = torch.clamp(n - te, min=0)
    in_row = (js >= lo[:, None]) & (js <= n[:, None])
    best_row = torch.where(m == 0, torch.where(in_row, prev, big[:, None])
                           .min(dim=1).values, big)
    v = torch.empty_like(prev)
    for i in range(1, M + 1):
        sub = (b != a[:, i - 1 : i]).to(torch.int32)
        v[:, 0] = torch.clamp(i - pb, min=0)
        torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + sub, out=v[:, 1:])
        cur = torch.cummin(v - js, dim=1).values + js
        live = i <= m
        at_n = cur[rows, n]
        take = live & (m - i <= pe) & (at_n < best_col)
        best_col = torch.where(take, at_n, best_col)
        last = m == i
        if bool(last.any()):
            best_row = torch.where(
                last, torch.where(in_row, cur, big[:, None]).min(dim=1).values,
                best_row)
        prev = cur
    return torch.minimum(best_row, best_col).cpu().numpy().astype(np.int64)


# -- gap-affine cigars ---------------------------------------------------------


def band_validity_cap(m: int, n: int, pb: int, pe: int, tb: int, te: int,
                      k: int) -> int:
    """Least score of any ends-free gap-affine path that touches a cell
    outside the diagonals [-(k + 1), k]: a banded score below it is the
    optimum, and every optimal path lies inside the band, so the banded
    traceback is the full matrix's."""
    a_up = (k + 1) - tb
    a_dn = (k + 2) - pb
    if a_up <= 0 or a_dn <= 0:
        return 0
    b_up = max(0, (k + 1) - (n - m + pe))
    c_up = GAP_OPEN * (2 if b_up > 0 else 1) + GAP_EXT * (a_up + b_up)
    b_dn = max(0, (n - m - te) + (k + 2))
    c_dn = GAP_OPEN * (2 if b_dn > 0 else 1) + GAP_EXT * (a_dn + b_dn)
    return min(c_up, c_dn)


def _affine_band(pats: List[np.ndarray], txts: List[np.ndarray], k: int,
                 pb: np.ndarray, tb: np.ndarray, device):
    """Banded H/E/F of a batch, (m_max + 1, B, W) int32 each, lane w of row
    i holding column j = i + w - (k + 1). Rows past a member's pattern are
    never read."""
    B = len(pats)
    m_max = max(len(p) for p in pats)
    W = 2 * (k + 1)
    n = torch.as_tensor([len(t) for t in txts], device=device,
                        dtype=torch.int32)[:, None]
    n_max = max(len(t) for t in txts)
    a = torch.as_tensor(_pad_rows(pats, m_max, -2), device=device)
    # text char j - 1 at column (j - 1) + (k + 2)
    b = torch.as_tensor(_pad_rows(txts, n_max + W + 2, -1, lead=k + 2),
                        device=device)
    H = torch.empty((m_max + 1, B, W), device=device, dtype=torch.int32)
    E = torch.empty_like(H)
    F = torch.empty_like(H)
    w = torch.arange(W, device=device, dtype=torch.int32)[None, :]
    ew = GAP_EXT * w
    j0 = w - (k + 1)
    tb2 = torch.as_tensor(tb, device=device, dtype=torch.int32)[:, None]
    pb2 = torch.as_tensor(pb, device=device, dtype=torch.int32)[:, None]
    big = torch.tensor(BIG, device=device, dtype=torch.int32)
    E[0] = BIG
    F[0] = BIG
    H[0] = torch.where((j0 >= 0) & (j0 <= n),
                       torch.where(j0 <= tb2, torch.zeros_like(j0),
                                   GAP_OPEN + GAP_EXT * (j0 - tb2)), big)
    # a lane is past its text (j > n) from row n - j0 + 1 on
    last = (n - j0).expand(B, W)
    Hup = torch.full((B, W), BIG, device=device, dtype=torch.int32)
    Fup = torch.full((B, W), BIG, device=device, dtype=torch.int32)
    ew_open = ew[:, 1:] + GAP_OPEN
    for i in range(1, m_max + 1):
        lo = i - (k + 1) - 1 + (k + 2)
        sub = (b[:, lo : lo + W] != a[:, i - 1 : i]).to(torch.int32)
        sub *= MISMATCH
        Hp, Fp = H[i - 1], F[i - 1]
        Hup[:, :-1] = Hp[:, 1:]
        Fup[:, :-1] = Fp[:, 1:]
        F_row = torch.minimum(Hup + (GAP_OPEN + GAP_EXT), Fup + GAP_EXT,
                              out=F[i])
        Bv = torch.minimum(Hp + sub, F_row)
        z = k + 1 - i           # the lane of column 0, while i <= k + 1
        if z >= 0:
            hb = torch.where(i <= pb2[:, 0], 0, GAP_OPEN + GAP_EXT * (i - pb2[:, 0]))
            Bv[:, :z] = BIG
            Bv[:, z] = hb
        past = last < i
        Bv.masked_fill_(past, BIG)
        scan = torch.cummin(Bv - ew, dim=1).values
        Er = E[i]
        Er[:, 0] = BIG
        torch.add(scan[:, :-1], ew_open, out=Er[:, 1:])
        Er.masked_fill_(past, BIG)
        torch.minimum(Bv, Er, out=H[i])
        if z >= 0:
            Er[:, :z] = BIG
            H[i][:, z] = hb
            F_row[:, :z] = BIG
        F_row.masked_fill_(past, BIG)
    return H, E, F


def _end_cell(Hm, kp1: int, m: int, n: int, pe: int, te: int):
    """Best allowed end cell (score, i, j), the longest alignment first on
    ties (WFA's furthest-reaching end)."""
    W = Hm.shape[1]

    def h(i, j):
        w = j - i + kp1
        return int(Hm[i, w]) if 0 <= w < W else BIG

    best = (h(m, n), m, n)
    for j in range(n - 1, max(0, n - te) - 1, -1):
        s = h(m, j)
        if s < best[0]:
            best = (s, m, j)
    for i in range(m - 1, max(0, m - pe) - 1, -1):
        s = h(i, n)
        if s < best[0]:
            best = (s, i, n)
    return best


def _traceback(Hl, El, Fl, k, a, b, m, n, ei, ej) -> str:
    """Banded traceback: I/D preferred over the diagonal on ties, which
    places edits as WFA does."""
    W = Hl.shape[1]
    kp1 = k + 1
    al = a.tolist()
    bl = b.tolist()
    ops = []
    ops.extend("I" * (n - ej))
    ops.extend("D" * (m - ei))
    i, j = ei, ej
    state = "H"
    big = BIG
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
            wf = w + 1
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


def affine_cigars(jobs: Sequence[Tuple[str, str, int, int, int, int]],
                  device) -> List[str]:
    """Cigars of (pattern, text, pb, pe, tb, te) jobs."""
    out: List[str] = [""] * len(jobs)
    groups: Dict[int, List[int]] = {}
    for idx, (p, t, pb, pe, tb, te) in enumerate(jobs):
        reach = max(abs(len(t) - len(p)), pb, pe, tb, te)
        k = 32
        while k < reach + 16:
            k *= 2
        groups.setdefault(k, []).append(idx)
    while groups:
        k = min(groups)
        members = sorted(groups.pop(k), key=lambda i: len(jobs[i][0]))
        W = 2 * (k + 1)
        start = 0
        while start < len(members):
            m_max = len(jobs[members[start]][0])
            rows = 1.5 * m_max + 32
            end = start
            while end < len(members):
                m_max = max(m_max, len(jobs[members[end]][0]))
                if ((end - start + 1) * (m_max + 1) * W > _CELL_BUDGET
                        or m_max > rows):
                    break
                end += 1
            end = max(end, start + 1)
            sub_idx = members[start:end]
            start = end
            pats = [_codes(jobs[i][0]) for i in sub_idx]
            txts = [_codes(jobs[i][1]) for i in sub_idx]
            pb = np.array([jobs[i][2] for i in sub_idx])
            tb = np.array([jobs[i][4] for i in sub_idx])
            H, E, F = (x.cpu().numpy() for x in _affine_band(
                pats, txts, k, pb, tb, device))
            for bi, idx in enumerate(sub_idx):
                p, t, pbv, pev, tbv, tev = jobs[idx]
                m, n = len(p), len(t)
                Hm = H[: m + 1, bi]
                score, ei, ej = _end_cell(Hm, k + 1, m, n, pev, tev)
                if k >= max(m, n) or score < band_validity_cap(
                        m, n, pbv, pev, tbv, tev, k):
                    out[idx] = _traceback(Hm, E[: m + 1, bi],
                                          F[: m + 1, bi], k, pats[bi],
                                          txts[bi], m, n, ei, ej)
                else:
                    groups.setdefault(2 * k, []).append(idx)
    return out
