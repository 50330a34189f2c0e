"""Kernels K5 and K6: banded gap-affine ends-free DP with the traceback
walked on the device, for the consensus member alignments.

Counterpart of ``otter_tpu/kernels/affine_pallas.py``: ``affine_tb_pallas``
(K5, every traceback code kept) and ``affine_tb_ckpt_pallas`` (K6, H/F
checkpoints every 256 rows, codes recomputed block by block during the
walk); on the card both run one warp per member (see
``csrc/affine_tb.cu``) for k in ``BANDS``. Both take the arrays
``pack_affine_jobs`` builds (the JAX package's layout: int8 codes, ``mn``
(B, 8) with the band-validity cap) and return ``(ops, end)``: (B, t_words)
int32 walk codes, 16 per word, and (B, 4) int32 (score, end i, end j,
walked); K6's results are K5's. Both also write every member's cigar as
finished bytes into ``cig``, a (B, stride) uint8 buffer (the layout of
``csrc/affine_tb.cu``'s ``struct Cigar``: an int32 offset, then the op
string, M / X resolved, with the free ends' tails); where the caller
passes none, the wrapper allocates one. ``affine_cigars_tb`` is
the host side: band buckets, escalation, and one slice of those bytes a
member; members it cannot prove optimal come back as failed, for the
native ladder.

``affine_tb_cuda`` / ``affine_tb_ckpt_cuda`` launch the hand-written
kernels, ``affine_tb_torch`` is the plain PyTorch version of both (same
DP, same walk decisions, every member walking at once), and ``affine_tb``
/ ``affine_tb_ckpt`` pick one by device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops.align_np import (GAP_EXT, GAP_OPEN, MISMATCH, _codes,
                            band_validity_cap)
from ..utils.metrics import add, to_host
from .myers_pallas import data_ptr

K_DEV, K_WIDE, K_ONT, K_XWIDE = 63, 127, 255, 511
BANDS = (K_DEV, K_WIDE, K_ONT, K_XWIDE)   # the kernels' template instances
LP_MAX = 16384           # pattern rows handled on the device
LT_MAX = 16384           # text length handled on the device
SCRATCH_BYTES = 1 << 31  # device scratch one launch may hold
CKPT_CELLS = 1 << 20     # rows * W from which a bucket takes K6
CKPT_BLOCK = 256         # K6's checkpoint interval, in rows
_INF = 1 << 28
OP_DIAG, OP_INS, OP_DEL = 1, 2, 3
_OP_LUT = np.frombuffer(b"?MID", dtype=np.uint8)  # code -> op char


def pack_affine_jobs(jobs: List[Tuple[str, str, int, int, int, int]],
                     max_rows: int, k: int):
    """jobs (pattern, text, pb, pe, tb, te) -> (a, bpad, mn): int8 codes
    (pads -2 / -1), the text shifted right by k + 1, and (m, n, pb, tb, pe,
    te, cap, 0) per member."""
    B = len(jobs)
    W = 2 * (k + 1)
    ntxt_max = max(len(j[1]) for j in jobs)
    a = np.full((B, max_rows), -2, dtype=np.int8)
    bpad = np.full((B, max(max_rows, ntxt_max) + W + 2), -1, dtype=np.int8)
    mn = np.zeros((B, 8), dtype=np.int32)
    for i, (p, t, pb, pe, tb, te) in enumerate(jobs):
        pc = _codes(p).astype(np.int8)
        tc = _codes(t).astype(np.int8)
        a[i, : len(pc)] = pc
        bpad[i, k + 1 : k + 1 + len(tc)] = tc
        cap = band_validity_cap(len(pc), len(tc), pb, pe, tb, te, k)
        mn[i] = (len(pc), len(tc), pb, tb, pe, te, cap, 0)
    return a, bpad, mn


def _check(a, bpad, mn, k: int, t_words: int, cig=None) -> torch.Tensor:
    """Raises on bad inputs; returns ``cig``, or where it is None a new
    buffer whose rows fit any member the arrays hold (4 + La + Lb bytes,
    rounded up to a multiple of 4)."""
    B, La = a.shape
    if a.dtype != torch.int8 or bpad.dtype != torch.int8 \
            or mn.dtype != torch.int32:
        raise ValueError("a and bpad must be int8, mn int32")
    if bpad.shape[0] != B or bpad.shape[1] < La + 2 * (k + 1) + 2 \
            or mn.shape != (B, 8):
        raise ValueError("bpad must be (B, >= La + 2 (k + 1) + 2), mn (B, 8)")
    if not (a.device == bpad.device == mn.device):
        raise ValueError("all inputs must be on one device")
    if t_words <= 0:
        raise ValueError("t_words must be positive")
    if cig is None:
        stride = -(-(4 + La + bpad.shape[1]) // 4) * 4
        return torch.empty((B, stride), dtype=torch.uint8, device=a.device)
    if cig.dtype != torch.uint8 or cig.dim() != 2 or cig.shape[0] != B \
            or cig.shape[1] < 4 or cig.shape[1] % 4 \
            or not cig.is_contiguous() or cig.device != a.device:
        raise ValueError("cig must be a contiguous uint8 (B, stride) tensor "
                         "on the inputs' device, stride a multiple of 4")
    return cig


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit patterns -> the int32 with those bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def affine_tb_torch(a: torch.Tensor, bpad: torch.Tensor, mn: torch.Tensor,
                    k: int, t_words: int, cig=None):
    """Plain PyTorch K5, vectorised over members: the DP row by row (E as a
    cummin along the row), then every member's walk one step at a time.
    Returns (ops (B, t_words) int32, end (B, 4) int32) and fills ``cig``
    with the cigar bytes (``_write_cigars``)."""
    cig = _check(a, bpad, mn, k, t_words, cig)
    dev = a.device
    B, La = a.shape
    W = 2 * (k + 1)
    k1 = k + 1
    i64 = dict(device=dev, dtype=torch.int64)
    cols = mn.to(torch.int64)
    m = cols[:, 0].clamp(max=La)
    n, pb, tb, pe, te, cap = (cols[:, c] for c in range(1, 7))
    w_idx = torch.arange(W, **i64).unsqueeze(0)
    ew = GAP_EXT * w_idx
    j0 = w_idx - k1
    n2, m2 = n.unsqueeze(1), m.unsqueeze(1)
    H = torch.where((j0 >= 0) & (j0 <= n2),
                    torch.where(j0 <= tb.unsqueeze(1), 0,
                                GAP_OPEN + GAP_EXT * (j0 - tb.unsqueeze(1))),
                    _INF)
    F = torch.full((B, W), _INF, **i64)
    inf_col = torch.full((B, 1), _INF, **i64)
    rows = int(m.max()) if B else 0
    bits = torch.zeros((B, max(rows, 1), W), device=dev, dtype=torch.uint8)
    colv = torch.full((B,), _INF, **i64)
    coli = torch.zeros(B, **i64)
    a64 = a.to(torch.int64)
    b64 = bpad.to(torch.int64)
    for i in range(1, rows + 1):
        j = i + j0
        sub = torch.where(b64[:, i - 1 : i - 1 + W] == a64[:, i - 1 : i], 0,
                          MISMATCH)
        Hup = torch.cat([H[:, 1:], inf_col], dim=1)
        Fup = torch.cat([F[:, 1:], inf_col], dim=1)
        F_row = torch.minimum(Hup + (GAP_OPEN + GAP_EXT), Fup + GAP_EXT)
        Bv = torch.minimum(H + sub, F_row)
        hb = torch.where(i <= pb, 0, GAP_OPEN + GAP_EXT * (i - pb)
                         ).unsqueeze(1)
        Bv = torch.where(j == 0, hb, Bv)
        invalid = (j < 0) | (j > n2)
        Bv = torch.where(invalid, _INF, Bv)
        scan = torch.cummin(Bv - ew, dim=1).values
        E_row = torch.cat([inf_col, scan[:, :-1]], dim=1) + ew + GAP_OPEN
        E_row = torch.where(invalid | (w_idx == 0), _INF, E_row)
        H_row = torch.minimum(Bv, E_row)
        H_row = torch.where(j == 0, hb, H_row)
        H_row = torch.where(invalid, _INF, H_row)
        F_rowm = torch.where(invalid, _INF, F_row)
        E_left = torch.cat([inf_col, E_row[:, :-1]], dim=1)
        row_bits = ((H_row == F_rowm).to(torch.uint8)
                    | ((H_row == E_row).to(torch.uint8) << 1)
                    | ((F_rowm == Fup + GAP_EXT).to(torch.uint8) << 2)
                    | ((E_row == E_left + GAP_EXT).to(torch.uint8) << 3))
        keep = (i <= m).unsqueeze(1)
        bits[:, i - 1] = torch.where(keep, row_bits, 0)
        H = torch.where(keep, H_row, H)
        F = torch.where(keep, F_rowm, F)
        wcol = n - i + k1
        hv = H_row.gather(1, wcol.clamp(0, W - 1).unsqueeze(1)).squeeze(1)
        active = (i <= m) & (m - i <= pe) & (wcol >= 0) & (wcol < W)
        better = active & (hv <= colv)
        colv = torch.where(better, hv, colv)
        coli = torch.where(better, i, coli)

    # end cell: (m, n), then the last row's window (larger j on ties), then
    # the last column on strict improvement
    wmn = n - m + k1
    best_s = torch.where((wmn >= 0) & (wmn < W),
                         H.gather(1, wmn.clamp(0, W - 1).unsqueeze(1)
                                  ).squeeze(1), _INF)
    best_i, best_j = m.clone(), n.clone()
    jw = w_idx - k1 + m2
    validw = (jw >= (n2 - te.unsqueeze(1)).clamp(min=0)) & (jw <= n2 - 1)
    Hm = torch.where(validw, H, _INF)
    smin = Hm.min(dim=1).values
    jbest = torch.where(validw & (Hm == smin.unsqueeze(1)), jw, -1
                        ).max(dim=1).values
    up1 = smin < best_s
    best_s = torch.where(up1, smin, best_s)
    best_j = torch.where(up1, jbest, best_j)
    up2 = (pe > 0) & (colv < best_s)
    best_s = torch.where(up2, colv, best_s)
    best_i = torch.where(up2, coli, best_i)
    best_j = torch.where(up2, n, best_j)
    walk = best_s < cap
    ci = torch.where(walk, best_i, 0)
    cj = torch.where(walk, best_j, 0)

    ops = torch.zeros((B, t_words), **i64)
    st = torch.zeros(B, **i64)        # 0 = H, 1 = F, 2 = E
    n_ops = torch.zeros(B, **i64)
    rows_b = torch.arange(B, device=dev)
    for _t in range(16 * t_words):
        act = (ci != 0) | (cj != 0)
        if not bool(act.any()):
            break
        wc = cj - ci + k1
        readable = act & (ci >= 1) & (wc >= 0) & (wc < W)
        byte = torch.where(
            readable,
            bits[rows_b, (ci - 1).clamp(0, bits.shape[1] - 1),
                 wc.clamp(0, W - 1)].to(torch.int64), 0)
        at_h = act & (st == 0)
        at_f = act & (st == 1)
        at_e = act & (st == 2)
        h_i0 = at_h & (ci == 0)
        h_j0 = at_h & (ci > 0) & (cj == 0)
        h_in = at_h & (ci > 0) & (cj > 0)
        go_f = h_in & ((byte & 1) != 0)
        go_e = h_in & ((byte & 1) == 0) & ((byte & 2) != 0)
        h_diag = h_in & ((byte & 3) == 0)
        op = torch.where(h_i0 | at_e, OP_INS,
                         torch.where(h_j0 | at_f, OP_DEL,
                                     torch.where(h_diag, OP_DIAG, 0)))
        di = (h_j0 | h_diag | at_f).to(torch.int64)
        dj = (h_i0 | h_diag | at_e).to(torch.int64)
        f_cont = at_f & ((byte & 4) != 0) & (ci > 1)
        e_cont = at_e & ((byte & 8) != 0) & (cj > 1)
        st = torch.where(go_f, 1, torch.where(
            go_e, 2, torch.where((at_f & ~f_cont) | (at_e & ~e_cont), 0, st)))
        ci = ci - di
        cj = cj - dj
        emit = op != 0
        ops.scatter_add_(1, (n_ops >> 4).clamp(max=t_words - 1).unsqueeze(1),
                         torch.where(emit, op << (2 * (n_ops & 15)), 0
                                     ).unsqueeze(1))
        n_ops = n_ops + emit.to(torch.int64)
    done = walk & (ci == 0) & (cj == 0)
    ei = torch.where(walk, best_i, 0)
    ej = torch.where(walk, best_j, 0)
    end = torch.stack([best_s, ei, ej, done.to(torch.int64)], dim=1)
    _write_cigars(cig, ops, n_ops, a64, b64, ei, ej, m, n, k1)
    return _to_int32(ops), end.to(torch.int32)


def _write_cigars(cig, ops, n_ops, a64, b64, ei, ej, m, n, k1) -> None:
    """The cigar bytes the kernels write (``csrc/affine_tb.cu``, ``struct
    Cigar``), from the walk codes: int32 offset of the cigar's first byte
    at [0, 4), op r of the walk (walk order) at byte top - 1 - r with top =
    4 + ei + ej, M or X as the chars at the cell the op leaves, (ei, ej)
    less the ops before it, are equal or not; then D * (m - ei) and
    I * (n - ej) up to 4 + m + n. A row too short gets offset 0."""
    B, C = cig.shape
    dev = cig.device
    i32 = dict(device=dev, dtype=torch.int32)
    T = int(n_ops.max()) if B else 0
    r = torch.arange(T, device=dev)
    codes = ((ops[:, r >> 4] >> (2 * (r & 15))) & 3).to(torch.int32)
    diag = codes == OP_DIAG
    di = (diag | (codes == OP_DEL)).to(torch.int32)
    dj = (diag | (codes == OP_INS)).to(torch.int32)
    ci = ei.to(torch.int32).unsqueeze(1) - (di.cumsum(1, dtype=torch.int32)
                                            - di)
    cj = ej.to(torch.int32).unsqueeze(1) - (dj.cumsum(1, dtype=torch.int32)
                                            - dj)
    pa = a64.gather(1, (ci - 1).clamp(0, a64.shape[1] - 1).long())
    pt = b64.gather(1, (cj - 1 + k1).clamp(0, b64.shape[1] - 1).long())
    chars = torch.tensor(_OP_LUT, **i32)[codes.long()]
    chars = torch.where(diag & (pa != pt), ord("X"), chars)
    top = (4 + ei + ej).to(torch.int32)
    fits = (4 + m + n <= C).unsqueeze(1)
    pos = torch.where((r < n_ops.unsqueeze(1)) & fits,
                      top.unsqueeze(1) - 1 - r, C)
    out = torch.zeros((B, C + 1), device=dev, dtype=torch.uint8)
    out.scatter_(1, pos.long(), chars.to(torch.uint8))
    out = out[:, :C]
    col = torch.arange(C, device=dev).unsqueeze(0)
    mid = (top + m - ei).unsqueeze(1)
    out[fits & (col >= top.unsqueeze(1)) & (col < mid)] = ord("D")
    out[fits & (col >= mid) & (col < (4 + m + n).unsqueeze(1))] = ord("I")
    first = torch.where(fits.squeeze(1), top - n_ops.to(torch.int32), 0)
    out[:, :4] = first.contiguous().view(torch.uint8).view(B, 4)
    cig.copy_(out)


def scratch_bytes_per_member(max_rows: int, k: int, ckpt: bool) -> int:
    """Device scratch one member takes in a launch: K5 keeps every row's
    traceback codes (4 bits per cell, W / 2 bytes a row), K6 the H and F
    rows (2 W int32) of every 256th row; K6's block of codes lives in shared
    memory."""
    W = 2 * (k + 1)
    if ckpt:
        return max(1, -(-max_rows // CKPT_BLOCK)) * 2 * W * 4
    return max_rows * W // 2


def _check_band(k: int) -> None:
    if k not in BANDS:
        raise ValueError(f"k must be one of {BANDS}: the kernels have no "
                         f"instance for k = {k}")


def affine_tb_cuda(a: torch.Tensor, bpad: torch.Tensor, mn: torch.Tensor,
                   k: int, t_words: int, cig=None):
    """K5 on the card (``csrc/affine_tb.cu``): one launch on the current
    stream, no synchronisation, one warp per member, the traceback codes
    in device memory, the cigar bytes into ``cig``. Raises on bad inputs or
    a refused launch."""
    from . import _build

    cig = _check(a, bpad, mn, k, t_words, cig)
    _check_band(k)
    if not a.is_cuda:
        raise ValueError("affine_tb_cuda takes CUDA tensors")
    B, La = a.shape
    ops = torch.empty((B, t_words), dtype=torch.int32, device=a.device)
    end = torch.empty((B, 4), dtype=torch.int32, device=a.device)
    if B == 0:
        return ops, end
    bits = torch.empty(B * scratch_bytes_per_member(La, k, False),
                       dtype=torch.uint8, device=a.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.otter_affine_tb(data_ptr(a), La, data_ptr(bpad),
                                  bpad.shape[1], data_ptr(mn), k, t_words,
                                  data_ptr(ops), data_ptr(end), B,
                                  data_ptr(bits), data_ptr(cig),
                                  cig.shape[1], stream)
    _build.check(lib, err, "affine_tb_cuda")
    affine_tb_cuda.launches += 1
    return ops, end


affine_tb_cuda.launches = 0


def affine_tb_ckpt_cuda(a: torch.Tensor, bpad: torch.Tensor,
                        mn: torch.Tensor, k: int, t_words: int, cig=None):
    """K6 on the card (``csrc/affine_tb.cu``): one launch on the current
    stream, no synchronisation, K5's results from H/F checkpoints every 256
    rows (the walk recomputes a block of codes at a time in shared
    memory), and K5's cigar bytes into ``cig``. Raises on bad inputs or a
    refused launch."""
    from . import _build

    cig = _check(a, bpad, mn, k, t_words, cig)
    _check_band(k)
    if not a.is_cuda:
        raise ValueError("affine_tb_ckpt_cuda takes CUDA tensors")
    B, La = a.shape
    ops = torch.empty((B, t_words), dtype=torch.int32, device=a.device)
    end = torch.empty((B, 4), dtype=torch.int32, device=a.device)
    if B == 0:
        return ops, end
    ckpt = torch.empty(B * scratch_bytes_per_member(La, k, True) // 4,
                       dtype=torch.int32, device=a.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.otter_affine_tb_ckpt(
            data_ptr(a), La, data_ptr(bpad), bpad.shape[1], data_ptr(mn), k,
            t_words, data_ptr(ops), data_ptr(end), B, data_ptr(ckpt),
            data_ptr(cig), cig.shape[1], stream)
    _build.check(lib, err, "affine_tb_ckpt_cuda")
    affine_tb_ckpt_cuda.launches += 1
    return ops, end


affine_tb_ckpt_cuda.launches = 0


def affine_tb_ckpt(a: torch.Tensor, bpad: torch.Tensor, mn: torch.Tensor,
                   k: int, t_words: int, cig=None):
    """K6 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version (K5's) for CPU tensors."""
    if a.is_cuda:
        return affine_tb_ckpt_cuda(a, bpad, mn, k, t_words, cig)
    if a.device.type == "cpu":
        return affine_tb_torch(a, bpad, mn, k, t_words, cig)
    raise ValueError(f"no K6 version for device {a.device}")


def affine_tb(a: torch.Tensor, bpad: torch.Tensor, mn: torch.Tensor, k: int,
              t_words: int, cig=None):
    """K5 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if a.is_cuda:
        return affine_tb_cuda(a, bpad, mn, k, t_words, cig)
    if a.device.type == "cpu":
        return affine_tb_torch(a, bpad, mn, k, t_words, cig)
    raise ValueError(f"no K5 version for device {a.device}")


# ---------------------------------------------------------------------------
# Host side: band buckets, escalation, cigars
# ---------------------------------------------------------------------------

def _decode_walk_ops(codes: np.ndarray, p: str, t: str,
                     ei: int, ej: int, m: int, n: int) -> str:
    """Walk codes (reverse order) -> per-base op string with M/X resolved
    against the sequences, plus the free-end tails: the host's decode, which
    the kernels' cigar bytes are held to."""
    fwd = codes[::-1]
    chars = _OP_LUT[fwd]
    di = (fwd != OP_INS).astype(np.int64)
    dj = (fwd != OP_DEL).astype(np.int64)
    i_idx = np.cumsum(di) - di
    j_idx = np.cumsum(dj) - dj
    isd = fwd == OP_DIAG
    if isd.any():
        pa = np.frombuffer(p.encode(), dtype=np.uint8)
        ta = np.frombuffer(t.encode(), dtype=np.uint8)
        eq = pa[i_idx[isd]] == ta[j_idx[isd]]
        chars = chars.copy()
        chars[isd] = np.where(eq, ord("M"), ord("X"))
    return chars.tobytes().decode() + "D" * (m - ei) + "I" * (n - ej)


def _unpack_codes(obuf: np.ndarray, t_words: int) -> np.ndarray:
    """(B, t_words) int32 -> (B, t_words * 16) uint8 2-bit codes."""
    B = obuf.shape[0]
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    codes = (obuf.astype(np.uint32)[:, :, None] >> shifts) & 3
    return codes.reshape(B, t_words * 16).astype(np.uint8)


def cigar_stride(jobs) -> int:
    """Bytes of a cigar row wide enough for every job: the int32 offset and
    m + n op bytes at most, rounded up to a multiple of 4."""
    need = 4 + max(len(j[0]) for j in jobs) + max(len(j[1]) for j in jobs)
    return -(-need // 4) * 4


def read_cigars(rows: np.ndarray, mn: np.ndarray, which) -> List[str]:
    """The cigars of members ``which`` from a launch's cigar bytes copied to
    the host (``rows``, (B, stride) uint8; ``mn`` the packed (m, n, ...)):
    one slice of one bytes object each."""
    which = np.asarray(which, dtype=np.int64)
    base = which * rows.shape[1]
    lo = (base + rows.view("<i4")[which, 0]).tolist()
    hi = (base + 4 + mn[which, 0] + mn[which, 1]).tolist()
    buf = rows.tobytes()
    return [buf[x:y].decode() for x, y in zip(lo, hi)]


def _rows_bucket(m: int) -> int:
    for cap in (256, 1024, 2048, 4096, 8192):
        if m <= cap:
            return cap
    return 16384


def _t_words(max_rows: int, k: int) -> int:
    """Walk-step budget in packed words (16 steps each): any walked
    member takes at most max_rows + 5k + 10 steps (the proof is in
    otter_tpu/kernels/affine_pallas.py::_t_words); 1000 steps of slack."""
    need = max_rows + 5 * k + 10 + 1000
    for w in (128, 256, 384, 512, 640, 768, 1152, 1280):
        if 16 * w >= need:
            return w
    return 1280


def _admissible_bands(m: int, n: int, pb: int, pe: int, tb: int, te: int,
                      hint) -> List[int]:
    """Bands (narrowest first) worth trying for one job (m <= LP_MAX): the
    end-diagonal range meets the band, and the validity cap is
    attainable (with an exact distance hint e the score is >= 2e)."""
    out: List[int] = []
    for cand in (K_DEV, K_WIDE, K_ONT, K_XWIDE):
        if (n - m + pe) < -(cand + 1) or (n - m - te) > cand:
            continue
        cap = band_validity_cap(m, n, pb, pe, tb, te, cand)
        if cap <= 0:
            continue
        if hint is not None:
            if 2 * int(hint) >= cap:
                continue
            delta = min(int(hint), abs(n - m))
            est = 6 + 2 * delta + 5 * (int(hint) - delta)
            if m > 4096 and est >= cap:
                continue
        elif abs(n - m) + 16 > cand:
            continue
        out.append(cand)
    return out


def affine_cigars_tb(jobs: List[Tuple[str, str, int, int, int, int]],
                     device, dist_hints=None):
    """Cigars of (pattern, text, pb, pe, tb, te) jobs through K5 on
    ``device``; returns (cigars, failed indices). Jobs are bucketed by
    (band, pattern rows), one launch per bucket chunk, which writes every
    member's cigar bytes; a member whose band cannot prove optimality
    escalates to its next admissible band, and members that exhaust them
    come back failed (the caller's native ladder computes the same cigar).
    Counters: ``affine_cigar_members`` one a job, ``affine_card_cigars``
    one a member whose cigar came from a launch's bytes."""
    add("affine_cigar_members", len(jobs))
    cigars: List[str] = [""] * len(jobs)
    failed: List[int] = []
    pending: dict = {}
    for idx, (p, t, pb, pe, tb, te) in enumerate(jobs):
        m, n = len(p), len(t)
        if not (0 < m <= LP_MAX and 0 < n <= LT_MAX):
            failed.append(idx)
            continue
        hint = None
        if dist_hints is not None and dist_hints[idx] is not None:
            hint = int(dist_hints[idx])
        bands = _admissible_bands(m, n, pb, pe, tb, te, hint)
        if bands:
            pending[idx] = bands
        else:
            failed.append(idx)
    while pending:
        buckets: dict = {}
        for idx, bands in pending.items():
            k = bands.pop(0)
            buckets.setdefault((k, _rows_bucket(len(jobs[idx][0]))),
                               []).append(idx)
        retry: dict = {}
        for (k, max_rows), idxs in sorted(buckets.items()):
            t_words = _t_words(max_rows, k)
            W = 2 * (k + 1)
            # K6 once a member's rows * W reach CKPT_CELLS
            use_ckpt = max_rows * W >= CKPT_CELLS
            run = affine_tb_ckpt if use_ckpt else affine_tb
            stride = cigar_stride([jobs[i] for i in idxs])
            chunk = max(1, SCRATCH_BYTES // (scratch_bytes_per_member(
                max_rows, k, use_ckpt) + stride))
            for c0 in range(0, len(idxs), chunk):
                sub_idx = idxs[c0 : c0 + chunk]
                a, bpad, mn = pack_affine_jobs([jobs[i] for i in sub_idx],
                                               max_rows, k)
                cig = torch.empty((len(sub_idx), stride), dtype=torch.uint8,
                                  device=device)
                _ops, end = run(
                    *(torch.from_numpy(x).to(device) for x in (a, bpad, mn)),
                    k, t_words, cig)
                rows = to_host(cig)
                end = to_host(end)
                # walked to (0, 0) below the band's validity cap: optimal
                keep = (end[:, 3] == 1) & (end[:, 0] < mn[:, 6])
                kept = np.flatnonzero(keep)
                for bi, cigar in zip(kept.tolist(),
                                     read_cigars(rows, mn, kept)):
                    cigars[sub_idx[bi]] = cigar
                add("affine_card_cigars", len(kept))
                for bi in np.flatnonzero(~keep).tolist():
                    idx = sub_idx[bi]
                    if pending[idx]:
                        retry[idx] = pending[idx]
                    else:
                        failed.append(idx)
        pending = retry
    return cigars, failed
