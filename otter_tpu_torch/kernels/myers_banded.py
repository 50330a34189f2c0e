"""Kernels K3 and K4: Ukkonen-banded Myers on 64-bit pattern blocks.

Counterpart of ``otter_tpu/kernels/myers_banded.py`` (``_banded_kernel``
and ``_banded_ef_kernel``). The inputs are K1's: ``pool`` (S, W_pool) int32
rows from ``pack_pool``, and per job ``idx_pat``, ``idx_txt``, ``nlen`` and
``minit`` (B,) int32; K4 adds ``tb`` and ``te``, the free leading and
trailing text chars. ``n_words`` counts 32-bit pattern words (even).

At text column j only the 64-char pattern blocks that meet rows
[j - tb - k, j + k] are computed; the boundaries of the band only raise DP
values, so a result <= k is exact (the global distance for K3, the one-sided
ends-free score for K4) and a result above k is an upper bound, or 2^30 when
row m left the band before the capture window (see ``csrc/myers_banded.cu``).

``*_cuda`` launches the hand-written kernel, ``*_torch`` is the plain
PyTorch version with the same blocks and boundaries (so the two agree above
k too), and ``myers_banded`` / ``myers_banded_ef`` pick one by device. On
the card a group of G lanes runs a job and holds the band's window of
G q blocks in registers, q a lane (``banded_launch`` picks G and q); a
window wider than ``32 * QMAX`` blocks raises.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .myers_pallas import (M32, check_inputs, data_ptr, match_mask,
                           myers_column, pattern_planes, score_delta)
from .myers_striped import CAPTURE_INIT, GROUPS, _pow2_ceil

QMAX = 8                    # q: 64-bit window blocks a lane (1 ... QMAX)
H100_LANES = 132 * 4 * 32   # a warp on each scheduler of an H100
SCORE_LIMIT = 1 << 20       # scores pass between lanes in 20 bits


def banded_window(k: int, tb_max: int = 0) -> int:
    """64-bit blocks of the band's window at band k with free begins up to
    tb_max: a column runs blocks w_lo .. w_hi, at most
    floor((2k + tb) / 64) + 2 of them."""
    return (2 * k + tb_max) // 64 + 2


def scheduler_lanes(device: torch.device) -> int:
    """Lanes of a warp on each warp scheduler of ``device`` (4 an SM); an
    H100's for a device that is not a card."""
    if device.type != "cuda":
        return H100_LANES
    return torch.cuda.get_device_properties(device).multi_processor_count * 128


def banded_shape(n_jobs: int, window: int, group=None, q=None,
                 lanes: int = H100_LANES) -> Tuple[int, int]:
    """(G, q) of a K3 / K4 launch: G lanes on each job, q window blocks a
    lane, G q >= ``window``. G is the largest power of two that keeps the
    launch within ``lanes`` (a warp a scheduler: past that, some
    schedulers run two warps and finish last), at most 32 and no more than
    the window needs, and at least what keeps q <= QMAX (then the launch
    is issue-bound, and fewer lanes issue fewer instructions); q =
    ceil(window / G). ``group`` forces G and ``q`` forces q, as long as G q
    covers the window (a sweep or a test). Raises past 32 * QMAX
    blocks."""
    if window > 32 * QMAX:
        raise ValueError(f"a band window of {window} blocks is past the "
                         f"kernel's {32 * QMAX}")
    least = _pow2_ceil(-(-window // QMAX))
    if group is not None:
        if group not in GROUPS or group < least:
            raise ValueError(f"group must be one of {GROUPS} and at least "
                             f"{least} for {window} blocks")
        G = group
    else:
        fit = max(1, lanes // max(1, n_jobs))
        G = max(least, min(32, 1 << (fit.bit_length() - 1),
                           _pow2_ceil(window)))
    if q is None:
        return G, -(-window // G)
    if not 1 <= q <= QMAX or G * q < window:
        raise ValueError(f"q must be 1 ... {QMAX} with G q >= {window}")
    return G, q


def banded_launch(nlen: torch.Tensor, tb, k: int, group=None, q=None,
                  tb_max=None):
    """(G, q, order) of a K3 (``tb`` None) or K4 launch: the shape from
    ``banded_shape`` for the widest window on ``nlen``'s device, and where
    a warp holds several jobs (G < 32) the jobs in order of window, then of
    text length (int32, on their device), so the groups of a warp run
    alike; else None. K4's window is sized by ``tb_max``, the widest free
    begin; where the caller does not give it, it is read back from ``tb``
    (a synchronisation)."""
    B = nlen.shape[0]
    if tb is not None and tb_max is None:
        tb_max = int(tb.max()) if B else 0
    window = banded_window(k, max(0, tb_max or 0))
    G, q = banded_shape(B, window, group, q, scheduler_lanes(nlen.device))
    if G == 32 or B <= 32 // G:
        return G, q, None
    key = nlen
    if tb is not None:  # window blocks (< 2^9) above the length (< 2^16)
        key = key + (2 * k + tb.clamp(min=0)) // 64 * (1 << 16)
    return G, q, torch.argsort(key).to(torch.int32)


def banded_shapes() -> List[Tuple[int, int]]:
    """Every (G, q) ``banded_shape`` can give."""
    return sorted({banded_shape(n_jobs, w, g)
                   for w in range(2, 32 * QMAX + 1)
                   for n_jobs in (1, H100_LANES)
                   for g in (None,) + GROUPS
                   if g is None or g * QMAX >= w})


def myers_banded_torch(pool: torch.Tensor, idx_pat: torch.Tensor,
                       idx_txt: torch.Tensor, nlen: torch.Tensor,
                       minit: torch.Tensor, tb: torch.Tensor,
                       te: torch.Tensor, k: int, n_words: int,
                       text_len: int) -> torch.Tensor:
    """Plain PyTorch K3/K4 (K3 is tb = te = 0), vectorised over jobs: each
    column gathers every job's band window of 32-bit words, runs Myers'
    column step on it with the band's top carry, and writes back the
    job's own blocks. Returns (B,) int32 on the inputs' device."""
    check_inputs(pool, (idx_pat, idx_txt, nlen, minit, tb, te), n_words,
                 text_len)
    dev = pool.device
    B = idx_pat.shape[0]
    i64 = dict(device=dev, dtype=torch.int64)
    m = minit.to(torch.int64)
    n = nlen.to(torch.int64)
    tb64 = tb.to(torch.int64)
    te64 = te.to(torch.int64)
    ok = (m > 0) & (m <= 32 * n_words) & (n > 0) & (n <= text_len)
    nwp = (m.clamp(min=1) + 63) // 64
    win = 2 * ((2 * k + int(tb64.max()) + 63) // 64 + 2) if B else 0
    pool64 = pool.to(torch.int64) & M32
    lo, hi = pattern_planes(pool64[idx_pat.long(), : 2 * n_words], n_words)
    pad = torch.zeros((B, win), **i64)
    lo = torch.cat([lo, pad], dim=1)
    hi = torch.cat([hi, pad], dim=1)
    Pv = torch.full((B, n_words + win), M32, **i64)
    Mv = torch.zeros((B, n_words + win), **i64)
    twords = pool64[idx_txt.long(), : (text_len + 15) // 16]
    ar = torch.arange(win, **i64)
    w_hi = torch.minimum(nwp - 1, torch.full_like(nwp, k >> 6))
    score = torch.minimum(64 * (w_hi + 1), m)
    captured = torch.full((B,), CAPTURE_INIT, **i64)
    alive = ok.clone()
    stop = int(n[ok].max()) if bool(ok.any()) else 0
    for j in range(1, stop + 1):
        w_lo = (j - tb64 - k - 1).clamp(min=0) // 64
        hi_now = torch.minimum(nwp - 1, torch.full_like(nwp, (j + k - 1) >> 6))
        run = alive & (j <= n)
        grow = run & (hi_now > w_hi)
        w_hi = torch.where(grow, hi_now, w_hi)
        score = score + torch.where(grow, (m - 64 * w_hi).clamp(max=64), 0)
        alive = alive & ~(run & (w_lo > w_hi))
        run = run & alive
        base = 2 * torch.minimum(w_lo, nwp - 1)  # in range for idle jobs
        idx = base.unsqueeze(1) + ar
        ch = (twords[:, (j - 1) >> 4] >> (2 * ((j - 1) & 15))) & 3
        ph_in = ((w_lo > 0) | (j > tb64)).to(torch.int64).unsqueeze(1)
        Pw = Pv.gather(1, idx)
        Mw = Mv.gather(1, idx)
        Pn, Mn, Ph, Mh = myers_column(
            Pw, Mw, match_mask(lo.gather(1, idx), hi.gather(1, idx), ch),
            ph_in)
        row = torch.where(w_hi == nwp - 1, m - 1, 64 * w_hi + 63)
        sel_word = (row // 32 - base).clamp(0, win - 1).unsqueeze(1)
        sel_bit = (torch.ones_like(row) << (row & 31)).unsqueeze(1)
        score = score + torch.where(run, score_delta(Ph, Mh, sel_word,
                                                     sel_bit), 0)
        keep = run.unsqueeze(1) & (ar < 2 * (w_hi - w_lo + 1).unsqueeze(1))
        Pv.scatter_(1, idx, torch.where(keep, Pn, Pw))
        Mv.scatter_(1, idx, torch.where(keep, Mn, Mw))
        cap = run & (w_hi == nwp - 1) & (j >= n - te64)
        captured = torch.where(cap, torch.minimum(captured, score), captured)
    return captured.to(torch.int32)


def _banded_cuda(name: str, pool, idx_pat, idx_txt, nlen, minit, tb, te,
                 k: int, n_words: int, text_len: int, group=None,
                 q=None, tb_max=None) -> torch.Tensor:
    from . import _build

    per_job = (idx_pat, idx_txt, nlen, minit) + \
        ((tb, te) if tb is not None else ())
    check_inputs(pool, per_job, n_words, text_len)
    if not pool.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    if n_words < 2 or n_words % 2 or k < 0:
        raise ValueError("n_words must be even and >= 2, k >= 0")
    if 32 * n_words + text_len >= SCORE_LIMIT:
        raise ValueError(f"patterns and texts of {32 * n_words} and "
                         f"{text_len} chars: the kernel passes scores below "
                         f"{SCORE_LIMIT} between lanes")
    B = idx_pat.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=pool.device)
    if B == 0:
        return out
    G, q, order = banded_launch(nlen, tb, k, group, q, tb_max)
    lib = _build.load()
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    head = (data_ptr(pool), pool.shape[1], data_ptr(idx_pat),
            data_ptr(idx_txt), data_ptr(nlen), data_ptr(minit))
    tail = (k, data_ptr(out), B, n_words, text_len, G, q,
            None if order is None else data_ptr(order), stream)
    with torch.cuda.device(pool.device):
        if tb is None:
            err = lib.otter_myers_banded(*head, *tail)
        else:
            err = lib.otter_myers_banded_ef(*head, data_ptr(tb), data_ptr(te),
                                            *tail)
    _build.check(lib, err, name)
    return out


def myers_banded_cuda(pool: torch.Tensor, idx_pat: torch.Tensor,
                      idx_txt: torch.Tensor, nlen: torch.Tensor,
                      minit: torch.Tensor, k: int, n_words: int,
                      text_len: int, group=None, q=None) -> torch.Tensor:
    """K3 on the card: one launch on the current stream, no
    synchronisation, shaped by ``banded_launch`` (``group`` / ``q`` force
    G / q). Raises on bad inputs, a window past the kernel's or a refused
    launch."""
    out = _banded_cuda("myers_banded_cuda", pool, idx_pat, idx_txt, nlen,
                       minit, None, None, k, n_words, text_len, group, q)
    myers_banded_cuda.launches += 1
    return out


myers_banded_cuda.launches = 0


def myers_banded_ef_cuda(pool: torch.Tensor, idx_pat: torch.Tensor,
                         idx_txt: torch.Tensor, nlen: torch.Tensor,
                         minit: torch.Tensor, tb: torch.Tensor,
                         te: torch.Tensor, k: int, n_words: int,
                         text_len: int, group=None, q=None,
                         tb_max=None) -> torch.Tensor:
    """K4 on the card: one launch on the current stream, shaped by
    ``banded_launch`` (``group`` / ``q`` force G / q). ``tb_max``, the
    widest free begin, sizes the window; it must be at least every ``tb``.
    Without it the wrapper reads ``tb.max()`` back, a synchronisation.
    Raises on bad inputs, a window past the kernel's or a refused
    launch."""
    out = _banded_cuda("myers_banded_ef_cuda", pool, idx_pat, idx_txt, nlen,
                       minit, tb, te, k, n_words, text_len, group, q, tb_max)
    myers_banded_ef_cuda.launches += 1
    return out


myers_banded_ef_cuda.launches = 0


def myers_banded(pool: torch.Tensor, idx_pat: torch.Tensor,
                 idx_txt: torch.Tensor, nlen: torch.Tensor,
                 minit: torch.Tensor, k: int, n_words: int,
                 text_len: int) -> torch.Tensor:
    """K3 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if pool.is_cuda:
        return myers_banded_cuda(pool, idx_pat, idx_txt, nlen, minit, k,
                                 n_words, text_len)
    if pool.device.type == "cpu":
        zero = torch.zeros_like(nlen)
        return myers_banded_torch(pool, idx_pat, idx_txt, nlen, minit, zero,
                                  zero, k, n_words, text_len)
    raise ValueError(f"no K3 version for device {pool.device}")


def myers_banded_ef(pool: torch.Tensor, idx_pat: torch.Tensor,
                    idx_txt: torch.Tensor, nlen: torch.Tensor,
                    minit: torch.Tensor, tb: torch.Tensor, te: torch.Tensor,
                    k: int, n_words: int, text_len: int,
                    tb_max=None) -> torch.Tensor:
    """K4 by device: the CUDA kernel for CUDA tensors (it launches or
    raises; ``tb_max`` as there), the plain version for CPU tensors."""
    if pool.is_cuda:
        return myers_banded_ef_cuda(pool, idx_pat, idx_txt, nlen, minit, tb,
                                    te, k, n_words, text_len, tb_max=tb_max)
    if pool.device.type == "cpu":
        return myers_banded_torch(pool, idx_pat, idx_txt, nlen, minit, tb, te,
                                  k, n_words, text_len)
    raise ValueError(f"no K4 version for device {pool.device}")
