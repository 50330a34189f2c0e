"""Kernel K2: full-matrix Myers for patterns of any length, with one-sided
ends-free boundaries on the text.

Counterpart of ``otter_tpu/kernels/myers_striped.py``. The TPU kernel runs
the pattern in stripes of 32 words chained by per-character carry planes;
on the card a group of G lanes runs a job, each lane a stripe of q words,
the carries passed lane to lane by shuffles (``striped_shape`` picks G and
q); the plain version runs all words at once. All give the same scores.

Per job: pattern = pool row ``idx_pat`` of ``minit`` chars, text = pool row
``idx_txt`` of ``nlen`` chars, ``tb`` free leading and ``te`` free trailing
text chars. The score is min over j in [nlen - te, nlen], j >= 1, of
D[m][j] with D[0][j] = max(0, j - tb), starting from 2^30 as on the TPU;
``tb = te = 0`` gives the global distance.

The host wrappers (``myers_striped_ends_free_async`` / ``_collect``) orient
ends-free jobs so every free sits on the text, resolve jobs with an empty
side in closed form, and raise on jobs with frees on both sides.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils.metrics import to_host
from .myers_pallas import (M32, check_inputs, data_ptr, int32_tensor,
                           match_mask, myers_column, pack_pool,
                           pattern_planes, pool_width, score_delta,
                           score_row)

CAPTURE_INIT = 1 << 30
GROUPS = (1, 2, 4, 8, 16, 32)   # G: lanes on a job
FILL_LANES = 1 << 16            # G: the power of two >= this / jobs


def striped_n_words(max_m: int) -> int:
    """32-bit pattern words for patterns up to max_m chars: an even count
    (the kernel runs 64-bit words), at least 2."""
    return 2 * max(1, -(-max_m // 64))


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def striped_shape(n_jobs: int, n_words: int, group=None) -> Tuple[int, int]:
    """(G, q) of a K2 launch: G lanes on each job, q 64-bit words a lane
    (a power of two, the kernel's template instances 1 ... 32). Patterns
    past 32 words (2048 chars) take a whole warp; otherwise G grows while
    the launch has fewer than FILL_LANES lanes (a small launch puts many
    lanes on each job, a large one one or a few), up to the pattern's word
    count. ``group`` forces G (a sweep or a test)."""
    nw64 = n_words // 2
    if nw64 > 32:
        G = 32
    elif group is not None:
        if group not in GROUPS:
            raise ValueError(f"group must be one of {GROUPS}")
        G = group
    else:
        G = min(32, _pow2_ceil(max(1, FILL_LANES // max(1, n_jobs))),
                _pow2_ceil(nw64))
    return G, _pow2_ceil(-(-nw64 // G))


def striped_launch(minit: torch.Tensor, nlen: torch.Tensor, n_words: int,
                   group=None):
    """(G, q, order) of a K2 launch over jobs of these lengths: the shape
    from ``striped_shape``, and where a warp holds several jobs (G < 32)
    the jobs in order of the words a lane runs, then of text length (int32,
    on their device), so the groups of a warp run alike and finish
    together; else None."""
    B = minit.shape[0]
    G, q = striped_shape(B, n_words, group)
    if G == 32 or B <= 32 // G:
        return G, q, None
    words = (minit.to(torch.int64) + 63) // 64
    key = (words + G - 1) // G * (1 << 32) + nlen.to(torch.int64)
    return G, q, torch.argsort(key).to(torch.int32)


def striped_shapes() -> List[Tuple[int, int]]:
    """Every (G, q) ``striped_shape`` can give, for n_words up to 1024."""
    return sorted({striped_shape(1, 2 * nw64, g)
                   for nw64 in range(1, 513) for g in GROUPS})


def myers_striped_torch(pool: torch.Tensor, idx_pat: torch.Tensor,
                        idx_txt: torch.Tensor, nlen: torch.Tensor,
                        minit: torch.Tensor, tb: torch.Tensor,
                        te: torch.Tensor, n_words: int,
                        text_len: int) -> torch.Tensor:
    """Plain PyTorch K2, vectorised over jobs and pattern words. Returns
    (B,) int32 on the inputs' device."""
    check_inputs(pool, (idx_pat, idx_txt, nlen, minit, tb, te), n_words,
                 text_len)
    dev = pool.device
    B = idx_pat.shape[0]
    pool64 = pool.to(torch.int64) & M32
    lo, hi = pattern_planes(pool64[idx_pat.long(), : 2 * n_words], n_words)
    twords = pool64[idx_txt.long(), : (text_len + 15) // 16]
    n = nlen.to(torch.int64)
    first = n - te.to(torch.int64)
    tb64 = tb.to(torch.int64).unsqueeze(1)
    sel_word, sel_bit = score_row(minit, n_words)
    Pv = torch.full((B, n_words), M32, device=dev, dtype=torch.int64)
    Mv = torch.zeros((B, n_words), device=dev, dtype=torch.int64)
    score = minit.to(torch.int64).clone()
    captured = torch.full((B,), CAPTURE_INIT, device=dev, dtype=torch.int64)
    stop = min(text_len, int(n.max())) if B else 0
    for j in range(stop):
        ch = (twords[:, j >> 4] >> (2 * (j & 15))) & 3
        ph_in = (tb64 <= j).to(torch.int64)
        Pv, Mv, Ph, Mh = myers_column(Pv, Mv, match_mask(lo, hi, ch), ph_in)
        score = score + score_delta(Ph, Mh, sel_word, sel_bit)
        window = (first <= j + 1) & (n >= j + 1)
        captured = torch.where(window, torch.minimum(captured, score),
                               captured)
    return captured.to(torch.int32)


def myers_striped_cuda(pool: torch.Tensor, idx_pat: torch.Tensor,
                       idx_txt: torch.Tensor, nlen: torch.Tensor,
                       minit: torch.Tensor, tb: torch.Tensor,
                       te: torch.Tensor, n_words: int, text_len: int,
                       group=None) -> torch.Tensor:
    """K2 on the card (``csrc/myers_striped.cu``): one launch on the
    current stream, no synchronisation, shaped by ``striped_launch``
    (``group`` forces G). Raises on bad inputs or a refused launch."""
    from . import _build

    check_inputs(pool, (idx_pat, idx_txt, nlen, minit, tb, te), n_words,
                 text_len)
    if not pool.is_cuda:
        raise ValueError("myers_striped_cuda takes CUDA tensors")
    if n_words < 2 or n_words % 2:
        raise ValueError("n_words must be even and >= 2")
    B = idx_pat.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=pool.device)
    if B == 0:
        return out
    G, q, order = striped_launch(minit, nlen, n_words, group)
    lib = _build.load()
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    with torch.cuda.device(pool.device):
        err = lib.otter_myers_striped(
            data_ptr(pool), pool.shape[1], data_ptr(idx_pat),
            data_ptr(idx_txt), data_ptr(nlen), data_ptr(minit), data_ptr(tb),
            data_ptr(te), data_ptr(out), B, n_words, text_len, G, q,
            None if order is None else data_ptr(order), stream)
    _build.check(lib, err, "myers_striped_cuda")
    myers_striped_cuda.launches += 1
    return out


myers_striped_cuda.launches = 0


def myers_striped(pool: torch.Tensor, idx_pat: torch.Tensor,
                  idx_txt: torch.Tensor, nlen: torch.Tensor,
                  minit: torch.Tensor, tb: torch.Tensor, te: torch.Tensor,
                  n_words: int, text_len: int) -> torch.Tensor:
    """K2 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if pool.is_cuda:
        return myers_striped_cuda(pool, idx_pat, idx_txt, nlen, minit, tb,
                                  te, n_words, text_len)
    if pool.device.type == "cpu":
        return myers_striped_torch(pool, idx_pat, idx_txt, nlen, minit, tb,
                                   te, n_words, text_len)
    raise ValueError(f"no K2 version for device {pool.device}")


# ---------------------------------------------------------------------------
# Host wrappers
# ---------------------------------------------------------------------------


def dedup_oriented(oriented: Sequence[Tuple[str, str]]
                   ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """id()-keyed unique-sequence pool over (pattern, text) tuples ->
    (seqs, idx_pat, idx_txt): pair sets that share string objects ship
    each sequence once."""
    rows: dict = {}
    seqs: List[str] = []
    ip = np.empty(len(oriented), dtype=np.int32)
    it = np.empty(len(oriented), dtype=np.int32)
    for k, (p, t) in enumerate(oriented):
        for s, dst in ((p, ip), (t, it)):
            r = rows.get(id(s))
            if r is None:
                r = rows[id(s)] = len(seqs)
                seqs.append(s)
            dst[k] = r
    return seqs, ip, it


def oriented_inputs(oriented: Sequence[Tuple[str, str]], tbs, tes,
                    device) -> tuple:
    """Pack (pattern, text) jobs with their tb/te into the arguments of
    ``myers_striped`` on ``device``: one pool of the unique sequences."""
    seqs, ip, it = dedup_oriented(oriented)
    mlen = np.fromiter((len(p) for p, _t in oriented), np.int32,
                       len(oriented))
    nlen = np.fromiter((len(t) for _p, t in oriented), np.int32,
                       len(oriented))
    n_words = striped_n_words(int(mlen.max()))
    text_len = int(nlen.max())
    pool = pack_pool(seqs, pool_width(n_words, text_len))
    return tuple(int32_tensor(a, device) for a in
                 (pool, ip, it, nlen, mlen, tbs, tes)) + (n_words, text_len)


def launch_oriented(oriented: Sequence[Tuple[str, str]], tbs, tes,
                    device) -> torch.Tensor:
    """Launch K2 over all (pattern, text) jobs at once; returns the (B,)
    int32 result on ``device``, still in flight on the card."""
    return myers_striped(*oriented_inputs(oriented, tbs, tes, device))


def _ends_free_degenerate(m: int, n: int, pb: int, pe: int,
                          tb: int, te: int) -> int:
    """Closed-form ends-free score when one side is empty."""
    if m == 0:
        return max(0, max(0, n - te) - tb)
    return max(0, max(0, m - pe) - pb)


def myers_striped_ends_free_async(jobs, device: torch.device):
    """Launch exact ends-free scores of ACGT jobs (pattern, text, pb, pe,
    tb, te) whose frees are on at most ONE side; returns a handle whose
    device work is in flight (finish with ``_collect``, the only copy back).

    Pattern-side frees move to the text by transposing the job
    (Levenshtein is symmetric); text-side frees then map onto the
    recurrence exactly (see the module docstring)."""
    out = np.zeros(len(jobs), dtype=np.int64)
    live: List[int] = []
    oriented: List[Tuple[str, str]] = []
    tbs: List[int] = []
    tes: List[int] = []
    for i, (p, t, pb, pe, tb, te) in enumerate(jobs):
        if min(len(p), len(t)) == 0:
            out[i] = _ends_free_degenerate(len(p), len(t), pb, pe, tb, te)
            continue
        live.append(i)
        if pb or pe:
            if tb or te:
                raise ValueError("frees on both sides not device-routable")
            oriented.append((t, p))
            tbs.append(pb)
            tes.append(pe)
        else:
            oriented.append((p, t))
            tbs.append(tb)
            tes.append(te)
    dev = None
    if oriented:
        dev = launch_oriented(oriented, tbs, tes, device)
    return out, live, dev


def myers_striped_ends_free_collect(handle) -> np.ndarray:
    out, live, dev = handle
    if dev is not None:
        out[live] = to_host(dev)
    return out


def myers_striped_ends_free(jobs, device: torch.device) -> np.ndarray:
    return myers_striped_ends_free_collect(
        myers_striped_ends_free_async(jobs, device))
