"""Kernel K1: batched Myers bit-parallel edit distance over a 2-bit pool.

Counterpart of ``otter_tpu/kernels/myers_pallas.py`` (the pool path,
``myers_pool_pallas`` -> ``_myers_kernel_packed``). The inputs are the numpy
arrays the TPU launch takes, as tensors: ``pool`` (S, W_pool) int32 rows from
``pack_pool``, and per pair ``idx_pat``, ``idx_txt``, ``nlen`` and
``minit`` (B,) int32. The pattern is the shorter side (``minit`` chars, at
most ``32 * n_words``), the text the longer (``nlen`` chars, at most
``text_len``). The result is (B,) int32: the exact global Levenshtein
distance, or ``minit`` where the TPU kernel captures no score.

``myers_pool_cuda`` launches the hand-written kernel (``csrc/myers.cu``);
``myers_pool_torch`` is the plain PyTorch version of the same recurrence on
the same 32-bit words; ``myers_pool`` picks one by the tensors' device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

N_WORDS_BUCKETS = (4, 8, 16, 32, 64)

M32 = 0xFFFFFFFF


def pack_pool(seqs: List[str], n_words_pool: int) -> np.ndarray:
    """(S, n_words_pool) int32, each row a sequence 2-bit packed (16 chars
    per word, char j -> bits 2(j%16)..+1 of word j//16, padding packs as
    'A' = 0): the TPU package's pool layout, by the threaded C++ packer."""
    from ..native import pack_pool_2bit_native

    return pack_pool_2bit_native(seqs, n_words_pool)


def int32_tensor(a, device) -> torch.Tensor:
    """A numpy array (or sequence) as a contiguous int32 tensor on
    ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)
                            ).to(device)


def pool_width(n_words: int, text_len: int) -> int:
    """Pool row width a launch needs: the pattern's 2 * n_words words and
    the text's ceil(text_len / 16)."""
    return max(2 * n_words, (text_len + 15) // 16)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def pattern_planes(rows: torch.Tensor, n_words: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 2 * n_words) pool words (int64, 32-bit values) -> the low and
    high bit planes of the 2-bit codes, (B, n_words) each: bit k of word v
    is code bit 0 (resp. 1) of pattern char 32 v + k."""
    B = rows.shape[0]
    shifts = torch.arange(16, device=rows.device, dtype=torch.int64)
    codes = (rows.unsqueeze(-1) >> (2 * shifts)) & 3           # (B, 2nw, 16)
    codes = codes.reshape(B, n_words, 32)
    weights = torch.ones(32, device=rows.device, dtype=torch.int64) \
        << torch.arange(32, device=rows.device, dtype=torch.int64)
    lo = ((codes & 1) * weights).sum(-1)
    hi = ((codes >> 1) * weights).sum(-1)
    return lo, hi


def match_mask(lo: torch.Tensor, hi: torch.Tensor,
               ch: torch.Tensor) -> torch.Tensor:
    """Peq row of text chars ``ch`` (B,): bits where the pattern char
    equals ch, from the two code-bit planes."""
    flip_lo = torch.where((ch & 1) != 0, 0, M32).unsqueeze(1)
    flip_hi = torch.where((ch & 2) != 0, 0, M32).unsqueeze(1)
    return (lo ^ flip_lo) & (hi ^ flip_hi)


def myers_column(Pv: torch.Tensor, Mv: torch.Tensor, Eq: torch.Tensor,
                 ph_in: torch.Tensor):
    """One text column of Myers' recurrence over (B, W) 32-bit words held
    in int64 (so adds never overflow and >> is logical on the values).

    The inter-word adder carry of (Eq & Pv) + Pv is resolved for all words
    at once: the carry into word w is the carry generated by the nearest
    lower word that does not merely propagate (its low 32 bits of the sum
    are not all ones), or 0 if every lower word propagates. That equals
    the ripple the TPU kernel runs word by word. ``ph_in`` (B, 1) is the
    top boundary's Ph carry-in. Returns (Pv, Mv, Ph, Mh), the last two
    before the shift (the score row reads them)."""
    B, W = Pv.shape
    Xv = Eq | Mv
    t = Eq & Pv
    s0 = t + Pv
    gen = s0 >> 32
    ends_chain = (gen != 0) | ((s0 & M32) != M32)
    pos = torch.arange(W, device=Pv.device, dtype=torch.int64).expand(B, W)
    last = torch.cummax(torch.where(ends_chain, pos, -1), dim=1).values
    neg = torch.full((B, 1), -1, device=Pv.device, dtype=torch.int64)
    below = torch.cat([neg, last[:, :-1]], dim=1)
    cin = torch.where(below >= 0, gen.gather(1, below.clamp(min=0)), 0)
    s = (s0 + cin) & M32
    Xh = (s ^ Pv) | Eq
    Ph = Mv | (M32 ^ (Xh | Pv))
    Mh = Pv & Xh
    zero = torch.zeros((B, 1), device=Pv.device, dtype=torch.int64)
    Phs = ((Ph << 1) & M32) | torch.cat([ph_in, Ph[:, :-1] >> 31], dim=1)
    Mhs = ((Mh << 1) & M32) | torch.cat([zero, Mh[:, :-1] >> 31], dim=1)
    return Mhs | (M32 ^ (Xv | Phs)), Phs & Xv, Ph, Mh


def score_row(minit: torch.Tensor, n_words: int):
    """(word, bit) of each pair's scored row m - 1, as (B, 1) tensors; the
    bit is 0 where the TPU kernel has no score row (m == 0 or
    m > 32 * n_words), so the score stays m."""
    m = minit.to(torch.int64)
    m1 = (m - 1).clamp(min=0)
    ok = (m > 0) & (m <= 32 * n_words)
    sel_word = (m1 // 32).clamp(max=n_words - 1).unsqueeze(1)
    sel_bit = torch.where(ok, torch.ones_like(m1) << (m1 & 31), 0)
    return sel_word, sel_bit.unsqueeze(1)


def score_delta(Ph, Mh, sel_word, sel_bit) -> torch.Tensor:
    ph = (Ph.gather(1, sel_word) & sel_bit) != 0
    mh = (Mh.gather(1, sel_word) & sel_bit) != 0
    return ph.squeeze(1).to(torch.int64) - mh.squeeze(1).to(torch.int64)


def myers_pool_torch(pool: torch.Tensor, idx_pat: torch.Tensor,
                     idx_txt: torch.Tensor, nlen: torch.Tensor,
                     minit: torch.Tensor, n_words: int,
                     text_len: int) -> torch.Tensor:
    """Plain PyTorch K1, vectorised over the pairs and the pattern words.
    Same semantics as the TPU kernel: score starts at minit and is captured
    at j == nlen. Returns (B,) int32 on the inputs' device."""
    check_inputs(pool, (idx_pat, idx_txt, nlen, minit), n_words, text_len)
    dev = pool.device
    B = idx_pat.shape[0]
    pool64 = pool.to(torch.int64) & M32
    lo, hi = pattern_planes(pool64[idx_pat.long(), : 2 * n_words], n_words)
    twords = pool64[idx_txt.long(), : (text_len + 15) // 16]
    n = nlen.to(torch.int64)
    sel_word, sel_bit = score_row(minit, n_words)
    Pv = torch.full((B, n_words), M32, device=dev, dtype=torch.int64)
    Mv = torch.zeros((B, n_words), device=dev, dtype=torch.int64)
    score = minit.to(torch.int64).clone()
    captured = score.clone()
    ph_in = torch.ones((B, 1), device=dev, dtype=torch.int64)
    stop = min(text_len, int(n.max())) if B else 0
    for j in range(stop):
        ch = (twords[:, j >> 4] >> (2 * (j & 15))) & 3
        Pv, Mv, Ph, Mh = myers_column(Pv, Mv, match_mask(lo, hi, ch), ph_in)
        score = score + score_delta(Ph, Mh, sel_word, sel_bit)
        captured = torch.where(n == j + 1, score, captured)
    return captured.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def check_inputs(pool, per_pair, n_words: int, text_len: int) -> None:
    """Shapes, dtypes and devices every version takes."""
    if pool.dim() != 2 or pool.dtype != torch.int32:
        raise ValueError("pool must be a (S, W_pool) int32 tensor")
    B = per_pair[0].shape[0]
    for t in per_pair:
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError("per-pair inputs must be (B,) int32 tensors")
        if t.device != pool.device:
            raise ValueError("all inputs must be on one device")
    need = pool_width(n_words, text_len)
    if pool.shape[1] < need:
        raise ValueError(f"pool rows have {pool.shape[1]} words, "
                         f"need {need}")


def data_ptr(t: torch.Tensor) -> int:
    if not t.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    return t.data_ptr()


def myers_pool_cuda(pool: torch.Tensor, idx_pat: torch.Tensor,
                    idx_txt: torch.Tensor, nlen: torch.Tensor,
                    minit: torch.Tensor, n_words: int,
                    text_len: int) -> torch.Tensor:
    """K1 on the card (``csrc/myers.cu``): one launch on the current
    stream, no synchronisation. Raises on bad inputs or a refused launch."""
    from . import _build

    check_inputs(pool, (idx_pat, idx_txt, nlen, minit), n_words, text_len)
    if not pool.is_cuda:
        raise ValueError("myers_pool_cuda takes CUDA tensors")
    if n_words not in N_WORDS_BUCKETS:
        raise ValueError(f"n_words must be one of {N_WORDS_BUCKETS}")
    B = idx_pat.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=pool.device)
    if B == 0:
        return out
    lib = _build.load()
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    with torch.cuda.device(pool.device):
        err = lib.otter_myers_pool(
            data_ptr(pool), pool.shape[1], data_ptr(idx_pat),
            data_ptr(idx_txt), data_ptr(nlen), data_ptr(minit), data_ptr(out),
            B, n_words, text_len, stream)
    _build.check(lib, err, "myers_pool_cuda")
    myers_pool_cuda.launches += 1
    return out


myers_pool_cuda.launches = 0


def myers_pool(pool: torch.Tensor, idx_pat: torch.Tensor,
               idx_txt: torch.Tensor, nlen: torch.Tensor, minit: torch.Tensor,
               n_words: int, text_len: int) -> torch.Tensor:
    """K1 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if pool.is_cuda:
        return myers_pool_cuda(pool, idx_pat, idx_txt, nlen, minit, n_words,
                               text_len)
    if pool.device.type == "cpu":
        return myers_pool_torch(pool, idx_pat, idx_txt, nlen, minit, n_words,
                                text_len)
    raise ValueError(f"no K1 version for device {pool.device}")
