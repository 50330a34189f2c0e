"""Kernel K10: per-allele k-mer histograms.

Counterpart of ``kcounts_device`` in ``otter_tpu/seqs/kmer.py`` (jnp, not
Pallas). Inputs: ``seqs`` (T,) uint8, every allele's bytes back to back;
``offsets`` (n + 1,) int32, allele a being ``seqs[offsets[a]:offsets[a +
1]]``; ``k`` >= 1. The result is (n, 4^k + 1) int32: per allele the count
of each window's base-4 index (A/a 0, C/c 1, G/g 2, T/t 3, the first base
the most significant digit), windows with any other byte in bucket 4^k,
and nothing for an allele shorter than k, as ``seq2kcounts``.

``kmer_counts_cuda`` launches the hand-written kernel
(``csrc/kmer_counts.cu``), ``kmer_counts_torch`` is the plain PyTorch
version (the window indices by a rolling shift over the flat codes, then
``torch.bincount`` of (allele, index) keys), and ``kmer_counts`` picks one
by device.
"""

from __future__ import annotations

import torch

from .myers_pallas import data_ptr

# k whose 4^k + 1 counts an int32 index holds (the kernel's limit too)
K_MAX = 15
# byte -> base code (4 for a non-ACGT byte)
_CODES = torch.full((256,), 4, dtype=torch.int64)
for _c, _v in zip(b"ACGTacgt", (0, 1, 2, 3, 0, 1, 2, 3)):
    _CODES[_c] = _v


def _check(seqs, offsets, k) -> None:
    if seqs.dtype != torch.uint8 or offsets.dtype != torch.int32:
        raise ValueError("seqs must be uint8 and offsets int32")
    if seqs.dim() != 1 or offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError("seqs must be (T,) and offsets (n + 1,)")
    if seqs.device != offsets.device:
        raise ValueError("seqs and offsets must be on one device")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in 1..{K_MAX}, not {k}")


def window_keys(seqs: torch.Tensor, offsets: torch.Tensor,
                k: int) -> torch.Tensor:
    """The flat (allele, index) key ``allele * (4^k + 1) + index`` of every
    window that lies inside one allele, as int64 (the plain version's and
    the library call's input)."""
    _check(seqs, offsets, k)
    n = offsets.shape[0] - 1
    width = 4 ** k + 1
    total = seqs.shape[0]
    if n == 0 or total < k:
        return torch.zeros(0, dtype=torch.int64, device=seqs.device)
    codes = _CODES.to(seqs.device)[seqs.long()]
    nw = total - k + 1
    bad = codes[:nw] >= 4
    idx = torch.where(bad, 0, codes[:nw])
    for j in range(1, k):
        cj = codes[j : j + nw]
        idx = idx * 4 + torch.where(cj < 4, cj, 0)
        bad |= cj >= 4
    idx = torch.where(bad, width - 1, idx)
    lens = (offsets[1:] - offsets[:-1]).long()
    owner = torch.repeat_interleave(
        torch.arange(n, device=seqs.device), lens, output_size=total)
    sid = owner[:nw]
    inseq = sid == owner[k - 1 :]
    return sid[inseq] * width + idx[inseq]


def kmer_counts_torch(seqs: torch.Tensor, offsets: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Plain PyTorch K10: ``torch.bincount`` of the window keys."""
    n = offsets.shape[0] - 1
    width = 4 ** k + 1
    keys = window_keys(seqs, offsets, k)
    return torch.bincount(keys, minlength=n * width).reshape(
        n, width).to(torch.int32)


def kmer_counts_cuda(seqs: torch.Tensor, offsets: torch.Tensor,
                     k: int) -> torch.Tensor:
    """K10 on the card (``csrc/kmer_counts.cu``): one launch on the current
    stream, no synchronisation; ``seqs`` 4-byte aligned (a tensor's own
    storage is). Raises on bad inputs or a refused launch."""
    from . import _build

    _check(seqs, offsets, k)
    if not seqs.is_cuda:
        raise ValueError("kmer_counts_cuda takes CUDA tensors")
    if data_ptr(seqs) % 4:
        raise ValueError("kmer_counts_cuda reads seqs as 4-byte words: its "
                         "data must be 4-byte aligned")
    n = offsets.shape[0] - 1
    width = 4 ** k + 1
    # the kernel writes a shared-memory histogram out whole; past 4^7 + 1
    # counts it adds into device memory, which must start at zero
    alloc = torch.empty if width <= 4 ** 7 + 1 else torch.zeros
    counts = alloc((n, width), dtype=torch.int32, device=seqs.device)
    if n == 0:
        return counts
    lib = _build.load()
    stream = torch.cuda.current_stream(seqs.device).cuda_stream
    with torch.cuda.device(seqs.device):
        err = lib.otter_kmer_counts(data_ptr(seqs), data_ptr(offsets), n, k,
                                    data_ptr(counts), stream)
    _build.check(lib, err, "kmer_counts_cuda")
    kmer_counts_cuda.launches += 1
    return counts


kmer_counts_cuda.launches = 0


def kmer_counts(seqs: torch.Tensor, offsets: torch.Tensor,
                k: int) -> torch.Tensor:
    """K10 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if seqs.is_cuda:
        return kmer_counts_cuda(seqs, offsets, k)
    if seqs.device.type == "cpu":
        return kmer_counts_torch(seqs, offsets, k)
    raise ValueError(f"no K10 version for device {seqs.device}")
