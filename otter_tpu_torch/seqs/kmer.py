"""K-mer encoding, usage vectors, cosine similarity, Hill-Shannon diversity.

Parity with reference KmerEncoding (src/anseqs.cpp:171-208), seq2kcounts with
the invalid-kmer bucket at index 4^k (:149-166), KUSAGE normalized usage +
cosine similarity + ``exp(-sum p ln p)`` diversity (:111-147).

``seq2kcounts_np`` is the vectorized form used by the batched TPU genotype
path; ``seq2kcounts`` keeps scalar parity semantics.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from .. import native

_NT2CODE = np.full(256, 4, dtype=np.uint8)
for _c, _v in (("A", 0), ("a", 0), ("C", 1), ("c", 1),
               ("G", 2), ("g", 2), ("T", 3), ("t", 3)):
    _NT2CODE[ord(_c)] = _v
CODE2NT = "ACGT"


class KmerEncoding:
    """2-bit nucleotide encoding; invalid bases map to 4."""

    nt2encoding = _NT2CODE

    def kmer2index(self, kmer: str) -> int:
        """Base-4 big-endian index: first char is the most significant digit
        (anseqs.cpp:186,203-208 recursion unrolled)."""
        idx = 0
        for ch in kmer:
            idx = 4 * idx + int(_NT2CODE[ord(ch)])
        return idx

    def index2kmer(self, index: int, k: int) -> str:
        out = ["N"] * k
        for i in range(k - 1, -1, -1):
            out[i] = CODE2NT[index % 4]
            index //= 4
        return "".join(out)


def seq2kcounts(k: int, seq: str) -> np.ndarray:
    """Counts over 4^k + 1 buckets; invalid k-mers into the last bucket."""
    max_index = int(4 ** k)
    counts = np.zeros(max_index + 1, dtype=np.float64)
    codes = _NT2CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]
    n = len(seq)
    if n >= k:
        windows = np.lib.stride_tricks.sliding_window_view(codes, k)
        valid = (windows < 4).all(axis=1)
        pow4 = (4 ** np.arange(k - 1, -1, -1)).astype(np.int64)
        idx = windows.astype(np.int64) @ pow4
        idx = np.where(valid, idx, max_index)
        np.add.at(counts, idx, 1.0)
    return counts


class Kusage:
    """Normalized k-mer usage vector (anseqs.cpp:111-121)."""

    def __init__(self, kcounts: np.ndarray):
        total = int(kcounts.sum())
        self.vec = kcounts / total if total != 0 else kcounts * np.nan
        # match the C++ loop: vnorm accumulates value*value even when total==0
        if total == 0:
            self.vec = np.full_like(kcounts, np.nan)
        self.vnorm = float(np.sqrt(np.sum(self.vec * self.vec)))
        self._hsdiv: Optional[float] = None

    def cosine_sim(self, other: "Kusage") -> float:
        x_dot_y = float(np.dot(self.vec, other.vec))
        return x_dot_y / (self.vnorm * other.vnorm)

    def hsdiv(self) -> float:
        """Hill-Shannon diversity exp(-sum p ln p) (anseqs.cpp:134-147)."""
        if self._hsdiv is not None:
            return self._hsdiv
        acc = 0.0
        for v in self.vec:
            if v > 0:
                acc += v * math.log(v)
        self._hsdiv = math.pow(math.e, -acc)
        return self._hsdiv


def seq2kcounts_np(k: int, seqs: List[str]) -> np.ndarray:
    """Vectorized seq2kcounts over an allele batch: (n, 4^k + 1) float64,
    bit-identical to the scalar version (integer counts are exact).

    One pass over the concatenated codes; windows that straddle a sequence
    boundary are masked out, invalid k-mers land in the last bucket, and
    sequences shorter than k contribute nothing — the scalar semantics."""
    n = len(seqs)
    max_index = int(4 ** k)
    width = max_index + 1
    counts = np.zeros((n, width), dtype=np.float64)
    if n == 0:
        return counts
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    total = int(lens.sum())
    if total < k:
        return counts
    blob = "".join(seqs)
    codes = _NT2CODE[np.frombuffer(blob.encode(),
                                   dtype=np.uint8)].astype(np.int64)
    # rolling-shift window indices (no sliding-window copy, no matmul)
    nw = total - k + 1
    bad = codes[:nw] >= 4
    idx = np.where(bad, 0, codes[:nw])
    for j in range(1, k):
        cj = codes[j : j + nw]
        idx = idx * 4 + np.where(cj < 4, cj, 0)
        bad |= cj >= 4
    idx[bad] = max_index
    owner = np.repeat(np.arange(n, dtype=np.int64), lens)
    sid = owner[:nw]
    inseq = sid == owner[k - 1 :]
    flat = sid[inseq] * width + idx[inseq]
    binc = np.bincount(flat, minlength=n * width)
    counts += binc.reshape(n, width)
    return counts


def kcounts_device(k: int, seqs: List[str], device="cuda") -> np.ndarray:
    """K-mer counts of an allele batch by kernel K10
    (``kernels/kmer_counts.py``) on ``device``: the card's kernel, or its
    plain version on the CPU. (n, 4^k + 1) float64, bit-identical to
    ``seq2kcounts`` per allele (integer counts). The port of the JAX
    package's ``kcounts_device``; OTTER_TPU_KMER_DEVICE=1 routes
    ``_batch_counts`` through it."""
    import torch

    from ..kernels.kmer_counts import kmer_counts

    n = len(seqs)
    width = int(4 ** k) + 1
    if n == 0:
        return np.zeros((0, width), dtype=np.float64)
    blob = "".join(seqs).encode("latin-1")
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=n)
    if len(blob) >= 2 ** 31:
        raise ValueError("k-mer batch over 2^31 bytes")
    offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    data = np.frombuffer(blob, dtype=np.uint8).copy()
    counts = kmer_counts(torch.from_numpy(data).to(device),
                         torch.from_numpy(offsets).to(device), k)
    return counts.cpu().numpy().astype(np.float64)


def _batch_vecs_vnorms(counts: np.ndarray):
    """(vecs, vnorms) from batch counts — the ONE implementation of the
    normalized-usage formula (same elementwise f64 ops / row reductions as
    the per-allele scalar Kusage.__init__), shared by kusage_batch and the
    lazy cohort view so byte-parity cannot drift between them."""
    totals = counts.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        vecs = np.where(totals[:, None] != 0,
                        counts / np.where(totals[:, None] == 0, 1.0,
                                          totals[:, None]),
                        np.nan)
    vnorms = np.sqrt(np.sum(vecs * vecs, axis=1))
    return vecs, vnorms


def _batch_counts(k: int, seqs: List[str], device="cpu") -> np.ndarray:
    """Batch k-mer counts: K10 on ``device`` with OTTER_TPU_KMER_DEVICE=1
    (the card's kernel, or its plain version on the CPU), else the native
    C++ counts, or with OTTER_TPU_NATIVE_KMER=0 the numpy oracle; a failure
    raises. All give bit-identical integer counts in f64."""
    import os

    if os.environ.get("OTTER_TPU_KMER_DEVICE", "") == "1":
        return kcounts_device(k, seqs, device)
    # native C++ counting kernel (bit-identical integer counts in f64);
    # OTTER_TPU_NATIVE_KMER=0 selects the numpy oracle
    if native.enabled("KMER"):
        return native.kcounts_native(k, seqs)
    return seq2kcounts_np(k, seqs)


class LazyKusages:
    """Sequence view constructing Kusage objects ON DEMAND from the batch
    arrays — the cohort genotype path reads hsdiv for representative
    alleles only, so building 2N+1 objects per region up front was pure
    overhead. Objects are bit-identical to kusage_batch's (same vec view,
    same float vnorm, scalar-on-demand hsdiv)."""

    __slots__ = ("vecs", "vnorms", "_cache")

    def __init__(self, vecs: np.ndarray, vnorms: np.ndarray):
        self.vecs = vecs
        self.vnorms = vnorms
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self.vnorms)

    def __getitem__(self, j):
        if isinstance(j, slice):
            return LazyKusages(self.vecs[j], self.vnorms[j])
        ku = self._cache.get(j)
        if ku is None:
            ku = Kusage.__new__(Kusage)
            ku.vec = self.vecs[j]
            ku.vnorm = float(self.vnorms[j])
            ku._hsdiv = None
            self._cache[j] = ku
        return ku

    def __iter__(self):
        for j in range(len(self.vnorms)):
            yield self[j]


def kusage_batch_arrays(k: int, seqs: List[str], lazy: bool = False,
                        device="cpu"):
    """(kus, vecs (N, 4^k+1) f64, vnorms (N,) f64) — kusage_batch plus the
    underlying batch arrays, so cohort callers can slice views instead of
    re-stacking 4^k-wide rows object by object. ``lazy=True`` returns a
    LazyKusages view in place of the object list (objects materialize only
    where read). ``device``: where OTTER_TPU_KMER_DEVICE=1 counts."""
    width = int(4 ** k) + 1
    if not seqs:
        empty_v = np.zeros((0, width))
        empty_n = np.zeros(0)
        return (LazyKusages(empty_v, empty_n) if lazy else []), \
            empty_v, empty_n
    if lazy:
        vecs, vnorms = _batch_vecs_vnorms(_batch_counts(k, seqs, device))
        return LazyKusages(vecs, vnorms), vecs, vnorms
    kus = kusage_batch(k, seqs, eager_hsdiv=False, device=device)
    vecs = kus[0].vec.base if kus[0].vec.base is not None else None
    if vecs is None or vecs.shape[0] != len(kus):
        vecs = np.stack([ku.vec for ku in kus])
    vnorms = np.asarray([ku.vnorm for ku in kus], dtype=np.float64)
    return kus, vecs, vnorms


def kusage_batch(k: int, seqs: List[str], eager_hsdiv: bool = True,
                 device="cpu") -> List[Kusage]:
    """Kusage objects for an allele batch with vectorized counts and
    vectorized (but bit-identical) Hill-Shannon diversity.

    The scalar hsdiv loop uses math.log (libm); numpy's SIMD np.log
    differs by ~1 ulp on some inputs, so the vectorized form computes
    math.log only over the UNIQUE usage values (typically a few hundred
    across a cohort region) and gathers — exact parity at vector speed.
    The accumulation rides np.cumsum, whose sequential order matches the
    scalar loop (interleaved zero terms add exactly).

    ``eager_hsdiv=False`` skips the batched diversity precompute (a global
    np.unique over every usage value); hsdiv() then computes scalar
    (bit-identical) on demand — the cohort genotype path only ever reads
    it for representative alleles. ``device``: where
    OTTER_TPU_KMER_DEVICE=1 counts."""
    counts = (_batch_counts(k, seqs, device) if seqs
              else seq2kcounts_np(k, seqs))
    # batched Kusage construction: vec = counts/total and
    # vnorm = sqrt(sum(vec*vec)) computed array-wise are elementwise /
    # row-reduction identical to the per-allele scalar __init__ (same
    # IEEE ops per cell; row-wise np.sum matches the 1-D pairwise tree —
    # measured in tests), so the objects are bit-equal without 2n python
    # numpy-call round trips
    n_all = len(seqs)
    kus: List[Kusage] = []
    if n_all:
        vecs_all, vnorms = _batch_vecs_vnorms(counts)
        for i in range(n_all):
            ku = Kusage.__new__(Kusage)
            ku.vec = vecs_all[i]
            ku.vnorm = float(vnorms[i])
            ku._hsdiv = None
            kus.append(ku)
    if kus and eager_hsdiv:
        vecs = vecs_all
        flat = vecs.ravel()
        pos = flat > 0  # NaN rows (total==0) compare False, like the scalar
        vals = flat[pos]
        if vals.size:
            uniq, inv = np.unique(vals, return_inverse=True)
            logs = np.array([math.log(float(u)) for u in uniq])
            term = np.zeros_like(flat)
            term[pos] = vals * logs[inv]
        else:
            term = np.zeros_like(flat)
        acc = np.cumsum(term.reshape(vecs.shape), axis=1)[:, -1]
        for ku, a in zip(kus, acc):
            ku._hsdiv = math.pow(math.e, -float(a))
    return kus
