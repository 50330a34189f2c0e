"""K10, the port's k-mer counts (otter_tpu_torch/kernels/kmer_counts.py,
csrc/kmer_counts.cu), on the CPU against ``otter_tpu``'s
``kcounts_device`` (jnp) and its scalar ``seq2kcounts``; the CUDA source on
the g++ warp emulation against the plain version; the
OTTER_TPU_KMER_DEVICE=1 route of ``kusage_batch``. Counts are integers:
every comparison is exact."""

import ctypes
import random

import numpy as np
import pytest
import torch

from otter_tpu.seqs.kmer import kcounts_device as reference_kcounts_device
from otter_tpu.seqs.kmer import kusage_batch as reference_kusage_batch
from otter_tpu.seqs.kmer import seq2kcounts
from otter_tpu_torch.kernels import kmer_counts as K10
from otter_tpu_torch.seqs.kmer import kcounts_device, kusage_batch

from test_torch_affine_emulated import build_emulated

SOURCE = K10.__file__.rsplit("/", 2)[0] + "/csrc/kmer_counts.cu"


def _alleles(seed, count, hi):
    """ACGT in both cases with N and other bytes, empty strings and
    sequences shorter than k among them."""
    rng = random.Random(seed)
    seqs = ["".join(rng.choice("ACGTacgtNNx") for _ in
                    range(rng.randrange(0, hi))) for _ in range(count)]
    return seqs + ["", "A", "AC", "ACG", "NN" * 20, "acgtACGT"]


def _packed(seqs):
    blob = "".join(seqs).encode()
    offsets = np.zeros(len(seqs) + 1, dtype=np.int32)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    return (torch.from_numpy(np.frombuffer(blob, dtype=np.uint8).copy()),
            torch.from_numpy(offsets))


@pytest.mark.parametrize("k", [1, 3, 6])
def test_kcounts_match_reference(k):
    """The port's kcounts_device (K10's plain version on the CPU) equals
    the JAX function and the scalar oracle, allele for allele."""
    seqs = _alleles(11 + k, 25, 300)
    got = kcounts_device(k, seqs, "cpu")
    assert got.dtype == np.float64
    assert np.array_equal(got, reference_kcounts_device(k, seqs))
    for s, row in zip(seqs, got):
        assert np.array_equal(row, seq2kcounts(k, s)), s


def test_kcounts_empty_batch():
    assert kcounts_device(3, [], "cpu").shape == (0, 65)


@pytest.mark.parametrize("k", [0, 16])
def test_kmer_counts_refuses_k(k):
    """k outside 1..15 (4^k + 1 counts an allele must fit int32 indices)
    raises rather than counting wrong."""
    with pytest.raises(ValueError):
        K10.kmer_counts_torch(*_packed(["ACGT"]), k)


def test_kusage_device_route(monkeypatch):
    """OTTER_TPU_KMER_DEVICE=1 sends kusage_batch through K10 with the
    objects of the JAX package's route (vec, vnorm, hsdiv bit for bit)."""
    seqs = ["ACGTACGTAC", "TTTTT", "", "ACGNNNACG"] + _alleles(3, 8, 120)
    calls = []
    real = K10.kmer_counts_torch
    monkeypatch.setattr(K10, "kmer_counts_torch",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("OTTER_TPU_KMER_DEVICE", "1")
    got = kusage_batch(3, seqs, device="cpu")
    want = reference_kusage_batch(3, seqs)
    assert calls
    for a, b in zip(got, want):
        assert np.array_equal(a.vec, b.vec, equal_nan=True)
        assert a.vnorm == b.vnorm or (np.isnan(a.vnorm) and np.isnan(b.vnorm))
        assert a.hsdiv() == b.hsdiv()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """kmer_counts.cu built for the host against the emulated CUDA names."""
    so = build_emulated(tmp_path_factory, SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.otter_kmer_counts.restype = I
    so.otter_kmer_counts.argtypes = [P, P, I, I, P, P]
    return so


@pytest.mark.parametrize("k", [1, 3, 7, 8])
def test_cuda_source_emulated_matches_plain(emulated, k):
    """The CUDA source at k = 1, 3 and 7 (shared-memory histograms) and 8
    (4^8 + 1 counts: device-memory atomics into a cleared output) equals
    the plain version exactly."""
    seqs, offsets = _packed(_alleles(k, 12, 200))
    want = K10.kmer_counts_torch(seqs, offsets, k)
    got = torch.zeros_like(want)
    assert emulated.otter_kmer_counts(seqs.data_ptr(), offsets.data_ptr(),
                                      len(offsets) - 1, k, got.data_ptr(),
                                      None) == 0
    assert torch.equal(got, want)


def _edge_alleles(seed):
    """Alleles of every length 0-13 and a few past a 32-word tile (up to
    300 bytes), so starts and ends fall at every offset of a 4-byte word;
    non-ACGT bytes (N, n, x, a NUL) on word edges of the packed blob."""
    rng = random.Random(seed)
    lens = list(range(14)) + [31, 32, 33, 127, 128, 129, 130, 131, 257, 300]
    rng.shuffle(lens)
    seqs = ["".join(rng.choice("ACGTacgt") for _ in range(n)) for n in lens]
    blob = bytearray("".join(seqs).encode())
    for pos in range(3, len(blob), 4):
        if rng.random() < 0.15:
            blob[pos] = ord(rng.choice("Nnx\0"))
            if pos + 1 < len(blob) and rng.random() < 0.5:
                blob[pos + 1] = ord("N")
    out, at = [], 0
    for n in lens:
        out.append(blob[at : at + n].decode("latin-1"))
        at += n
    return out


def _emulated_counts(so, seqs, offsets, k):
    want = K10.kmer_counts_torch(seqs, offsets, k)
    got = torch.full_like(want, -7) if want.shape[1] <= 4 ** 7 + 1 \
        else torch.zeros_like(want)  # the device-memory route adds in
    assert so.otter_kmer_counts(seqs.data_ptr(), offsets.data_ptr(),
                                len(offsets) - 1, k, got.data_ptr(),
                                None) == 0
    return got, want


@pytest.mark.parametrize("k", [1, 2, 3, 5, 6, 8, 10])
def test_cuda_source_emulated_word_edges(emulated, k):
    """The CUDA source at k = 1 (no lane ahead), 2-5 (one), 6 and 8 (two)
    and 10 (three; device-memory histograms from k = 8, shared ones of 1, 2
    and 8 warps a block below): alleles of every length mod 4, shorter than
    k and empty, over several tiles, non-ACGT bytes on word edges; every
    count equal to the plain version's and the scalar oracle's, the shared
    histograms written out whole (no -7 left)."""
    alleles = _edge_alleles(k)
    if k == 10:  # 4^10 + 1 counts an allele
        alleles = alleles[:: 4] + ["", "ACGTNACGTACG" * 3]
    seqs, offsets = _packed(alleles)
    got, want = _emulated_counts(emulated, seqs, offsets, k)
    assert torch.equal(got, want)
    for s, row in zip(alleles, want):
        assert np.array_equal(row.numpy(), seq2kcounts(k, s)), s


def test_cuda_source_refuses_unaligned_seqs(emulated):
    """The CUDA source reads 4-byte words: a seqs pointer off a word
    boundary is refused (a CUDA error, nothing counted)."""
    seqs, offsets = _packed(["ACGTACGT", "ACG"])
    got = torch.full((2, 65), -7, dtype=torch.int32)
    assert emulated.otter_kmer_counts(seqs.data_ptr() + 1, offsets.data_ptr(),
                                      2, 3, got.data_ptr(), None) != 0
    assert (got == -7).all()
