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
