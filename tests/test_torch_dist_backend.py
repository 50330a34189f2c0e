"""The port's ``TorchDistBackend.fill_matrix`` and ``.pair_dist_fn``
(otter_tpu_torch/kernels/dist_backend.py) on the CPU against the port's
host ``fill_dist_matrix`` and the JAX package's ``DeviceDistBackend("cpu")``
on ``tests/test_dist_backend.py``'s 12 reads (seed 51), with and without
the haplotag shortcut.

Every comparison is exact: the matrices are float64 quotients of exact
integer distances, compared bit for bit."""

import random

import numpy as np
import pytest

from otter_tpu.kernels.dist_backend import DeviceDistBackend
from otter_tpu.ops.distmat import DistMatrix as JaxDistMatrix
from otter_tpu.seqs.model import Haplotag as JaxHaplotag
from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
from otter_tpu_torch.ops.consensus import fill_dist_matrix, get_dist_anreads
from otter_tpu_torch.ops.distmat import DistMatrix
from otter_tpu_torch.seqs.model import AnRead, Haplotag

from test_dist_backend import _reads


def _both_reads():
    """The 12 reads of seed 51 as the JAX package's and the port's AnRead,
    every third without a haplotag and the rest on two haplotypes of one
    phase set, so the shortcut gives 0 and 1."""
    jax_reads = _reads(random.Random(51), 12, 300)
    port_reads = []
    for i, r in enumerate(jax_reads):
        if i % 3:
            r.hpt = JaxHaplotag(ps=7, hp=i % 2)
        hpt = Haplotag(ps=r.hpt.ps, hp=r.hpt.hp)
        port_reads.append(AnRead(seq=r.seq, name=r.name, hpt=hpt,
                                 is_spanning_l=True, is_spanning_r=True))
    return jax_reads, port_reads


@pytest.mark.parametrize("ignore_haps", [True, False])
def test_fill_matrix_equals_host_and_jax(ignore_haps):
    """``fill_matrix`` on the plain versions writes the port's host
    ``fill_dist_matrix`` matrix and the JAX backend's, bit for bit, over a
    subset of the reads in a shuffled order."""
    jax_reads, reads = _both_reads()
    indeces = [5, 0, 11, 3, 8, 1, 9, 2, 7]
    want = DistMatrix(len(indeces))
    fill_dist_matrix(ignore_haps, reads, indeces, want)
    got = DistMatrix(len(indeces))
    backend = TorchDistBackend("cpu")
    backend.fill_matrix(ignore_haps, reads, indeces, got)
    jax_dm = JaxDistMatrix(len(indeces))
    DeviceDistBackend("cpu").fill_matrix(ignore_haps, jax_reads, indeces,
                                         jax_dm)
    assert np.array_equal(got.values, want.values)
    assert np.array_equal(got.values, jax_dm.values)
    assert len(np.unique(got.values)) > (2 if ignore_haps else 1)
    # the shortcut aligns nothing; otherwise one engine call, all on K1
    assert backend.engine.pairs_k1 == (36 if ignore_haps else 0)


def test_pair_dist_fn_equals_get_dist_anreads():
    """``pair_dist_fn`` is ``get_dist_anreads`` with the haplotags
    ignored, on every pair, whatever the reads' haplotags (exact)."""
    jax_reads, reads = _both_reads()
    fn = TorchDistBackend("cpu").pair_dist_fn(reads)
    jax_fn = DeviceDistBackend("cpu").pair_dist_fn(jax_reads)
    for i in range(len(reads)):
        for j in range(i + 1, len(reads)):
            d = fn(reads[i], reads[j])
            assert d == get_dist_anreads(True, reads[i], reads[j])
            assert d == jax_fn(jax_reads[i], jax_reads[j])
    assert fn(reads[0], reads[0]) == 0.0


def test_fill_matrix_of_one_read_writes_nothing():
    """One read has no pair: the matrix is left as it was."""
    _jax_reads, reads = _both_reads()
    dm = DistMatrix(1)
    TorchDistBackend("cpu").fill_matrix(True, reads, [4], dm)
    assert dm.values.size == 0
