"""Kernel K2 of the PyTorch port (otter_tpu_torch/kernels/myers_striped.py)
against the JAX package's striped Pallas kernel and the numpy ends-free DP.

Every comparison is exact: the results are integer edit distances, so the
tolerance is zero."""

import random

import numpy as np
import pytest
import torch

from otter_tpu.kernels.myers_striped import (myers_striped_distances,
                                             myers_striped_ends_free)
from otter_tpu.ops.align_np import edit_distance, edit_distance_ends_free
from otter_tpu_torch.kernels import myers_striped as K2

CPU = torch.device("cpu")


def _acgt(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _jobs(rng, count, max_m):
    """One-sided ends-free jobs of every kind the reference emits (frees
    on the text or on the pattern side, begin, end or both) plus zero-free
    jobs; the free-less side is never the longer one."""
    jobs = []
    for k in range(count):
        m = rng.randint(1, max_m)
        ld = rng.randint(0, 60)
        p = _acgt(rng, m)
        t = _acgt(rng, m + ld)
        jobs.append([(p, t, 0, 0, ld, 0), (p, t, 0, 0, 0, ld),
                     (p, t, 0, 0, ld // 2, ld - ld // 2),
                     (t, p, ld, 0, 0, 0), (t, p, 0, ld, 0, 0),
                     (t, p, ld // 2, ld - ld // 2, 0, 0),
                     (p, t, 0, 0, 0, 0)][k % 7])
    return jobs


def test_ends_free_matches_pallas_interpret():
    """The same jobs through the JAX striped kernel (interpret mode) and
    the port's plain version, including a multi-stripe pattern and an
    empty side, equal each other and the numpy ends-free DP (exact)."""
    rng = random.Random(73)
    jobs = _jobs(rng, 14, 250)
    jobs.append(("", "ACGTAC", 0, 0, 2, 1))
    long_p = _acgt(rng, 1100)
    jobs.append((long_p, long_p[:5] + _acgt(rng, 1150), 0, 0, 0, 55))
    want = np.array([edit_distance_ends_free(*j) for j in jobs])
    jax_got = myers_striped_ends_free(jobs, interpret=True)
    got = K2.myers_striped_ends_free(jobs, CPU)
    assert np.array_equal(jax_got, want)
    assert np.array_equal(got, want)


def test_global_distance_matches_pallas_interpret():
    """With no frees K2 is the global distance: the port equals the JAX
    striped kernel on pairs past K1's 2048 bp (exact)."""
    rng = random.Random(71)
    base = _acgt(rng, 1100)
    pairs = [(base, base[:300] + _acgt(rng, 40) + base[320:]),
             (base[:1050], _acgt(rng, 1200))]
    want = myers_striped_distances(pairs, 2048, interpret=True)
    oriented = [(a, b) if len(a) <= len(b) else (b, a) for a, b in pairs]
    zero = np.zeros(len(pairs), dtype=np.int32)
    got = K2.launch_oriented(oriented, zero, zero, CPU).numpy()
    assert np.array_equal(got, want)
    assert got.tolist() == [edit_distance(a, b) for a, b in pairs]


def test_ends_free_longer_free_less_side():
    """The port keeps the free-less side as the pattern even when it is
    the longer side, so the frees stay where the job puts them (exact
    against the numpy DP)."""
    rng = random.Random(75)
    jobs = []
    for _ in range(10):
        t = _acgt(rng, rng.randint(20, 120))
        p = t + _acgt(rng, rng.randint(1, 80))
        tb = rng.randint(0, len(t))
        jobs.append((p, t, 0, 0, tb, 0) if rng.random() < 0.5
                    else (p, t, 0, 0, 0, tb))
    got = K2.myers_striped_ends_free(jobs, CPU)
    assert got.tolist() == [edit_distance_ends_free(*j) for j in jobs]


def test_two_sided_frees_raise():
    """Frees on both sides have no exact K2 mapping: the host wrapper
    raises rather than return a wrong score."""
    with pytest.raises(ValueError):
        K2.myers_striped_ends_free([("ACGT", "ACGTT", 1, 0, 0, 1)], CPU)


def test_striped_cuda_rejects_cpu_tensors():
    """The kernel wrapper never runs the plain version: CPU tensors raise."""
    one = torch.zeros(1, dtype=torch.int32)
    pool = torch.zeros((1, 8), dtype=torch.int32)
    before = K2.myers_striped_cuda.launches
    with pytest.raises(ValueError):
        K2.myers_striped_cuda(pool, one, one, one + 4, one + 4, one, one, 2,
                              16)
    assert K2.myers_striped_cuda.launches == before
