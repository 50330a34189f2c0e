"""The port's banded kernels on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode and the numpy
oracles: K3 and K4 (otter_tpu_torch/kernels/myers_banded.py) and K7
(otter_tpu_torch/kernels/edit_banded.py).

Every comparison is exact (integer distances, tolerance zero). A banded
result is exact when it is <= k; above k the contract is only "above k",
so the port and the TPU kernel are held to that there."""

import random

import numpy as np
import pytest
import torch

from otter_tpu.kernels.edit_pallas import (_pack_bucket, edit_banded_numpy,
                                           edit_banded_pallas)
from otter_tpu.kernels.myers_banded import (myers_banded_ends_free_launch,
                                            myers_banded_pool_launch)
from otter_tpu.ops.align_np import edit_distance, edit_distance_ends_free
from otter_tpu_torch.kernels.edit_banded import (edit_banded,
                                                 edit_banded_torch,
                                                 pack_banded)
from otter_tpu_torch.kernels.myers_banded import (myers_banded,
                                                  myers_banded_ef,
                                                  myers_banded_torch)
from otter_tpu_torch.kernels.myers_striped import oriented_inputs

CPU = torch.device("cpu")


def _acgt(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _mutate(rng, s, rate):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate * 0.4:
            out.append(rng.choice("ACGT"))
        elif r < rate * 0.7:
            out.append(ch)
            out.append(rng.choice("ACGT"))
        elif r >= rate:
            out.append(ch)
    return "".join(out) or "A"


def _k3_pairs(rng, n, lo, hi):
    pairs = []
    for _ in range(n):
        p = _acgt(rng, rng.randint(lo, hi))
        pairs.append((p, _mutate(rng, p, rng.choice([0.0, 0.02, 0.1, 0.3]))))
    return pairs


def _k3(pairs, k):
    oriented = [(a, b) if len(a) <= len(b) else (b, a) for a, b in pairs]
    zeros = [0] * len(pairs)
    pool, ip, it, nl, ml, _tb, _te, nw, tl = oriented_inputs(
        oriented, zeros, zeros, CPU)
    return myers_banded(pool, ip, it, nl, ml, k, nw, tl).numpy()


@pytest.mark.parametrize("k", [5, 31, 63, 130])
def test_k3_exact_within_band(k):
    """K3 (plain version) equals the numpy distance wherever it is <= k and
    is an upper bound everywhere; patterns span several 64-char blocks so
    blocks enter and leave the band (exact)."""
    rng = random.Random(31 + k)
    pairs = _k3_pairs(rng, 48, 1, 400)
    got = _k3(pairs, k)
    for (a, b), g in zip(pairs, got):
        d = edit_distance(a, b)
        assert g >= d
        if d <= k:
            assert g == d


def test_k3_matches_tpu_kernel_interpret():
    """The same pairs through the TPU kernel (interpret mode) and the port:
    equal where either is <= k, both above k elsewhere (exact)."""
    rng = random.Random(33)
    pairs = _k3_pairs(rng, 40, 60, 300)
    k = 63
    want = np.asarray(myers_banded_pool_launch(
        pairs, 16, 512, k, interpret=True)).reshape(-1)[: len(pairs)]
    got = _k3(pairs, k)
    for g, w in zip(got.tolist(), want.tolist()):
        assert g == w or (g > k and w > k), (g, w)


def _k4_jobs(rng, n, m_max):
    """One-sided jobs oriented as the kernel takes them: (pattern, text, tb,
    te) with the frees on the text."""
    jobs = []
    for _ in range(n):
        p = _acgt(rng, rng.randint(20, m_max))
        tb, te = rng.randint(0, 40), rng.randint(0, 40)
        t = _acgt(rng, tb) + _mutate(rng, p, rng.choice([0.0, 0.03, 0.1])) \
            + _acgt(rng, te)
        jobs.append((p, t, tb, te))
    return jobs


def _k4(jobs, k):
    pool, ip, it, nl, ml, tb, te, nw, tl = oriented_inputs(
        [j[:2] for j in jobs], [j[2] for j in jobs], [j[3] for j in jobs],
        CPU)
    return myers_banded_ef(pool, ip, it, nl, ml, tb, te, k, nw, tl).numpy()


@pytest.mark.parametrize("k", [15, 31, 63])
def test_k4_exact_within_band(k):
    """K4 (plain version) equals the numpy ends-free DP wherever it is <= k
    and is an upper bound everywhere (exact)."""
    rng = random.Random(41 + k)
    jobs = _k4_jobs(rng, 40, 260)
    got = _k4(jobs, k)
    for (p, t, tb, te), g in zip(jobs, got):
        d = edit_distance_ends_free(p, t, 0, 0, tb, te)
        assert g >= d
        if d <= k:
            assert g == d


def test_k4_matches_tpu_kernel_interpret():
    """The same jobs through the TPU ends-free kernel (interpret mode) and
    the port: equal where either is <= k, both above k elsewhere (exact)."""
    rng = random.Random(43)
    jobs = _k4_jobs(rng, 24, 180)
    k = 31
    want = np.asarray(myers_banded_ends_free_launch(
        jobs, 8, 256, k, 64, interpret=True)).reshape(-1)[: len(jobs)]
    got = _k4(jobs, k)
    for g, w in zip(got.tolist(), want.tolist()):
        assert g == w or (g > k and w > k), (g, w)


def _k7_pairs(rng):
    pairs = []
    for _ in range(30):
        p = "".join(rng.choice("ACGTN") for _ in range(rng.randint(1, 200)))
        pairs.append((p, _mutate(rng, p, rng.choice([0.0, 0.05, 0.2]))))
    pairs += [("ANNA" * 20, "ACNA" * 19), ("N", ""), ("ACGT", "A" * 300)]
    return pairs


@pytest.mark.parametrize("k", [7, 63])
def test_k7_matches_tpu_kernel_interpret(k):
    """K7 on the arrays the TPU launch takes: the port's plain version
    equals the Pallas kernel (interpret mode) and the numpy recurrence on
    every pair, INF lanes included, and the numpy distance where <= k
    (exact)."""
    rng = random.Random(70 + k)
    pairs = _k7_pairs(rng)
    a, bp, mn, L = _pack_bucket(pairs, k, tile_b=8)
    want = np.asarray(edit_banded_pallas(a, bp, mn, k, L, interpret=True,
                                         tile_b=8))
    got = edit_banded_torch(torch.from_numpy(a), torch.from_numpy(bp),
                            torch.from_numpy(mn), k).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, edit_banded_numpy(a, bp, mn[:, 0], mn[:, 1],
                                                 k, L))
    for (x, y), g in zip(pairs, got):
        d = edit_distance(x, y)
        if d <= k:
            assert g == d


def test_k7_port_packing_and_dispatch():
    """pack_banded + edit_banded (CPU tensors take the plain version) give
    the TPU packing's results (exact)."""
    rng = random.Random(77)
    pairs = _k7_pairs(rng)
    k = 63
    a, bp, mn = pack_banded(pairs, k)
    got = edit_banded(*(torch.from_numpy(x) for x in (a, bp, mn)), k).numpy()
    a2, bp2, mn2, L = _pack_bucket(pairs, k, tile_b=1)
    assert np.array_equal(got, edit_banded_numpy(a2, bp2, mn2[:, 0],
                                                 mn2[:, 1], k, L)[: len(pairs)])


def test_banded_inputs_are_checked():
    """Bad shapes and dtypes raise in every version."""
    a = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        edit_banded_torch(a, torch.zeros((2, 5), dtype=torch.int32),
                          torch.zeros((2, 2), dtype=torch.int32), 1)
    pool = torch.zeros((2, 8), dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        myers_banded_torch(pool, one, one, one.to(torch.int64), one, one,
                           one, 3, 2, 16)
