"""The PyTorch port's distance engine (otter_tpu_torch/kernels/edit_engine.py)
on the CPU against the JAX package's engine (Pallas kernels in interpret
mode) and the numpy oracles, over every route.

Every comparison is exact: the results are integer edit distances, so the
tolerance is zero."""

import random

import numpy as np
import pytest
import torch

from otter_tpu.kernels.edit_pallas import EditDistanceEngine as JaxEngine
from otter_tpu.ops.align_np import edit_distance, edit_distance_ends_free
from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
from otter_tpu_torch.kernels.edit_engine import (EditDistanceEngine,
                                                 IndexedPairs, acgt_flags)


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
    return "".join(out)


def _route_pairs(rng):
    """Pairs for every distance route: K1 buckets, K3 (shorter side past
    2048 bp, within a band), K2 (past 2048 bp, no band fits), K7
    (non-ACGT), and the equal / empty shortcuts."""
    pairs = []
    for lo, hi in ((1, 128), (129, 256), (257, 400)):
        for _ in range(6):
            s = _acgt(rng, rng.randint(lo, hi))
            pairs.append((s, _mutate(rng, s, 0.05) or "A"))
    long_a = _acgt(rng, 2100)
    pairs.append((long_a, long_a + _acgt(rng, 650)))
    long_b = _acgt(rng, 2300)
    pairs.append((long_b, _mutate(rng, long_b, 0.01)))
    pairs.append(("ACGTNACGT" * 5, "ACGTACGT" * 6))
    s = _acgt(rng, 50)
    pairs += [(s, s), ("", "ACGT"), ("ACG", "")]
    return pairs


def test_distances_match_jax_engine_and_oracle():
    """distances() on torch-cpu equals the JAX engine in pallas interpret
    mode and the numpy DP on every route (exact); the counters record
    the routes."""
    rng = random.Random(81)
    pairs = _route_pairs(rng)
    eng = EditDistanceEngine("cpu")
    got = eng.distances(pairs)
    want = [edit_distance(a, b) for a, b in pairs]
    assert got.tolist() == want
    assert np.array_equal(got, JaxEngine(mode="pallas",
                                         interpret=True).distances(pairs))
    assert (eng.pairs_k1, eng.pairs_k3, eng.pairs_k2, eng.pairs_k7) == (
        18, 1, 1, 1)
    assert eng.mode == "torch-cpu"


def test_distances_indexed_all_vs_all():
    """The indexed form over an all-vs-all set (shared sequence objects,
    equal-length orientation ties) equals the numpy DP (exact)."""
    rng = random.Random(82)
    base = _acgt(rng, 300)
    seqs = [base] + [_mutate(rng, base, 0.05) for _ in range(9)]
    seqs.append(_acgt(rng, 300))
    xi, yi = np.triu_indices(len(seqs), 1)
    eng = EditDistanceEngine("cpu")
    got = eng.distances_indexed(seqs, xi, yi)
    assert got.tolist() == [edit_distance(seqs[i], seqs[j])
                            for i, j in zip(xi, yi)]
    assert eng.pairs_k1 == len(xi)


def test_ends_free_match_jax_engine_and_oracle():
    """ends_free() routes one-sided ACGT jobs to K2 (K4 first when the
    free-less side is past 2048 bp), zero-free jobs to the distance path
    and the rest (two-sided, non-ACGT) to the host DP; the results equal
    the JAX engine in interpret mode and the numpy DP (exact)."""
    rng = random.Random(83)
    jobs = []
    for k in range(8):
        m = rng.randint(30, 200)
        ld = rng.randint(1, 40)
        p = _acgt(rng, m)
        t = _mutate(rng, p, 0.05) + _acgt(rng, ld)
        jobs.append([(t, p, 0, ld, 0, 0), (p, t, 0, 0, 0, ld),
                     (p, t, 0, 0, ld, 0), (p, t, 0, 0, 0, 0)][k % 4])
    jobs.append(("ACGTTGCA" * 4, "ACGTTGCA" * 5, 1, 0, 0, 2))
    jobs.append(("ACGNNACG" * 3, "ACGTACGT" * 3, 0, 0, 2, 0))
    jobs.append(("ACGT" * 5, "ACGT" * 5, 0, 0, 3, 0))
    long_p = _acgt(rng, 2200)
    jobs.append((long_p, _mutate(rng, long_p, 0.01) + _acgt(rng, 40),
                 0, 0, 0, 40))
    eng = EditDistanceEngine("cpu")
    got = eng.ends_free(jobs)
    assert got.tolist() == [edit_distance_ends_free(*j) for j in jobs]
    assert np.array_equal(got, JaxEngine(mode="pallas",
                                         interpret=True).ends_free(jobs))
    assert (eng.jobs_k2, eng.jobs_k4, eng.jobs_host) == (6, 1, 2)
    assert eng.pairs_k1 == 2


def test_async_handles_collect_in_any_order():
    """Two launches in flight at once collect to the synchronous results."""
    rng = random.Random(84)
    pairs = [(_acgt(rng, 90), _acgt(rng, 120)) for _ in range(12)]
    jobs = [(p, t, 0, 0, 0, 30) for p, t in pairs]
    eng = EditDistanceEngine("cpu")
    hd = eng.distances_async(pairs)
    he = eng.ends_free_async(jobs)
    ef = eng.ends_free_collect(he)
    d = eng.distances_collect(hd)
    assert d.tolist() == [edit_distance(a, b) for a, b in pairs]
    assert ef.tolist() == [edit_distance_ends_free(*j) for j in jobs]


def test_indexed_pairs_view():
    """IndexedPairs materialises the right pairs and lengths, and
    acgt_flags marks exactly the pure-ACGT sequences (exact)."""
    seqs = ["AC", "ACGT", "G"]
    pv = IndexedPairs(seqs, [0, 2], [1, 1])
    assert len(pv) == 2
    assert pv[1] == ("G", "ACGT")
    assert list(pv) == [("AC", "ACGT"), ("G", "ACGT")]
    assert pv.maxlens().tolist() == [4, 4]
    assert acgt_flags(["ACGT", "ACNT", "", "é", "A☃C", "GT"]).tolist() == [
        True, False, True, False, False, True]


def test_cuda_request_without_card_raises(monkeypatch):
    """No silent fall back: asking for the card where there is none
    raises, in the engine and in the backend."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        EditDistanceEngine("cuda")
    with pytest.raises(RuntimeError):
        TorchDistBackend("cuda")
    assert TorchDistBackend("cpu").engine.mode == "torch-cpu"
