"""The PyTorch port's distance engine (otter_tpu_torch/kernels/edit_engine.py)
on the CPU against the JAX package's engine (Pallas kernels in interpret
mode) and the numpy oracles, over every route.

Every comparison is exact: the results are integer edit distances, so the
tolerance is zero."""

import functools
import random

import numpy as np
import pytest
import torch

from otter_tpu.kernels.edit_pallas import EditDistanceEngine as JaxEngine
from otter_tpu.ops.align_np import edit_distance, edit_distance_ends_free
from otter_tpu_torch.kernels import edit_engine
from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
from otter_tpu_torch.kernels.edit_engine import (EditDistanceEngine,
                                                 IndexedPairs, MeshEngine,
                                                 acgt_flags)
from otter_tpu_torch.kernels.myers_banded import myers_banded_torch
from otter_tpu_torch.kernels.myers_striped import oriented_inputs


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


# the engine's K3 / K4 bands
K_LONG = (63, 127, 255, 511, 1023, 2047)
SENTINEL = 1 << 30


def _ladder_jobs(case):
    """Rung-jumping inputs (seed 91): for ``k3`` and ``mesh`` pairs of
    2.1-2.6 kb ACGT reads at 8-15% divergence, whose banded score at k = 63
    is 154-314; for ``k4`` one-sided jobs of that kind (the read's end
    free) and one 4.5 kb job whose text runs 260 chars past the pattern
    and its free end, so its row m leaves the band at k = 63 and 127 (the
    2^30 sentinel; K3's own admission, n - m <= k, keeps row m in its
    band). Every (m, n) differs, so a launch's jobs are known by it."""
    rng = random.Random(91)
    if case in ("k3", "mesh"):
        jobs = []
        for length, rate in ((2100, 0.08), (2300, 0.10), (2500, 0.12),
                             (2600, 0.15)):
            s = _acgt(rng, length)
            jobs.append((s, _mutate(rng, s, rate)))
        return jobs
    rng = random.Random(92)
    jobs = []
    for length, rate, te in ((2150, 0.08, 30), (2350, 0.10, 40),
                             (2450, 0.12, 20), (2600, 0.15, 50)):
        p = _acgt(rng, length)
        jobs.append((p, _mutate(rng, p, rate) + _acgt(rng, te), 0, 0, 0, te))
    p = _acgt(rng, 4500)
    jobs.append((p, _mutate(rng, p, 0.01) + _acgt(rng, 300), 0, 0, 0, 40))
    p = _acgt(rng, 2500)
    jobs.append((_mutate(rng, p, 0.09) + _acgt(rng, 30), p, 0, 30, 0, 0))
    return jobs


@functools.lru_cache(maxsize=None)
def _jax_results(kind):
    """The JAX engine's results on ``_ladder_jobs(kind)`` (its Pallas
    kernels in interpret mode, its own rung-jumping ladders), None for
    ``k4``'s 4.5 kb job: interpret mode takes minutes on it, and the numpy
    oracle holds it."""
    jobs = _ladder_jobs(kind)
    eng = JaxEngine(mode="pallas", interpret=True)
    if kind != "k4":
        return eng.distances(jobs).tolist()
    keep = [i for i, j in enumerate(jobs) if len(j[0]) < 4000]
    got = eng.ends_free([jobs[i] for i in keep]).tolist()
    out = [None] * len(jobs)
    for i, d in zip(keep, got):
        out[i] = d
    return out


def _oriented(case, jobs):
    """(pattern, text, tb, te) of each job as the K3 / K4 ladder runs it:
    the shorter side, or the free-less one, as the pattern."""
    if case != "k4":
        return [((a, b) if len(a) <= len(b) else (b, a)) + (0, 0)
                for a, b in jobs]
    return [(t, p, pb, pe) if (pb or pe) else (p, t, tb, te)
            for p, t, pb, pe, tb, te in jobs]


def _admissible(case, m, n, tb):
    """The rungs the engine's ladder admits a job to, by its shape alone."""
    if case != "k4":
        return [k for k in K_LONG if n - m <= k <= m * 0.25 and k < n]
    klo = 1 << max(6, (max(tb, 1) - 1).bit_length())
    return [k for k in K_LONG if klo + 2 * k <= m * 0.25 and k < n]


def _scores(oriented, k):
    """Each job's banded score at rung k from the plain K3 / K4 (exact at
    or below k, an upper bound or the sentinel above)."""
    pool, ip, it, nl, ml, tb, te, nw, tl = oriented_inputs(
        [o[:2] for o in oriented], [o[2] for o in oriented],
        [o[3] for o in oriented], torch.device("cpu"))
    return myers_banded_torch(pool, ip, it, nl, ml, tb, te, k, nw,
                              tl).tolist()


def _by_rule(rungs, score, jump):
    """The rungs a job runs at on the ladder ``rungs``: with ``jump``, a
    rung k it fails sends it to the first rung >= min(score, 8 k)."""
    need, ran = 0, []
    for k in rungs:
        if k < need:
            continue
        ran.append(k)
        if score[k] <= k:
            break
        if jump:
            need = min(score[k], 8 * k)
    return ran


@pytest.mark.parametrize("case", ["k3", "k4", "mesh"])
def test_rung_jumping_follows_the_rule(monkeypatch, case):
    """The K3 (``k3``; over a CPU mesh of two shards, ``mesh``) and K4
    (``k4``) ladders on the plain versions: every distance or ends-free
    score equals the numpy oracle's and the JAX engine's; the rungs each
    job was launched at, recorded around ``myers_banded`` /
    ``myers_banded_ef``, are those of need = min(score, 8 k) with the
    plain version's scores, the 2^30 sentinel capped like any score (the
    4.5 kb job runs k = 63, then 511); and fewer rungs run than on the
    ladder without the jumps (exact)."""
    jobs = _ladder_jobs(case)
    oriented = _oriented(case, jobs)
    ran: dict = {}
    name = "myers_banded_ef" if case == "k4" else "myers_banded"
    inner = getattr(edit_engine, name)

    def record(*args, **kw):
        m, n = args[4].tolist(), args[3].tolist()
        k = args[7] if case == "k4" else args[5]
        for key in zip(m, n):
            ran.setdefault(key, []).append(k)
        return inner(*args, **kw)

    monkeypatch.setattr(edit_engine, name, record)
    if case == "k4":
        eng = EditDistanceEngine("cpu")
        got = eng.ends_free(jobs).tolist()
        want = [edit_distance_ends_free(*j) for j in jobs]
    else:
        eng = (MeshEngine((torch.device("cpu"),) * 2) if case == "mesh"
               else EditDistanceEngine("cpu"))
        got = eng.distances(jobs).tolist()
        want = [edit_distance(a, b) for a, b in jobs]
    assert got == want
    jax = _jax_results("k4" if case == "k4" else "k3")
    assert [g for g, j in zip(got, jax) if j is not None] == [
        j for j in jax if j is not None]
    assert jax.count(None) == (1 if case == "k4" else 0)

    shapes = [(len(p), len(t), tb) for p, t, tb, _te in oriented]
    rungs = [_admissible(case, *s) for s in shapes]
    score = {k: _scores(oriented, k) for k in sorted(set(sum(rungs, [])))}
    jumped, plain = [], []
    for i, (m, n, _tb) in enumerate(shapes):
        s = {k: score[k][i] for k in rungs[i]}
        jumped.append(_by_rule(rungs[i], s, True))
        plain.append(_by_rule(rungs[i], s, False))
        assert ran.get((m, n), []) == jumped[-1], (i, s)
    assert sum(map(len, jumped)) < sum(map(len, plain))
    if case == "k4":
        hit = [i for i, r in enumerate(rungs) if score[63][i] == SENTINEL]
        assert any(511 in rungs[i] and jumped[i] == [63, 511] for i in hit)
        counts = eng.counters()
        assert counts["jobs_k4"] + counts["jobs_k2"] == len(jobs)
    else:
        counts = eng.counters()
        assert counts["pairs_k3"] + counts["pairs_k2"] == len(jobs)
        if case == "k3":
            assert eng.ladders == [("K3", [(63, 4, 0), (255, 3, 3),
                                           (511, 1, 1)], 0)]
