"""K11, the port's average linkage (otter_tpu_torch/kernels/linkage.py,
csrc/linkage.cu, ops/hclust_device.py), on the CPU against ``otter_tpu``'s
``average_linkage_device`` / ``hclust_average_device`` (jnp under XLA on
the CPU): merges and float32 heights bit for bit; the CUDA source on the
g++ warp emulation against the plain version; the port's
``_hclust_route`` against the JAX package's."""

import ctypes
import random
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from otter_tpu.ops import cluster as reference_cluster
from otter_tpu.ops.distmat import DistMatrix as ReferenceDistMatrix
from otter_tpu.ops.hclust import cutree_cdist, hclust_average
from otter_tpu.ops.hclust_device import (
    average_linkage_device as reference_linkage,
    hclust_average_device as reference_hclust_device)
from otter_tpu_torch.kernels import linkage as K11
from otter_tpu_torch.ops import cluster
from otter_tpu_torch.ops.distmat import DistMatrix
from otter_tpu_torch.ops.hclust_device import (average_linkage_device,
                                               hclust_average_device)
from otter_tpu_torch.utils import metrics

from test_torch_affine_emulated import build_emulated

SOURCE = K11.__file__.rsplit("/", 2)[0] + "/csrc/linkage.cu"


def _square(n, seed):
    """(n, n) float32 symmetric distances from seeded condensed values."""
    cond = np.random.default_rng(seed).random(n * (n - 1) // 2)
    sq = np.zeros((n, n), dtype=np.float32)
    sq[np.triu_indices(n, 1)] = cond
    return sq + sq.T, cond


def _reference_records(sq):
    """The JAX function's first n - 1 records on its own padding."""
    n = sq.shape[0]
    n_pad = max(8, 1 << (n - 1).bit_length())
    padded = np.zeros((n_pad, n_pad), dtype=np.float32)
    padded[:n, :n] = sq
    recs, hs = reference_linkage(jnp.asarray(padded), jnp.int32(n), n_pad)
    return np.asarray(recs)[: n - 1], np.asarray(hs)[: n - 1]


def _unfused(sq):
    """The JAX algorithm in numpy float32 with the merged row as a separate
    multiply and add: what a port that does not reproduce XLA's fma
    computes."""
    n = sq.shape[0]
    inf = np.float32(3.0e38)
    D = sq.copy()
    np.fill_diagonal(D, inf)
    size = np.ones(n, dtype=np.float32)
    active = np.ones(n, dtype=bool)
    upper = np.triu(np.ones((n, n), dtype=bool), 1)
    hs = []
    for _ in range(n - 1):
        M = np.where(active[:, None] & active[None, :] & upper, D, inf)
        i, j = divmod(int(np.argmin(M)), n)
        hs.append(M[i, j])
        si, sj = size[i], size[j]
        with np.errstate(over="ignore", invalid="ignore"):
            row = (si * D[i] + sj * D[j]) / np.maximum(si + sj,
                                                       np.float32(1))
        D[i] = row
        D[:, i] = row
        D[i, i] = inf
        size[i] = si + sj
        size[j] = 0
        active[j] = False
    return np.asarray(hs, dtype=np.float32)


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("n,seed", [(3, 0), (17, 1), (64, 2), (129, 3)])
def test_linkage_matches_reference(n, seed):
    """K11's plain version: merges and heights bit for bit."""
    sq, _cond = _square(n, seed)
    recs, hs = average_linkage_device(sq, "cpu")
    want_r, want_h = _reference_records(sq)
    assert np.array_equal(recs, want_r)
    assert np.array_equal(_bits(hs), _bits(want_h))


def test_linkage_fma_case():
    """n = 40, seed 0: the merged row as a separate multiply and add gives
    a different height than the JAX function (whose XLA contraction is
    fma(si, D[i], sj D[j])); the port equals the JAX function."""
    sq, _cond = _square(40, 0)
    want_r, want_h = _reference_records(sq)
    assert not np.array_equal(_bits(_unfused(sq)), _bits(want_h))
    recs, hs = average_linkage_device(sq, "cpu")
    assert np.array_equal(recs, want_r)
    assert np.array_equal(_bits(hs), _bits(want_h))


@pytest.mark.parametrize("n", [5, 23, 64])
def test_hclust_average_device_matches_reference(n):
    """R-convention (merge, height) equal to the JAX package's."""
    _sq, cond = _square(n, 100 + n)
    merge, height = hclust_average_device(cond, n, "cpu")
    want_m, want_h = reference_hclust_device(cond, n)
    assert np.array_equal(merge, want_m)
    assert np.array_equal(height, want_h)


def _fma_exact(a, b, c):
    """fl32(a b + c) from exact rationals, ties to even."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    dist = [abs(Fraction(float(x)) - exact) for x in cands]
    best = min(dist)
    ties = [x for x, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda x: int(np.float32(x).view(np.int32)) & 1)


def test_fma_f32_rounds_once():
    """K11's plain fma: once-rounded against exact rationals, including
    products that land on a float32 midpoint with a small addend, where a
    float64 sum rounded to float32 would round twice (24929 x 673 =
    2^24 + 1, with + 2^-30 rounds up to 2^24 + 2)."""
    rng = np.random.default_rng(7)
    a = np.concatenate([[24929, 24929, 3, 7], rng.integers(1, 500, 400)
                        ]).astype(np.float32)
    b = np.concatenate([[673, 673], rng.random(402)]).astype(np.float32)
    c = np.concatenate([[2.0 ** -30, -(2.0 ** -30)], rng.random(402)]
                       ).astype(np.float32)
    got = K11.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    want = np.asarray([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)],
                      dtype=np.float32)
    assert got[0] == np.float32(2 ** 24 + 2) and got[1] == np.float32(2 ** 24)
    assert np.array_equal(_bits(got), _bits(want))


def _canon(labels):
    seen = {}
    return [seen.setdefault(l, len(seen)) for l in labels]


@pytest.mark.parametrize("trial", range(4))
def test_device_linkage_partitions_match_host(trial):
    """The JAX package's test_device_linkage_matches_host on K11: the same
    partitions as the host NN-chain at three cuts."""
    rng = random.Random(41 + trial)
    n = rng.randrange(3, 24)
    cond = np.array([rng.random() for _ in range(n * (n - 1) // 2)])
    mh, hh = hclust_average(n, cond)
    md, hd = hclust_average_device(cond, n, "cpu")
    assert np.allclose(np.sort(hh), np.sort(hd), atol=1e-5)
    for cut in (0.25, 0.5, 0.75):
        assert _canon(cutree_cdist(n, mh, hh, cut).tolist()) == _canon(
            cutree_cdist(n, md, hd, cut).tolist())


@pytest.mark.parametrize("case", ["forced", "ties", "disabled", "small"])
def test_hclust_route_matches_reference(case, monkeypatch):
    """The port's cohort route against the JAX package's, with the
    setting forced (tie-free: K11 serves, counted), on a tie matrix
    (tests/test_hclust_device.py's: the guard declines, counted), set to
    0, and by default below n = 64 on the CPU (neither tries the device)."""
    env = {"forced": "1", "ties": "1", "disabled": "0", "small": ""}[case]
    monkeypatch.setenv("OTTER_TPU_HCLUST_DEVICE", env)
    n = 8 if case == "ties" else 17
    vals = (np.round(np.linspace(0.1, 0.9, n * (n - 1) // 2), 1)
            if case == "ties" else np.random.default_rng(n).random(
                n * (n - 1) // 2))
    metrics.reset()
    got = cluster.cluter_to_e(0.4, n, DistMatrix(n, vals.copy()))
    snap = metrics.snapshot()
    want = reference_cluster.cluter_to_e(0.4, n, ReferenceDistMatrix(
        n, vals.copy()))
    assert got == want
    assert snap.get("count.hclust_device", 0) == (case == "forced")
    assert snap.get("count.hclust_device_declined", 0) == (case == "ties")


def test_hclust_route_default_on_card_only(monkeypatch):
    """By default K11 is tried for n >= 64 when the caller's device is a
    card, never on the CPU; a device that is a card with no card present
    raises (no fallback)."""
    monkeypatch.delenv("OTTER_TPU_HCLUST_DEVICE", raising=False)
    n = 64
    vals = np.random.default_rng(5).random(n * (n - 1) // 2)
    metrics.reset()
    cluster._hclust_route(n, vals, 0.4, "cpu")
    assert not metrics.snapshot().get("count.hclust_device", 0)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            cluster._hclust_route(n, vals, 0.4, "cuda")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """linkage.cu built for the host against the emulated CUDA names."""
    so = build_emulated(tmp_path_factory, SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.otter_linkage.restype = I
    so.otter_linkage.argtypes = [P, I, I, P, P, P, P]
    so.otter_linkage_route.restype = I
    so.otter_linkage_route.argtypes = [P, I, I, P, P, P, I, I, P]
    so.otter_linkage_plan.restype = I
    so.otter_linkage_plan.argtypes = [I, P, P, P]
    so.emu_set_stagger.argtypes = [I]
    so.emu_set_max_cluster.argtypes = [I]
    return so


@pytest.mark.parametrize("n,mats,route,cluster,stagger", [
    (2, 1, None, 0, 0), (40, 2, None, 0, 0), (129, 1, None, 0, 0),
    (240, 1, "l2", 0, 0), (96, 1, None, 0, 1), (96, 1, None, 0, -1),
    (300, 1, None, 0, 0), (40, 2, "cluster", 3, 0),
    (40, 1, "cluster", 4, 1), (40, 1, "cluster", 4, -1),
    (60, 1, "cluster", 16, 0), (60, 1, "cluster", 1, 1)])
def test_cuda_source_emulated_matches_plain(emulated, n, mats, route,
                                            cluster, stagger):
    """The CUDA source equals the plain version bit for bit on each route:
    D in shared memory (n <= 224; two matrices, a block each), in
    device-memory scratch (n = 240, the L2 route forced), and its upper
    triangle in a cluster's shared memory (n = 300 by the plan: two
    blocks; n = 40 and 60 with 1, 3, 4 and 16 blocks forced, the blocks of
    a cluster run together); also with the warps run one at a time between barriers,
    from the first and from the last (``emu_set_stagger``; over all the
    cluster's warps at a cluster barrier), so a warp's writes before a
    barrier land ahead of the other warps' reads after it."""
    emulated.emu_set_stagger(stagger)
    D = torch.from_numpy(np.stack([_square(n, 7 * n + m)[0]
                                   for m in range(mats)]))
    want_r, want_h = K11.linkage_torch(D)
    recs = torch.empty_like(want_r)
    hs = torch.empty_like(want_h)
    scratch = torch.empty_like(D)
    args = (D.data_ptr(), n, mats, scratch.data_ptr(), recs.data_ptr(),
            hs.data_ptr())
    try:
        if route is None:
            assert emulated.otter_linkage(*args, None) == 0
        else:
            assert emulated.otter_linkage_route(
                *args, K11.ROUTES.index(route), cluster, None) == 0
    finally:
        emulated.emu_set_stagger(0)
    assert torch.equal(recs, want_r)
    assert np.array_equal(_bits(hs.numpy()), _bits(want_h.numpy()))


def test_linkage_plan_routes_by_n(emulated):
    """K11's route by n alone: one block while D and the block's state fit
    200 KB (n <= 224), then the smallest cluster of two or more blocks
    that each hold their share of the upper triangle in 227 KB (two to n =
    473, ten at genotype500's n = 1,001, sixteen at the last, n = 1,312),
    then the L2 route up to N_MAX; a forced cluster too small for the
    triangle is refused."""
    plans = {n: K11.linkage_plan(n, emulated) for n in range(2, 1400)}
    assert all(plans[n][0] == "shared" for n in range(2, 225))
    assert plans[225] == ("cluster", 2, plans[225][2])
    assert plans[473][:2] == ("cluster", 2)
    assert plans[474][:2] == ("cluster", 3)
    assert plans[1001][:2] == ("cluster", 10)
    cluster = [n for n in plans if plans[n][0] == "cluster"]
    assert cluster == list(range(225, 1313))
    assert plans[1312][1] == 16
    assert all(plans[n][0] == "l2" for n in range(1313, 1400))
    assert all(plans[n][2] <= 227 * 1024 for n in cluster)
    assert K11.linkage_plan(K11.N_MAX, emulated)[0] == "l2"
    with pytest.raises(ValueError):
        K11.linkage_plan(K11.N_MAX + 1, emulated)
    D = torch.from_numpy(_square(400, 1)[0][None])
    recs = torch.empty((1, 399, 2), dtype=torch.int32)
    hs = torch.empty((1, 399))
    assert emulated.otter_linkage_route(
        D.data_ptr(), 400, 1, D.data_ptr(), recs.data_ptr(), hs.data_ptr(),
        K11.ROUTES.index("cluster"), 1, None) != 0


def test_linkage_plan_refused_cluster_takes_l2(emulated):
    """On a card that cannot place the cluster the plan would pick (the
    emulated card's clusters capped at 4 blocks, then at 1), the plan takes
    the L2 route (n = 1,001 wants 10 blocks, n = 300 two), the default
    launch there equals the plain version, and a forced launch of a
    cluster the card cannot place returns an error (which ``linkage_cuda``
    raises) and writes nothing."""
    n = 300
    D = torch.from_numpy(_square(n, 3)[0][None])
    want_r, want_h = K11.linkage_torch(D)
    recs = torch.zeros_like(want_r)
    hs = torch.zeros_like(want_h)
    scratch = torch.empty_like(D)
    args = (D.data_ptr(), n, 1, scratch.data_ptr(), recs.data_ptr(),
            hs.data_ptr())
    try:
        emulated.emu_set_max_cluster(4)
        assert K11.linkage_plan(1001, emulated)[:2] == ("l2", 1)
        assert K11.linkage_plan(474, emulated)[:2] == ("cluster", 3)
        assert K11.linkage_plan(n, emulated)[:2] == ("cluster", 2)
        emulated.emu_set_max_cluster(1)
        assert K11.linkage_plan(n, emulated)[:2] == ("l2", 1)
        assert emulated.otter_linkage_route(
            *args, K11.ROUTES.index("cluster"), 2, None) != 0
        assert not recs.any() and not hs.any()
        assert emulated.otter_linkage(*args, None) == 0
    finally:
        emulated.emu_set_max_cluster(16)
    assert torch.equal(recs, want_r)
    assert np.array_equal(_bits(hs.numpy()), _bits(want_h.numpy()))


def test_genotype_vntr_k11_route_byte_identical(tmp_path, monkeypatch):
    """genotype on a VNTR cohort (a length allele a haplotype: tie-free
    length matrices) with OTTER_TPU_NATIVE_HCLUST=0 and
    OTTER_TPU_HCLUST_DEVICE=1: K11's plain version serves matrices, and the
    VCF is otter_tpu --device host's, byte for byte."""
    import io

    from otter_tpu.config import OtterOpts
    from otter_tpu.models.genotype import genotype as reference_genotype
    from otter_tpu_torch.config import OtterOpts as PortOpts
    from otter_tpu_torch.models.genotype import genotype
    from otter_tpu_torch.utils.synth import cohort_fixture

    bam, bed, fa = cohort_fixture(str(tmp_path), 16, 4, 41, vntr=True)
    host = OtterOpts()
    host.device = "host"
    want = io.StringIO()
    reference_genotype(host, bam, bed, fa, out=want)
    monkeypatch.setenv("OTTER_TPU_NATIVE_HCLUST", "0")
    monkeypatch.setenv("OTTER_TPU_HCLUST_DEVICE", "1")
    metrics.reset()
    got = io.StringIO()
    genotype(PortOpts(device="cpu"), bam, bed, fa, out=got)
    assert got.getvalue() == want.getvalue()
    assert want.getvalue().count("\n") > 4
    assert metrics.snapshot().get("count.hclust_device", 0) > 0


def test_genotype_vntr_prime_lengths_every_length_matrix(tmp_path,
                                                         monkeypatch):
    """A VNTR cohort whose haplotypes take distinct prime lengths
    (``prime_lengths``, as ``chip_smoke.py``'s vntr128) at a length cut of
    0.1 (genotype -e 0.1): every region's length matrix passes the
    exactness guards and takes K11 (its plain version here), and the VCF is
    otter_tpu --device host's, byte for byte."""
    import io

    from otter_tpu.config import OtterOpts
    from otter_tpu.models.genotype import genotype as reference_genotype
    from otter_tpu_torch.config import OtterOpts as PortOpts
    from otter_tpu_torch.models.genotype import genotype
    from otter_tpu_torch.utils.synth import cohort_fixture

    bam, bed, fa = cohort_fixture(str(tmp_path), 24, 3, 41, vntr=True,
                                  prime_lengths=True)
    host = OtterOpts()
    host.device = "host"
    host.init_max_error(0.1)
    want = io.StringIO()
    reference_genotype(host, bam, bed, fa, out=want)
    monkeypatch.setenv("OTTER_TPU_NATIVE_HCLUST", "0")
    monkeypatch.setenv("OTTER_TPU_HCLUST_DEVICE", "1")
    metrics.reset()
    opts = PortOpts(device="cpu")
    opts.init_max_error(0.1)
    got = io.StringIO()
    genotype(opts, bam, bed, fa, out=got)
    assert got.getvalue() == want.getvalue()
    assert metrics.snapshot().get("count.hclust_device", 0) == 3
