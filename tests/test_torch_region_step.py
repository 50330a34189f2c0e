"""The sharded forward step, K13, K14, the fused collect and the dry run of
the PyTorch port (otter_tpu_torch/parallel/mesh.py, parallel/dryrun.py,
kernels/kde_pairs.py, kernels/kde_scaled.py's K13) on the CPU, against the
JAX package's ``region_batch_step`` / ``run_sharded_region_step``,
``kde_tree_step``, ``kde_fused_from_pairs`` and ``__graft_entry__``'s dry
run on its 8 virtual CPU devices.

Tolerances, each stated where it is used: distances are equal; densities
agree to a relative 1e-5 (the JAX test's own, tests/test_parallel.py), with
an absolute 1e-30 for the subnormal terms XLA flushes to zero; the port's
densities are bit-equal across its mesh sizes; K13 agrees with the JAX
function within its error model; the CUDA sources on the g++ warp
emulation, with exp swapped for an f32 function numpy repeats, equal that
numpy order bit for bit, and with the real expf the plain versions to a
relative 1e-6."""

import ctypes
import filecmp
import io
import math
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from __graft_entry__ import _example_pair_batch
from otter_tpu.kernels.edit_pallas import _pack_bucket, edit_banded_jnp
from otter_tpu.ops.kde import kde_grid
from otter_tpu.parallel import mesh as jax_mesh
from otter_tpu_torch.config import OtterOpts
from otter_tpu_torch.kernels import kde_pairs as K14
from otter_tpu_torch.kernels import kde_scaled as K8
from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
from otter_tpu_torch.kernels.edit_banded import edit_banded_torch, pack_bucket
from otter_tpu_torch.kernels.edit_engine import EditDistanceEngine, MeshEngine
from otter_tpu_torch.models.assemble import assemble
from otter_tpu_torch.parallel import mesh as port_mesh
from otter_tpu_torch.parallel.dryrun import dryrun_multichip, entry
from otter_tpu_torch.utils import metrics
from otter_tpu_torch.utils.synth import region_fixture

from test_torch_affine_emulated import build_emulated

CPU = torch.device("cpu")
CSRC = K8.__file__.rsplit("/", 2)[0] + "/csrc/"
XS = kde_grid(0.0025).astype(np.float32)
EPS32 = float(np.finfo(np.float32).eps)
# densities: the JAX test's rtol, and the subnormals XLA flushes to zero
DENS_RTOL = 1e-5
DENS_ATOL = 1e-30


def _mesh(n):
    return (CPU,) * n


def _jax_step(a, bp, mn, rid, valid, bw, k, L, n_regions, grid_pts=401):
    d, dens = jax_mesh.run_sharded_region_step(
        jax_mesh.make_mesh(1), a, bp, mn[:, 0], mn[:, 1], rid, valid, bw,
        k=k, max_rows=L, n_regions=n_regions, grid_pts=grid_pts)
    return np.asarray(d), np.asarray(dens)


@pytest.mark.parametrize("grid_pts", [1, 2, 3, 101, 401, 1000])
def test_linspace_grid_is_jax(grid_pts):
    """The grid K14 takes is jnp.linspace(0, 1, n, float32) bit for bit
    (torch.linspace differs at 77 of 401 points)."""
    want = np.asarray(jax_mesh.jax.jit(
        lambda: jnp.linspace(0.0, 1.0, grid_pts, dtype=jnp.float32))())
    assert np.array_equal(K14.linspace_grid(grid_pts), want)


def test_pack_bucket_is_jax():
    """pack_bucket is the JAX package's _pack_bucket, padding included."""
    rng = random.Random(1)
    pairs = [("".join(rng.choice("ACGTN") for _ in range(rng.randint(0, 300))),
              "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 300))))
             for _ in range(45)]
    for k in (31, 63):
        want = _pack_bucket(pairs, k)
        got = pack_bucket(pairs, k)
        assert got[3] == want[3]
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_sharded_step_matches_jax(n_devices):
    """run_sharded_region_step on a CPU mesh of 1, 2 and 8 against the JAX
    one on the same arrays: distances equal on every row (padding rows
    included), densities within DENS_RTOL (DENS_ATOL), and bit-equal to
    the port's own on a mesh of one."""
    a, bp, mn, rid, valid, k, L = _example_pair_batch(n_pairs=32)
    bw = np.full(2, 0.01, dtype=np.float32)
    dj, densj = _jax_step(a, bp, mn, rid, valid, bw, k, L, 2)
    args = (a, bp, mn[:, 0], mn[:, 1], rid, valid, bw)
    d, dens = port_mesh.run_sharded_region_step(_mesh(n_devices), *args,
                                                k=k, max_rows=L, n_regions=2)
    d1, dens1 = port_mesh.run_sharded_region_step(_mesh(1), *args, k=k,
                                                  max_rows=L, n_regions=2)
    assert np.array_equal(d.numpy(), dj)
    np.testing.assert_allclose(dens.numpy(), densj, rtol=DENS_RTOL,
                               atol=DENS_ATOL)
    assert torch.equal(dens, dens1) and torch.equal(d, d1)


@pytest.mark.parametrize("n_devices", [1, 2])
def test_sharded_step_chunked_regions_match_jax(n_devices):
    """The step with regions past several K14 chunks (3 CHUNK + 5 pairs
    over 2 regions: 3 and 4 chunks) against the JAX step: distances equal,
    densities within DENS_RTOL (DENS_ATOL), bit-equal across mesh sizes."""
    n_pairs = 3 * K14.CHUNK + 5
    a, bp, mn, rid, valid, k, L = _example_pair_batch(n_pairs=n_pairs,
                                                      length=40)
    assert int(valid.sum()) == n_pairs
    bw = np.asarray([0.01, 0.015], dtype=np.float32)
    dj, densj = _jax_step(a, bp, mn, rid, valid, bw, k, L, 2)
    args = (a, bp, mn[:, 0], mn[:, 1], rid, valid, bw)
    d, dens = port_mesh.run_sharded_region_step(_mesh(n_devices), *args,
                                                k=k, max_rows=L, n_regions=2)
    d1, dens1 = port_mesh.run_sharded_region_step(_mesh(1), *args, k=k,
                                                  max_rows=L, n_regions=2)
    assert np.array_equal(d.numpy(), dj)
    np.testing.assert_allclose(dens.numpy(), densj, rtol=DENS_RTOL,
                               atol=DENS_ATOL)
    assert torch.equal(dens, dens1)


def _mixed_batch(seed):
    """Pairs of three regions interleaved, with lengths 0-300, N bases,
    pairs whose length difference passes the band (INF), invalid pairs and
    a region with none: the step's edge rows."""
    rng = random.Random(seed)
    pairs = []
    for p in range(40):
        x = "".join(rng.choice("ACGTN" if p % 7 == 0 else "ACGT")
                    for _ in range(rng.randint(1, 300)))
        if p % 5 == 0:
            y = x[: max(0, len(x) - 90)]  # |m - n| > k: INF
        else:
            y = "".join(c if rng.random() > 0.05 else rng.choice("ACGT")
                        for c in x)
        pairs.append((x, y))
    k = 63
    a, bp, mn, L = _pack_bucket(pairs, k)
    rid = np.zeros(a.shape[0], dtype=np.int32)
    rid[: len(pairs)] = [p % 3 for p in range(len(pairs))]
    valid = np.zeros(a.shape[0], dtype=bool)
    valid[: len(pairs)] = [p % 9 != 4 for p in range(len(pairs))]
    return a, bp, mn, rid, valid, k, L


@pytest.mark.parametrize("n_devices", [1, 3])
def test_step_edge_rows_match_jax(n_devices):
    """The step on INF pairs (length difference past the band), N bases,
    invalid pairs, padding rows (m = n = 0) and an empty fourth region:
    distances equal to edit_banded_jnp's and the JAX step's, K7's plain
    version equal on every row; densities within DENS_RTOL (DENS_ATOL)."""
    a, bp, mn, rid, valid, k, L = _mixed_batch(5)
    bw = np.asarray([0.01, 0.015, 0.01, 0.02], dtype=np.float32)
    dj, densj = _jax_step(a, bp, mn, rid, valid, bw, k, L, 4)
    d, dens = port_mesh.run_sharded_region_step(
        _mesh(n_devices), a, bp, mn[:, 0], mn[:, 1], rid, valid, bw, k=k,
        max_rows=L, n_regions=4)
    direct = np.asarray(edit_banded_jnp(jnp.asarray(a), jnp.asarray(bp),
                                        jnp.asarray(mn[:, 0]),
                                        jnp.asarray(mn[:, 1]), k, L))
    plain = edit_banded_torch(*(torch.from_numpy(x) for x in (a, bp, mn)), k)
    assert np.array_equal(d.numpy(), dj)
    assert np.array_equal(d.numpy(), direct)
    assert np.array_equal(plain.numpy(), dj)
    assert (dj == 1 << 24).sum() >= 5 and (dj[~valid] == 0).sum() > 0
    np.testing.assert_allclose(dens.numpy(), densj, rtol=DENS_RTOL,
                               atol=DENS_ATOL)
    assert np.all(dens.numpy()[3] == 0)


def test_entry_runs_on_the_cpu():
    """The port's entry on the CPU: the JAX entry's shapes and distances,
    densities within DENS_RTOL (DENS_ATOL)."""
    from __graft_entry__ import entry as jax_entry

    fn, args = entry(CPU)
    d, dens = fn(*args)
    jfn, jargs = jax_entry()
    jd, jdens = jfn(*jargs)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(dens.numpy(), np.asarray(jdens),
                               rtol=DENS_RTOL, atol=DENS_ATOL)


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_dryrun_multichip_cpu(n_devices):
    """dryrun_multichip on a CPU mesh of 1, 2 and 8, as test_parallel.py
    runs the JAX one: its four checks pass (step, assemble and genotype
    byte-identical to the port's host mode)."""
    out = dryrun_multichip(n_devices, devices=_mesh(8))
    assert out["vcf_rows"] >= 6 and out["alleles"] >= 6
    assert set(out["scaling"]["regions_per_sec"]) == {
        str(s) for s in (1, 2, 4, 8) if s <= n_devices}


@pytest.mark.parametrize("args", [dict(n_regions=6, cov=10),
                                  dict(n_regions=3, cov=12, err=0.05,
                                       region_len=90, seed=3)])
def test_region_fixture_is_bench_e2e(tmp_path, args):
    """synth.region_fixture writes bench_e2e.build_fixture's BAM, BAI, BED
    and FASTA byte for byte."""
    from bench_e2e import build_fixture

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    build_fixture(str(tmp_path / "a"), **args)
    region_fixture(str(tmp_path / "b"), **args)
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b"))
    assert set(names) >= {"reads.bam", "reads.bam.bai", "regions.bed",
                          "ref.fa"}
    for name in names:
        assert filecmp.cmp(tmp_path / "a" / name, tmp_path / "b" / name,
                           shallow=False), name


# ---------------------------------------------------------------------------
# K13: the unscaled tree KDE
# ---------------------------------------------------------------------------


def _values(rng, n):
    near = rng.normal(0.01, 0.004, n - n // 3)
    far = rng.normal(0.17, 0.01, n // 3)
    return np.clip(np.concatenate([near, far]), 0.0, 1.0).astype(np.float32)


def _tree_batch(rng, sizes, bws):
    n_pad = 8
    while n_pad < max(sizes):
        n_pad *= 2
    V = np.zeros((len(sizes), n_pad), dtype=np.float32)
    for r, n in enumerate(sizes):
        V[r, :n] = _values(rng, n)
    return (V, np.asarray(sizes, dtype=np.int32),
            np.asarray(bws, dtype=np.float32), n_pad)


@pytest.mark.parametrize("sizes", [[1, 7, 9], [300, 45], [4950], [19900]])
def test_kde_tree_plain_matches_jax(sizes):
    """K13's plain version against kde_tree_step: per cell within the JAX
    docstring's model, (log2 n_pad + 2) eps32 of the sum plus the exp's
    error (2 ulp each side), twice for the row total it is divided by,
    plus the total's own halving tree over 512 lanes and the two
    divisions; an absolute 1e-30 for the subnormal terms XLA flushes."""
    rng = np.random.default_rng(sum(sizes))
    bws = [[0.01, 0.015][r % 2] for r in range(len(sizes))]
    V, nv, bw, n_pad = _tree_batch(rng, sizes, bws)
    want = np.asarray(jax_mesh.kde_tree_step(V, nv, bw, XS, n_pad))
    got = K8.kde_tree_torch(*(torch.from_numpy(x) for x in (V, nv, bw, XS)))
    cell = (math.log2(n_pad) + 2 + 4) * EPS32
    rtol = 2 * cell + (math.log2(K8.ROW_LANES) + 2) * EPS32
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-30)
    assert np.all(np.isfinite(got.numpy()))


def test_kde_tree_any_padding():
    """kde_tree (K13 by device) gives the same bits at any n_pad: the
    padding lanes add zeros."""
    rng = np.random.default_rng(4)
    V, nv, bw, n_pad = _tree_batch(rng, [9, 30, 5], [0.01, 0.015, 0.01])
    wide = np.zeros((3, 4 * n_pad), dtype=np.float32)
    wide[:, :n_pad] = V
    a = K8.kde_tree(*(torch.from_numpy(x) for x in (V, nv, bw, XS)))
    b = K8.kde_tree(*(torch.from_numpy(x) for x in (wide, nv, bw, XS)))
    assert torch.equal(a, b)


def _exp_test(d):
    """The f32 stand-in for exp of the exact-order checks: 1 / (1 - d)."""
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        return np.float32(1.0) / (np.float32(1.0) - d)


def _normalize_np(raw, div):
    """kde_rows.cuh's normalisation in numpy f32."""
    d = (raw / div[:, None]).astype(np.float32)
    t = np.zeros((raw.shape[0], K8.row_lanes(raw.shape[1])), np.float32)
    t[:, : raw.shape[1]] = d
    w = t.shape[1]
    while w > 1:
        t = t[:, : w // 2] + t[:, w // 2 : w]
        w //= 2
    return d / np.maximum(t, np.float32(1e-30))


def _tree_reference(V, nv, bw, xs, exp):
    """K13 in numpy f32: kde_tree_step's ops and halving order, then the
    normalisation, with ``exp`` for the exponential."""
    R, n_pad = V.shape
    mask = np.arange(n_pad)[None, None, :] < nv[:, None, None]
    h = bw[:, None, None]
    z = (xs[None, :, None] - V[:, None, :]) / h
    kern = (K8.INV_SQRT_2PI / h) * exp(-(z * z) / np.float32(2.0))
    t = np.where(mask, kern, np.float32(0.0)).astype(np.float32)
    w = n_pad
    while w > 1:
        t = t[..., : w // 2] + t[..., w // 2 : w]
        w //= 2
    return _normalize_np(t[..., 0], (bw * nv.astype(np.float32)))


def _with_test_exp(tmp_path_factory, name):
    """A copy of csrc/``name`` with expf swapped for 1 / (1 - d)."""
    d = tmp_path_factory.mktemp(name.split(".")[0] + "_src")
    with open(CSRC + name) as fh:
        text = fh.read()
    path = str(d / name)
    with open(path, "w") as fh:
        fh.write(text.replace("expf(", "kde_test_exp(").replace(
            "namespace {\n", "namespace {\ninline float kde_test_exp(float d) "
            "{ return 1.0f / (1.0f - d); }\n", 1))
    return path


def _k13_lib(tmp_path_factory, test_exp):
    src = (_with_test_exp(tmp_path_factory, "kde_scaled.cu") if test_exp
           else CSRC + "kde_scaled.cu")
    so = build_emulated(tmp_path_factory, src)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.otter_kde_tree.restype = I
    so.otter_kde_tree.argtypes = [P, I, P, P, P, I, I, I, I, I, P, P, P, P]
    return so


@pytest.fixture(scope="module")
def k13_emulated(tmp_path_factory):
    return _k13_lib(tmp_path_factory, False)


@pytest.fixture(scope="module")
def k13_emulated_test_exp(tmp_path_factory):
    return _k13_lib(tmp_path_factory, True)


def _k13_run(so, V, nv, bw, xs, n_max, warps=0, cells=0):
    R, G = V.shape[0], len(xs)
    raw = np.full((R, G), -7, dtype=np.float32)
    div = np.full(R, -7, dtype=np.float32)
    out = np.full((R, G), -7, dtype=np.float32)
    assert so.otter_kde_tree(V.ctypes.data, V.shape[1], nv.ctypes.data,
                             bw.ctypes.data, xs.ctypes.data, G, R, n_max,
                             cells, warps, raw.ctypes.data, div.ctypes.data,
                             out.ctypes.data, None) == 0
    return out


# every 17th grid cell: few blocks a launch on the emulation
XS_SUB = np.ascontiguousarray(XS[::17])


@pytest.mark.parametrize("sizes,warps,cells,staged", [
    ([1, 9, 31, 33], 0, 0, True), ([300, 7, 1000], 0, 0, False),
    ([129, 40], 4, 8, True), ([4950], 0, 0, True)])
def test_k13_cuda_source_emulated_sum_order(k13_emulated_test_exp, sizes,
                                            warps, cells, staged):
    """K13 as written for the card (K8's kernel in its unscaled instance,
    then the row normalisation), values staged in shared memory or read
    from device memory, by the launcher's rule or a forced W and C, exp
    swapped for an f32 function: the densities equal the numpy halving
    order's bit for bit."""
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    V, nv, bw, _n = _tree_batch(rng, sizes, [[0.01, 0.015][r % 2]
                                            for r in range(len(sizes))])
    xs = XS if len(sizes) == 1 else XS_SUB
    got = _k13_run(k13_emulated_test_exp, V, nv, bw, xs,
                   int(nv.max()) if staged else 0, warps, cells)
    assert np.array_equal(got, _tree_reference(V, nv, bw, xs, _exp_test))


def test_k13_cuda_source_emulated_match_plain(k13_emulated):
    """K13 as written for the card (expf) against its plain version: a
    relative 1e-6 a cell."""
    rng = np.random.default_rng(13)
    V, nv, bw, _n = _tree_batch(rng, [300, 7, 1000], [0.015, 0.01, 0.015])
    got = _k13_run(k13_emulated, V, nv, bw, XS_SUB, int(nv.max()))
    want = K8.kde_tree_torch(*(torch.from_numpy(x)
                               for x in (V, nv, bw, XS_SUB)))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# K14: the pair KDE of the forward step
# ---------------------------------------------------------------------------


def _pair_inputs(seed, n_pairs, n_regions):
    """Distances and lengths of a cross-region batch: most pairs 0-5%
    apart, some INF, regions interleaved and shuffled, a few invalid."""
    rng = np.random.default_rng(seed)
    m = rng.integers(80, 300, n_pairs).astype(np.int32)
    n = (m + rng.integers(-5, 6, n_pairs)).astype(np.int32)
    d = (rng.random(n_pairs) * 0.05 * m).astype(np.int32)
    d[rng.random(n_pairs) < 0.05] = 1 << 24
    rid = rng.integers(0, n_regions, n_pairs).astype(np.int32)
    valid = rng.random(n_pairs) > 0.1
    bw = np.where(np.arange(n_regions) % 2, 0.015, 0.01).astype(np.float32)
    return d, m, n, rid, valid, bw


def _pairs_terms(d, m, n, rid, valid, bw, xs, exp):
    """(per region: its valid pairs in input order, the term row of each
    pair) of K14 in numpy f32, with ``exp`` for the exponential."""
    R = len(bw)
    norm = (d.astype(np.float32)
            / np.maximum(np.maximum(m, n).astype(np.float32), np.float32(1)))
    pairs = [[] for _ in range(R)]
    for p in range(len(d)):
        if valid[p] and 0 <= rid[p] < R:
            pairs[rid[p]].append(p)

    def term(r, p):
        h = bw[r]
        z = (xs - norm[p]) / h
        return (K8.INV_SQRT_2PI / h) * exp((z * z) * np.float32(-0.5))

    return pairs, term


def _pairs_reference(d, m, n, rid, valid, bw, xs, exp, chunk=K14.CHUNK):
    """K14 in numpy f32: a region's valid pairs in input order cut into
    chunks of ``chunk``, each chunk summed in order, the chunk sums added in
    chunk order; then the normalisation, with ``exp`` for the
    exponential."""
    R, G = len(bw), len(xs)
    pairs, term = _pairs_terms(d, m, n, rid, valid, bw, xs, exp)
    raw = np.zeros((R, G), dtype=np.float32)
    for r in range(R):
        sums = []
        for c0 in range(0, max(len(pairs[r]), 1), chunk):
            s = np.zeros(G, dtype=np.float32)
            for p in pairs[r][c0 : c0 + chunk]:
                s = s + term(r, p)
            sums.append(s)
        raw[r] = sums[0]
        for s in sums[1:]:
            raw[r] = raw[r] + s
    counts = np.asarray([len(x) for x in pairs], dtype=np.float32)
    return _normalize_np(raw, np.maximum(counts, np.float32(1)))


def _pairs_reference_sequential(d, m, n, rid, valid, bw, xs, exp):
    """The order before the chunks: a region's valid pairs summed in input
    order from 0, then the normalisation."""
    R, G = len(bw), len(xs)
    pairs, term = _pairs_terms(d, m, n, rid, valid, bw, xs, exp)
    raw = np.zeros((R, G), dtype=np.float32)
    for r in range(R):
        for p in pairs[r]:
            raw[r] = raw[r] + term(r, p)
    counts = np.asarray([len(x) for x in pairs], dtype=np.float32)
    return _normalize_np(raw, np.maximum(counts, np.float32(1)))


def _sized_pair_inputs(seed, sizes, n_invalid=9):
    """``_pair_inputs`` with region r holding exactly sizes[r] valid pairs,
    ``n_invalid`` invalid pairs and one out-of-range region id among them,
    the regions interleaved at random."""
    rng = np.random.default_rng(seed)
    rid = np.concatenate([np.full(c, r, dtype=np.int32)
                          for r, c in enumerate(sizes)]
                         + [rng.integers(0, len(sizes), n_invalid,
                                         dtype=np.int32),
                            np.asarray([len(sizes)], dtype=np.int32)])
    valid = np.arange(len(rid)) < sum(sizes)
    valid[-1] = True  # out of range: counts nowhere
    perm = rng.permutation(len(rid))
    d, m, n, _rid, _valid, bw = _pair_inputs(seed, len(rid), len(sizes))
    return d, m, n, rid[perm], valid[perm], bw


def _reinterleave(seed, rid, valid, *cols):
    """The same pairs with the regions interleaved another way: each
    region's (and the invalid pairs') relative order kept."""
    label = np.where(valid, rid, -1)
    new = np.random.default_rng(seed).permutation(label)
    idx = np.empty(len(label), dtype=np.int64)
    for lab in np.unique(label):
        idx[new == lab] = np.nonzero(label == lab)[0]
    return (rid[idx], valid[idx]) + tuple(c[idx] for c in cols)


def _k14_lib(tmp_path_factory, test_exp):
    src = (_with_test_exp(tmp_path_factory, "kde_pairs.cu") if test_exp
           else CSRC + "kde_pairs.cu")
    so = build_emulated(tmp_path_factory, src)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.otter_kde_pairs.restype = I
    so.otter_kde_pairs.argtypes = [P] * 7 + [I, I, I, P, P, P, P]
    return so


@pytest.fixture(scope="module")
def k14_emulated(tmp_path_factory):
    return _k14_lib(tmp_path_factory, False)


@pytest.fixture(scope="module")
def k14_emulated_test_exp(tmp_path_factory):
    return _k14_lib(tmp_path_factory, True)


def _k14_run(so, d, m, n, rid, valid, bw, xs):
    """The CUDA source's densities; its ticket array, zero before, is zero
    again after."""
    order, starts = (t.numpy() for t in K14.group_pairs(
        torch.from_numpy(rid), torch.from_numpy(valid), len(bw)))
    R, G = len(bw), len(xs)
    partial = np.full((len(order) // K14.CHUNK + R, G), -7, dtype=np.float32)
    tickets = np.zeros(R, dtype=np.int32)
    out = np.full((R, G), -7, dtype=np.float32)
    order = np.ascontiguousarray(order)
    assert so.otter_kde_pairs(
        d.ctypes.data, m.ctypes.data, n.ctypes.data, order.ctypes.data,
        starts.ctypes.data, bw.ctypes.data, xs.ctypes.data, G, R,
        len(order), partial.ctypes.data, tickets.ctypes.data,
        out.ctypes.data, None) == 0
    assert not tickets.any()
    return out


def _k14_plain(*arrays):
    return K14.kde_pairs_torch(*(torch.from_numpy(x)
                                 for x in arrays)).numpy()


@pytest.mark.parametrize("n_pairs,n_regions,grid_pts", [
    (40, 3, 401), (1500, 2, 57), (7, 4, 1)])
def test_k14_cuda_source_emulated_sum_order(k14_emulated_test_exp, n_pairs,
                                            n_regions, grid_pts):
    """K14 as written for the card, exp swapped for an f32 function: the
    densities equal the numpy order (a region's valid pairs in chunks of
    CHUNK, the chunk sums in chunk order) bit for bit; the plain
    version's order is the same."""
    d, m, n, rid, valid, bw = _pair_inputs(n_pairs, n_pairs, n_regions)
    xs = K14.linspace_grid(grid_pts)
    got = _k14_run(k14_emulated_test_exp, d, m, n, rid, valid, bw, xs)
    assert np.array_equal(got, _pairs_reference(d, m, n, rid, valid, bw, xs,
                                                _exp_test))


C = K14.CHUNK


@pytest.mark.parametrize("sizes,grid_pts", [
    ([C], 401), ([C + 1], 401), ([3 * C + 5], 401),
    ([3 * C + 5, 0, C + 1, 2], 200), ([2 * C, 17], 1000), ([C + 1, 3], 100)])
def test_k14_cuda_source_emulated_chunks(k14_emulated_test_exp, sizes,
                                         grid_pts):
    """K14 as written for the card on regions of exactly CHUNK, CHUNK + 1
    and 3 CHUNK + 5 pairs (an empty region among them; every points-a-thread
    instance: 100, 200, 401 and 1000 grid points), exp swapped for an f32
    function: bit for bit the numpy chunk order, which differs from the
    one sequential sum only past CHUNK pairs."""
    d, m, n, rid, valid, bw = _sized_pair_inputs(sum(sizes), sizes)
    xs = K14.linspace_grid(grid_pts)
    got = _k14_run(k14_emulated_test_exp, d, m, n, rid, valid, bw, xs)
    want = _pairs_reference(d, m, n, rid, valid, bw, xs, _exp_test)
    assert np.array_equal(got, want)
    seq = _pairs_reference_sequential(d, m, n, rid, valid, bw, xs, _exp_test)
    for r, size in enumerate(sizes):
        if size <= C:
            assert np.array_equal(got[r], seq[r])


@pytest.mark.parametrize("sizes", [[C], [1, C, 93, 120, 66], [0, 5, 2]])
def test_k14_small_regions_keep_the_sequential_order(k14_emulated_test_exp,
                                                     sizes):
    """Regions of at most CHUNK pairs (the regions leg's ~93) keep the one
    sequential sum of the design before the chunks bit for bit: the CUDA
    source with the f32 stand-in for exp against that numpy order, and the
    plain version against that order written in PyTorch."""
    d, m, n, rid, valid, bw = _sized_pair_inputs(7 + len(sizes), sizes)
    xs = K14.linspace_grid(401)
    got = _k14_run(k14_emulated_test_exp, d, m, n, rid, valid, bw, xs)
    assert np.array_equal(got, _pairs_reference_sequential(
        d, m, n, rid, valid, bw, xs, _exp_test))
    R = len(bw)
    ts = [torch.from_numpy(x) for x in (d, m, n, rid, valid, bw, xs)]
    order, starts = K14.group_pairs(ts[3], ts[4], R)
    norm = (ts[0].float() / torch.clamp(torch.maximum(ts[1], ts[2]).float(),
                                        min=1.0))[order.long()]
    raw = torch.zeros((R, len(xs)), dtype=torch.float32)
    h = ts[5][:, None]
    c = torch.tensor(K8.INV_SQRT_2PI) / h
    for r in range(R):
        for i in range(int(starts[r]), int(starts[r + 1])):
            z = (ts[6] - norm[i]) / h[r]
            raw[r] = raw[r] + c[r] * torch.exp((z * z) * -0.5)
    div = torch.clamp((starts[1:] - starts[:-1]).float(), min=1.0)
    want = K8.normalize_rows_torch(raw, div)
    assert torch.equal(torch.from_numpy(_k14_plain(d, m, n, rid, valid, bw,
                                                   xs)), want)


@pytest.mark.parametrize("sizes", [[3 * C + 5, 40, C + 1], [30, 7, 12]])
def test_k14_interleaving_changes_nothing(k14_emulated_test_exp, sizes):
    """The same pairs with the regions interleaved another way (each
    region's own order kept): the same densities bit for bit, from the CUDA
    source (f32 stand-in for exp) and from the plain version."""
    d, m, n, rid, valid, bw = _sized_pair_inputs(3 + len(sizes), sizes)
    rid2, valid2, d2, m2, n2 = _reinterleave(5, rid, valid, d, m, n)
    assert not np.array_equal(rid2, rid)
    xs = K14.linspace_grid(401)
    for run in (lambda *a: _k14_run(k14_emulated_test_exp, *a), _k14_plain):
        assert np.array_equal(run(d, m, n, rid, valid, bw, xs),
                              run(d2, m2, n2, rid2, valid2, bw, xs))


def test_k14_cuda_source_emulated_match_plain(k14_emulated):
    """K14 as written for the card (expf) against its plain version: a
    relative 1e-6 a cell (an absolute 1e-30 for subnormals), at a region
    of a few chunks too."""
    xs = K14.linspace_grid(401)
    for inputs in (_pair_inputs(9, 300, 3),
                   _sized_pair_inputs(9, [3 * C + 5, 40])):
        got = _k14_run(k14_emulated, *inputs, xs)
        np.testing.assert_allclose(got, _k14_plain(*inputs, xs), rtol=1e-6,
                                   atol=1e-30)


@pytest.mark.parametrize("sizes", [None, [3 * C + 5, 2, C]])
def test_k14_plain_order_is_numpy(sizes):
    """K14's plain version against the numpy order with numpy's exp: a
    relative 1e-6 (the two exps), and the JAX step's densities within
    DENS_RTOL on the same distances."""
    inputs = (_pair_inputs(3, 500, 5) if sizes is None
              else _sized_pair_inputs(3, sizes))
    xs = K14.linspace_grid(401)
    got = _k14_plain(*inputs, xs)
    want = _pairs_reference(*inputs, xs, np.exp)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


# ---------------------------------------------------------------------------
# The fused collect
# ---------------------------------------------------------------------------


def _jax_fused_inputs(rng):
    P, n_rows, n_pad = 50, 3, 32
    flat = rng.integers(0, 20, P).astype(np.int32)
    mlen = rng.integers(80, 120, P).astype(np.float32)
    rid = rng.integers(0, n_rows + 1, P).astype(np.int32)
    slot = np.zeros(P, dtype=np.int32)
    for r in range(n_rows + 1):
        sel = np.nonzero(rid == r)[0]
        slot[sel] = np.arange(len(sel))
    nvals = np.asarray([(rid == r).sum() for r in range(n_rows)], np.int32)
    ex_row = np.asarray([0, 2, 2], dtype=np.int32)
    ex_slot = nvals[[0, 2, 2]] + np.asarray([0, 0, 1], dtype=np.int32)
    ex_val = np.asarray([0.0, 1.0, 0.5], dtype=np.float32)
    nvals[0] += 1
    nvals[2] += 2
    bw = np.asarray([0.01, 0.015, 0.01], dtype=np.float32)
    return (flat, mlen, rid, slot, ex_row, ex_slot, ex_val, nvals, bw, XS,
            n_pad, n_rows)


def test_kde_fused_from_pairs_matches_jax():
    """The port's kde_fused_from_pairs against the JAX one on the same
    inputs: the distances equal, m equal, s within a relative 1e-6 (K8's
    tolerance against the JAX function: each term's exp comes from
    another library)."""
    args = _jax_fused_inputs(np.random.default_rng(3))
    *arrays, n_pad, n_rows = args
    want = np.asarray(jax_mesh.kde_fused_from_pairs(*arrays, n_pad=n_pad,
                                                    n_rows=n_rows))
    got = port_mesh.kde_fused_from_pairs(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
        n_pad, n_rows).numpy()
    P, G = len(arrays[0]), len(XS)
    assert np.array_equal(got[:P], want[:P])
    assert np.array_equal(got[P : P + n_rows * G], want[P : P + n_rows * G])
    np.testing.assert_allclose(got[P + n_rows * G :], want[P + n_rows * G :],
                               rtol=1e-6, atol=0)


def _pairs(rng, n, length=80, rate=0.03):
    out = []
    for _ in range(n):
        base = "".join(rng.choice("ACGT") for _ in range(length))
        mut = "".join(c if rng.random() > rate else rng.choice("ACGT")
                      for c in base)
        out.append((base, mut))
    return out


def _two_step(engine, pairs, rid, slot, ex_entries, nvals, bw, n_rows):
    """The two-step route: distances_collect, then pooled_kde_scaled of
    each row's values (the pairs' normalised distances, the host-known
    entries)."""
    d = engine.distances(pairs)
    rows = [[None] * int(nvals[r]) for r in range(n_rows)]
    for p, (x, y) in enumerate(pairs):
        if rid[p] < n_rows:
            rows[rid[p]][slot[p]] = d[p] / max(len(x), len(y))
    for r, s, v in ex_entries:
        rows[r][s] = v
    scaled = port_mesh.pooled_kde_scaled(
        [np.asarray(v, dtype=np.float64) for v in rows], list(bw), "cpu")
    return d, scaled


@pytest.mark.parametrize("mesh", [None, 2])
def test_distances_collect_kde_matches_two_step(mesh):
    """distances_collect_kde (one engine, or a CPU mesh of two) against the
    two-step route: the distances equal, and m and s bit-equal (the same
    plain K8 on the same values; wider padding adds zeros), with shortcut
    pairs (equal sequences, an empty side) folded in as host-known
    entries, a host-known row of haplotag values and excluded pairs in the
    dump row."""
    rng = random.Random(21)
    pairs = _pairs(rng, 24)
    pairs[3] = (pairs[3][0], pairs[3][0])
    pairs[12] = ("", pairs[12][1])
    engine = (EditDistanceEngine("cpu") if mesh is None
              else MeshEngine(_mesh(mesh)))
    rid = np.array([0] * 10 + [1] * 10 + [3] * 4, dtype=np.int32)
    slot = np.array(list(range(10)) * 2 + [0] * 4, dtype=np.int32)
    ex = [(2, k, float(v)) for k, v in enumerate([0.0, 1.0, 1.0, 0.0, 1.0])]
    nvals = np.array([10, 10, 5], dtype=np.int32)
    bw = np.array([0.01, 0.015, 0.01], dtype=np.float32)
    fused = engine.distances_collect_kde(engine.distances_async(pairs), rid,
                                         slot, ex, nvals, bw, 3, 16)
    assert fused is not None
    d, m, s = fused
    d2, scaled = _two_step(EditDistanceEngine("cpu"), pairs, rid, slot, ex,
                           nvals, bw, 3)
    assert np.array_equal(d, d2)
    for r in range(3):
        assert np.array_equal(m[r], scaled[r][0])
        assert np.array_equal(s[r], scaled[r][1])


@pytest.mark.parametrize("mesh", [None, 2])
@pytest.mark.parametrize("kind", ["n_base", "long"])
def test_distances_collect_kde_declines_ladders(mesh, kind):
    """A pair that goes to a ladder (a non-ACGT base: the K7 ladder; a
    side past 2,048: the K3 ladder) makes the fused collect decline
    (None); the handle then collects in full."""
    rng = random.Random(44)
    pairs = _pairs(rng, 4)
    pairs.append(("ACGTN" * 10, "ACGTT" * 10) if kind == "n_base" else
                 _pairs(rng, 1, length=2100)[0])
    engine = (EditDistanceEngine("cpu") if mesh is None
              else MeshEngine(_mesh(mesh)))
    handle = engine.distances_async(pairs)
    rid = np.zeros(5, dtype=np.int32)
    assert engine.distances_collect_kde(
        handle, rid, np.arange(5, dtype=np.int32), [], np.array([5]),
        np.array([0.01], np.float32), 1, 8) is None
    assert np.array_equal(engine.distances_collect(handle),
                          EditDistanceEngine("cpu").distances(pairs))


@pytest.fixture(scope="module")
def loci(tmp_path_factory):
    """Four tandem-repeat loci with non-spanning reads (reassignment
    jobs) and one with N bases (a K7 ladder pair)."""
    from otter_tpu_torch.utils.synth import tandem_repeat_loci

    tmp = str(tmp_path_factory.mktemp("fused"))
    clean = tandem_repeat_loci(tmp, n_regions=4, cov=14, err=0.002,
                               expansion=30, region_len=500, seed=8,
                               name="clean", partial=0.2)
    with_n = tandem_repeat_loci(tmp, n_regions=2, cov=12, err=0.002,
                                expansion=20, region_len=300, seed=9,
                                name="n", n_bases=2)
    return {"clean": clean, "n_bases": with_n}


def _assemble(bam, bed, backend):
    p = OtterOpts(device="cpu")
    p.read_group = "S1"
    out = io.StringIO()
    assemble(bam, bed, "", False, p, out=out, dist_backend=backend)
    return out.getvalue()


@pytest.mark.parametrize("mesh", [None, 2])
@pytest.mark.parametrize("name", ["clean", "n_bases"])
def test_assemble_fused_kde_setting(loci, name, mesh, monkeypatch):
    """assemble with OTTER_TPU_FUSED_KDE=1 writes the bytes of the default
    (two-step) route and of =0; where no pair takes a ladder it took the
    fused collect (K8 ran, no separate KDE dispatch), and with N bases it
    declined to the two-step route."""
    bam, bed = loci[name]

    def run(setting):
        if setting is None:
            monkeypatch.delenv("OTTER_TPU_FUSED_KDE", raising=False)
        else:
            monkeypatch.setenv("OTTER_TPU_FUSED_KDE", setting)
        backend = (TorchDistBackend("cpu") if mesh is None
                   else TorchDistBackend(mesh=_mesh(mesh)))
        metrics.reset()
        text = _assemble(bam, bed, backend)
        return text, metrics.snapshot()

    want, snap0 = run(None)
    off, _snap = run("0")
    got, snap = run("1")
    assert got == want == off and want.count("\n") >= 4
    assert "count.kde_device_regions" not in snap0
    fused = name == "clean"
    assert (snap.get("count.kde_device_regions", 0) > 0) == fused
    assert "time.kde_device" not in snap
