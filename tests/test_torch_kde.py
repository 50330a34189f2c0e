"""Kernel K8 (the scaled KDE, otter_tpu_torch/kernels/kde_scaled.py and
csrc/kde_scaled.cu) and the port's pooled KDE on the CPU, against the JAX
package's ``kde_tree_step_scaled`` / ``pooled_kde_scaled`` (jnp on the CPU).

Tolerances: the max exponent m is equal (the same IEEE f32 ops, nothing
contracted); the mantissa sum s agrees to a relative 1e-6 (each term's exp
comes from another library, ~1 ulp apart, and the same halving order adds
them); the certified decisions are equal. The CUDA source runs on the g++
warp emulation of tests/test_torch_affine_emulated.py: with its exp swapped
for an f32 function the test repeats in numpy, its m and s equal the
halving order's bit for bit; with the real expf, the plain version's to a
relative 1e-6."""

import ctypes

import numpy as np
import pytest
import torch

from otter_tpu.parallel import mesh as jax_mesh
from otter_tpu_torch.kernels import kde_scaled as K8
from otter_tpu_torch.ops.kde import (kde_decision_certified_scaled_batch,
                                     kde_grid, kde_maximas)
from otter_tpu_torch.parallel.mesh import pooled_kde_scaled

from test_torch_affine_emulated import build_emulated

SOURCE = K8.__file__.rsplit("/", 2)[0] + "/csrc/kde_scaled.cu"
XS = kde_grid(0.0025).astype(np.float32)
RADIUS = 4   # max(1, int(max_error 0.01 / 0.0025))
S_RTOL = 1e-6


def _values(rng, n):
    """Pair distances of a two-allele region: most near 0.01, a third near
    0.17 (the cross-allele pairs), clipped to [0, 1]."""
    near = rng.normal(0.01, 0.004, n - n // 3)
    far = rng.normal(0.17, 0.01, n // 3)
    return np.clip(np.concatenate([near, far]), 0.0, 1.0).astype(np.float32)


def _n_pad(n):
    p = 8
    while p < n:
        p *= 2
    return p


def _batch(rng, sizes, bws):
    n_pad = _n_pad(max(sizes))
    V = np.zeros((len(sizes), n_pad), dtype=np.float32)
    for r, n in enumerate(sizes):
        V[r, :n] = _values(rng, n)
    return (V, np.asarray(sizes, dtype=np.int32),
            np.asarray(bws, dtype=np.float32), n_pad)


def _assert_close(m, s, m_want, s_want):
    assert np.array_equal(m, m_want)
    np.testing.assert_allclose(s, s_want, rtol=S_RTOL, atol=0)


def _decisions(scaled, value_lists, bws):
    """Per region: certified or not, and where certified the extrema
    indices of the density (the clustering decision surface)."""
    out = []
    for ok, d in kde_decision_certified_scaled_batch(scaled, value_lists,
                                                     bws, RADIUS):
        out.append((ok, None if d is None else [
            [i for i, _v in side] for side in kde_maximas(RADIUS, d)]))
    return out


@pytest.mark.parametrize("bw", [0.01, 0.015])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 4950, 19900])
def test_plain_matches_jax(n, bw):
    """The plain K8 equals the JAX kde_tree_step_scaled: m exactly, s to a
    relative 1e-6, the same certified decisions."""
    rng = np.random.default_rng(n + int(bw * 1000))
    V, nv, bwv, n_pad = _batch(rng, [n], [bw])
    m_j, s_j = (np.asarray(a) for a in jax_mesh.kde_tree_step_scaled(
        V, nv, bwv, XS, n_pad))
    m, s = K8.kde_scaled_torch(*(torch.from_numpy(a) for a in (V, nv, bwv,
                                                                XS)))
    _assert_close(m.numpy(), s.numpy(), m_j, s_j)
    vals = [V[0, :n]]
    assert _decisions([(m[0].numpy(), s[0].numpy())], vals, [bw]) == \
        _decisions([(m_j[0], s_j[0])], vals, [bw])


def test_plain_any_padding_is_the_same():
    """Zeros add exactly: a wider padding gives the same m and s."""
    rng = np.random.default_rng(3)
    V, nv, bwv, n_pad = _batch(rng, [9, 30, 5], [0.01, 0.015, 0.01])
    wide = np.zeros((3, 4 * n_pad), dtype=np.float32)
    wide[:, :n_pad] = V
    a = K8.kde_scaled_torch(*(torch.from_numpy(x) for x in (V, nv, bwv, XS)))
    b = K8.kde_scaled_torch(*(torch.from_numpy(x)
                              for x in (wide, nv, bwv, XS)))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_pooled_matches_jax():
    """The port's pooled_kde_scaled (buckets by n_pad, one copy) equals the
    JAX one region by region: m exactly, s to a relative 1e-6, the same
    certified decisions."""
    rng = np.random.default_rng(11)
    sizes = [3, 8, 9, 45, 300, 300, 1225, 4950]
    bws = [0.01, 0.015] * 4
    value_lists = [_values(rng, n).astype(np.float64) for n in sizes]
    got = pooled_kde_scaled(value_lists, bws, "cpu")
    want = jax_mesh.pooled_kde_scaled(value_lists, bws)
    for (m, s), (m_j, s_j) in zip(got, want):
        _assert_close(m, s, np.asarray(m_j), np.asarray(s_j))
    assert _decisions(got, value_lists, bws) == \
        _decisions([(np.asarray(a), np.asarray(b)) for a, b in want],
                   value_lists, bws)
    assert sum(ok for ok, _d in _decisions(got, value_lists, bws)) > 0


def _exp_test(d):
    """The f32 stand-in for exp of the exact-order check: 1 / (1 - d)."""
    return np.float32(1.0) / (np.float32(1.0) - d)


def _halving_reference(V, nv, bwv, exp):
    """m and s by the JAX function's ops and halving loop, in numpy f32."""
    R, n_pad = V.shape
    mask = np.arange(n_pad)[None, None, :] < nv[:, None, None]
    z = (XS[None, :, None] - V[:, None, :]) / bwv[:, None, None]
    e = np.where(mask, -(z * z) / np.float32(2.0), -np.inf).astype(
        np.float32)
    m = e.max(axis=2)
    with np.errstate(invalid="ignore", over="ignore"):
        t = np.where(mask, exp(e - m[:, :, None]), np.float32(0.0))
    w = n_pad
    while w > 1:
        t = t[..., : w // 2] + t[..., w // 2 : w]
        w //= 2
    return m, t[..., 0]


def _build(tmp_path_factory, test_exp):
    """kde_scaled.cu on the warp emulation; ``test_exp`` swaps its expf
    for the numpy-repeatable 1 / (1 - d)."""
    src = SOURCE
    if test_exp:
        d = tmp_path_factory.mktemp("kde_src")
        with open(SOURCE) as fh:
            text = fh.read()
        src = str(d / "kde_scaled.cu")
        with open(src, "w") as fh:
            fh.write(text.replace("expf(", "kde_test_exp(").replace(
                "namespace {\n",
                "namespace {\ninline float kde_test_exp(float d) "
                "{ return 1.0f / (1.0f - d); }\n", 1))
    so = build_emulated(tmp_path_factory, src)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.otter_kde_scaled.restype = I
    so.otter_kde_scaled.argtypes = [P, I, P, P, P, I, I, I, P, P, P]
    return so


@pytest.fixture(scope="module")
def k8_emulated(tmp_path_factory):
    return _build(tmp_path_factory, test_exp=False)


@pytest.fixture(scope="module")
def k8_emulated_test_exp(tmp_path_factory):
    return _build(tmp_path_factory, test_exp=True)


def _emulated_run(so, V, nv, bwv, n_max):
    R = V.shape[0]
    m = np.full((R, len(XS)), -7, dtype=np.float32)
    s = np.full((R, len(XS)), -7, dtype=np.float32)
    err = so.otter_kde_scaled(V.ctypes.data, V.shape[1], nv.ctypes.data,
                              bwv.ctypes.data, XS.ctypes.data, len(XS), R,
                              n_max, m.ctypes.data, s.ctypes.data, None)
    assert err == 0
    return m, s


# region sizes of each emulated launch: lanes below, at and past a warp,
# a ragged batch, and a region of the hifi-tr-1.5k cell (4,950 pairs)
EMU_SETS = {"small": [1, 9, 31, 32, 33], "ragged": [300, 7, 1000],
            "cell": [4950]}


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("name", list(EMU_SETS))
def test_cuda_source_emulated_sum_order(k8_emulated_test_exp, name, staged):
    """K8 as written for the card, its values staged in shared memory or
    read from device memory, with exp swapped for an f32 function: m and s
    equal the halving order's bit for bit."""
    rng = np.random.default_rng(len(name) + 100 * staged)
    sizes = EMU_SETS[name]
    V, nv, bwv, _n = _batch(rng, sizes, [[0.01, 0.015][r % 2]
                                         for r in range(len(sizes))])
    m, s = _emulated_run(k8_emulated_test_exp, V, nv, bwv,
                         int(nv.max()) if staged else 0)
    m_want, s_want = _halving_reference(V, nv, bwv, _exp_test)
    assert np.array_equal(m, m_want)
    assert np.array_equal(s, s_want)


@pytest.mark.parametrize("name", list(EMU_SETS))
def test_cuda_source_emulated_match_plain(k8_emulated, name):
    """K8 as written for the card (expf) against the plain version: m
    exactly, s to a relative 1e-6."""
    rng = np.random.default_rng(7 + len(name))
    sizes = EMU_SETS[name]
    V, nv, bwv, _n = _batch(rng, sizes, [0.015] * len(sizes))
    m, s = _emulated_run(k8_emulated, V, nv, bwv, int(nv.max()))
    m_p, s_p = K8.kde_scaled_torch(*(torch.from_numpy(a)
                                     for a in (V, nv, bwv, XS)))
    _assert_close(m, s, m_p.numpy(), s_p.numpy())
