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


def _halving_reference(V, nv, bwv, exp, xs=XS):
    """m and s by the JAX function's ops and halving loop, in numpy f32."""
    R, n_pad = V.shape
    mask = np.arange(n_pad)[None, None, :] < nv[:, None, None]
    z = (xs[None, :, None] - V[:, None, :]) / bwv[:, None, None]
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
    so.otter_kde_scaled_launch.restype = I
    so.otter_kde_scaled_launch.argtypes = [P, I, P, P, P, I, I, I, I, I, P, P,
                                           P]
    so.otter_kde_scaled_geometry.restype = I
    so.otter_kde_scaled_geometry.argtypes = [I, I, I, I, P]
    return so


@pytest.fixture(scope="module")
def k8_emulated(tmp_path_factory):
    return _build(tmp_path_factory, test_exp=False)


@pytest.fixture(scope="module")
def k8_emulated_test_exp(tmp_path_factory):
    return _build(tmp_path_factory, test_exp=True)


def _emulated_run(so, V, nv, bwv, n_max, warps=None, xs=XS, cells=0):
    """m and s of one emulated launch; ``warps`` forces W and ``cells`` C
    (None and 0: the C entry point of the package, which takes the
    launcher's rule)."""
    R = V.shape[0]
    m = np.full((R, len(xs)), -7, dtype=np.float32)
    s = np.full((R, len(xs)), -7, dtype=np.float32)
    args = [V.ctypes.data, V.shape[1], nv.ctypes.data, bwv.ctypes.data,
            xs.ctypes.data, len(xs), R, n_max]
    if warps is None and not cells:
        err = so.otter_kde_scaled(*args, m.ctypes.data, s.ctypes.data, None)
    else:
        err = so.otter_kde_scaled_launch(*args, cells, warps or 0,
                                         m.ctypes.data, s.ctypes.data, None)
    assert err == 0
    return m, s


def _geometry(so, R, n_pad, n_max, cells=len(XS)):
    out = (ctypes.c_int * 4)()
    assert so.otter_kde_scaled_geometry(n_pad, n_max, cells, R,
                                        ctypes.addressof(out)) == 0
    return tuple(out)


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


# every 17th grid cell: 24 cells, 6 groups of 4, so a launch at any W has
# few blocks on the emulation
XS_SUB = np.ascontiguousarray(XS[::17])


@pytest.mark.parametrize("warps,n,cells,staged", [
    (w, n, c, staged) for w in (1, 2, 4, 16)
    for (n, c, staged) in ((32 * w - 1, 4, True), (32 * w + 1, 4, False),
                           (128 * w - 1, 4, True), (128 * w, 4, False),
                           (128 * w + 1, 4, True), (700, 4, False),
                           (128 * w, 8, True), (256 * w + 1, 8, False))])
def test_cuda_source_emulated_warps_sum_order(k8_emulated_test_exp, warps,
                                              n, cells, staged):
    """K8 as written for the card at a forced W (P = 32 W residue classes)
    and C (4 or 8 cells a thread), n below and just past P, P x 4 (a
    step's four values) and P x 8, a ragged batch of three regions, staged
    or read from device memory, exp swapped for an f32 function: m and s
    equal the halving order's bit for bit."""
    rng = np.random.default_rng(1000 * warps + n + 7 * staged + cells)
    sizes = [n, max(1, n // 3), n]
    V, nv, bwv, _n = _batch(rng, sizes, [0.01, 0.015, 0.02])
    m, s = _emulated_run(k8_emulated_test_exp, V, nv, bwv,
                         n if staged else 0, warps, XS_SUB, cells)
    m_want, s_want = _halving_reference(V, nv, bwv, _exp_test, XS_SUB)
    assert np.array_equal(m, m_want)
    assert np.array_equal(s, s_want)


@pytest.mark.parametrize("warps,n,n_max", [
    (1, 17000, 17000),      # W = 1: a fold stack deeper than 8 levels
    (16, 52000, 52000),     # past the 200 KB stage: read from memory
    (None, 52000, 52000),   # the same by the launcher's rule
])
def test_cuda_source_emulated_deep_rows(k8_emulated_test_exp, warps, n,
                                        n_max):
    """The rows the common instance does not take: a lane fold stack past
    its 8 levels (the general instance) and a row over the shared-memory
    stage; bit for bit the halving order."""
    rng = np.random.default_rng(n + (warps or 0))
    V, nv, bwv, _n = _batch(rng, [n], [0.015])
    m, s = _emulated_run(k8_emulated_test_exp, V, nv, bwv, n_max, warps,
                         XS_SUB)
    m_want, s_want = _halving_reference(V, nv, bwv, _exp_test, XS_SUB)
    assert np.array_equal(m, m_want)
    assert np.array_equal(s, s_want)


def _adversarial_values(xs):
    """Values that meet the grid cells ``xs`` head on: a cell exactly, two
    values at one distance either side of a cell, the float32 neighbours of
    a cell, zeros and ones, and values 1 ulp apart."""
    f = np.float32
    out = []
    for i, x in enumerate(xs[1:-1]):
        x = f(x)
        d = f(0.0025 * (i % 5 + 1))
        out += [x, f(x - d), f(x + d), np.nextafter(x, f(0)),
                np.nextafter(x, f(1)), np.nextafter(np.nextafter(x, f(1)),
                                                    f(1))]
    out += [f(0), f(0), f(1), np.nextafter(f(1), f(0)), f(1e-30), f(1e-40)]
    return np.asarray(out, dtype=np.float32)


@pytest.mark.parametrize("bw", [0.01, 0.015, 0.0025, 3e-3])
def test_cuda_source_emulated_max_adversarial(k8_emulated, bw):
    """m from the division-free max pass (scaled(min |x - v|)) equals the
    plain version's max of every exponent on values made to tie: a value
    on a cell, values at equal distance either side, zeros, 1-ulp
    neighbours; one region of those values alone, one of a single value on
    a cell, and one shuffled with random values."""
    rng = np.random.default_rng(int(bw * 1e4))
    adv = _adversarial_values(XS_SUB)
    mixed = np.concatenate([adv, _values(rng, 200)])
    rng.shuffle(mixed)
    rows = [adv, XS_SUB[3:4], mixed]
    n_pad = _n_pad(max(len(r) for r in rows))
    V = np.zeros((3, n_pad), dtype=np.float32)
    for r, row in enumerate(rows):
        V[r, : len(row)] = row
    nv = np.asarray([len(r) for r in rows], dtype=np.int32)
    bwv = np.full(3, bw, dtype=np.float32)
    m_p, s_p = K8.kde_scaled_torch(*(torch.from_numpy(a)
                                     for a in (V, nv, bwv, XS_SUB)))
    for warps, cells in ((None, 0), (1, 4), (4, 8)):
        m, s = _emulated_run(k8_emulated, V, nv, bwv, int(nv.max()), warps,
                             XS_SUB, cells)
        assert np.array_equal(m, m_p.numpy()), warps
        assert m[1].max() == 0.0  # the value on a cell: e = -0
        np.testing.assert_allclose(s, s_p.numpy(), rtol=S_RTOL, atol=0)


def test_scaled_exponent_monotone_in_distance():
    """The max pass's premise, in numpy float32: e(a) = -(fl(a / h))^2 / 2
    is the same for a and -a and never rises as |a| grows, so the largest
    exponent is the one of the least |a|; checked on 10^6 sorted distances
    and their 1-ulp neighbours at several bandwidths."""
    rng = np.random.default_rng(5)
    a = np.sort(np.abs(rng.normal(0, 0.3, 1_000_000)).astype(np.float32))
    a = np.unique(np.concatenate([a, np.nextafter(a, np.float32(1)),
                                  np.float32([0, 1e-40, 1e-30, 1])]))
    for h in np.float32([0.01, 0.015, 0.0025, 0.3, 7e-5]):
        z = a / h
        e = (z * z) * np.float32(-0.5)
        zn = (-a) / h
        assert np.array_equal(e, (zn * zn) * np.float32(-0.5))
        assert np.all(np.diff(e) <= 0)


@pytest.mark.parametrize("R,n,want", [
    (32, 4950, (2, 8, 256, 448)),     # hifi-tr-1.5k's batch: Q = 7
    (1, 19900, (16, 4, 101, 512)),    # the refscale region
    (256, 19900, (2, 8, 1792, 512)),  # the largest batch: many rounds
    (5, 33, (1, 4, 65, 256)),         # small regions: one warp, Q = 8
    (1, 60000, (16, 4, 101, 512)),    # past the stage
    (10, 4950, (4, 4, 260, 512)),     # 510 groups of 8 cells: C = 4
    (11, 4950, (4, 8, 187, 384)),     # 561 groups of 8: C = 8, Q = 3
])
def test_cuda_source_geometry_rule(k8_emulated, R, n, want):
    """The launcher's rule (132 SMs): 8 cells a thread once the batch has
    4 groups of 8 cells an SM, else 4; W doubles until the grid of full
    blocks (16 / W groups) has a block an SM while each lane keeps >= 16
    values, and until the fold stack fits 8 levels; on a grid of at most 4
    full blocks an SM, Q groups a block (>= 8 warps) that give an SM the
    fewest groups; (W, C, blocks, threads a block)."""
    n_pad = max(8, 1 << (n - 1).bit_length())
    assert _geometry(k8_emulated, R, n_pad, n) == want



# The reciprocal division of the sum pass (div_by in kde_scaled.cu) against
# IEEE division, on the g++ build of the source: a harness appended to it
# calls the kernel's own helpers. The range where the kernel takes it:
# |h| in [2^-40, 2^40], a = 0 or |a| in [2^-80, 2^80].
DIV_HARNESS = r"""
#include <cstring>
#include <random>
extern "C" long kde_div_mismatches(const float* a, const float* h, long n) {
  long bad = 0;
  for (long i = 0; i < n; ++i) {
    bad += !(div_by(a[i], h[i], __frcp_rn(h[i])) == a[i] / h[i]);
  }
  return bad;
}
// every positive float from bits lo to hi, and its negative, over h
extern "C" long kde_div_sweep(float h, unsigned lo, unsigned hi) {
  const float y = __frcp_rn(h);
  long bad = 0;
  for (unsigned u = lo; u <= hi; ++u) {
    float a;
    std::memcpy(&a, &u, 4);
    bad += !(div_by(a, h, y) == a / h) + !(div_by(-a, h, y) == -a / h);
  }
  return bad;
}
// quotients nearest a midpoint between two floats: A 2^k - H M = d for
// small d, H and A 24-bit, M odd 25-bit (a / h is then M / 2 ulp-units
// off by |d| / H of the grain); half of the H just below 2^24, where
// fl(1 / h) rounds worst; exponents spread over the range
extern "C" long kde_div_hard(long count, unsigned seed, float* a_out,
                             float* h_out) {
  std::mt19937_64 rng(seed);
  long made = 0;
  while (made < count) {
    int64_t H = rng() & 1 ? (1 << 23) + rng() % (1 << 23)
                          : (1 << 24) - 1 - rng() % (1 << 20);
    if (!(H & 1)) continue;
    const int64_t d = static_cast<int64_t>(rng() % 7) - 3;
    if (d == 0) continue;
    for (int k = 24; k <= 25 && made < count; ++k) {
      int64_t r0 = H, r1 = (int64_t(1) << k) % H, s0 = 0, s1 = 1;
      while (r1) {  // s1 = (2^k)^-1 mod H
        const int64_t q = r0 / r1, r2 = r0 - q * r1, s2 = s0 - q * s1;
        r0 = r1; r1 = r2; s0 = s1; s1 = s2;
      }
      const int64_t A0 = (((d * s0) % H) + H) % H;
      for (int64_t A = A0 + ((1 << 23) - A0 + H - 1) / H * H;
           A < (1 << 24) && made < count; A += H) {
        const int64_t num = (A << k) - d;
        if (A < (1 << 23) || num % H) continue;
        const int64_t M = num / H;
        if (!(M & 1) || M < (int64_t(1) << 24) || M >= (int64_t(1) << 25)) {
          continue;
        }
        const int eh = -63 + static_cast<int>(rng() % 80);   // 2^-40..2^40
        const int ea = eh + static_cast<int>(rng() % 60) - 30;
        const float sign = rng() & 1 ? 1.0f : -1.0f;
        a_out[made] = sign * ldexpf(static_cast<float>(A), ea);
        h_out[made] = ldexpf(static_cast<float>(H), eh);
        ++made;
      }
    }
  }
  return made;
}
"""


@pytest.fixture(scope="module")
def k8_division(tmp_path_factory):
    d = tmp_path_factory.mktemp("kde_div_src")
    with open(SOURCE) as fh:
        text = fh.read()
    src = str(d / "kde_scaled.cu")
    with open(src, "w") as fh:
        fh.write(text + DIV_HARNESS)
    so = build_emulated(tmp_path_factory, src)
    P, L = ctypes.c_void_p, ctypes.c_long
    so.kde_div_mismatches.restype = L
    so.kde_div_mismatches.argtypes = [P, P, L]
    so.kde_div_sweep.restype = L
    so.kde_div_sweep.argtypes = [ctypes.c_float, ctypes.c_uint, ctypes.c_uint]
    so.kde_div_hard.restype = L
    so.kde_div_hard.argtypes = [L, ctypes.c_uint, P, P]
    return so


def _mismatches(so, a, h):
    a = np.ascontiguousarray(a, dtype=np.float32)
    h = np.ascontiguousarray(np.broadcast_to(h, a.shape), dtype=np.float32)
    # every input inside the kernel's range
    nz = a != 0
    assert np.all((np.abs(a[nz]) >= 2.0 ** -80) & (np.abs(a[nz]) <= 2.0 ** 80))
    assert np.all((np.abs(h) >= 2.0 ** -40) & (np.abs(h) <= 2.0 ** 40))
    return so.kde_div_mismatches(a.ctypes.data, h.ctypes.data, a.size)


def _random_floats(rng, n, lo, hi):
    """n float32 of random sign and mantissa, exponents uniform in [lo,
    hi)."""
    mant = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    expo = rng.integers(lo + 127, hi + 127, n, dtype=np.uint32)
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    return (sign | (expo << 23) | mant).view(np.float32)


def _edge_inputs(rng):
    """(a, h) at the division's edges: a = +-0; quotients next to a power
    of two (a = fl(2^k h) and its ulp neighbours); the ulp neighbours of
    small multiples of h; the smallest and largest |a| of the range."""
    f = np.float32
    h = np.concatenate([f([0.01, 0.015, 0.0025, 1, 3, 2.0 ** -40, 2.0 ** 40]),
                        np.abs(_random_floats(rng, 200, -40, 40))])
    a_parts, h_parts = [], []
    for hv in h:
        hv = f(hv)
        base = [f(0), f(-0.0)]
        for k in range(-30, 31, 3):
            p = f(np.ldexp(hv, k))
            if 2.0 ** -80 <= p <= 2.0 ** 80:
                base += [p, np.nextafter(p, f(0)), np.nextafter(p, f(np.inf))]
        mult = (np.arange(1, 1001, dtype=np.float32) * hv).astype(np.float32)
        mult = mult[(mult >= 2.0 ** -80) & (mult <= 2.0 ** 80)]
        for x in (mult, np.nextafter(mult, f(0)), np.nextafter(mult, f(np.inf)),
                  np.nextafter(np.nextafter(mult, f(np.inf)), f(np.inf))):
            base += list(x)
        base += [f(2.0 ** -80), f(2.0 ** 80)]
        a = np.asarray(base, dtype=np.float32)
        a_parts += [a, -a]
        h_parts += [np.full(2 * len(a), hv, dtype=np.float32)]
    return np.concatenate(a_parts), np.concatenate(h_parts)


@pytest.mark.parametrize("kind", ["random", "near_midpoint", "edges"])
def test_cuda_source_reciprocal_division_exact(k8_division, kind):
    """The sum pass's division (fl(a * fl(1 / h)) and one FMA correction
    with the remainder) equals IEEE a / h, with +-0 alike (the kernel only
    squares the quotient), over the range where the kernel takes it:
    4 * 10^6 random inputs of every exponent; 10^6 quotients within a few
    2^-49 of a midpoint between two floats (the hard cases of rounding),
    half with the worst-rounded reciprocals; and the edges (a = +-0,
    quotients beside powers of two, ulp neighbours of multiples of h)."""
    rng = np.random.default_rng(["random", "near_midpoint", "edges"]
                                .index(kind))
    if kind == "random":
        a = _random_floats(rng, 4_000_000, -80, 80)
        h = np.abs(_random_floats(rng, 4_000_000, -40, 40))
    elif kind == "near_midpoint":
        a = np.empty(1_000_000, dtype=np.float32)
        h = np.empty_like(a)
        assert k8_division.kde_div_hard(a.size, 17, a.ctypes.data,
                                        h.ctypes.data) == a.size
    else:
        a, h = _edge_inputs(rng)
        assert a.size > 10 ** 6
    assert _mismatches(k8_division, a, h) == 0
    assert _mismatches(k8_division, a, -h) == 0


@pytest.mark.parametrize("bw", [0.01, 0.015])
def test_cuda_source_reciprocal_division_every_distance(k8_division, bw):
    """At the default bandwidths (short 0.01, long 0.015), every float
    distance a with 2^-12 <= |a| < 2 (x - v of grid cells and pair
    distances in [0, 1]), both signs: the reciprocal division equals IEEE
    a / h on all 2 x 109 M of them."""
    lo = np.float32(2.0 ** -12).view(np.uint32)
    hi = np.nextafter(np.float32(2), np.float32(0)).view(np.uint32)
    assert k8_division.kde_div_sweep(np.float32(bw), int(lo), int(hi)) == 0


@pytest.mark.parametrize("case", ["tiny_value", "huge_value", "narrow_bw",
                                  "wide_bw", "tiny_max"])
def test_cuda_source_emulated_division_paths(k8_emulated_test_exp, case):
    """Regions whose cells leave the reciprocal division's range take
    __fdiv_rn (a value of 10^-40 for the cell at x = 0, a value of
    3 x 10^38, a bandwidth below 2^-40 or above 2^40, a value 10^-18 from
    the cell at x = 0, so that 0 < |m| < 2^-100) beside a region that
    keeps it; with exp swapped for an f32 function, m and s equal the
    halving order's bit for bit. The reciprocal division would give NaN
    for the 3 x 10^38 value (its quotient overflows); below the range its
    quotients can be an ulp off, but their squares underflow to 0 there,
    so only the bits of the __fdiv_rn path show."""
    rng = np.random.default_rng(len(case))
    V, nv, bwv, _n = _batch(rng, [300, 300], [0.01, 0.015])
    if case == "tiny_value":
        V[0, 5] = np.float32(1e-40)
    elif case == "huge_value":
        V[0, 7] = np.float32(3e38)
    elif case == "tiny_max":
        V[0, 9] = np.float32(1e-18)
    else:
        bwv[0] = np.float32(1e-13 if case == "narrow_bw" else 2e12)
    m, s = _emulated_run(k8_emulated_test_exp, V, nv, bwv, 300, None, XS_SUB)
    with np.errstate(over="ignore"):
        m_want, s_want = _halving_reference(V, nv, bwv, _exp_test, XS_SUB)
    assert np.array_equal(m, m_want)
    assert np.array_equal(s, s_want)


def test_cuda_source_geometry_per_device(k8_emulated):
    """K8's launch rule reads the SM count of the device it launches on:
    on the emulation's second device (66 SMs) 510 groups of 8 cells are 4
    an SM, so a thread holds 8 cells, where the H100's 132 SMs give 4.
    The count is cached per device, so the first device's launch is the
    same after the second's, and threads on the two devices at once (ctypes
    drops the GIL) each get their own device's launch."""
    import threading

    so = k8_emulated
    so.emu_set_device.restype = ctypes.c_int
    so.emu_set_device.argtypes = [ctypes.c_int]
    h100 = (4, 4, 260, 512)
    assert _geometry(so, 10, 8192, 4950) == h100
    try:
        assert so.emu_set_device(1) == 0
        small = _geometry(so, 10, 8192, 4950)
    finally:
        assert so.emu_set_device(0) == 0
    assert small == (2, 8, 130, 256)
    assert _geometry(so, 10, 8192, 4950) == h100
    seen = {0: set(), 1: set()}

    def on(dev):
        assert so.emu_set_device(dev) == 0
        for _ in range(200):
            seen[dev].add(_geometry(so, 10, 8192, 4950))

    threads = [threading.Thread(target=on, args=(d,)) for d in (0, 1, 0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {0: {h100}, 1: {small}}
