"""The CUDA sources of K7 and K9 (otter_tpu_torch/csrc/edit_banded.cu) and K2
(csrc/myers_striped.cu) run on the CPU: g++ compiles each against the
emulation of the CUDA surface in tests/test_torch_affine_emulated.py (one
std::thread per CUDA thread; a warp meets at every shuffle, a block at every
__syncthreads), and the kernels' results are held against the plain PyTorch
versions, exactly. This checks the warp and block designs (the prefix-min
scans, the lane-group pipeline and its carries, the job order) where there
is no card; the card runs the same sources in tests/test_torch_cuda.py and
chip_smoke.py."""

import ctypes
import random

import numpy as np
import pytest
import torch

from otter_tpu_torch.kernels import edit_banded as K7
from otter_tpu_torch.kernels import myers_striped as K2

from test_torch_affine_emulated import build_emulated
from test_torch_cuda import k9_jobs

CSRC = K7.__file__.rsplit("/", 2)[0] + "/csrc/"
CPU = torch.device("cpu")
P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def k7_emulated(tmp_path_factory):
    so = build_emulated(tmp_path_factory, CSRC + "edit_banded.cu")
    so.otter_edit_banded.restype = I
    so.otter_edit_banded.argtypes = [P, P, P, I, I, P, I, P, P]
    return so


@pytest.fixture(scope="module")
def k9_emulated(k7_emulated):
    so = k7_emulated
    so.otter_edit_banded_ends_free.restype = I
    so.otter_edit_banded_ends_free.argtypes = [P, P, P, I, I, I, P, I, P, P]
    so.otter_edit_banded_ends_free_shape.restype = I
    so.otter_edit_banded_ends_free_shape.argtypes = [I, P]
    so.emu_set_stagger.argtypes = [I]
    return so


@pytest.fixture(scope="module")
def k2_emulated(tmp_path_factory):
    so = build_emulated(tmp_path_factory, CSRC + "myers_striped.cu")
    so.otter_myers_striped.restype = I
    so.otter_myers_striped.argtypes = [P, I, P, P, P, P, P, P, P, I, I, I, I,
                                       I, P, P]
    return so


def _seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(alphabet) for _ in range(n))


def _mutate(rng, s, rate):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate * 0.4:
            out.append(rng.choice("ACGTN"))
        elif r < rate * 0.7:
            out += [ch, rng.choice("ACGT")]
        elif r >= rate:
            out.append(ch)
    return "".join(out)


def _k7_run(so, pairs, k):
    a, bpad, mn = K7.pack_banded(pairs, k)
    B, L = a.shape
    W = 2 * (k + 1)
    out = np.full(B, -7, dtype=np.int32)
    scratch = np.zeros(W * B if W > K7.SMEM_LANES else 1, dtype=np.int32)
    err = so.otter_edit_banded(a.ctypes.data, bpad.ctypes.data,
                               mn.ctypes.data, L, k, out.ctypes.data, B,
                               scratch.ctypes.data, None)
    assert err == 0
    want = K7.edit_banded_torch(*(torch.from_numpy(x) for x in (a, bpad, mn)),
                                k).numpy()
    return out, want


# k -> (pairs, shortest, longest side): the warp kernel at L = 1, 2, 4, 12
# and 32 lanes a thread, the block kernel with the row in shared memory
# (766) and in device-memory scratch (16894); at both, diagonal +1 is the
# first lane of a warp (192 threads of 8 lanes, 1024 of 33)
K7_CASES = {7: (6, 5, 60), 31: (6, 10, 120), 63: (6, 20, 200),
            130: (6, 50, 300), 511: (4, 50, 300), 766: (3, 100, 200),
            16894: (2, 10, 24)}


@pytest.mark.parametrize("k", list(K7_CASES))
def test_k7_cuda_source_emulated_match_plain(k7_emulated, k):
    """K7 as written for the card, on the emulated warps and blocks: equal
    to the plain version on every pair (exact, INF included): N bases,
    distances near k, unrelated sides (the band's edges reach the result),
    a length difference past k, an empty side, identical sides; and a
    launch of one pair."""
    rng = random.Random(7000 + k)
    count, lo, hi = K7_CASES[k]
    pairs = []
    for q in range(count):
        s = _seq(rng, rng.randint(lo, hi), "ACGTN" if q % 2 else "ACGT")
        pairs.append((s, _mutate(rng, s, [0.02, 0.3][q % 2]) or "N"))
    # unrelated sides: a banded value far above k, which the lanes at the
    # band's right edge reach (their "up" operand is INF)
    u = hi if k > 130 else max(hi, 5 * k)
    pairs += [(_seq(rng, u), _seq(rng, u - 3, "ACGTN")), ("", "ACGN"),
              ("NNAC", "NNAC")]
    # an insertion of g in the columns, then g + 1 more rows: the
    # alignment runs along diagonal +g (at k <= 130 the band's right edge,
    # whose "up" operand is INF) and crosses every lane boundary from
    # diagonal 0 to +g in one row
    g = min(k, 80 if k < 1000 else 6)
    x = _seq(rng, 4 * g + 40)
    pairs.append((x + _seq(rng, g + 1), x[:20] + _seq(rng, g) + x[20:]))
    if k < 1000:  # a length difference of k + 1 or more: INF
        far = k + 1 + rng.randint(0, 8)
        pairs.append((_seq(rng, 20), _seq(rng, 20 + far, "ACGTN")))
    got, want = _k7_run(k7_emulated, pairs, k)
    assert np.array_equal(got, want)
    assert (want < K7.INF).any() and ((want == K7.INF).any() or k > 1000)
    got1, want1 = _k7_run(k7_emulated, pairs[:1], k)
    assert np.array_equal(got1, want1)


def _k9_run(so, jobs, k):
    ax, bxp, meta = K7.pack_ends_free(jobs, range(len(jobs)), k)
    B = len(jobs)
    W = 2 * (k + 1)
    out = np.full(B, -7, dtype=np.int32)
    scratch = np.zeros(W * B if W > K7.SMEM_LANES else 1, dtype=np.int32)
    err = so.otter_edit_banded_ends_free(
        ax.ctypes.data, bxp.ctypes.data, meta.ctypes.data, ax.shape[1],
        bxp.shape[1], k, out.ctypes.data, B, scratch.ctypes.data, None)
    assert err == 0
    want = K7.edit_banded_ends_free_torch(
        *(torch.from_numpy(x) for x in (ax, bxp, meta)), k).numpy()
    return out, want


# k -> (jobs, shortest, longest text, the kernel and instance that k takes:
# (0, 1, L) the warp kernel of L lanes a thread, (1, P, L) P warps of L,
# (2, threads, lanes a thread) the block kernel): the warp kernel at L = 4,
# 8, 12, 24 and 32 (k = 32, 64, 128: the ladder's first rungs); P warps at
# every instance: k = 512 (W = 1026, two lanes past the warp kernel), 575
# (W = 1152 = 32 P L, the last lane in the band), 600 and 1100 (W not a
# multiple of 32 P L), 1500, 2200 and 8447 (k_max, 16 warps of 33); the
# block kernel with the row in shared memory (9000) and in device-memory
# scratch (16500)
K9_CASES = {32: (12, 70, 200, (0, 1, 4)), 64: (12, 130, 300, (0, 1, 8)),
            128: (8, 100, 300, (0, 1, 12)), 256: (6, 60, 200, (0, 1, 24)),
            511: (4, 40, 150, (0, 1, 32)), 512: (6, 100, 700, (1, 4, 9)),
            575: (4, 150, 400, (1, 4, 9)), 600: (3, 30, 90, (1, 8, 9)),
            1100: (4, 300, 700, (1, 8, 9)), 1500: (3, 200, 600, (1, 8, 17)),
            2200: (3, 40, 600, (1, 16, 17)), 8447: (3, 10, 90, (1, 16, 33)),
            9000: (2, 10, 40, (2, 1024, 18)),
            16500: (2, 10, 24, (2, 1024, 33))}


def _k9_crossings(rng, k, lanes):
    """Two jobs whose path leaves the main diagonal (lane k + 1) along a row
    (text chars inserted) and down a column (pattern chars inserted) across
    the nearest boundary between two warps of ``lanes`` lanes each: past it
    a lane's left term comes from the warps before it, and before it its
    "up" from the next warp. The inserted chars are N, which match nothing
    in the ACGT rest, so that path is the only one of least cost, and a
    cell on it one too high changes the result."""
    x = _seq(rng, 60)
    right = (k + 1) // lanes * lanes + lanes - (k + 1) + 4
    down = (k + 1) % lanes + 4
    return [(x, x[:30] + "N" * right + x[30:], 0, 0, 0, 0),
            (x[:30] + "N" * down + x[30:], x, 0, 0, 0, 0)]


@pytest.mark.parametrize("k", list(K9_CASES))
def test_k9_cuda_source_emulated_match_plain(k9_emulated, k):
    """K9 as written for the card, on the emulated warps and blocks (a
    block's warps together, so the P-warp kernel's slots are shared as on
    the card): k takes the instance its case names, and the kernel equals
    the plain version on every job (exact, INF included), with jobs of
    different m, n and frees in one launch, on P warps also paths that
    cross between warps along a row and down a column; and a launch of one
    job."""
    rng = random.Random(9000 + k)
    count, lo, hi, shape = K9_CASES[k]
    got_shape = np.zeros(3, dtype=np.int32)
    assert k9_emulated.otter_edit_banded_ends_free_shape(
        k, got_shape.ctypes.data) == 0
    assert tuple(got_shape) == shape
    jobs = k9_jobs(rng, k, count, lo, hi)
    if shape[0] == 1:
        jobs += _k9_crossings(rng, k, 32 * shape[2])
    got, want = _k9_run(k9_emulated, jobs, k)
    assert np.array_equal(got, want)
    assert (want < K7.INF).any()
    got1, want1 = _k9_run(k9_emulated, jobs[:1], k)
    assert np.array_equal(got1, want1)


# one k of each P-warp instance: (4, 9), (8, 9), (8, 17), (16, 17), (16, 33)
K9_WARPS_STAGGERED = (512, 1100, 1500, 2200, 8447)


@pytest.mark.parametrize("stagger", [1, -1], ids=["first", "last"])
@pytest.mark.parametrize("k", K9_WARPS_STAGGERED)
def test_k9_warps_emulated_staggered(k9_emulated, k, stagger):
    """K9's P-warp kernel with a block's warps run one at a time between
    barriers, from the first warp or from the last: each warp writes the
    next row's slots before the warps after it read this row's (the
    exclusive prefix from the warps before, the "up" from the warp after),
    so a slot that is not double-buffered by row parity is read stale, one
    too high on the crossing paths. Exact against the plain version, on
    the paths that cross between warps along a row and down a column (each
    a result that a stale slot changes)."""
    jobs = _k9_crossings(random.Random(9100 + k), k, 32 * K9_CASES[k][3][2])
    k9_emulated.emu_set_stagger(stagger)
    try:
        got, want = _k9_run(k9_emulated, jobs, k)
    finally:
        k9_emulated.emu_set_stagger(0)
    assert np.array_equal(got, want)
    assert (want < K7.INF).any()


def _k2_jobs(rng, G, q):
    """Oriented (pattern, text) jobs with tb / te: the longest pattern fills
    G q words, the others leave lanes idle; patterns longer and shorter
    than their texts (both orientations the engine sends), free begins and
    ends, 1-char sides."""
    m_max = 64 * G * q - rng.randint(0, 40)
    jobs = [(_seq(rng, m_max), _seq(rng, rng.randint(20, 60)), 3, 4)]
    for x in range(128 // G + 3):
        m = rng.randint(1, min(m_max, 150))
        p = _seq(rng, m)
        t = _mutate(rng, p, 0.1).replace("N", "A") + _seq(rng,
                                                          rng.randint(0, 20))
        t = t[: rng.randint(1, 90)] or "C"
        tb, te = [(0, 0), (rng.randint(0, len(t)), 0),
                  (0, rng.randint(0, len(t))), (2, 3)][x % 4]
        # every pattern within the first one's words
        jobs.append((p, t, tb, te) if x % 3 else (t[:m_max], p, tb, te))
    jobs.append(("A", "ACGTACGT", 0, 8))
    return jobs


def _k2_run(so, jobs, group):
    pool, ip, it, nl, ml, tb, te, nw, tl = K2.oriented_inputs(
        [j[:2] for j in jobs], [j[2] for j in jobs], [j[3] for j in jobs],
        CPU)
    G, q, order = K2.striped_launch(ml, nl, nw, group)
    B = len(jobs)
    out = torch.full((B,), -7, dtype=torch.int32)
    err = so.otter_myers_striped(
        pool.data_ptr(), pool.shape[1], ip.data_ptr(), it.data_ptr(),
        nl.data_ptr(), ml.data_ptr(), tb.data_ptr(), te.data_ptr(),
        out.data_ptr(), B, nw, tl, G, q,
        None if order is None else order.data_ptr(), None)
    assert err == 0
    return (G, q), out, K2.myers_striped_torch(pool, ip, it, nl, ml, tb, te,
                                               nw, tl)


@pytest.mark.parametrize("shape", K2.striped_shapes())
def test_k2_cuda_source_emulated_match_plain(k2_emulated, shape):
    """K2 as written for the card, at every (G, q) its wrapper can pick, on
    the emulated warps: equal to the plain version on every job (exact),
    with jobs in two blocks (the last one part full), and in a launch of
    one job."""
    G, q = shape
    rng = random.Random(200 + 64 * G + q)
    jobs = _k2_jobs(rng, G, q)
    got_shape, got, want = _k2_run(k2_emulated, jobs, G)
    assert got_shape == shape
    assert torch.equal(got, want)
    _shape, got1, want1 = _k2_run(k2_emulated, jobs[:1], G)
    assert torch.equal(got1, want1)


def test_k2_shapes_cover_patterns_past_2048():
    """Patterns over 2048 chars take a whole warp with q up to 16; short
    launches put many lanes on each job, large ones fewer."""
    assert K2.striped_shape(3, 2 * 33) == (32, 2)
    assert K2.striped_shape(100000, 2 * 512) == (32, 16)
    assert K2.striped_shape(10, 44)[0] == 32
    assert K2.striped_shape(16384, 44)[0] < 32
    shapes = K2.striped_shapes()
    assert {G for G, _q in shapes} == set(K2.GROUPS)
    assert {q for _G, q in shapes} == {1, 2, 4, 8, 16, 32}
    assert (1, 32) in shapes and (32, 16) in shapes
    with pytest.raises(ValueError):
        K2.striped_shape(1, 4, group=3)
