"""The CUDA source of K3 and K4 (otter_tpu_torch/csrc/myers_banded.cu) run
on the CPU: g++ compiles it against the emulation of the CUDA surface in
tests/test_torch_affine_emulated.py (one std::thread per CUDA thread; a
warp meets at every shuffle and vote), and the kernels' results are held
against the plain PyTorch version, exactly, above k and where row m left
the band too. This checks the lane-group pipeline and its carries, the
sliding band window, the score's hand-over between lanes and the job
order at every (G, q) instance the wrapper can pick, where there is no
card; the card runs the same source in tests/test_torch_cuda.py and
chip_smoke.py."""

import ctypes
import random

import pytest
import torch

from otter_tpu_torch.kernels import myers_banded as K34
from otter_tpu_torch.kernels import myers_striped as K2
from otter_tpu_torch.kernels.edit_engine import EditDistanceEngine

from test_torch_affine_emulated import build_emulated
from test_torch_distance_emulated import CSRC, _mutate, _seq

CPU = torch.device("cpu")
P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def k34_emulated(tmp_path_factory):
    # the kernel's warps share no memory, so they may run in turn
    so = build_emulated(tmp_path_factory, CSRC + "myers_banded.cu",
                        warps_in_turn=True)
    so.otter_myers_banded.restype = I
    so.otter_myers_banded.argtypes = [P, I, P, P, P, P, I, P, I, I, I, I, I,
                                      P, P]
    so.otter_myers_banded_ef.restype = I
    so.otter_myers_banded_ef.argtypes = [P, I, P, P, P, P, P, P, I, P, I, I,
                                         I, I, I, P, P]
    return so


def _k34_run(so, jobs, k, ef, shape=None, plain=True):
    """K3 (``ef`` False: tb = te = 0) or K4 over oriented (pattern, text,
    tb, te) jobs on the emulated warps, at ``shape`` = (G, q) or the
    wrapper's pick, in the wrapper's job order; returns (G, q), the
    kernel's result and the plain version's (None unless ``plain``)."""
    pool, ip, it, nl, ml, tb, te, nw, tl = K2.oriented_inputs(
        [j[:2] for j in jobs], [j[2] for j in jobs], [j[3] for j in jobs],
        CPU)
    if not ef:
        tb = te = torch.zeros_like(nl)
    G, q, order = K34.banded_launch(nl, tb if ef else None, k,
                                    *(shape or (None, None)))
    B = len(jobs)
    out = torch.full((B,), -7, dtype=torch.int32)
    head = (pool.data_ptr(), pool.shape[1], ip.data_ptr(), it.data_ptr(),
            nl.data_ptr(), ml.data_ptr())
    tail = (k, out.data_ptr(), B, nw, tl, G, q,
            None if order is None else order.data_ptr(), None)
    if ef:
        err = so.otter_myers_banded_ef(*head, tb.data_ptr(), te.data_ptr(),
                                       *tail)
    else:
        err = so.otter_myers_banded(*head, *tail)
    assert err == 0
    if not plain:
        return (G, q), out, None
    return (G, q), out, K34.myers_banded_torch(pool, ip, it, nl, ml, tb, te,
                                               k, nw, tl)


def _k34_jobs(rng, n, k, tb_max, m_lo, m_hi):
    """Oriented jobs for band k: a pattern and its mutated copy with tb / te
    random text chars around it (free where ``tb_max`` > 0), patterns of
    any length mod 64, texts long enough that the window slides; a pattern
    far longer than its text (row m never enters the band: 2^30), and
    unrelated sides (results far above k)."""
    jobs = []
    for x in range(n):
        p = _seq(rng, rng.randint(m_lo, m_hi))
        tb = rng.randint(0, tb_max)
        te = rng.randint(0, tb_max)
        t = _seq(rng, tb) + _mutate(rng, p, [0.01, 0.05, 0.3][x % 3]).replace(
            "N", "G") + _seq(rng, te)
        jobs.append((p, t, tb, te))
    short = _seq(rng, rng.randint(10, 40))
    jobs += [(_seq(rng, len(short) + k + 200) + short, short, 0, 0),
             (_seq(rng, m_hi), _seq(rng, m_hi + 5), 0, 0)]
    return jobs


@pytest.mark.parametrize("shape", K34.banded_shapes())
def test_k34_cuda_source_emulated_every_shape(k34_emulated, shape):
    """K3 and K4 as written for the card, at every (G, q) their wrapper can
    pick, on the emulated warps: equal to the plain version on every job
    (exact, above k and 2^30 included), with a band window of
    min(G q, q + 2) blocks, so it spans two lanes or more and every 64
    columns slides a block across a lane boundary; K4 with free ends that differ
    by job (one launch of several window widths); and a launch of one
    job."""
    G, q = shape
    rng = random.Random(400 + 16 * G + q)
    wt = min(G * q, q + 2)
    k3, k4 = 32 * (wt - 2) + 31, 32 * (wt - 2) + 10
    n = min(32 // G + 3, 20)
    for ef, k in ((False, k3), (True, k4)):
        jobs = _k34_jobs(rng, n, k, 40 if ef else 0, 48 * wt + 64,
                         48 * wt + 150)
        assert K34.banded_window(k, 40 if ef else 0) <= G * q
        _s, got, want = _k34_run(k34_emulated, jobs, k, ef, shape)
        assert torch.equal(got, want)
        assert (want <= k).any() and (want > k).any()
        assert (want == K2.CAPTURE_INIT).any()
        # a job's plain result does not depend on the others in its launch
        _s, got1, _w = _k34_run(k34_emulated, jobs[:1], k, ef, shape,
                                plain=False)
        assert torch.equal(got1, want[:1])


@pytest.mark.parametrize("k", [5, 63, 130, 511, 2047])
def test_k34_cuda_source_emulated_bands(k34_emulated, k):
    """K3 and K4 at the shape their wrapper picks for a small launch (the
    widest group), at k = 5 ... 2047 (2047: the widest K3 rung, 65 blocks):
    equal to the plain version (exact), patterns past k + 250 so blocks
    enter and leave the band."""
    rng = random.Random(900 + k)
    m_lo = k + 250
    for ef in (False, True):
        tb_max = min(k, 200) if ef else 0
        jobs = _k34_jobs(rng, 3, k, tb_max, m_lo, m_lo + 130)
        shape, got, want = _k34_run(k34_emulated, jobs, k, ef)
        assert shape == K34.banded_shape(len(jobs),
                                         K34.banded_window(k, tb_max))
        assert torch.equal(got, want)
        assert (want <= k).any()


def test_k4_cuda_source_emulated_widest_window(k34_emulated):
    """K4 with free begins from 0 to 8,064 chars: a window of 129 blocks
    (the engine allows 2k + tb up to 8,192 for 32 kb patterns), one launch
    of jobs whose windows range from 3 to 129 blocks, exact against the
    plain version."""
    rng = random.Random(77)
    k = 63
    jobs = []
    for tb in (0, 100, 1000, 8064):
        p = _seq(rng, rng.randint(200, 300))
        jobs.append((p, _seq(rng, tb) + _mutate(rng, p, 0.02).replace(
            "N", "T"), tb, rng.randint(0, 3)))
    shape, got, want = _k34_run(k34_emulated, jobs, k, True)
    assert shape == (32, 5) and K34.banded_window(k, 8064) == 129
    assert torch.equal(got, want)
    assert (want <= k).all()


def test_k34_shapes_cover_engine_rungs():
    """The shape picker covers every rung the engine's K3 ladder can ask
    for (k up to 2047: 65 blocks) and every K4 rung (klo + 2k up to a
    quarter of a 32 kb pattern: 130 blocks), with q <= QMAX and G q at least
    the window, at any job count; a small launch takes many lanes on each
    job, a large one few; a window past 32 QMAX blocks raises, and so does a
    forced group too small for the window."""
    shapes = set(K34.banded_shapes())
    quarter = EditDistanceEngine.MYERS_TEXT_CAP * EditDistanceEngine.BANDED_FRAC
    for k in EditDistanceEngine.K_LONG:
        windows = [K34.banded_window(k)]
        klo = 64
        while klo + 2 * k <= quarter:
            windows.append(K34.banded_window(k, klo))
            klo *= 2
        for w in windows:
            for n_jobs in (1, 7, 300, 9900, 100000):
                G, q = K34.banded_shape(n_jobs, w)
                assert (G, q) in shapes and G * q >= w and q <= K34.QMAX
    assert K34.banded_window(2047) == 65
    assert K34.banded_window(63, 8192 - 128) == 129
    # a warp a scheduler at most, else the least G (the timing sets and the
    # reference-default region's rungs)
    assert K34.banded_shape(8128, 3) == (2, 2)
    assert K34.banded_shape(4096, 3) == (4, 1)
    assert K34.banded_shape(9900, 3) == (1, 3)
    assert K34.banded_shape(10000, K34.banded_window(511)) == (4, 5)
    assert K34.banded_shape(2048, K34.banded_window(63, 2000)) == (8, 5)
    assert K34.banded_shape(1, 3)[0] == 4
    assert K34.banded_shape(1 << 20, 8) == (1, 8)
    assert len(shapes) == 47
    with pytest.raises(ValueError):
        K34.banded_shape(1, 32 * K34.QMAX + 1)
    with pytest.raises(ValueError):
        K34.banded_shape(1, 65, group=4)
    assert K34.banded_shape(1, 10, group=32, q=8) == (32, 8)
    with pytest.raises(ValueError):
        K34.banded_shape(1, 10, group=4, q=2)


def test_k34_launch_given_free_begin_and_order():
    """``banded_launch``: K4 sized by the widest free begin its caller gives
    takes the shape and order the read-back of ``tb`` gives; the jobs are
    put in order of window, then text length, only where a warp holds
    several of them; a card with fewer schedulers takes fewer lanes a
    job."""
    g = torch.Generator().manual_seed(5)
    nl = torch.randint(2000, 2600, (4096,), generator=g, dtype=torch.int32)
    tb = torch.randint(0, 200, (4096,), generator=g, dtype=torch.int32)
    G, q, order = K34.banded_launch(nl, tb, 63)
    for given in (199, int(tb.max())):
        G1, q1, order1 = K34.banded_launch(nl, tb, 63, tb_max=given)
        assert (G1, q1) == (G, q) and torch.equal(order1, order)
    key = nl.long() + (126 + tb.long()) // 64 * (1 << 16)
    assert (G, q) == (4, 2) and bool((key[order.long()].diff() >= 0).all())
    assert K34.banded_launch(nl, None, 63)[:2] == (4, 1)
    assert K34.banded_launch(nl[:8], None, 63)[2] is None  # one warp
    assert K34.banded_launch(nl[:100], None, 1023)[:3] == (32, 2, None)
    assert K34.scheduler_lanes(CPU) == K34.H100_LANES == 132 * 128
    assert K34.banded_shape(8128, 3, lanes=114 * 128) == (1, 3)
