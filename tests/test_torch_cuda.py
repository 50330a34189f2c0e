"""The port's CUDA kernels and pipeline on the card, against their plain
PyTorch versions and the JAX-free oracles. Every test is marked ``cuda``
and skips without a CUDA device.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Every comparison is exact: integer distances and output bytes."""

import io
import random

import numpy as np
import pytest
import torch

from otter_tpu.config import OtterOpts
from otter_tpu.models.assemble import assemble as reference_assemble
from otter_tpu.native import edit_distance_batch
from otter_tpu.ops.align_np import edit_distance_ends_free
from otter_tpu.ops.align_batch import affine_cigars_multi
from otter_tpu_torch.kernels import affine_tb as K5
from otter_tpu_torch.kernels import edit_banded as K7
from otter_tpu_torch.kernels import myers_banded as K34
from otter_tpu_torch.kernels import myers_pallas as K1
from otter_tpu_torch.kernels import myers_striped as K2
from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
from otter_tpu_torch.kernels.edit_engine import EditDistanceEngine, MeshEngine
from otter_tpu_torch.models.assemble import assemble
from otter_tpu_torch.ops.align_batch import _ends_free_banded_numpy
from otter_tpu_torch.utils.synth import poa_shaped_graph

from fixtures import make_reference, simulate_region_bam

pytestmark = pytest.mark.cuda
CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


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


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def k9_jobs(rng, k, count, lo, hi):
    """Ends-free jobs for a K9 pass at band k: texts of lo-hi chars with N
    bases, each pattern a mutated piece of its text, frees on both sides,
    one side and none (up to the length difference, as the callers give
    them), patterns of different lengths (rows past the shorter ones), and
    short jobs whose last column starts in row 0's band (n <= k) or whose
    pattern is empty."""
    jobs = []
    for q in range(count):
        t = "".join(rng.choice("ACGTN") for _ in range(rng.randint(lo, hi)))
        a = rng.randint(0, min(30, len(t) // 4))
        b = len(t) - rng.randint(0, min(30, len(t) // 4))
        p = "".join(c if rng.random() > [0.01, 0.1, 0.3][q % 3]
                    else rng.choice("ACGTN") for c in t[a:b]) or "A"
        ld = abs(len(t) - len(p))
        frees = [(ld, ld, 0, 0), (0, 0, ld, ld), (a, 0, 0, len(t) - b),
                 (0, 0, 0, 0), (0, ld, a, 0), (ld // 2, 0, 0, ld)][q % 6]
        jobs.append((p, t, *frees) if q % 2 else (t, p, *frees))
    jobs += [("ACGTA", "ACG", 0, 5, 0, 0), ("ACNT", "AGNT", 1, 0, 0, 2),
             ("", "ACGT", 0, 0, 2, 3)]
    return jobs


def _column_scores(p, t, tb, pe):
    """Scores of p[:i] against all of t (no free ends after them) for the
    last pe + 1 rows i, from the plain version on the CPU."""
    jobs = [(p[:i], t, 0, 0, tb, 0) for i in range(len(p) - pe, len(p) + 1)]
    args = [torch.from_numpy(x) for x in K5.pack_affine_jobs(jobs, 256, 63)]
    return K5.affine_tb_torch(*args, 63, 128)[1][:, 0].numpy()


def last_column_tie_jobs(rng, n):
    """n members (pattern end free) whose end cell lies on the last column
    above row m, where the smallest score is reached at two or more rows:
    the tie order (largest i) decides the end cell."""
    jobs = []
    while len(jobs) < n:
        core = "".join(rng.choice("AC") for _ in range(rng.randint(10, 40)))
        tail = "".join(rng.choice("ACG") for _ in range(rng.randint(2, 12)))
        t = core + "".join(rng.choice("AC") for _ in range(rng.randint(0, 3)))
        p = core + tail
        pe = rng.randint(2, len(tail))
        tb = rng.randint(0, 3)
        v = _column_scores(p, t, tb, pe)
        low = v[:-1].min()
        if low < v[-1] and (v[:-1] == low).sum() >= 2:
            jobs.append((p, t, 0, pe, tb, 0))
    return jobs


@pytest.mark.parametrize("n_words", K1.N_WORDS_BUCKETS)
def test_myers_pool_cuda_matches_plain(cuda_device, n_words):
    """K1 equals its plain version on the card and the native C++ edit
    distance, in every n_words bucket (exact)."""
    rng = random.Random(n_words)
    pairs = []
    for _ in range(300):
        s = _acgt(rng, rng.randint(max(1, 8 * n_words), 32 * n_words))
        pairs.append((s, _mutate(rng, s, rng.random() * 0.3)
                      + _acgt(rng, rng.randint(0, 100))))
    oriented = [(a, b) if len(a) <= len(b) else (b, a) for a, b in pairs]
    seqs, ip, it = K2.dedup_oriented(oriented)
    m = [len(a) for a, _b in oriented]
    n = [len(b) for _a, b in oriented]
    text_len = max(n)
    pool = K1.pack_pool(seqs, K1.pool_width(n_words, text_len))
    args = [_t(x, cuda_device) for x in (pool, ip, it, n, m)]
    before = K1.myers_pool_cuda.launches
    got = K1.myers_pool(*args, n_words, text_len)
    assert K1.myers_pool_cuda.launches == before + 1
    assert torch.equal(got, K1.myers_pool_torch(*args, n_words, text_len))
    want, _cells = edit_distance_batch(pairs, 8)
    assert got.cpu().tolist() == want.tolist()


@pytest.mark.parametrize("shape", K2.striped_shapes())
def test_myers_striped_cuda_matches_plain(cuda_device, shape):
    """K2 at every (G, q) its wrapper can pick equals its plain version
    (exact): the longest pattern fills G q words (past 2048 bp from q = 2 at
    G = 32), shorter ones leave lanes idle, patterns longer and shorter
    than their texts, free begins and ends, jobs in many warps and in
    job-length order, and a launch of one job."""
    G, q = shape
    rng = random.Random(76 + 64 * G + q)
    m_max = 64 * G * q - rng.randint(0, 40)
    jobs = [(_acgt(rng, m_max), _acgt(rng, rng.randint(100, 400)), 5, 7)]
    for k in range(300):
        p = _acgt(rng, rng.randint(1, min(m_max, 1500)))
        t = _mutate(rng, p, 0.05) + _acgt(rng, rng.randint(0, 60))
        tb, te = [(0, 0), (rng.randint(0, 60), 0), (0, rng.randint(0, 60)),
                  (3, 4)][k % 4]
        # every pattern within the first one's words
        jobs.append((p, t, tb, te) if k % 3 else (t[:m_max], p, tb, te))
    for sel in (jobs, jobs[:1]):
        args = K2.oriented_inputs([j[:2] for j in sel], [j[2] for j in sel],
                                  [j[3] for j in sel], cuda_device)
        assert K2.striped_launch(args[4], args[3], args[7], G)[:2] == shape
        before = K2.myers_striped_cuda.launches
        got = K2.myers_striped_cuda(*args, group=G)
        assert K2.myers_striped_cuda.launches == before + 1
        assert torch.equal(got, K2.myers_striped_torch(*args))


def test_myers_striped_cuda_ends_free_matches_oracle(cuda_device):
    """K2 on one-sided ends-free jobs of every kind, with patterns past
    2048 bp, equals its plain version and the numpy ends-free DP
    (exact)."""
    rng = random.Random(76)
    jobs = []
    for k in range(70):
        m = rng.randint(1, 2600)
        ld = rng.randint(0, 60)
        p = _acgt(rng, m)
        t = _mutate(rng, p, 0.05) + _acgt(rng, ld)
        jobs.append([(p, t, 0, 0, ld, 0), (p, t, 0, 0, 0, ld),
                     (t, p, ld, 0, 0, 0), (t, p, 0, ld, 0, 0),
                     (p, t, 0, 0, ld // 2, ld - ld // 2),
                     (p, t, 0, 0, 0, 0), (p, "", 0, 0, 1, 0)][k % 7])
    got = K2.myers_striped_ends_free(jobs, cuda_device)
    assert np.array_equal(got, K2.myers_striped_ends_free(jobs, CPU))
    assert got.tolist() == [edit_distance_ends_free(*j) for j in jobs]


def test_engine_cuda_matches_cpu(cuda_device):
    """The engine on the card equals the engine on the CPU on every route
    (exact), with the same routing counters."""
    rng = random.Random(85)
    pairs = []
    for lo, hi in ((1, 128), (129, 512), (513, 2048)):
        for _ in range(20):
            s = _acgt(rng, rng.randint(lo, hi))
            pairs.append((s, _mutate(rng, s, 0.05)))
    long_a = _acgt(rng, 2300)
    pairs += [(long_a, _mutate(rng, long_a, 0.02)),
              ("ACGTNACGT" * 5, "ACGTACGT" * 6), ("", "ACG")]
    gpu = EditDistanceEngine(cuda_device)
    cpu = EditDistanceEngine("cpu")
    assert np.array_equal(gpu.distances(pairs), cpu.distances(pairs))
    assert gpu.counters() == cpu.counters()
    assert gpu.pairs_k3 == 1 and gpu.pairs_k7 == 1


@pytest.mark.parametrize("is_fa", [False, True])
def test_assemble_cuda_byte_identical(cuda_device, tmp_path, is_fa):
    """The port's assemble on the card writes otter_tpu --device host's
    bytes on the het fixture of test_e2e_assemble.py (exact)."""
    rng = random.Random(123)
    ref = make_reference(rng, length=3000, repeat="CAG", repeat_at=1500,
                         repeat_units=20)
    bam = str(tmp_path / "reads.bam")
    simulate_region_bam(bam, "chr1", ref, (1500, 1560),
                        [ref[1500:1560], "CAG" * 30], per_allele_cov=12,
                        error_rate=0.002, seed=99)
    bed = str(tmp_path / "regions.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t1500\t1560\n")
    outs = []
    for fn, device in ((assemble, "cuda"), (reference_assemble, "host")):
        p = OtterOpts()
        p.read_group = "S1"
        p.device = device
        p.is_fa = is_fa
        out = io.StringIO()
        fn(bam, bed, "", False, p, out=out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("k", [63, 127, 511, 2047])
def test_myers_banded_cuda_matches_plain(cuda_device, k):
    """K3 and K4 on the card equal their plain versions on every job, above
    k too, at the wrapper's pick and at every (G, q) whose window covers the
    band (a launch of one job too), and the numpy DP where <= k (exact)."""
    rng = random.Random(300 + k)
    jobs = []
    for _ in range(200):
        p = _acgt(rng, rng.randint(1, 3000))
        tb, te = rng.randint(0, 50), rng.randint(0, 50)
        jobs.append((p, _acgt(rng, tb) + _mutate(rng, p, rng.random() * 0.1)
                     + _acgt(rng, te), tb, te))
    args = K2.oriented_inputs([j[:2] for j in jobs], [j[2] for j in jobs],
                              [j[3] for j in jobs], cuda_device)
    pool, ip, it, nl, ml, tb, te, nw, tl = args
    zero = torch.zeros_like(nl)
    want3 = K34.myers_banded_torch(pool, ip, it, nl, ml, zero, zero, k, nw,
                                   tl)
    want4 = K34.myers_banded_torch(pool, ip, it, nl, ml, tb, te, k, nw, tl)
    before = K34.myers_banded_cuda.launches
    assert torch.equal(K34.myers_banded(pool, ip, it, nl, ml, k, nw, tl),
                       want3)
    assert K34.myers_banded_cuda.launches == before + 1
    got4 = K34.myers_banded_ef(pool, ip, it, nl, ml, tb, te, k, nw, tl)
    assert torch.equal(got4, want4)
    window = K34.banded_window(k, int(tb.max()))
    for G, q in K34.banded_shapes():
        if G * q < window:
            continue
        for sl in (slice(None), slice(0, 1)):
            a = (pool, ip[sl], it[sl], nl[sl], ml[sl])
            assert torch.equal(K34.myers_banded_cuda(*a, k, nw, tl, group=G,
                                                     q=q), want3[sl])
            assert torch.equal(K34.myers_banded_ef_cuda(
                *a, tb[sl], te[sl], k, nw, tl, group=G, q=q), want4[sl])
    for (p, t, b, e), g in zip(jobs, got4.cpu().tolist()):
        d = edit_distance_ends_free(p, t, 0, 0, b, e)
        assert g >= d and (d > k or g == d)


@pytest.mark.parametrize("k", [31, 63, 130, 255, 511, 1023])
def test_edit_banded_cuda_matches_plain(cuda_device, k):
    """K7 on the card (the warp kernel to k = 511, the block kernel above)
    equals its plain version on every pair, INF lanes included, and the
    native distance where <= k (exact): N bases, unrelated pairs, a length
    difference past k, an alignment along diagonal +min(k, 200), and a
    launch of one pair."""
    rng = random.Random(700 + k)
    pairs = []
    for _ in range(200):
        s = "".join(rng.choice("ACGTN") for _ in range(rng.randint(1, 1500)))
        pairs.append((s, _mutate(rng, s, rng.random() * 0.1)))
    g = min(k, 200)
    x = _acgt(rng, 4 * g + 40)
    pairs += [(_acgt(rng, 900), _acgt(rng, 890)),
              (_acgt(rng, 30), _acgt(rng, 31 + k)),
              (x + _acgt(rng, g + 1), x[:20] + _acgt(rng, g) + x[20:])]
    for sel in (pairs[:1], pairs):
        a, bpad, mn = K7.pack_banded(sel, k)
        args = [_t(y, cuda_device) for y in (a, bpad, mn)]
        before = K7.edit_banded_cuda.launches
        got = K7.edit_banded(*args, k)
        assert K7.edit_banded_cuda.launches == before + 1
        assert torch.equal(got, K7.edit_banded_torch(*args, k))
    want, _cells = edit_distance_batch(pairs, 8)
    for v, d in zip(got.cpu().tolist(), want.tolist()):
        assert d > k or v == d


def _affine_cases(rng, k):
    """Consensus members of 100-1500 bp, some with a long gap in the text
    or the pattern (E and F runs across many lanes), a few unrelated ones
    (their score is not below the cap: not walked), and members whose end
    cell is on the last column with tied scores."""
    jobs = []
    for i in range(150):
        rep = _acgt(rng, rng.randint(100, 1500))
        mem = _mutate(rng, rep, rng.choice([0.002, 0.02, 0.08]))
        x, g = rng.randint(0, len(mem) - 1), rng.randint(8, k // 2)
        if i % 25 == 24:
            mem = _acgt(rng, len(rep) + rng.randint(0, k // 2))
        elif i % 5 == 3:
            mem = mem[:x] + mem[x + g:] or "A"
        elif i % 5 == 4:
            mem = mem[:x] + _acgt(rng, g) + mem[x:]
        cut = rng.randint(0, len(mem) // 4)
        jobs.append([(mem, rep, 0, 0, 0, 0), (mem[cut:], rep, 0, 0, cut, 0),
                     (rep, mem[cut:], cut, 0, 0, 0)][i % 3])
    return jobs + last_column_tie_jobs(rng, 8)


def _affine_both(args, k, tw):
    """K5 and K6 on the card, each equal to the plain version (exact);
    returns the plain end rows."""
    ops_p, end_p = K5.affine_tb_torch(*args, k, tw)
    before = (K5.affine_tb_cuda.launches, K5.affine_tb_ckpt_cuda.launches)
    ops, end = K5.affine_tb(*args, k, tw)
    ops_c, end_c = K5.affine_tb_ckpt(*args, k, tw)
    assert (K5.affine_tb_cuda.launches, K5.affine_tb_ckpt_cuda.launches) \
        == (before[0] + 1, before[1] + 1)
    assert torch.equal(ops, ops_p) and torch.equal(end, end_p)
    assert torch.equal(ops_c, ops_p) and torch.equal(end_c, end_p)
    return end_p.cpu().numpy()


@pytest.mark.parametrize("k", [63, 127, 255, 511])
def test_affine_tb_cuda_matches_plain(cuda_device, k):
    """K5 and K6 on the card write their plain version's walks and end
    cells, on members of very different lengths in one launch, members
    that are not walked and last-column ties, and the cigars equal the
    host ladder's (exact)."""
    rng = random.Random(500 + k)
    jobs = _affine_cases(rng, k)
    a, bpad, mn = K5.pack_affine_jobs(jobs, 2048, k)
    tw = K5._t_words(2048, k)
    args = [torch.from_numpy(x).to(cuda_device) for x in (a, bpad, mn)]
    end = _affine_both(args, k, tw)
    assert 0 < end[:, 3].sum() < len(jobs)          # some are not walked
    ties = end[len(jobs) - 8:]
    assert np.all(ties[:, 2] == [len(j[1]) for j in jobs[-8:]])
    cigs, failed = K5.affine_cigars_tb(jobs, cuda_device)
    want = affine_cigars_multi(jobs)
    assert len(failed) < len(jobs) // 2
    for i in set(range(len(jobs))) - set(failed):
        assert cigs[i] == want[i]


@pytest.mark.parametrize("rows", [4096, 8192])
def test_affine_cigar_bytes_cuda_panel_shapes(cuda_device, rows):
    """Panel-shaped members (3-5 kb alleles at k = 63, free ends on either
    side, one unrelated member that is not walked) through K5 <4> and
    K6 <4>: each kernel's (ops, end) into a given cigar buffer equal its own
    into the buffer its wrapper allocates and the plain version's, and its
    cigar bytes equal the plain version's and the host decode of the walk
    codes (exact)."""
    k = 63
    rng = random.Random(2300 + rows)
    jobs = []
    for i in range(24):
        rep = _acgt(rng, rng.randint(rows // 2 + 1000, rows - 200)
                    if rows == 4096 else rng.randint(4200, 5000))
        mem = _mutate(rng, rep, rng.choice([0.002, 0.01, 0.02]))
        if i == 23:
            mem = _acgt(rng, len(rep))
        cut = rng.randint(0, 300)
        jobs.append([(mem, rep, 0, 0, 0, 0), (mem[cut:], rep, 0, 0, cut, 0),
                     (rep, mem[cut:], cut, 0, 0, 0)][i % 3])
    a, bpad, mn = K5.pack_affine_jobs(jobs, rows, k)
    tw = K5._t_words(rows, k)
    args = [torch.from_numpy(x).to(cuda_device) for x in (a, bpad, mn)]
    stride = K5.cigar_stride(jobs)
    cig_p = torch.empty((len(jobs), stride), dtype=torch.uint8,
                        device=cuda_device)
    ops_p, end_p = K5.affine_tb_torch(*args, k, tw, cig_p)
    every = np.arange(len(jobs))
    want = K5.read_cigars(cig_p.cpu().numpy(), mn, every)
    codes = K5._unpack_codes(ops_p.cpu().numpy(), tw)
    end = end_p.cpu().numpy()
    for b, (p, t, *_f) in enumerate(jobs):
        assert want[b] == K5._decode_walk_ops(
            codes[b][codes[b] != 0], p, t, int(end[b, 1]), int(end[b, 2]),
            len(p), len(t)), b
    assert 0 < end[:, 3].sum() < len(jobs)
    for run in (K5.affine_tb_cuda, K5.affine_tb_ckpt_cuda):
        cig = torch.full((len(jobs), stride), ord("?"), dtype=torch.uint8,
                         device=cuda_device)
        before = run.launches
        ops, end_c = run(*args, k, tw, cig)
        ops0, end0 = run(*args, k, tw)
        assert run.launches == before + 2
        assert torch.equal(ops, ops0) and torch.equal(end_c, end0)
        assert torch.equal(ops, ops_p) and torch.equal(end_c, end_p)
        assert K5.read_cigars(cig.cpu().numpy(), mn, every) == want, \
            run.__name__


@pytest.mark.parametrize("k", [63, 127, 255, 511])
def test_affine_tb_cuda_one_member(cuda_device, k):
    """A launch of one member (one warp, most of K5's block idle), a
    member of 1 bp and an unrelated member: exact against the plain
    version."""
    rng = random.Random(900 + k)
    rep = _acgt(rng, 700)
    for job in ((_mutate(rng, rep, 0.02), rep, 0, 0, 0, 0),
                ("A", "C", 0, 0, 0, 0),
                (_acgt(rng, 300), _acgt(rng, 300), 0, 0, 0, 0)):
        a, bpad, mn = K5.pack_affine_jobs([job], 1024, k)
        args = [torch.from_numpy(x).to(cuda_device) for x in (a, bpad, mn)]
        _affine_both(args, k, K5._t_words(1024, k))


@pytest.mark.parametrize("k", [63, 127, 255, 511])
def test_affine_tb_cuda_warps_match_one_warp_launches(cuda_device, k):
    """K5 runs 4 members a block, a warp each, and each warp stages its
    member's codes in its own slice of shared memory; K6 runs a member a
    block. 64 members of 900-1000 bp (long walks, so the stages reload
    often, with different codes in each warp) in one launch write, bit for
    bit, what one-member launches of the same members write, where the
    block's other warps are idle: a warp reading or writing another's slice
    breaks it (exact)."""
    rng = random.Random(1300 + k)
    jobs = []
    for _ in range(64):
        rep = _acgt(rng, rng.randint(900, 1000))
        jobs.append((_mutate(rng, rep, 0.03), rep, 0, 0, 0, 0))
    a, bpad, mn = K5.pack_affine_jobs(jobs, 1024, k)
    tw = K5._t_words(1024, k)
    args = [torch.from_numpy(x).to(cuda_device) for x in (a, bpad, mn)]
    for run in (K5.affine_tb_cuda, K5.affine_tb_ckpt_cuda):
        ops, end = run(*args, k, tw)
        assert int(end[:, 3].sum()) == len(jobs), run.__name__  # all walked
        for i in range(len(jobs)):
            ops1, end1 = run(*(x[i : i + 1] for x in args), k, tw)
            assert torch.equal(ops[i : i + 1], ops1), (run.__name__, i)
            assert torch.equal(end[i : i + 1], end1), (run.__name__, i)


# (regions, nvals) of chip_smoke.py's K8 sets (hifi-tr-1.5k's batch, the
# refscale region, the largest batch), regions of 1 and 9 values, and the
# launch geometry's edges: two regions (W = 4 where one takes 8), and a
# region past the 200 KB shared-memory stage (read from device memory)
K8_SHAPES = [(32, 4950), (1, 19900), (256, 19900), (4, 1), (4, 9),
             (2, 4950), (1, 60000)]


def _k8_args(device, R, n):
    from otter_tpu_torch.ops.kde import kde_grid

    rng = np.random.default_rng(R * 100003 + n)
    n_pad = max(8, 1 << (n - 1).bit_length())
    V = np.zeros((R, n_pad), dtype=np.float32)
    V[:, :n] = np.clip(rng.normal(0.05, 0.05, (R, n)), 0, 1)
    nv = np.full(R, n, dtype=np.int32)
    nv[-1] = max(1, n // 2)                 # a ragged row
    bw = np.where(np.arange(R) % 2, 0.015, 0.01).astype(np.float32)
    return [torch.from_numpy(a).to(device)
            for a in (V, nv, bw, kde_grid(0.0025).astype(np.float32))]


@pytest.mark.parametrize("shape", K8_SHAPES)
def test_kde_scaled_cuda_matches_plain(cuda_device, shape):
    """K8 on the card against its plain version on the card: m equal (the
    same IEEE f32 ops), s to a relative 1e-6 (expf against torch.exp, the
    same halving order)."""
    from otter_tpu_torch.kernels import kde_scaled as K8

    R, n = shape
    args = _k8_args(cuda_device, R, n)
    before = K8.kde_scaled_cuda.launches
    m, s = K8.kde_scaled(*args, n_max=n)
    assert K8.kde_scaled_cuda.launches == before + 1
    m_p, s_p = K8.kde_scaled_torch(*args)
    assert torch.equal(m, m_p)
    torch.testing.assert_close(s, s_p, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(32, 4950), (1, 19900), (3, 1000),
                                   (1, 60000)])
def test_kde_scaled_cuda_every_warps_same_bits(cuda_device, shape):
    """Every W (the warps that split a cell's values) and C (the cells a
    thread holds) keep the halving order, so m and s are the same bits at
    W = 1 ... 16 and C = 4, 8 as by the rule."""
    from otter_tpu_torch.kernels import kde_scaled as K8

    R, n = shape
    args = _k8_args(cuda_device, R, n)
    m, s = K8.kde_scaled_cuda(*args, n_max=n)
    for C in K8.CELLS:
        for W in K8.WARPS:
            mw, sw = K8.kde_scaled_cuda(*args, n_max=n, warps=W, cells=C)
            assert torch.equal(m, mw) and torch.equal(s, sw), (W, C)


def test_kde_scaled_cuda_refused_launch_raises(cuda_device):
    """A launch the kernel's entry refuses (n_max past n_pad) raises; no
    result comes back from another path."""
    from otter_tpu_torch.kernels import kde_scaled as K8

    args = [torch.zeros((2, 8), device=cuda_device),
            torch.ones(2, dtype=torch.int32, device=cuda_device),
            torch.full((2,), 0.01, device=cuda_device),
            torch.zeros(401, device=cuda_device)]
    with pytest.raises(RuntimeError):
        K8.kde_scaled_cuda(*args, n_max=9)


def _tandem_loci(tmp_path):
    from otter_tpu_torch.utils.synth import tandem_repeat_loci

    return tandem_repeat_loci(str(tmp_path), n_regions=2, cov=40, err=0.002,
                              expansion=30, region_len=300, seed=5,
                              name="k8")


def _port_assemble(bam, bed, device):
    from otter_tpu_torch.config import OtterOpts as PortOpts

    p = PortOpts()
    p.read_group = "S1"
    p.device = device
    out = io.StringIO()
    assemble(bam, bed, "", False, p, out=out)
    return out.getvalue()


def test_assemble_device_kde_cuda_byte_identical(cuda_device, tmp_path,
                                                 monkeypatch):
    """With OTTER_TPU_MESH_KDE=1 the port's assemble on the card runs K8 and
    writes the bytes of its CPU run with the float64 KDE (exact)."""
    from otter_tpu_torch.kernels import kde_scaled as K8

    bam, bed = _tandem_loci(tmp_path)
    monkeypatch.setenv("OTTER_TPU_MESH_KDE", "0")
    want = _port_assemble(bam, bed, "cpu")
    monkeypatch.setenv("OTTER_TPU_MESH_KDE", "1")
    before = K8.kde_scaled_cuda.launches
    assert _port_assemble(bam, bed, "cuda") == want
    assert K8.kde_scaled_cuda.launches > before


def test_assemble_k8_failure_raises(cuda_device, tmp_path, monkeypatch):
    """A K8 failure on the card raises out of assemble instead of falling
    back to the float64 KDE."""
    from otter_tpu_torch.kernels import kde_scaled as K8

    def broken(*_a, **_k):
        raise RuntimeError("K8 failed")

    bam, bed = _tandem_loci(tmp_path)
    monkeypatch.setenv("OTTER_TPU_MESH_KDE", "1")
    monkeypatch.setattr(K8, "kde_scaled_cuda", broken)
    with pytest.raises(RuntimeError, match="K8 failed"):
        _port_assemble(bam, bed, "cuda")


def _port_genotype(bam, bed, fa, device):
    from otter_tpu_torch.config import OtterOpts as PortOpts
    from otter_tpu_torch.models.genotype import genotype

    p = PortOpts()
    p.device = device
    out = io.StringIO()
    genotype(p, bam, bed, fa, out=out)
    return out.getvalue()


def test_genotype_cuda_gemm_byte_identical(cuda_device, tmp_path,
                                           monkeypatch):
    """genotype on the card: by default the host f64 BLAS takes the pooled
    cosine GEMM (torch.bmm is never called); with
    OTTER_TPU_GENOTYPE_DEVICE=1 the card does (f32 torch.bmm, TF32 off).
    Both write the VCF of the port's CPU run (exact), on a 64-sample
    cohort."""
    from otter_tpu_torch.utils.synth import cohort_fixture

    cohort = cohort_fixture(str(tmp_path), n_samples=64, n_regions=6)
    want = _port_genotype(*cohort, "cpu")
    calls = []
    real_bmm = torch.bmm

    def spy(x, y):
        calls.append(x.device.type)
        return real_bmm(x, y)

    monkeypatch.setattr(torch, "bmm", spy)
    assert _port_genotype(*cohort, "cuda") == want
    assert calls == []
    monkeypatch.setenv("OTTER_TPU_GENOTYPE_DEVICE", "1")
    got = _port_genotype(*cohort, "cuda")
    assert got == want and calls == ["cuda"]
    assert len([l for l in got.splitlines() if not l.startswith("#")]) == 6


def test_genotype_gemm_failure_raises(cuda_device, tmp_path, monkeypatch):
    """A failure of the GEMM on the card (OTTER_TPU_GENOTYPE_DEVICE=1)
    raises out of genotype instead of giving way to the host BLAS."""
    from otter_tpu_torch.utils.synth import cohort_fixture

    def broken(*_a, **_k):
        raise RuntimeError("bmm failed")

    cohort = cohort_fixture(str(tmp_path), n_samples=8, n_regions=3)
    monkeypatch.setenv("OTTER_TPU_GENOTYPE_DEVICE", "1")
    monkeypatch.setattr(torch, "bmm", broken)
    with pytest.raises(RuntimeError, match="bmm failed"):
        _port_genotype(*cohort, "cuda")


def test_compare_engine_failure_raises(cuda_device, tmp_path, monkeypatch):
    """A failure of the distance engine raises out of compare instead of
    giving way to the scalar host DP."""
    from otter_tpu_torch.config import OtterOpts as PortOpts
    from otter_tpu_torch.models.compare import compare
    from otter_tpu_torch.utils.synth import compare_fixture

    def broken(*_a, **_k):
        raise RuntimeError("engine failed")

    truth, query, bed = compare_fixture(str(tmp_path), 4, seed=3)
    monkeypatch.setattr(EditDistanceEngine, "distances", broken)
    p = PortOpts()
    with pytest.raises(RuntimeError, match="engine failed"):
        compare(p, bed, truth, query, out=io.StringIO())


@pytest.mark.parametrize("k", [32, 64, 128, 256, 511, 512, 1024, 2048,
                               4095, 8191, 9000])
def test_edit_banded_ends_free_cuda_matches_plain(cuda_device, k):
    """K9 on the card (the warp kernel to k = 511, P warps to k = 8447 at
    every instance, the block kernel above) equals its plain version on
    every job (exact, INF included) and the numpy pass of
    edit_ends_free_batch; and a launch of one job."""
    kind = "warp" if k <= 511 else "warps" if k <= 8447 else "block"
    assert K7.ends_free_shape(k)[0] == kind
    rng = random.Random(900 + k)
    jobs = k9_jobs(rng, k, 40 if k <= 2048 else 4, 2 * k + 2, 2 * k + 400)
    members = list(range(len(jobs)))
    want_np = np.minimum(_ends_free_banded_numpy(jobs, members, k), K7.INF)
    for sel in (members[:1], members):
        args = [_t(y, cuda_device) for y in K7.pack_ends_free(jobs, sel, k)]
        before = K7.edit_banded_ends_free_cuda.launches
        got = K7.edit_banded_ends_free(*args, k)
        assert K7.edit_banded_ends_free_cuda.launches == before + 1
        assert torch.equal(got, K7.edit_banded_ends_free_torch(*args, k))
    assert np.array_equal(got.cpu().numpy(), want_np)


def test_mesh_engine_cuda_two_shards_match_one_device(cuda_device):
    """The mesh engine on one card in two shards equals the engine on that
    card (exact) on distances of every route and on ends-free jobs, with
    the same routing counters; its two-sided and non-ACGT ends-free jobs
    run on K9."""
    rng = random.Random(86)
    pairs = []
    for lo, hi in ((1, 128), (129, 512), (513, 2048)):
        for _ in range(20):
            s = _acgt(rng, rng.randint(lo, hi))
            pairs.append((s, _mutate(rng, s, 0.05)))
    long_a = _acgt(rng, 2300)
    pairs += [(long_a, _mutate(rng, long_a, 0.02)),
              ("ACGTNACGT" * 5, "ACGTACGT" * 6), ("", "ACG")]
    jobs = k9_jobs(rng, 32, 30, 100, 600)
    one = EditDistanceEngine(cuda_device)
    mesh = MeshEngine((cuda_device, cuda_device))
    assert np.array_equal(mesh.distances(pairs), one.distances(pairs))
    before = K7.edit_banded_ends_free_cuda.launches
    got = mesh.ends_free(jobs)
    assert K7.edit_banded_ends_free_cuda.launches > before
    assert got.tolist() == [edit_distance_ends_free(*j) for j in jobs]
    assert np.array_equal(got, one.ends_free(jobs))
    c1, cm = one.counters(), mesh.counters()
    assert cm["jobs_k9"] > 0
    assert cm["jobs_host"] + cm["jobs_k9"] == c1["jobs_host"]
    assert {k: v for k, v in cm.items() if k not in ("jobs_host", "jobs_k9")} \
        == {k: v for k, v in c1.items() if k not in ("jobs_host", "jobs_k9")}
    assert all(c["pairs_k1"] > 0 for c in mesh.shard_counters())


def test_assemble_mesh_cuda_byte_identical(cuda_device, tmp_path,
                                           monkeypatch):
    """assemble on one card in two shards (the device KDE on, so K8 runs on
    both) writes the same SAM bytes as on the card alone."""
    from otter_tpu_torch.config import OtterOpts as PortOpts

    bam, bed = _tandem_loci(tmp_path)
    monkeypatch.setenv("OTTER_TPU_MESH_KDE", "1")
    texts = []
    for backend in (TorchDistBackend(cuda_device),
                    TorchDistBackend(mesh=(cuda_device, cuda_device))):
        p = PortOpts()
        p.read_group = "S1"
        out = io.StringIO()
        assemble(bam, bed, "", False, p, out=out, dist_backend=backend)
        texts.append(out.getvalue())
    assert texts[0] == texts[1] and texts[0]


@pytest.mark.parametrize("k", [1, 2, 3, 5, 6, 7, 8, 10])
def test_kmer_counts_cuda_matches_plain(cuda_device, k):
    """K10 on the card equals its plain version at every route: shared-
    memory histograms of 8 warps a block (k = 1-5), 2 (k = 6) and 1 past
    48 KB (k = 7), device-memory atomics at k = 8 and 10; 0-3 lanes ahead;
    alleles of every length mod 4, shorter than k and empty, non-ACGT
    bytes, lengths past several 32-word tiles."""
    from otter_tpu_torch.kernels import kmer_counts as K10

    rng = random.Random(k)
    seqs = ["".join(rng.choice("ACGTacgtN") for _ in range(rng.randint(0,
                                                                       400)))
            for _ in range(300 if k < 10 else 20)] + [
        "", "A", "ACG", "ACGTN" * 3, "x" * 7]
    blob = "".join(seqs).encode()
    offsets = np.zeros(len(seqs) + 1, dtype=np.int32)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    data = torch.from_numpy(np.frombuffer(blob, dtype=np.uint8).copy())
    want = K10.kmer_counts_torch(data, torch.from_numpy(offsets), k)
    before = K10.kmer_counts_cuda.launches
    got = K10.kmer_counts(data.to(cuda_device),
                          torch.from_numpy(offsets).to(cuda_device), k)
    assert K10.kmer_counts_cuda.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n", [2, 129, 300])
def test_linkage_cuda_matches_plain(cuda_device, n):
    """K11 on the card equals its plain version bit for bit: D in shared
    memory (n = 2, 129; two matrices) and, at n = 300, the upper triangle
    in a cluster of two blocks (two matrices, a cluster each)."""
    from otter_tpu_torch.kernels import linkage as K11

    rng = np.random.default_rng(n)
    D = np.zeros((2, n, n), dtype=np.float32)
    iu = np.triu_indices(n, 1)
    for b in range(2):
        D[b][iu] = rng.random(len(iu[0]))
        D[b] += D[b].T
    D = torch.from_numpy(D)
    want_r, want_h = K11.linkage_torch(D)
    got_r, got_h = K11.linkage(D.to(cuda_device))
    assert torch.equal(got_r.cpu(), want_r)
    assert torch.equal(got_h.cpu().view(torch.int32),
                       want_h.view(torch.int32))


def _tie_free(n, seed):
    """(1, n, n) float32 symmetric distances, all distinct."""
    rs = np.random.default_rng(seed)
    m = n * (n - 1) // 2
    sq = np.zeros((n, n), dtype=np.float32)
    sq[np.triu_indices(n, 1)] = (rs.permutation(m) + 1.0) / (m + 1.0)
    return torch.from_numpy(sq + sq.T)[None]


def _route_bounds():
    """K11's last n on the shared-memory route and last on the cluster
    route, by the library's plan."""
    from otter_tpu_torch.kernels import linkage as K11

    last = {}
    for n in range(100, 2000):
        last[K11.linkage_plan(n)[0]] = n
    return last["shared"], last["cluster"]


@pytest.mark.parametrize("side", ["shared", "cluster_low", "cluster_high",
                                  "l2"])
def test_linkage_cuda_route_boundaries(cuda_device, side):
    """K11 on each side of each route boundary (the last n of D in shared
    memory, the first and last n of the cluster route, the first n of the
    L2 route): the plan's route is taken and counted, and records and
    heights equal the plain version's and the L2 route's bit for bit."""
    from otter_tpu_torch.kernels import linkage as K11

    last_shared, last_cluster = _route_bounds()
    n = {"shared": last_shared, "cluster_low": last_shared + 1,
         "cluster_high": last_cluster, "l2": last_cluster + 1}[side]
    route = "shared" if side == "shared" else side.split("_")[0]
    assert K11.linkage_plan(n)[0] == route
    D = _tie_free(n, n).to(cuda_device)
    before = dict(K11.linkage_cuda.routes)
    got_r, got_h = K11.linkage_cuda(D)
    assert K11.linkage_cuda.routes[route] == before[route] + 1
    want_r, want_h = K11.linkage_torch(D)
    assert torch.equal(got_r, want_r)
    assert torch.equal(got_h.view(torch.int32), want_h.view(torch.int32))
    l2_r, l2_h = K11.linkage_cuda(D, route="l2")
    assert torch.equal(l2_r, got_r)
    assert torch.equal(l2_h.view(torch.int32), got_h.view(torch.int32))


@pytest.mark.parametrize("cluster", [1, 2, 5, 16])
def test_linkage_cuda_cluster_sizes(cuda_device, cluster):
    """The cluster kernel with 1, 2, 5 and 16 blocks on two matrices (n =
    300, a cluster each): bit for bit the plain version's."""
    from otter_tpu_torch.kernels import linkage as K11

    D = torch.cat([_tie_free(300, 3), _tie_free(300, 4)]).to(cuda_device)
    want_r, want_h = K11.linkage_torch(D)
    got_r, got_h = K11.linkage_cuda(D, route="cluster", cluster=cluster)
    assert torch.equal(got_r, want_r)
    assert torch.equal(got_h.view(torch.int32), want_h.view(torch.int32))


def test_linkage_cuda_non_symmetric_raises(cuda_device):
    """A D that is not symmetric raises on the cluster route (it holds the
    upper triangle), before any launch."""
    from otter_tpu_torch.kernels import linkage as K11

    D = _tie_free(400, 9).to(cuda_device)
    assert K11.linkage_plan(400)[0] == "cluster"
    D[0, 3, 7] += 0.25
    launches = K11.linkage_cuda.launches
    with pytest.raises(ValueError, match="symmetric"):
        K11.linkage_cuda(D)
    assert K11.linkage_cuda.launches == launches


def test_poa_heaviest_stream_longer_than_ring(cuda_device):
    """K12's streamed kernel on graphs far longer than its rings (3,140
    nodes against rings of 4 x 256 elements): h bit for bit and min_eid
    equal to the plain version's and to the device-memory kernel's."""
    from otter_tpu_torch.kernels import poa_heaviest as K12

    rs = np.random.default_rng(23)
    batch = K12.pack_graphs([poa_shaped_graph(rs, 3000, 100, 40, 60),
                             poa_shaped_graph(rs, 700, 20, 10, 10)])
    lg_slots, lg_pos, lg_edge = K12.RING
    assert batch.max_nodes > 2 << lg_slots + max(lg_pos, lg_edge)
    assert K12.stream_fits(batch)
    want_h, want_m = K12.poa_heaviest_torch(batch)
    on_card = batch.to(cuda_device)
    before = K12.poa_heaviest_cuda.routes["stream"]
    got_h, got_m = K12.poa_heaviest_cuda(on_card)
    assert K12.poa_heaviest_cuda.routes["stream"] == before + 1
    assert torch.equal(got_h.cpu().view(torch.int32),
                       want_h.view(torch.int32))
    assert torch.equal(got_m.cpu(), want_m)
    g_h, g_m = K12.poa_heaviest_cuda(on_card, route="global")
    assert torch.equal(g_h.view(torch.int32), got_h.view(torch.int32))
    assert torch.equal(g_m, got_m)


def test_poa_heaviest_past_stream_nodes(cuda_device):
    """A graph past STREAM_NODES takes the device-memory kernel, counted,
    bit for bit the plain version's."""
    from otter_tpu_torch.kernels import poa_heaviest as K12

    rs = np.random.default_rng(29)
    batch = K12.pack_graphs([poa_shaped_graph(rs, 24000, 800, 100, 300),
                             poa_shaped_graph(rs, 500, 10, 5, 5)])
    assert batch.max_nodes > K12.STREAM_NODES
    assert not K12.stream_fits(batch)
    want_h, want_m = K12.poa_heaviest_torch(batch)
    before = K12.poa_heaviest_cuda.routes["global"]
    got_h, got_m = K12.poa_heaviest_cuda(batch.to(cuda_device))
    assert K12.poa_heaviest_cuda.routes["global"] == before + 1
    assert torch.equal(got_h.cpu().view(torch.int32),
                       want_h.view(torch.int32))
    assert torch.equal(got_m.cpu(), want_m)


def test_poa_heaviest_past_smem_nodes(cuda_device):
    """A graph past the device-memory kernel's shared memory (SMEM_NODES)
    keeps h in device-memory scratch, by position: bit for bit the plain
    version's."""
    from otter_tpu_torch.kernels import poa_heaviest as K12

    rs = np.random.default_rng(31)
    batch = K12.pack_graphs([poa_shaped_graph(rs, 50000, 900, 100, 300),
                             poa_shaped_graph(rs, 500, 10, 5, 5)])
    assert batch.max_nodes > K12.SMEM_NODES
    on_card = batch.to(cuda_device)
    want_h, want_m = K12.poa_heaviest_torch(on_card)
    got_h, got_m = K12.poa_heaviest_cuda(on_card)
    assert torch.equal(got_h.view(torch.int32), want_h.view(torch.int32))
    assert torch.equal(got_m, want_m)


def test_poa_heaviest_cuda_matches_plain(cuda_device):
    """K12 on the card equals its plain version (h bit for bit, min_eid
    equal) on seeded graphs, and the consensus strings equal the python
    oracle's."""
    from otter_tpu_torch.kernels import poa_heaviest as K12
    from otter_tpu_torch.ops.align_np import affine_align_cigar
    from otter_tpu_torch.ops.poa import Ppoa
    from otter_tpu_torch.ops.poa_device import (graph_arrays,
                                                poa_consensus_device_batch)

    rng = random.Random(17)
    poas = []
    for _ in range(24):
        base = _acgt(rng, rng.randint(50, 600))
        seqs = [base] + [_mutate(rng, base, 0.05) for _ in range(6)]
        poa = Ppoa(base)
        for s in seqs:
            poa.insert_alignment(s, affine_align_cigar(base, s), True, True)
        poa.adjust_weights(float(np.float32(7 * np.float32(0.4))), 0.3)
        poas.append(poa)
    arrs = [graph_arrays(p) for p in poas]
    batch = K12.pack_graphs([(a[0], a[1], a[2], a[5]) for a in arrs])
    want_h, want_m = K12.poa_heaviest_torch(batch)
    got_h, got_m = K12.poa_heaviest(batch.to(cuda_device))
    assert torch.equal(got_h.cpu().view(torch.int32),
                       want_h.view(torch.int32))
    assert torch.equal(got_m.cpu(), want_m)
    assert poa_consensus_device_batch(poas, cuda_device) == [
        p.consensus() for p in poas]


def test_assemble_poa_device_cuda_byte_identical(cuda_device, tmp_path,
                                                 monkeypatch):
    """assemble on the card with OTTER_TPU_POA_DEVICE=1 (K12) writes the
    bytes of the default route (native PPOA)."""
    from otter_tpu_torch.config import OtterOpts as PortOpts
    from otter_tpu_torch.kernels import poa_heaviest as K12

    bam, bed = _tandem_loci(tmp_path)
    texts = []
    for env in ("0", "1"):
        monkeypatch.setenv("OTTER_TPU_POA_DEVICE", env)
        p = PortOpts()
        p.read_group = "S1"
        out = io.StringIO()
        before = K12.poa_heaviest_cuda.launches
        assemble(bam, bed, "", False, p, out=out,
                 dist_backend=TorchDistBackend(cuda_device))
        assert (K12.poa_heaviest_cuda.launches > before) == (env == "1")
        texts.append(out.getvalue())
    assert texts[0] == texts[1] and texts[0]


@pytest.mark.parametrize("shape", K8_SHAPES)
def test_kde_tree_cuda_matches_plain(cuda_device, shape):
    """K13 on the card against its plain version on the card: a relative
    1e-6 a cell (expf against torch.exp; the same halving orders), an
    absolute 1e-30 for subnormals; every W and C give the same bits."""
    from otter_tpu_torch.kernels import kde_scaled as K8

    R, n = shape
    args = _k8_args(cuda_device, R, n)
    before = K8.kde_tree_cuda.launches
    got = K8.kde_tree(*args, n_max=n)
    assert K8.kde_tree_cuda.launches == before + 1
    torch.testing.assert_close(got, K8.kde_tree_torch(*args), rtol=1e-6,
                               atol=1e-30)
    for C in K8.CELLS:
        for W in (1, 16):
            assert torch.equal(got, K8.kde_tree_cuda(*args, n_max=n,
                                                     warps=W, cells=C))


@pytest.mark.parametrize("n_pairs,n_regions,grid_pts,sizes", [
    (40, 3, 401, None), (11904, 128, 401, None), (5000, 2, 401, None),
    (0, 4, 401, [3 * 256 + 5, 0, 256, 257]), (0, 3, 1000, [2000, 1, 600]),
    (0, 2, 100, [1500, 300])])
def test_kde_pairs_cuda_matches_plain(cuda_device, n_pairs, n_regions,
                                      grid_pts, sizes):
    """K14 on the card against its plain version on the card, regions
    interleaved, INF and invalid pairs included: a relative 1e-6 a cell,
    an absolute 1e-30 for subnormals. Regions of one chunk and past several
    (the last block of a region adds the chunk sums; ``sizes`` gives exact
    region sizes, an empty region among them) at 100, 401 and 1000 grid
    points; the ticket array zero after the launch, and a second launch the
    same bits."""
    from otter_tpu_torch.kernels import kde_pairs as K14

    rng = np.random.default_rng(n_pairs + sum(sizes or []))
    if sizes is not None:
        rid = np.repeat(np.arange(n_regions, dtype=np.int32), sizes)
        n_pairs = len(rid)
        valid = np.ones(n_pairs, dtype=bool)
        perm = rng.permutation(n_pairs)
        rid = rid[perm]
    else:
        rid = rng.integers(0, n_regions, n_pairs).astype(np.int32)
        valid = rng.random(n_pairs) > 0.1
    m = rng.integers(80, 300, n_pairs).astype(np.int32)
    n = (m + rng.integers(-5, 6, n_pairs)).astype(np.int32)
    d = (rng.random(n_pairs) * 0.05 * m).astype(np.int32)
    d[rng.random(n_pairs) < 0.05] = 1 << 24
    bw = np.where(np.arange(n_regions) % 2, 0.015, 0.01).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda_device) for x in (
        d, m, n, rid, valid, bw, K14.linspace_grid(grid_pts))]
    before = K14.kde_pairs_cuda.launches
    got = K14.kde_pairs(*args)
    assert K14.kde_pairs_cuda.launches == before + 1
    torch.testing.assert_close(got, K14.kde_pairs_torch(*args), rtol=1e-6,
                               atol=1e-30)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    assert not K14._tickets(cuda_device, stream, n_regions).any()
    assert torch.equal(K14.kde_pairs_cuda(*args), got)


def test_sharded_step_cuda_two_shards(cuda_device):
    """The sharded step on the card and on two shards of it: distances
    equal to K7's plain version, densities the same bits on both meshes
    and within a relative 1e-6 of the plain versions' step on the CPU."""
    from otter_tpu_torch.parallel.dryrun import example_pair_batch
    from otter_tpu_torch.parallel.mesh import run_sharded_region_step

    a, bp, mn, rid, valid, k, L = example_pair_batch(n_pairs=64)
    bw = np.full(2, 0.01, dtype=np.float32)
    args = (a, bp, mn[:, 0], mn[:, 1], rid, valid, bw)
    outs = [run_sharded_region_step(mesh, *args, k=k, max_rows=L,
                                    n_regions=2)
            for mesh in ((cuda_device,), (cuda_device, cuda_device), (CPU,))]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][0].cpu(), outs[2][0])
    torch.testing.assert_close(outs[0][1].cpu(), outs[2][1], rtol=1e-6,
                               atol=1e-30)


@pytest.mark.parametrize("two_shards", [False, True])
def test_dryrun_multichip_cuda(cuda_device, two_shards):
    """The port's dry run on the card's mesh and on two shards of card 0:
    every check passes (its assemble and genotype byte-identical to the
    port's host mode)."""
    from otter_tpu_torch.parallel.dryrun import dryrun_multichip

    if two_shards:
        out = dryrun_multichip(2, (cuda_device, cuda_device))
    else:
        out = dryrun_multichip(1)
    assert out["vcf_rows"] >= 6


@pytest.mark.parametrize("env", [{"OTTER_TPU_FUSED_KDE": "1"},
                                 {"OTTER_TPU_AFFINE_DEVICE": "0"},
                                 {"OTTER_TPU_AFFINE_HINTS": "0"},
                                 {"OTTER_TPU_AFFINE_HINTS": "1"}])
def test_assemble_settings_cuda_byte_identical(cuda_device, tmp_path,
                                               monkeypatch, env):
    """assemble on the card under the fused collect and the consensus
    settings writes the default route's bytes; K8 launches with the fused
    collect, K5 never with OTTER_TPU_AFFINE_DEVICE=0."""
    from otter_tpu_torch.kernels import kde_scaled as K8

    bam, bed = _tandem_loci(tmp_path)
    monkeypatch.setenv("OTTER_TPU_MESH_KDE", "1")
    want = _port_assemble(bam, bed, "cuda")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    k5, k8 = K5.affine_tb_cuda.launches, K8.kde_scaled_cuda.launches
    assert _port_assemble(bam, bed, "cuda") == want
    assert K8.kde_scaled_cuda.launches > k8
    assert (K5.affine_tb_cuda.launches == k5) == \
        (env.get("OTTER_TPU_AFFINE_DEVICE") == "0")


def test_assemble_finish_pool_cuda_byte_identical(cuda_device, tmp_path,
                                                  monkeypatch):
    """OTTER_TPU_FINISH_POOL=1 at -t 2 on the card: two spawned workers
    take the host half, this process launches K1 and K8, and the bytes
    are the -t 1 run's."""
    from otter_tpu_torch.config import OtterOpts as PortOpts
    from otter_tpu_torch.kernels import kde_scaled as K8

    bam, bed = _tandem_loci(tmp_path)
    monkeypatch.setenv("OTTER_TPU_MESH_KDE", "1")
    want = _port_assemble(bam, bed, "cuda")
    monkeypatch.setenv("OTTER_TPU_FINISH_POOL", "1")
    k1, k8 = K1.myers_pool_cuda.launches, K8.kde_scaled_cuda.launches
    p = PortOpts()
    p.read_group = "S1"
    p.init_threads(2)
    out = io.StringIO()
    assemble(bam, bed, "", False, p, out=out)
    assert out.getvalue() == want
    assert K1.myers_pool_cuda.launches > k1
    assert K8.kde_scaled_cuda.launches > k8
