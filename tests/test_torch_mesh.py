"""The port's mesh mode (``otter_tpu_torch/parallel/mesh.py``,
``kernels/edit_engine.py::MeshEngine``, kernel K9's plain version) on CPU
meshes, against the JAX package's mesh mode on the 8 virtual CPU devices of
tests/conftest.py, its host paths and the port's one-device engine. Every
comparison is exact: integers equal, files byte-identical."""

import io
import os
import random
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otter_tpu.config import OtterOpts
from otter_tpu.kernels.edit_pallas import EditDistanceEngine as JaxEngine
from otter_tpu.kernels.edit_pallas import edit_banded_ends_free_jnp
from otter_tpu.models.assemble import assemble as reference_assemble
from otter_tpu.models.compare import compare as reference_compare
from otter_tpu.models.genotype import genotype as reference_genotype
from otter_tpu.ops.align_np import edit_distance_ends_free
from otter_tpu.parallel.mesh import make_mesh as jax_make_mesh
from otter_tpu_torch.config import OtterOpts as PortOpts
from otter_tpu_torch.kernels import edit_banded as K9
from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
from otter_tpu_torch.kernels.edit_engine import EditDistanceEngine, MeshEngine
from otter_tpu_torch.models import genotype as port_genotype
from otter_tpu_torch.models.assemble import assemble
from otter_tpu_torch.models.compare import compare
from otter_tpu_torch.ops.align_batch import (_ends_free_banded_numpy,
                                             edit_ends_free_batch)
from otter_tpu_torch.parallel.mesh import (make_mesh, pooled_kde_scaled,
                                           shard_rows)
from otter_tpu_torch.utils.synth import cohort_fixture

from fixtures import make_bam, make_reference, read_record, \
    simulate_region_bam
from test_e2e_wgat_compare import _otter_bam_from_alleles
from test_torch_cuda import k9_jobs

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(n):
    return (CPU,) * n


def _seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(alphabet) for _ in range(n))


def _k9_three_ways(jobs, k):
    """K9's plain version, edit_banded_ends_free_jnp and the numpy pass of
    edit_ends_free_batch on the same pass."""
    members = list(range(len(jobs)))
    ax, bxp, meta = K9.pack_ends_free(jobs, members, k)
    plain = K9.edit_banded_ends_free_torch(
        *(torch.from_numpy(x) for x in (ax, bxp, meta)), k).numpy()
    jx = np.asarray(edit_banded_ends_free_jnp(
        jnp.asarray(ax), jnp.asarray(bxp),
        *(jnp.asarray(meta[:, c]) for c in range(6)), k=k,
        max_rows=ax.shape[1]))
    npy = _ends_free_banded_numpy(jobs, members, k)
    return plain, jx, npy


def _edge_jobs(rng, k):
    """Jobs whose best end cell is exactly k - reach (the pass resolves
    them) and k - reach + 1 (the ladder escalates): substitutions spread
    over a text of 4k, as many as the scalar oracle says give that
    distance, with frees of up to 6 on both sides, one side or none."""
    jobs = []
    for q, frees in enumerate([(3, 2, 0, 0), (0, 0, 4, 6), (5, 0, 0, 0),
                               (0, 0, 0, 0), (2, 1, 3, 4)]):
        reach = max(frees)
        for want in (k - reach, k - reach + 1):
            found = None
            while found is None:
                t = _seq(rng, 4 * k)
                for s in range(want, want + 8):
                    p = list(t)
                    for i in range(s):
                        at = 20 + i * (len(t) - 40) // s
                        p[at] = "ACGT"[("ACGT".index(p[at]) + 1 + q % 3)
                                       % 4]
                    job = ("".join(p), t, *frees)
                    if edit_distance_ends_free(*job) == want:
                        found = job
                        break
            jobs.append(found)
    return jobs


@pytest.mark.parametrize("k", [32, 64, 128])
def test_k9_plain_matches_jax_and_numpy(k):
    """K9's plain version equals edit_banded_ends_free_jnp bit for bit and
    the numpy pass where the numpy pass has an end cell (it has no INF):
    frees on both sides, one side and none, N bases, patterns of different
    lengths in one pass (rows of padding past the shorter ones), rows
    i <= k + 1 (where the text window starts in the k + 2 sentinel
    columns), and jobs at the validity edge, whose best is k - reach and
    k - reach + 1."""
    rng = random.Random(800 + k)
    jobs = k9_jobs(rng, k, 18, 2 * k + 2, 2 * k + 120) + _edge_jobs(rng, k)
    plain, jx, npy = _k9_three_ways(jobs, k)
    assert np.array_equal(plain, jx)
    assert np.array_equal(plain, np.minimum(npy, K9.INF))
    reach = np.asarray([max(abs(len(t) - len(p)), *fr)
                        for p, t, *fr in jobs])
    edge = plain[-10:] - (k - reach[-10:])
    assert edge.tolist() == [0, 1] * 5
    ok = plain <= k - reach
    want = [edit_distance_ends_free(*j) for j in jobs]
    assert all(int(plain[i]) == want[i] for i in np.nonzero(ok)[0])


def test_k9_runner_ladder_matches_scalar():
    """edit_ends_free_batch with the mesh engine's K9 runner on a CPU mesh
    of 3 equals the numpy ladder and the scalar oracle, and the jobs its
    passes resolve are counted as jobs_k9."""
    rng = random.Random(81)
    jobs = k9_jobs(rng, 32, 12, 90, 400) + _edge_jobs(rng, 32)
    eng = MeshEngine(_mesh(3))
    got = edit_ends_free_batch(jobs, banded_runner=eng._k9_runner)
    assert got.tolist() == edit_ends_free_batch(jobs).tolist() \
        == [edit_distance_ends_free(*j) for j in jobs]
    assert 0 < eng.counters()["jobs_k9"] <= len(jobs)


def test_shard_rows_and_make_mesh():
    """Contiguous blocks in order, sizes within one, empty shards past the
    rows; an explicit mesh is kept as given; without a card the visible
    cards' mesh raises."""
    assert shard_rows(10, _mesh(4)) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert shard_rows(2, _mesh(4)) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert shard_rows(0, _mesh(2)) == [(0, 0), (0, 0)]
    assert make_mesh(devices=["cpu", "cpu"]) == _mesh(2)
    assert make_mesh(1, devices=_mesh(3)) == _mesh(1)
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()


def _pairs_and_jobs(rng):
    pairs = []
    for _ in range(14):
        a = _seq(rng, rng.randint(1, 150), rng.choice(["ACGT", "ACGTN"]))
        pairs.append((a, "".join(c if rng.random() > 0.08
                                 else rng.choice("ACGT") for c in a)))
    pairs += [("", "ACG"), ("ACGT", "ACGT"), (_seq(rng, 2100),
                                              _seq(rng, 2150))]
    jobs = k9_jobs(rng, 32, 8, 80, 200)
    for _ in range(8):  # one-sided ACGT jobs: K2
        p, t = _seq(rng, rng.randint(5, 120)), _seq(rng, rng.randint(5, 120))
        ld = abs(len(p) - len(t))
        jobs.append((p, t, 0, 0, ld, 0) if rng.random() < 0.5
                    else (p, t, 0, ld, 0, 0))
    return pairs, jobs


@pytest.fixture(scope="module")
def engine_case():
    """Pairs of every route, ends-free jobs of every route, the one-device
    engine's results and counters, and the JAX package's mesh engine's
    results on the 8 virtual CPU devices."""
    pairs, jobs = _pairs_and_jobs(random.Random(82))
    one = EditDistanceEngine("cpu")
    d1, e1 = one.distances(pairs), one.ends_free(jobs)
    jax_eng = JaxEngine(mode="jnp", mesh=jax_make_mesh(8))
    dj = np.asarray(jax_eng.distances(pairs))
    ej = np.asarray(jax_eng.ends_free(jobs))
    return pairs, jobs, d1, e1, one.counters(), dj, ej


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_mesh_engine_matches_one_device_and_jax(engine_case, shards):
    """The mesh engine on CPU meshes of 1, 2 and 4 shards equals the
    one-device engine and the JAX package's mesh engine, on distances and
    ends-free jobs, with the one-device engine's routing counts (its host
    jobs split into K9's and the host DP's); every shard gets K1 pairs, and
    the long pair and the K7 pairs are a route empty on some shard."""
    pairs, jobs, d1, e1, c1, dj, ej = engine_case
    eng = MeshEngine(_mesh(shards))
    d, e = eng.distances(pairs), eng.ends_free(jobs)
    assert np.array_equal(d, d1) and np.array_equal(d, dj)
    assert np.array_equal(e, e1) and np.array_equal(e, ej)
    c = eng.counters()
    assert c["jobs_k9"] > 0
    assert c["jobs_host"] + c["jobs_k9"] == c1["jobs_host"]
    assert {k: v for k, v in c.items() if k not in ("jobs_host", "jobs_k9")} \
        == {k: v for k, v in c1.items() if k not in ("jobs_host", "jobs_k9")}
    per = eng.shard_counters()
    assert all(s["pairs_k1"] > 0 for s in per)
    if shards > 1:
        assert sum(s["pairs_k3"] + s["pairs_k2"] > 0 for s in per) == 1


def test_mesh_engine_more_shards_than_pairs_and_none():
    """More shards than pairs, and no pairs or jobs at all."""
    eng = MeshEngine(_mesh(4))
    pairs = [("ACGT", "AGT"), ("NNAC", "NAC")]
    assert eng.distances(pairs).tolist() == [1, 1]
    assert eng.distances([]).tolist() == []
    assert eng.ends_free([]).tolist() == []
    assert eng.ends_free([("ACGTT", "CGT", 1, 1, 0, 0)]).tolist() == [0]


def test_pooled_kde_mesh_equals_one_device():
    """K8's plain version over a CPU mesh of 3 (regions split in each
    n_pad bucket) gives every region the one-device bits, in order."""
    rs = np.random.default_rng(83)
    values = [rs.random(int(rs.integers(1, 300))) for _ in range(11)]
    bws = [0.01 + 0.002 * i for i in range(11)]
    one = pooled_kde_scaled(values, bws, "cpu")
    for got in (pooled_kde_scaled(values, bws, _mesh(3)),
                pooled_kde_scaled(values, bws, _mesh(16))):
        for (m1, s1), (m, s) in zip(one, got):
            assert np.array_equal(m1, m) and np.array_equal(s1, s)


def _kde_fixture(tmp_path):
    """tests/test_parallel.py's mesh-KDE fixture (one CAG locus, two
    alleles at coverage 8)."""
    rng = random.Random(5)
    ref = make_reference(rng, length=4000, repeat="CAG", repeat_at=2000,
                         repeat_units=30)
    start, end = 2000, 2090
    bam = str(tmp_path / "m.bam")
    simulate_region_bam(bam, "chr1", ref, (start, end),
                        [ref[start:end], "CAG" * 45], per_allele_cov=8,
                        error_rate=0.01, seed=7)
    bed = str(tmp_path / "r.bed")
    with open(bed, "w") as fh:
        fh.write(f"chr1\t{start}\t{end}\n")
    return bam, bed


def test_assemble_cpu_mesh_byte_identical(tmp_path, monkeypatch):
    """assemble over a CPU mesh of 4 with OTTER_TPU_MESH_KDE=1 (K8's plain
    version on every shard) writes the bytes of otter_tpu at
    device="mesh" (its 8 virtual devices) and at device="host"."""
    bam, bed = _kde_fixture(tmp_path)

    def ref(device):
        p = OtterOpts()
        p.read_group = "S1"
        p.device = device
        out = io.StringIO()
        reference_assemble(bam, bed, "", False, p, out=out)
        return out.getvalue()

    host = ref("host")
    monkeypatch.setenv("OTTER_TPU_MESH_KDE", "1")
    jax_mesh = ref("mesh")
    p = PortOpts()
    p.read_group = "S1"
    got = io.StringIO()
    backend = TorchDistBackend(mesh=_mesh(4))
    assemble(bam, bed, "", False, p, out=got, dist_backend=backend)
    assert got.getvalue() == jax_mesh == host
    assert backend.engine.counters()["pairs_k1"] > 0


def test_genotype_cpu_mesh_byte_identical(tmp_path):
    """genotype's batched pipeline with its GEMM over a CPU mesh of 2 (the
    f32 route, whatever OTTER_TPU_GENOTYPE_DEVICE says) writes the VCF of
    otter_tpu's mesh mode and host path."""
    bam, bed, fa = cohort_fixture(str(tmp_path), n_samples=8, n_regions=5,
                                  seed=9)
    calls = []
    real = port_genotype.cosine_gemm_f32

    def spy(Vs, devices):
        calls.append(devices)
        return real(Vs, devices)

    want = {}
    for device in ("host", "mesh"):
        p = OtterOpts()
        p.device = device
        out = io.StringIO()
        reference_genotype(p, bam, bed, fa, out=out)
        want[device] = out.getvalue()
    p = PortOpts()
    p.device = "cpu"
    got = io.StringIO()
    port_genotype.cosine_gemm_f32 = spy
    try:
        port_genotype.genotype(p, bam, bed, fa, out=got, mesh=_mesh(2))
    finally:
        port_genotype.cosine_gemm_f32 = real
    assert got.getvalue() == want["mesh"] == want["host"]
    assert calls == [_mesh(2)]


def test_compare_cpu_mesh_byte_identical(tmp_path):
    """compare's pooled pairs on a CPU mesh of 2 write the TSV of otter_tpu
    at device="mesh" and device="host": N alleles, equal sequences, indels
    and divergent pairs over 8 regions."""
    rng = random.Random(84)
    truth, query, rows = {}, {}, []
    start = 100
    for r in range(8):
        base = _seq(rng, rng.randint(40, 300))
        mut = "".join(c if rng.random() > 0.05 else rng.choice("ACGT")
                      for c in base)
        t = [(base, "b"), (base + "CAGCAG", "b")]
        q = [(mut, "b"), ("N", "b")] if r % 2 else [(base, "b")]
        truth[(f"{start}-{start + 60}", start)] = t
        query[(f"{start}-{start + 60}", start)] = q
        rows.append(f"chr1\t{start}\t{start + 60}\n")
        start += 200
    tb = _otter_bam_from_alleles(tmp_path, "t.bam", truth, "T1")
    qb = _otter_bam_from_alleles(tmp_path, "q.bam", query, "Q1")
    bed = str(tmp_path / "c.bed")
    with open(bed, "w") as fh:
        fh.writelines(rows)
    want = {}
    for device in ("host", "mesh"):
        p = OtterOpts()
        p.device = device
        out = io.StringIO()
        reference_compare(p, bed, tb, qb, out=out)
        want[device] = out.getvalue()
    got = io.StringIO()
    backend = TorchDistBackend(mesh=_mesh(2))
    compare(PortOpts(), bed, tb, qb, out=got, dist_backend=backend)
    assert got.getvalue() == want["mesh"] == want["host"]
    assert backend.engine.counters()["pairs_k1"] > 0


def test_mesh_device_without_card_raises(tmp_path):
    """params.device = "mesh" runs on the visible cards: with none,
    assemble, genotype and compare raise; nothing becomes a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    bam, bed = _kde_fixture(tmp_path)
    p = PortOpts()
    p.read_group = "S1"
    p.device = "mesh"
    with pytest.raises(RuntimeError, match="mesh"):
        assemble(bam, bed, "", False, p, out=io.StringIO())
    with pytest.raises(RuntimeError, match="mesh"):
        port_genotype.genotype(p, bam, bed, "", out=io.StringIO())
    with pytest.raises(RuntimeError, match="mesh"):
        compare(p, bed, bam, bam, out=io.StringIO())
    with pytest.raises(RuntimeError, match="mesh"):
        TorchDistBackend("mesh")


WORKER = r"""
import sys

import torch

sys.path.insert(0, {repo!r})
from otter_tpu_torch.config import OtterOpts
from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
from otter_tpu_torch.models.assemble import assemble

bam, bed, out_path = sys.argv[1:4]
params = OtterOpts()
params.read_group = "S1"
cpu = torch.device("cpu")
with open(out_path, "w") as fh:
    assemble(bam, bed, "", False, params, out=fh,
             dist_backend=TorchDistBackend(mesh=(cpu, cpu)))
"""


def test_two_processes_by_cpu_mesh_assemble(tmp_path):
    """tests/test_distributed_multiprocess.py's two-process mesh topology
    in the port: 2 processes over gloo (region sharding), each over a CPU
    mesh of 2 shards with the device KDE forced on, as one program; the
    concatenated output equals the one-process host run of otter_tpu."""
    from otter_tpu.io.bam import BAM_CMATCH

    rng = random.Random(31)
    n_regions, span = 4, 1500
    ref = _seq(rng, 1000 + n_regions * span + 1000)
    records, regions = [], []
    for r in range(n_regions):
        start = 1000 + r * span
        end = start + 90
        regions.append((start, end))
        alleles = [ref[start:end]]
        if r % 2 == 0:
            alleles.append(ref[start:end] + "CAG" * 12)
        for a_i, allele in enumerate(alleles):
            for c in range(8 // len(alleles) + 2):
                seq = ref[start - 150 : start] + allele + ref[end : end + 150]
                cig = [(150 + (end - start), BAM_CMATCH)]
                if len(allele) > end - start:
                    cig.append((len(allele) - (end - start), 1))
                cig.append((150, BAM_CMATCH))
                records.append(read_record(
                    f"r{r}_{a_i}_{c}", 0, start - 150, seq, cig,
                    tags=[("rq", "f", 0.999)]))
    bam = str(tmp_path / "reads.bam")
    bed = str(tmp_path / "regions.bed")
    make_bam(bam, [("chr1", len(ref))], records)
    with open(bed, "w") as fh:
        fh.writelines(f"chr1\t{s}\t{e}\n" for s, e in regions)
    p = OtterOpts()
    p.read_group = "S1"
    p.device = "host"
    single = io.StringIO()
    reference_assemble(bam, bed, "", False, p, out=single)
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs, outs = [], []
    for pid in range(2):
        out = str(tmp_path / f"out_{pid}.sam")
        outs.append(out)
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   OTTER_TPU_MESH_KDE="1", PYTHONPATH=REPO)
        for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "OTTER_TPU_GATHER"):
            env.pop(name, None)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), bam, bed, out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO))
    fails = []
    for pid, proc in enumerate(procs):
        _so, se = proc.communicate(timeout=240)
        if proc.returncode != 0 or f"process {pid}/2" not in se:
            fails.append((pid, proc.returncode, se[-2000:]))
    assert not fails, fails
    combined = "".join(open(o).read() for o in outs)
    assert combined == single.getvalue()
