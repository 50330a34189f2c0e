"""The PyTorch port's ``assemble`` (otter_tpu_torch/models/assemble.py) on
the CPU against ``otter_tpu``'s host and cpu paths.

Every comparison is exact: the outputs must be byte-identical."""

import io
import os
import random
import subprocess
import sys

import pytest

from otter_tpu.config import OtterOpts
from otter_tpu.io.bam import BAM_CMATCH
from otter_tpu.models.assemble import assemble as reference_assemble
from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
from otter_tpu_torch.models.assemble import assemble

from fixtures import (make_bam, make_reference, read_record,
                      simulate_region_bam, write_fasta)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: ((reference seed, length, repeat, repeat_at, repeat_units), region,
# expanded allele, simulate_region_bam arguments): the fixtures of
# test_e2e_assemble.py, test_dist_backend.py and test_e2e_ont.py
FIXTURES = {
    "het": ((123, 3000, "CAG", 1500, 20), (1500, 1560), "CAG" * 30,
            dict(per_allele_cov=12, error_rate=0.002, seed=99)),
    "backend": ((61, 3000, "CAG", 1500, 20), (1500, 1560), "CAG" * 30,
                dict(per_allele_cov=10, error_rate=0.003, seed=5)),
    "ont": ((777, 4000, "TTAGG", 2000, 40), (2000, 2200), "TTAGG" * 60,
            dict(per_allele_cov=15, error_rate=0.05, seed=13)),
    "ont_long": ((778, 6000, "TTAGGC", 3000, 100), (3000, 3600),
                 "TTAGGC" * 120,
                 dict(per_allele_cov=14, error_rate=0.06, seed=14,
                      flank=500)),
}
VARIANTS = {"sam": ({}, False), "fasta": ({"is_fa": True}, False),
            "sam_reference": ({}, True)}


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    out = {}
    for name, (ref_args, (start, end), expanded, sim) in FIXTURES.items():
        tmp = tmp_path_factory.mktemp(name)
        seed, length, repeat, repeat_at, units = ref_args
        ref = make_reference(random.Random(seed), length=length,
                             repeat=repeat, repeat_at=repeat_at,
                             repeat_units=units)
        bam = str(tmp / "reads.bam")
        simulate_region_bam(bam, "chr1", ref, (start, end),
                            [ref[start:end], expanded], **sim)
        fa = str(tmp / "ref.fa")
        write_fasta(fa, [("chr1", ref)])
        bed = str(tmp / "regions.bed")
        with open(bed, "w") as fh:
            fh.write(f"chr1\t{start}\t{end}\n")
        out[name] = (bam, bed, fa)
    return out


def _params(device, **kw):
    p = OtterOpts()
    p.read_group = "S1"
    p.device = device
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _run(fn, fx, device, variant):
    bam, bed, fa = fx
    kw, with_ref = VARIANTS[variant]
    out = io.StringIO()
    fn(bam, bed, fa if with_ref else "", False, _params(device, **kw),
       out=out)
    return out.getvalue()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", list(FIXTURES))
def test_port_cpu_byte_identical(fixtures, name, variant):
    """The port on the CPU writes the same bytes as otter_tpu --device
    host and --device cpu (exact)."""
    fx = fixtures[name]
    got = _run(assemble, fx, "cpu", variant)
    assert got == _run(reference_assemble, fx, "host", variant)
    assert got == _run(reference_assemble, fx, "cpu", variant)
    body = [l for l in got.splitlines() if l and not l.startswith(("@", ">"))]
    assert len(body) == 2


def test_port_cpu_reads_with_n_bases(tmp_path):
    """Reads with N bases (the fixture of test_e2e_ont.py::
    test_reads_with_N_bases) take the K7 banded distance route, and the
    port writes otter_tpu --device host's bytes (exact)."""
    rng = random.Random(555)
    ref = make_reference(rng, length=3000, repeat="CAG", repeat_at=1500,
                         repeat_units=20)
    start, end = 1500, 1560
    recs = []
    for c in range(8):
        seq = list(ref[start - 150 : end + 150])
        for _ in range(6):
            seq[rng.randrange(len(seq))] = "N"
        seq = "".join(seq)
        recs.append(read_record(f"n{c}", 0, start - 150, seq,
                                [(len(seq), BAM_CMATCH)],
                                tags=[("rq", "f", 0.99)]))
    bam = str(tmp_path / "n.bam")
    make_bam(bam, [("chr1", len(ref))], recs)
    bed = str(tmp_path / "r.bed")
    with open(bed, "w") as fh:
        fh.write(f"chr1\t{start}\t{end}\n")
    backend = TorchDistBackend("cpu")
    got = io.StringIO()
    assemble(bam, bed, "", False, _params("cpu"), out=got,
             dist_backend=backend)
    want = io.StringIO()
    reference_assemble(bam, bed, "", False, _params("host"), out=want)
    assert got.getvalue() == want.getvalue()
    assert backend.engine.pairs_k7 > 0


def test_cli_runs_without_jax(fixtures, tmp_path):
    """``python -m otter_tpu_torch.cli.main`` in a fresh process runs every
    subcommand (assemble, genotype, wgat, vcf2mat; compare through its
    model entry on the CPU, the CLI's default being the card), writes the
    host paths' bytes, and imports neither jax nor any module of the JAX
    package (exact). The process runs under a coordinator (a one-process
    gloo group for each subcommand, parallel/distributed.py), and its
    second assemble with -t 2 and the finish pool on, so the distributed
    worker and the pools load neither either."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    from otter_tpu.models.compare import compare as reference_compare
    from otter_tpu.models.genotype import genotype as reference_genotype
    from otter_tpu.models.vcf2mat import vcf2mat as reference_vcf2mat
    from otter_tpu.models.wgat import wgat as reference_wgat
    from otter_tpu_torch.utils.synth import cohort_fixture
    from test_e2e_wgat_compare import _otter_bam_from_alleles

    bam, bed, _fa = fixtures["het"]
    gbam, gbed, gfa = cohort_fixture(str(tmp_path), n_samples=6,
                                     n_regions=3, seed=9)
    asm = str(tmp_path / "asm.bam")
    contig = make_reference(random.Random(4), length=1500, repeat="AT",
                            repeat_at=700, repeat_units=20)
    make_bam(asm, [("chr1", 3000)], [read_record(
        "ctg", 0, 500, contig, [(len(contig), BAM_CMATCH)])])
    abed = str(tmp_path / "asm.bed")
    with open(abed, "w") as fh:
        fh.write("chr1\t900\t960\nchr1\t1500\t1540\n")
    truth = _otter_bam_from_alleles(tmp_path, "t.bam", {("100-200", 100): [
        ("ACGTACGTACGGT", "b"), ("ACGTTTTTAC", "l")]}, "T1")
    query = _otter_bam_from_alleles(tmp_path, "q.bam", {("100-200", 100): [
        ("ACGTACGTACGT", "b"), ("ACGTTTTGAC", "b")]}, "Q1")
    cbed = str(tmp_path / "c.bed")
    with open(cbed, "w") as fh:
        fh.write("chr1\t100\t200\n")
    vcf = str(tmp_path / "want.vcf")
    runs = {"assemble": ["assemble", bam, "-b", bed, "-R", "S1",
                         "--device", "cpu"],
            "assemble_pools": ["assemble", bam, "-b", bed, "-R", "S1",
                               "--device", "cpu", "-t", "2"],
            "genotype": ["genotype", gbam, "-b", gbed, "-r", gfa,
                         "--device", "cpu"],
            "wgat": ["wgat", asm, "-b", abed, "-R", "ASM1"],
            "vcf2mat": ["vcf2mat", vcf, "-b", gbed]}
    code = (
        "import io, os, sys\n"
        "from otter_tpu_torch.cli.main import main\n"
        "from otter_tpu_torch.config import OtterOpts\n"
        "from otter_tpu_torch.models import _finish_worker\n"
        "from otter_tpu_torch.models.compare import compare\n"
        "from otter_tpu_torch.ops import hclust_device, poa_device\n"
        "from otter_tpu_torch.kernels import kmer_counts, linkage\n"
        "from otter_tpu_torch.kernels import poa_heaviest\n"
        "def run(name, argv):\n"
        "    buf, sys.stdout = sys.stdout, io.StringIO()\n"
        "    try:\n"
        "        assert main(argv) == 0\n"
        "    finally:\n"
        "        buf, sys.stdout = sys.stdout, buf\n"
        "    open(name + '.out', 'w').write(buf.getvalue())\n"
        f"for name, argv in {runs!r}.items():\n"
        "    os.environ['OTTER_TPU_FINISH_POOL'] = \\\n"
        "        '1' if name == 'assemble_pools' else '0'\n"
        "    run(name, argv)\n"
        "p = OtterOpts()\n"
        "p.device = 'cpu'\n"
        "with open('compare.out', 'w') as fh:\n"
        f"    compare(p, {cbed!r}, {truth!r}, {query!r}, out=fh)\n"
        "sys.stderr.write('JAX_LOADED=%s\\n' % ('jax' in sys.modules))\n"
        "sys.stderr.write('REFERENCE_LOADED=%s\\n' % any(\n"
        "    m.split('.')[0] == 'otter_tpu' for m in sys.modules))\n")
    want = {"assemble": _run(reference_assemble, fixtures["het"], "host",
                             "sam")}
    want["assemble_pools"] = want["assemble"]
    host = OtterOpts()
    host.device = "host"
    out = io.StringIO()
    reference_genotype(host, gbam, gbed, gfa, out=out)
    want["genotype"] = out.getvalue()
    with open(vcf, "w") as fh:
        fh.write(want["genotype"])
    out = io.StringIO()
    reference_vcf2mat(host, gbed, vcf, 3, out=out)
    want["vcf2mat"] = out.getvalue()
    wp = OtterOpts()
    wp.read_group = "ASM1"
    out = io.StringIO()
    reference_wgat(wp, asm, abed, out=out)
    want["wgat"] = out.getvalue()
    out = io.StringIO()
    reference_compare(host, cbed, truth, query, out=out)
    want["compare"] = out.getvalue()
    env = dict(os.environ, PYTHONPATH=REPO,
               JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               JAX_NUM_PROCESSES="1", JAX_PROCESS_ID="0")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "running single-process" not in res.stderr
    assert "JAX_LOADED=False" in res.stderr
    assert "REFERENCE_LOADED=False" in res.stderr
    for name, text in want.items():
        assert text.count("\n") >= 2, name
        with open(tmp_path / f"{name}.out") as fh:
            assert fh.read() == text, name


def test_poa_device_setting_byte_identical(fixtures, monkeypatch):
    """OTTER_TPU_POA_DEVICE=1 builds the POA graphs in Python and runs the
    heaviest-path DP on K12 (its plain version on the CPU engine): the
    port writes otter_tpu --device host's bytes (exact)."""
    from otter_tpu_torch.kernels import poa_heaviest

    calls = []
    plain = poa_heaviest.poa_heaviest_torch
    monkeypatch.setattr(poa_heaviest, "poa_heaviest_torch",
                        lambda batch: calls.append(1) or plain(batch))
    monkeypatch.setenv("OTTER_TPU_POA_DEVICE", "1")
    got = _run(assemble, fixtures["het"], "cpu", "sam")
    monkeypatch.delenv("OTTER_TPU_POA_DEVICE")
    assert got == _run(reference_assemble, fixtures["het"], "host", "sam")
    assert calls


@pytest.mark.parametrize("name", list(FIXTURES))
def test_port_cpu_device_kde_byte_identical(fixtures, name, monkeypatch):
    """OTTER_TPU_MESH_KDE=1 sends the batch's KDE to K8 (its plain version
    on the CPU) and the certification: the port writes otter_tpu --device
    host's bytes (exact), and the device KDE served regions."""
    from otter_tpu_torch.utils import metrics

    monkeypatch.setenv("OTTER_TPU_MESH_KDE", "1")
    metrics.reset()
    got = _run(assemble, fixtures[name], "cpu", "sam")
    counts = metrics.snapshot()
    monkeypatch.delenv("OTTER_TPU_MESH_KDE")
    assert got == _run(reference_assemble, fixtures[name], "host", "sam")
    assert counts["count.kde_device_regions"] > 0
    assert "time.kde_device" in counts and "time.kde_certify" in counts


def test_device_kde_route_by_size(monkeypatch):
    """Without the setting, K8 takes a batch on an engine on the card once
    values x 401 reaches 2,000,000, never on a CPU engine; =0 keeps the
    float64 KDE."""
    from otter_tpu_torch.models.assemble import _use_device_kde

    class Card:
        mode = "cuda"

    big = [(0, [0.0] * 4988, 0.01)]     # 4,988 x 401 = 2,000,188
    small = [(0, [0.0] * 4987, 0.01)]
    monkeypatch.delenv("OTTER_TPU_MESH_KDE", raising=False)
    assert _use_device_kde(Card(), big)
    assert not _use_device_kde(Card(), small)
    assert not _use_device_kde(TorchDistBackend("cpu").engine, big)
    monkeypatch.setenv("OTTER_TPU_MESH_KDE", "0")
    assert not _use_device_kde(Card(), big)
    monkeypatch.setenv("OTTER_TPU_MESH_KDE", "1")
    assert _use_device_kde(TorchDistBackend("cpu").engine, small)


@pytest.mark.parametrize("device", ["tpu", "auto"])
def test_unknown_device_raises(fixtures, device):
    """A device the port refuses (the JAX package's tpu and auto) raises
    instead of running another path."""
    with pytest.raises(ValueError):
        _run(assemble, fixtures["het"], device, "sam")


def test_synth_loci_equal_bench_fixture(tmp_path):
    """The port's seeded loci generator writes bench_e2e.build_ont_fixture's
    BAM, BAI and BED byte for byte when neither option is on (exact)."""
    sys.path.insert(0, REPO)
    import bench_e2e
    from otter_tpu_torch.utils.synth import tandem_repeat_loci

    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    want = bench_e2e.build_ont_fixture(str(a), n_regions=2, err=0.002,
                                       cov=10, expansion=40, region_len=300,
                                       seed=77, name="smoke")
    got = tandem_repeat_loci(str(b), n_regions=2, cov=10, err=0.002,
                             expansion=40, region_len=300, seed=77,
                             name="smoke")
    for w, g in ((want[0], got[0]), (want[0] + ".bai", got[0] + ".bai"),
                 (want[1], got[1])):
        with open(w, "rb") as fw, open(g, "rb") as fg:
            assert fw.read() == fg.read()


def test_synth_cohort_equal_bench_fixture(tmp_path):
    """The port's cohort generator writes bench_e2e.build_cohort_fixture's
    BAM, BAI, BED and FASTA byte for byte (exact)."""
    sys.path.insert(0, REPO)
    import bench_e2e
    from otter_tpu_torch.utils.synth import cohort_fixture

    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    want = bench_e2e.build_cohort_fixture(str(a), n_samples=12, n_regions=3,
                                          seed=23)
    got = cohort_fixture(str(b), n_samples=12, n_regions=3, seed=23)
    for w, g in zip(list(want) + [want[0] + ".bai"],
                    list(got) + [got[0] + ".bai"]):
        with open(w, "rb") as fw, open(g, "rb") as fg:
            assert fw.read() == fg.read()


def test_route_coverage_fixture_reaches_every_route(tmp_path):
    """Non-spanning reads, a 2.4 kb allele and reads with N bases send work
    down every engine route and through K5; the port's bytes equal
    otter_tpu --device host's (exact)."""
    from otter_tpu_torch.utils.synth import tandem_repeat_loci

    bam, bed = tandem_repeat_loci(str(tmp_path), n_regions=1, cov=16,
                                  err=0.002, expansion=300, region_len=1500,
                                  seed=78, name="routes", partial=0.3,
                                  n_bases=2)
    backend = TorchDistBackend("cpu")
    got = io.StringIO()
    assemble(bam, bed, "", False, _params("cpu"), out=got,
             dist_backend=backend)
    want = io.StringIO()
    reference_assemble(bam, bed, "", False, _params("host"), out=want)
    assert got.getvalue() == want.getvalue()
    c = backend.engine.counters()
    for key in ("pairs_k1", "pairs_k3", "pairs_k7", "jobs_k2", "jobs_k4",
                "jobs_k5"):
        assert c[key] > 0, key
