"""The PyTorch port's host mode (``device="host"``) on the CPU against
``otter_tpu``'s ``device="host"``: assemble, genotype and compare write the
same bytes, and the mode builds no engine, no pool and no process group,
reads through the python extractors and launches no kernel. Every
comparison is exact: the outputs must be byte-identical."""

import io
import os
import random
import socket
import subprocess
import sys

import pytest

from otter_tpu.config import OtterOpts
from otter_tpu.models.assemble import assemble as reference_assemble
from otter_tpu.models.compare import compare as reference_compare
from otter_tpu.models.genotype import genotype as reference_genotype
from otter_tpu_torch import kernels
from otter_tpu_torch.cli.main import main as port_main
from otter_tpu_torch.config import OtterOpts as PortOpts
from otter_tpu_torch.models import assemble as port_assemble
from otter_tpu_torch.models import compare as port_compare
from otter_tpu_torch.models import genotype as port_genotype
from otter_tpu_torch.parallel import distributed
from otter_tpu_torch.seqs import extract
from otter_tpu_torch.utils.synth import cohort_fixture, compare_fixture

from fixtures import make_reference, simulate_region_bam, write_fasta
from test_torch_assemble import FIXTURES, VARIANTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSEMBLE_FIXTURES = ("het", "backend", "ont")


@pytest.fixture(scope="module")
def loci(tmp_path_factory):
    """test_torch_assemble.py's het, backend and ont fixtures: name ->
    (bam, bed, fasta)."""
    out = {}
    for name in ASSEMBLE_FIXTURES:
        ref_args, (start, end), expanded, sim = FIXTURES[name]
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


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A seeded cohort: 6 samples x 3 regions (synth.cohort_fixture)."""
    return cohort_fixture(str(tmp_path_factory.mktemp("cohort")),
                          n_samples=6, n_regions=3, seed=9)


@pytest.fixture(scope="module")
def vntr(tmp_path_factory):
    """A seeded cohort of distinct prime allele lengths: 8 samples x 2
    regions (synth.cohort_fixture): tie-free length matrices, which K11's
    guards let through."""
    return cohort_fixture(str(tmp_path_factory.mktemp("vntr")),
                          n_samples=8, n_regions=2, seed=41, vntr=True,
                          prime_lengths=True)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A seeded truth / query pair: 6 regions of 80-300 bp alleles, N bases
    and an N allele among them (synth.compare_fixture)."""
    return compare_fixture(str(tmp_path_factory.mktemp("compare")), 6,
                           seed=31, lo=80, hi=300)


def _opts(cls, **kw):
    p = cls()
    p.device = "host"
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _assemble(fn, opts_cls, fx, variant):
    bam, bed, fa = fx
    kw, with_ref = VARIANTS[variant]
    out = io.StringIO()
    fn(bam, bed, fa if with_ref else "", False,
       _opts(opts_cls, read_group="S1", **kw), out=out)
    return out.getvalue()


def _genotype(fn, opts_cls, bam, bed, fa, threads=1):
    p = _opts(opts_cls)
    p.init_threads(threads)
    out = io.StringIO()
    fn(p, bam, bed, fa, out=out)
    return out.getvalue()


def _compare(fn, opts_cls, truth, query, bed):
    out = io.StringIO()
    fn(_opts(opts_cls), bed, truth, query, out=out)
    return out.getvalue()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", ASSEMBLE_FIXTURES)
def test_host_assemble_byte_identical(loci, name, variant):
    """The port's host mode writes otter_tpu --device host's SAM, FASTA
    and SAM with a reference (local realignment) (exact)."""
    got = _assemble(port_assemble.assemble, PortOpts, loci[name], variant)
    assert got == _assemble(reference_assemble, OtterOpts, loci[name],
                            variant)
    body = [l for l in got.splitlines() if l and not l.startswith(("@", ">"))]
    assert len(body) == 2


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("with_reference", [True, False])
def test_host_genotype_byte_identical(cohort, with_reference, threads):
    """The VCF (with a reference) and the no-reference TSV of the host
    mode's sequential path, at -t 1 and with the -t 2 region pool, equal
    otter_tpu --device host's (exact)."""
    bam, bed, fa = cohort
    fa = fa if with_reference else ""
    got = _genotype(port_genotype.genotype, PortOpts, bam, bed, fa, threads)
    assert got == _genotype(reference_genotype, OtterOpts, bam, bed, fa)
    rows = [l for l in got.splitlines() if l and not l.startswith("#")]
    assert len(rows) == (3 if with_reference else 3 * 6)


@pytest.mark.parametrize("setting", [("OTTER_TPU_KMER_DEVICE", "kmer"),
                                     ("OTTER_TPU_HCLUST_DEVICE", "hclust")])
def test_host_genotype_opt_in_setting_on_the_cpu(vntr, setting,
                                                 monkeypatch):
    """Under host an opt-in device setting (K10's counts, K11's linkage)
    reaches its device function with the CPU, so its plain version runs,
    and the VCF stays otter_tpu --device host's (exact)."""
    from otter_tpu_torch.ops import hclust_device
    from otter_tpu_torch.seqs import kmer

    want = _genotype(reference_genotype, OtterOpts, *vntr)
    name, which = setting
    mod, fn_name = ((kmer, "kcounts_device") if which == "kmer"
                    else (hclust_device, "hclust_average_device"))
    real = getattr(mod, fn_name)
    devices = []

    def spy(*a):
        devices.append(str(a[-1]))
        return real(*a)

    monkeypatch.setattr(mod, fn_name, spy)
    monkeypatch.setenv(name, "1")
    assert _genotype(port_genotype.genotype, PortOpts, *vntr) == want
    assert devices and set(devices) == {"cpu"}


def test_host_compare_byte_identical(pair):
    """compare in the host mode (the scalar DP of every pair) writes
    otter_tpu --device host's TSV (exact), two rows a kept region."""
    got = _compare(port_compare.compare, PortOpts, *pair)
    assert got == _compare(reference_compare, OtterOpts, *pair)
    assert got.count("\n") == 12


def _launch_counts() -> dict:
    """Every kernel wrapper's launch count, by name."""
    import importlib
    import pkgutil

    counts = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for name, fn in vars(mod).items():
            if isinstance(getattr(fn, "launches", None), int):
                counts[name] = fn.launches
    return counts


@pytest.fixture
def host_only(monkeypatch):
    """Make every route the host mode must not take raise: the native read
    and allele feeders, the engine, the finish pool, the process group,
    the batched pipelines, the pooled compare call and the kernels' device
    halves (K5, K8)."""
    def refuse(what):
        def fn(*_a, **_k):
            raise AssertionError(f"host mode reached {what}")
        return fn

    for mod, name in (
            (extract, "_parse_anreads_native"),
            (extract, "_parse_analleles_native"),
            (port_assemble, "TorchDistBackend"),
            (port_assemble, "_make_dist_backend"),
            (port_assemble, "_finish_pool"),
            (port_assemble, "_assemble_batched"),
            (port_assemble, "_dispatch_batch"),
            (port_compare, "TorchDistBackend"),
            (port_compare, "pooled_compare_results"),
            (port_genotype, "genotype_process_batched"),
            (distributed, "process_group"),
            (distributed, "maybe_initialize"),
            (distributed, "bind_device")):
        monkeypatch.setattr(mod, name, refuse(f"{mod.__name__}.{name}"))
    from otter_tpu_torch.kernels import affine_tb, dist_backend
    from otter_tpu_torch.parallel import mesh

    monkeypatch.setattr(dist_backend, "TorchDistBackend",
                        refuse("TorchDistBackend"))
    monkeypatch.setattr(affine_tb, "affine_cigars_tb",
                        refuse("affine_cigars_tb"))
    monkeypatch.setattr(mesh, "pooled_kde_scaled",
                        refuse("pooled_kde_scaled"))
    before = _launch_counts()
    yield
    assert _launch_counts() == before


def test_host_assemble_takes_the_host_path(loci, host_only, monkeypatch):
    """assemble under host: assemble_region once a region, in BED order,
    whatever -t is, with none of the batched pipeline's routes (each
    refused here) and no kernel launch; the output is the one-process
    stream with its header, even under a 2-process coordinator
    environment (process 1 of 2)."""
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.setenv("OTTER_TPU_FINISH_POOL", "1")
    bam, _bed, fa = loci["het"]
    bed = os.path.join(os.path.dirname(bam), "two.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t1500\t1560\nchr1\t1400\t1460\n")
    seen = []
    region = port_assemble.assemble_region

    def spy(params, local_bed, *a, **k):
        seen.append(local_bed.to_sc_string())
        return region(params, local_bed, *a, **k)

    monkeypatch.setattr(port_assemble, "assemble_region", spy)
    got = _assemble(port_assemble.assemble, PortOpts, (bam, bed, fa),
                    "sam_reference")
    assert seen == ["chr1:1500-1560", "chr1:1400-1460"]
    assert got.startswith("@SQ\t")
    want = _assemble(reference_assemble, OtterOpts, (bam, bed, fa),
                     "sam_reference")
    assert got == want
    p = _opts(PortOpts, read_group="S1")
    p.init_threads(4)
    out = io.StringIO()
    port_assemble.assemble(bam, bed, fa, False, p, out=out)
    assert out.getvalue() == want


def test_host_genotype_and_compare_take_the_host_path(cohort, pair,
                                                      host_only):
    """genotype and compare under host: the python allele parser, no
    batched pipeline, no engine, no process group, no kernel launch; the
    same bytes as otter_tpu --device host's."""
    got = _genotype(port_genotype.genotype, PortOpts, *cohort, threads=2)
    assert got == _genotype(reference_genotype, OtterOpts, *cohort)
    got = _compare(port_compare.compare, PortOpts, *pair)
    assert got == _compare(reference_compare, OtterOpts, *pair)


def test_host_refuses_an_engine(loci, cohort, pair):
    """The host mode runs no engine and no mesh: one given raises."""
    from otter_tpu_torch.kernels.dist_backend import TorchDistBackend

    bam, bed, _fa = loci["het"]
    backend = TorchDistBackend("cpu")
    with pytest.raises(ValueError, match="host"):
        port_assemble.assemble(bam, bed, "", False, _opts(PortOpts),
                               out=io.StringIO(), dist_backend=backend)
    with pytest.raises(ValueError, match="host"):
        port_compare.compare(_opts(PortOpts), pair[2], pair[0], pair[1],
                             out=io.StringIO(), dist_backend=backend)
    import torch

    with pytest.raises(ValueError, match="host"):
        port_genotype.genotype(_opts(PortOpts), *cohort, out=io.StringIO(),
                               mesh=(torch.device("cpu"),) * 2)


@pytest.mark.parametrize("device", ["host", "cpu", "cuda"])
def test_cli_device_choices(device, monkeypatch):
    """--device of assemble and genotype offers cuda, cpu and host and
    hands the choice to the model unchanged."""
    seen = []
    monkeypatch.setattr(port_assemble, "assemble",
                        lambda *a, **k: seen.append(a[4].device))
    monkeypatch.setattr(port_genotype, "genotype",
                        lambda p, *a, **k: seen.append(p.device))
    assert port_main(["assemble", "r.bam", "-b", "r.bed", "-R", "S1",
                      "--device", device]) == 0
    assert port_main(["genotype", "c.bam", "-b", "r.bed", "--device",
                      device]) == 0
    assert seen == [device, device]


@pytest.mark.parametrize("device", ["auto", "tpu"])
def test_cli_refuses_auto_and_tpu(device, capsys):
    """The JAX CLI's auto (it would carry on on the CPU without a card) and
    tpu (another chip) are refused by both subcommands."""
    for argv in (["assemble", "r.bam", "-b", "r.bed", "-R", "S1"],
                 ["genotype", "c.bam", "-b", "r.bed"]):
        with pytest.raises(SystemExit) as exc:
            port_main(argv + ["--device", device])
        assert exc.value.code == 2
        assert "invalid choice" in capsys.readouterr().err


def test_host_cli_processes_without_jax(loci, cohort, tmp_path):
    """``otter-torch assemble --device host`` and ``genotype --device
    host`` in two fresh processes under one 2-process coordinator
    environment: neither joins a group or shards (each writes the whole
    one-process stream, the JAX package's host bytes), and each ends with
    neither jax nor any otter_tpu module loaded and no CUDA context."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    bam, bed, _fa = loci["het"]
    gbam, gbed, gfa = cohort
    runs = {"assemble": ["assemble", bam, "-b", bed, "-R", "S1",
                         "--device", "host"],
            "genotype": ["genotype", gbam, "-b", gbed, "-r", gfa,
                         "--device", "host", "-e", "0.01"]}
    code = (
        "import io, sys\n"
        "import torch\n"
        "from otter_tpu_torch.cli.main import main\n"
        "tag = sys.argv[1]\n"
        f"for name, argv in {runs!r}.items():\n"
        "    buf, sys.stdout = sys.stdout, io.StringIO()\n"
        "    try:\n"
        "        assert main(argv) == 0\n"
        "    finally:\n"
        "        buf, sys.stdout = sys.stdout, buf\n"
        "    open(f'{name}_{tag}.out', 'w').write(buf.getvalue())\n"
        "sys.stderr.write('JAX_LOADED=%s\\n' % ('jax' in sys.modules))\n"
        "sys.stderr.write('REFERENCE_LOADED=%s\\n' % any(\n"
        "    m.split('.')[0] == 'otter_tpu' for m in sys.modules))\n"
        "sys.stderr.write('CUDA_INITIALIZED=%s\\n'\n"
        "                 % torch.cuda.is_initialized())\n")
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=REPO,
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   OTTER_TPU_COORD_TIMEOUT_S="5")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(pid)], cwd=str(tmp_path),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want = {"assemble": _assemble(reference_assemble, OtterOpts,
                                  loci["het"], "sam")}
    p = _opts(OtterOpts)
    p.init_max_error(0.01)
    out = io.StringIO()
    reference_genotype(p, gbam, gbed, gfa, out=out)
    want["genotype"] = out.getvalue()
    for pid, (proc, (_out, err)) in enumerate(zip(procs, results)):
        assert proc.returncode == 0, err
        assert "JAX_LOADED=False" in err
        assert "REFERENCE_LOADED=False" in err
        assert "CUDA_INITIALIZED=False" in err
        assert "handling" not in err and "single-process" not in err
        for name, text in want.items():
            assert text.count("\n") >= 3, name
            with open(tmp_path / f"{name}_{pid}.out") as fh:
                assert fh.read() == text, (name, pid)
