"""The PyTorch port's multi-process region sharding
(otter_tpu_torch/parallel/distributed.py) on the CPU over gloo: analogs of
tests/test_distributed_multiprocess.py and tests/test_distributed_failures.py.

Each process runs the port's command line (``python -m
otter_tpu_torch.cli.main``), which imports neither jax nor otter_tpu; the
oracle is ``otter_tpu`` with ``device="host"`` in the test process. Every
comparison is exact: the outputs must be byte-identical."""

import contextlib
import io
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from otter_tpu.config import OtterOpts
from otter_tpu.models.assemble import assemble as reference_assemble
from otter_tpu.models.assemble import \
    trim_partial_output as reference_trim
from otter_tpu.models.genotype import genotype as reference_genotype
from otter_tpu_torch.cli.main import main as port_main
from otter_tpu_torch.io.bed import parse_bed_file
from otter_tpu_torch.models.assemble import trim_partial_output
from otter_tpu_torch.parallel import distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPOLOGY_ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "OTTER_TPU_COORD_TIMEOUT_S", "OTTER_TPU_GATHER")


@pytest.fixture(autouse=True)
def _no_topology(monkeypatch):
    """The test process itself runs single-process."""
    for name in TOPOLOGY_ENV:
        monkeypatch.delenv(name, raising=False)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _make_fixture(tmp_path, n_regions, cov=8, seed=21):
    """tests/test_distributed_failures.py's fixture: n_regions loci of 90 bp
    in one BAM, cov reads each."""
    import random

    from fixtures import make_bam, make_reference, read_record
    from otter_tpu.io.bam import BAM_CMATCH

    rng = random.Random(seed)
    span = 1500
    ref = make_reference(rng, length=1000 + n_regions * span + 1000,
                         repeat="CAG", repeat_at=500, repeat_units=10)
    bam = str(tmp_path / "reads.bam")
    bed = str(tmp_path / "regions.bed")
    records = []
    regions = []
    for r in range(n_regions):
        start = 1000 + r * span
        end = start + 90
        regions.append((start, end))
        for c in range(cov):
            seq = ref[start - 150 : start] + ref[start:end] + ref[end : end + 150]
            records.append(read_record(
                f"r{r}_{c}", 0, start - 150, seq,
                [(len(seq), BAM_CMATCH)], tags=[("rq", "f", 0.999)]))
    make_bam(bam, [("chr1", len(ref))], records)
    with open(bed, "w") as fh:
        for start, end in regions:
            fh.write(f"chr1\t{start}\t{end}\n")
    return bam, bed


def _reference(bam, bed, is_fa=False) -> str:
    params = OtterOpts()
    params.read_group = "S1"
    params.device = "host"
    params.is_fa = is_fa
    buf = io.StringIO()
    reference_assemble(bam, bed, "", False, params, out=buf)
    return buf.getvalue()


def _port_cli(argv) -> str:
    """The port's command line in this process (single-process)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_main(argv) == 0
    return buf.getvalue()


def _assemble_argv(bam, bed, *extra):
    return ["assemble", bam, "-b", bed, "-R", "S1", "--device", "cpu",
            *extra]


def _spawn(argv, out_path, env):
    full = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1", **env)
    with open(out_path, "w") as fh:
        return subprocess.Popen(
            [sys.executable, "-m", "otter_tpu_torch.cli.main", *argv],
            env=full, stdout=fh, stderr=subprocess.PIPE, text=True,
            cwd=REPO)


def _topology(port, pid, nproc, launcher="jax"):
    env = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}"}
    if launcher == "jax":
        env.update(JAX_NUM_PROCESSES=str(nproc), JAX_PROCESS_ID=str(pid))
    else:  # torchrun's variables
        env.update(WORLD_SIZE=str(nproc), RANK=str(pid), LOCAL_RANK=str(pid))
    return env


def _run_all(argv, tmp_path, nproc, extra=None, launcher="jax",
             suffix="out"):
    """nproc processes of the port's CLI on one coordinator; returns their
    outputs in process order, after checking that each exited 0 and saw
    the topology."""
    port = _free_port()
    procs, outs = [], []
    for pid in range(nproc):
        outs.append(str(tmp_path / f"{suffix}_{pid}"))
        env = _topology(port, pid, nproc, launcher)
        env.update(extra or {})
        procs.append(_spawn(argv, outs[-1], env))
    fails = []
    for pid, p in enumerate(procs):
        try:
            _so, se = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            _so, se = p.communicate()
            fails.append((pid, "timeout", se[-2000:]))
            continue
        if p.returncode != 0 or f"process {pid}/{nproc}" not in se:
            fails.append((pid, p.returncode, se[-2000:]))
    assert not fails, fails
    texts = []
    for path in outs:
        with open(path) as fh:
            texts.append(fh.read())
    return texts


@pytest.mark.parametrize("launcher", ["jax", "torchrun"])
def test_two_process_assemble_matches_single(tmp_path, launcher):
    """2 processes, 6 regions x 8 reads, per-process streams: concatenated
    in process order they are the single-process port's bytes, which are
    otter_tpu --device host's; the topology comes from the JAX package's
    variables or from torchrun's WORLD_SIZE / RANK."""
    bam, bed = _make_fixture(tmp_path, n_regions=6)
    single = _reference(bam, bed)
    assert _port_cli(_assemble_argv(bam, bed)) == single
    outs = _run_all(_assemble_argv(bam, bed), tmp_path, 2,
                    launcher=launcher)
    assert outs[0].startswith("@SQ") and not outs[1].startswith("@")
    assert "".join(outs) == single


@pytest.mark.parametrize("n_regions,nproc", [(6, 2), (2, 3)])
def test_gather_to_writer(tmp_path, n_regions, nproc):
    """OTTER_TPU_GATHER=1: process 0 writes the whole single-process stream,
    the others nothing, also with more processes than regions (process 2's
    shard is empty and it still joins the gather)."""
    bam, bed = _make_fixture(tmp_path, n_regions=n_regions)
    single = _reference(bam, bed)
    outs = _run_all(_assemble_argv(bam, bed), tmp_path, nproc,
                    extra={"OTTER_TPU_GATHER": "1"})
    assert outs[0] == single
    assert outs[1:] == [""] * (nproc - 1)


def test_killed_worker_region_redispatch(tmp_path):
    """SIGKILL worker 1 once it has written a record (one region a batch, so
    it writes region by region); trim its torn output to whole regions and
    run its shard again with --resume: worker 0's output, the trimmed
    partial and the resumed run are the single-process FASTA, byte for
    byte, and the resumed run repeats no region."""
    n_regions = 8
    bam, bed = _make_fixture(tmp_path, n_regions=n_regions)
    single = _reference(bam, bed, is_fa=True)
    port = _free_port()
    argv = _assemble_argv(bam, bed, "--fasta")
    extra = {"OTTER_TPU_REGION_BATCH": "1"}
    out0, out1 = str(tmp_path / "out_0.fa"), str(tmp_path / "out_1.fa")
    p0 = _spawn(argv, out0, {**_topology(port, 0, 2), **extra})
    p1 = _spawn(argv, out1, {**_topology(port, 1, 2), **extra})
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and p1.poll() is None:
            if os.path.getsize(out1) > 0:
                break
            time.sleep(0.05)
        if p1.poll() is None:
            os.kill(p1.pid, signal.SIGKILL)
        p1.communicate(timeout=60)
        _so, se0 = p0.communicate(timeout=240)
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert p0.returncode == 0, se0[-2000:]

    done = trim_partial_output(out1)
    shard1 = dist.shard_regions(parse_bed_file(bed), 1, 2)
    assert len(shard1) == n_regions // 2
    bed1 = str(tmp_path / "shard1.bed")
    with open(bed1, "w") as fh:
        fh.writelines(f"{b.chr}\t{b.start}\t{b.end}\n" for b in shard1)
    redone = _port_cli(_assemble_argv(bam, bed1, "--fasta", "--resume",
                                      out1))
    resumed = {line[1:].split("#")[1] for line in redone.splitlines()
               if line.startswith(">")}
    assert not (done & resumed), "resume repeated a completed region"
    assert done | resumed == {b.to_sc_string() for b in shard1}
    with open(out0) as f0, open(out1) as f1:
        assert f0.read() + f1.read() + redone == single


INVALID_TOPOLOGIES = [
    {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "x"},
    {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "0"},
    {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "2",
     "JAX_PROCESS_ID": "7"},
    {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "2",
     "JAX_PROCESS_ID": "nope"},
    {"JAX_COORDINATOR_ADDRESS": "127.0.0.1", "JAX_NUM_PROCESSES": "2"},
    {"COORDINATOR_ADDRESS": "127.0.0.1:1"},
    {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "WORLD_SIZE": "2",
     "RANK": "5"},
]


@pytest.fixture
def rendezvous_calls(monkeypatch):
    """Stand-ins for torch.distributed's rendezvous that record their
    arguments."""
    import torch.distributed as tdist

    calls = []
    monkeypatch.setattr(tdist, "TCPStore",
                        lambda *a, **k: calls.append(("store", a, k)))
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda *a, **k: calls.append(("init", a, k)))
    monkeypatch.setattr(tdist, "get_rank", lambda: calls[-1][2]["rank"])
    monkeypatch.setattr(tdist, "get_world_size",
                        lambda: calls[-1][2]["world_size"])
    return calls


@pytest.mark.parametrize("env", INVALID_TOPOLOGIES)
def test_coordinator_env_validation(env, monkeypatch, capsys,
                                    rendezvous_calls):
    """An invalid topology warns and runs single-process: no rendezvous is
    attempted, nothing raises."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dist.maybe_initialize() == (0, 1)
    assert not rendezvous_calls, f"rendezvous attempted for {env}"
    assert "[WARNING]" in capsys.readouterr().err


def test_valid_topology_reaches_rendezvous(monkeypatch, rendezvous_calls):
    """A valid topology reaches the rendezvous with the bounded timeout, as
    a client for a non-zero process index, over gloo; torchrun's
    WORLD_SIZE / RANK stand in for JAX_NUM_PROCESSES / JAX_PROCESS_ID."""
    import datetime

    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:29400")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.setenv("OTTER_TPU_COORD_TIMEOUT_S", "7")
    assert dist.maybe_initialize() == (1, 2)
    (_s, sargs, skw), (_i, iargs, ikw) = rendezvous_calls
    assert sargs == ("127.0.0.1", 29400, 2)
    assert skw["is_master"] is False
    assert skw["timeout"] == datetime.timedelta(seconds=7)
    assert iargs == ("gloo",) and (ikw["rank"], ikw["world_size"]) == (1, 2)
    monkeypatch.delenv("JAX_NUM_PROCESSES")
    monkeypatch.delenv("JAX_PROCESS_ID")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    assert dist._validated_topology() == dict(
        host="127.0.0.1", port=29400, world_size=4, rank=0, timeout_s=7.0)


def test_unreachable_coordinator_times_out():
    """A dead coordinator with OTTER_TPU_COORD_TIMEOUT_S=5 fails the
    rendezvous fast (a warning, single-process), it does not hang."""
    code = (
        "import sys, time\n"
        "from otter_tpu_torch.parallel.distributed import maybe_initialize\n"
        "t0 = time.monotonic()\n"
        "pidx, pcount = maybe_initialize()\n"
        "print('RESULT', pidx, pcount, time.monotonic() - t0)\n")
    env = dict(os.environ, PYTHONPATH=REPO,
               JAX_COORDINATOR_ADDRESS="127.0.0.1:1", JAX_NUM_PROCESSES="2",
               JAX_PROCESS_ID="1", OTTER_TPU_COORD_TIMEOUT_S="5")
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert time.monotonic() - t0 < 60
    assert r.returncode == 0, r.stderr[-2000:]
    assert "RESULT 0 1" in r.stdout
    assert "[WARNING]" in r.stderr


TRIM_CASES = {
    # the second region has only its first allele flushed
    "half_region": "\n".join(
        [">a0#chr1:100-200#x", "ACGTACGT", ">a1#chr1:100-200#x", "GGGG",
         ">b0#chr1:300-400#x", "TTTT"]) + "\n",
    # a torn (no newline) sequence line of the last record
    "torn_line": "\n".join(
        [">a0#chr1:100-200#x", "ACGTACGT", ">a1#chr1:100-200#x", "GGGG",
         ">b0#chr1:300-400#x", "TTTT", ">b1#chr1:300-400#x", "CCCC"])
    + "\n>c0#chr1:500-600#x\nACG",
    # a whole file: the last region still goes (completeness is unknowable)
    "complete": "\n".join(
        [">a0#chr1:100-200#x", "ACGTACGT", ">a1#chr1:100-200#x", "GGGG",
         ">b0#chr1:300-400#x", "TTTT", ">b1#chr1:300-400#x", "CCCC"]) + "\n",
    # SAM: the header stays, the last region's records go, a torn line too
    "sam": "@SQ\tSN:chr1\tLN:9\n@RG\tID:S1\n"
    + "".join(f"r{i}\t0\tchr1\t1\t60\t4M\t*\t0\t0\tACGT\t*\tta:Z:chr1:{a}\n"
              for i, a in enumerate(["1-5", "1-5", "6-9"]))
    + "r3\t0\tchr1\t1\t60\t4M\t*",
}


@pytest.mark.parametrize("name", sorted(TRIM_CASES))
def test_trim_partial_output_matches_jax(tmp_path, name):
    """trim_partial_output on multi-line FASTA records and on SAM: the same
    surviving regions and the same rewritten file as the JAX package's."""
    text = TRIM_CASES[name]
    got, want = tmp_path / "port", tmp_path / "jax"
    got.write_text(text)
    want.write_text(text)
    done = trim_partial_output(str(got))
    assert done == reference_trim(str(want))
    assert got.read_bytes() == want.read_bytes()
    assert done == {"half_region": {"chr1:100-200"},
                    "torn_line": {"chr1:100-200", "chr1:300-400"},
                    "complete": {"chr1:100-200"},
                    "sam": {"chr1:1-5"}}[name]


@pytest.mark.parametrize("gather", ["0", "1"])
def test_two_process_genotype(tmp_path, gather):
    """genotype in 2 processes on a 4-sample x 6-region cohort: with
    OTTER_TPU_GATHER=1 process 0 writes otter_tpu genotype's VCF (host) and
    process 1 nothing; without it, the two streams concatenated are that
    VCF."""
    from otter_tpu_torch.utils.synth import cohort_fixture

    bam, bed, fa = cohort_fixture(str(tmp_path), 4, 6, seed=9)
    params = OtterOpts()
    params.device = "host"
    single = io.StringIO()
    reference_genotype(params, bam, bed, fa, out=single)
    # -e: the oracle runs with OtterOpts' max_error, not the CLI's
    argv = ["genotype", bam, "-b", bed, "-r", fa, "--device", "cpu", "-e",
            str(params.max_error)]
    outs = _run_all(argv, tmp_path, 2, extra={"OTTER_TPU_GATHER": gather},
                    suffix="vcf")
    if gather == "1":
        assert outs == [single.getvalue(), ""]
    else:
        assert "".join(outs) == single.getvalue()
        assert not outs[1].startswith("#")
