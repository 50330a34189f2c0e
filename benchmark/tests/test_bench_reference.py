"""The plain reference: its dynamic programs against plain loops and the
program's numpy aligner, and its records on hand-checked and small
regions."""

import os
import random

import pytest

from benchmark.fixtures.synth import read_record, write_bam, write_fasta
from benchmark.harness import component, load_cell
from benchmark.reference import dp
from benchmark.reference import otter as ref

from conftest import TINY


def _lev(x: str, y: str) -> int:
    prev = list(range(len(y) + 1))
    for i in range(1, len(x) + 1):
        cur = [i] + [0] * len(y)
        for j in range(1, len(y) + 1):
            cur[j] = min(prev[j - 1] + (x[i - 1] != y[j - 1]), prev[j] + 1,
                         cur[j - 1] + 1)
        prev = cur
    return prev[-1]


def test_edit_distances_against_plain_loop():
    rnd = random.Random(11)
    pairs = [("", "ACGT"), ("ACGT", "ACGT"), ("A", "T"), ("AC" * 40, "CA")]
    for _ in range(80):
        x = "".join(rnd.choice("ACGTN") for _ in range(rnd.randint(1, 90)))
        y = list(x) if rnd.random() < 0.5 else []
        for _ in range(rnd.randint(0, 12)):
            if y:
                y[rnd.randrange(len(y))] = rnd.choice("ACGT")
        y = "".join(y) or "".join(rnd.choice("ACGT")
                                  for _ in range(rnd.randint(1, 120)))
        pairs.append((x, y))
    want = [_lev(x, y) for x, y in pairs]
    # a narrow first band sends most pairs up the ladder
    assert dp.edit_distances(pairs, "cpu", k0=1).tolist() == want
    assert dp.edit_distances(pairs, "cpu").tolist() == want


def _ends_free_lev(p: str, t: str, pb: int, pe: int, tb: int,
                   te: int) -> int:
    """Edit distance with up to pb / pe pattern and tb / te text
    characters skipped for free at the begin / end: plain loops."""
    m, n = len(p), len(t)
    D = [[0] * (n + 1) for _ in range(m + 1)]
    for i in range(m + 1):
        for j in range(n + 1):
            if i == 0 or j == 0:
                D[i][j] = max(0, i - pb) if j == 0 else max(0, j - tb)
                continue
            D[i][j] = min(D[i - 1][j - 1] + (p[i - 1] != t[j - 1]),
                          D[i - 1][j] + 1, D[i][j - 1] + 1)
    last_row = min(D[m][j] for j in range(max(0, n - te), n + 1))
    last_col = min(D[i][n] for i in range(max(0, m - pe), m + 1))
    return min(last_row, last_col)


def test_ends_free_distances_against_plain_loops():
    """The batched ends-free DP against plain loops and the program's
    numpy version, empty sides included."""
    from otter_tpu_torch.ops.align_np import edit_distance_ends_free

    rnd = random.Random(13)
    jobs = [("", "ACG", 0, 0, 1, 0), ("ACG", "", 0, 2, 0, 0), ("", "", 0, 0,
                                                               0, 0)]
    for _ in range(120):
        x = "".join(rnd.choice("ACGT") for _ in range(rnd.randint(0, 50)))
        y = x[rnd.randint(0, len(x) // 2):] if rnd.random() < 0.5 else ""
        y += "".join(rnd.choice("ACGT") for _ in range(rnd.randint(0, 40)))
        jobs.append((x, y) + tuple(rnd.randint(0, 15) for _ in range(4)))
    want = [_ends_free_lev(*j) for j in jobs]
    assert [edit_distance_ends_free(*j) for j in jobs] == want
    assert dp.edit_distances_ends_free(jobs, "cpu").tolist() == want


def test_affine_cigars_against_numpy_aligner():
    from otter_tpu_torch.ops.align_np import affine_align_ends_free_cigar

    rnd = random.Random(5)
    jobs = []
    for _ in range(40):
        p = "".join(rnd.choice("ACGT") for _ in range(rnd.randint(5, 160)))
        t = list(p)
        for _ in range(rnd.randint(0, 10)):
            op = rnd.random()
            at = rnd.randrange(len(t) + 1)
            if op < 0.4 and at < len(t):
                t[at] = rnd.choice("ACGT")
            elif op < 0.7:
                t.insert(at, rnd.choice("ACGT"))
            elif at < len(t):
                del t[at]
        t = "".join(t) or "A"
        ld = len(p) - len(t)
        ends = rnd.choice([(0, 0, 0, 0), (0, max(ld, 0), 0, 0),
                           (max(ld, 0), 0, 0, 0), (0, 0, 0, max(-ld, 0)),
                           (0, 0, max(-ld, 0), 0)])
        jobs.append((p, t) + ends)
    jobs.append(("CAGCAGCAG" * 30, "CAGCAGCAG" * 20, 0, 0, 0, 0))
    got = dp.affine_cigars(jobs, "cpu")
    want = [affine_align_ends_free_cigar(*j) for j in jobs]
    assert got == want


def test_hand_checked_region(tmp_path):
    """Three reads with the same 20 bases over chr1:100-120: one allele of
    those bases, total, allele and spanning coverage 3, one cluster, SE
    0."""
    rng = random.Random(2)
    contig = "".join(rng.choice("ACGT") for _ in range(400))
    fasta = str(tmp_path / "ref.fa")
    write_fasta(fasta, [("chr1", contig)])
    records = [read_record(f"r{i}", 50, contig[50:200], [(150, 0)])
               for i in range(3)]
    bam = str(tmp_path / "r.bam")
    write_bam(bam, [("chr1", 400)], records)
    out = ref.assemble(ref.Opts(read_group="S"), bam, fasta,
                       [("chr1", 100, 120)], "cpu")
    seq = contig[99:120]
    assert out[("chr1", 100, 120)] == [(
        f"chr1:100-120_0\t0\tchr1\t100\t0\t{len(seq)}M\t*\t0\t0\t{seq}\t"
        f"{'!' * len(seq)}\tRG:Z:S\tta:Z:chr1:100-120\ttc:i:3\tac:i:3"
        f"\tsc:i:3\tic:i:1\tse:f:0", 0.0)]


def _fixture(tmp_path, workload, seed):
    cell = load_cell(workload, overrides=TINY[workload])
    gen = component("generators", cell.traffic["generator"])
    return cell, gen.make(str(tmp_path), seed, cell.config, cell.traffic)


def _host_mode_records(package, cell, fx, sample):
    """The records of ``package``'s (the port's or the JAX package's)
    pure-host mode over one sample."""
    import importlib
    import io

    OtterOpts = importlib.import_module(f"{package}.config").OtterOpts
    assemble = importlib.import_module(f"{package}.models.assemble").assemble
    params = OtterOpts()
    for k, v in cell.config["otter"].items():
        setattr(params, k, v)
    params.read_group = sample.name
    params.device = "host"
    buf = io.StringIO()
    assemble(sample.bam, fx.bed, fx.fasta, False, params, out=buf)
    return [l for l in buf.getvalue().splitlines() if not l.startswith("@")]


def _reference_records(cell, fx, sample):
    opts = ref.Opts.of(dict(cell.config["otter"], read_group=sample.name))
    want = ref.assemble(opts, sample.bam, fx.fasta, fx.regions(), "cpu")
    return [l for r in fx.regions() for l, _se in want[r]]


@pytest.mark.parametrize("workload", sorted(TINY))
def test_reference_equals_program_host_mode(tmp_path, workload):
    """At the small sizes the reference's records are the bytes of the
    program's pure-host mode."""
    cell, fx = _fixture(tmp_path, workload, 77)
    for sample in fx.samples:
        got = _host_mode_records("otter_tpu_torch", cell, fx, sample)
        assert got == _reference_records(cell, fx, sample)
        assert len(got) >= len(fx.loci)


_WITNESS = """
import json, pathlib, sys, tempfile
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import test_bench_reference as t
out = []
for seed in {seeds!r}:
    with tempfile.TemporaryDirectory() as d:
        cell, fx = t._fixture(pathlib.Path(d), {workload!r}, seed)
        for sample in fx.samples:
            out.append(t._host_mode_records("otter_tpu", cell, fx, sample))
print(json.dumps(out))
"""


@pytest.mark.parametrize("workload", sorted(TINY))
def test_reference_equals_jax_package_host_mode(tmp_path, workload):
    """A second witness for the reference's host logic, which is a frozen
    copy of the port's: the JAX package's pure-host mode (the repository's
    own reference implementation) gives the same records on the cells'
    layouts at the small sizes, reads that end inside a locus included.
    It runs in a process of its own, so the JAX stack stays out of this
    one."""
    import json
    import subprocess
    import sys

    from conftest import ROOT

    seeds = [11, 12, 13]
    code = _WITNESS.format(root=ROOT, tests=os.path.dirname(__file__),
                           seeds=seeds, workload=workload)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=ROOT, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    want = []
    for seed in seeds:
        (tmp_path / str(seed)).mkdir()
        cell, fx = _fixture(tmp_path / str(seed), workload, seed)
        want += [_reference_records(cell, fx, s) for s in fx.samples]
    assert got == want
    assert sum(map(len, want)) >= len(seeds) * len(fx.loci)
