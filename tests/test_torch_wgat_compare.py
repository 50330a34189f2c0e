"""The PyTorch port's ``wgat`` and ``compare`` (otter_tpu_torch/models/) on
the CPU against ``otter_tpu`` on the fixtures of test_e2e_wgat_compare.py.
Every comparison is exact: the outputs must be byte-identical."""

import io
import random

import pytest

from otter_tpu.config import OtterOpts
from otter_tpu.models.compare import compare as reference_compare
from otter_tpu.models.wgat import wgat as reference_wgat
from otter_tpu_torch.config import OtterOpts as PortOpts
from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
from otter_tpu_torch.models.compare import compare
from otter_tpu_torch.models.wgat import wgat

from fixtures import make_bam, read_record
from test_e2e_wgat_compare import (BAM_CMATCH, _otter_bam_from_alleles,
                                   wga_fixture)  # noqa: F401 (fixture)


def _wgat_pair(bam, bed, is_fa=False, threads=1):
    outs = []
    for fn, opts in ((wgat, PortOpts()), (reference_wgat, OtterOpts())):
        opts.read_group = "ASM1"
        opts.is_fa = is_fa
        opts.init_threads(threads)
        out = io.StringIO()
        fn(opts, bam, bed, out=out)
        outs.append(out.getvalue())
    return outs


@pytest.mark.parametrize("is_fa", [False, True])
def test_wgat_byte_identical(wga_fixture, is_fa):  # noqa: F811
    """wgat SAM and FASTA on the contig with a deletion in one region."""
    got, want = _wgat_pair(wga_fixture["bam"], wga_fixture["bed"], is_fa)
    assert got == want
    assert len([l for l in got.splitlines()
                if l and not l.startswith("@")]) in (2, 4)


def test_wgat_threaded_byte_identical(tmp_path):
    """-t 4 (contig pool, contig-ordered emission) on 4 contigs x 3
    regions equals otter_tpu's -t 1 output."""
    rng = random.Random(9)
    refs, recs, bed_lines = [], [], []
    for c in range(4):
        name = f"chr{c + 1}"
        ref = "".join(rng.choice("ACGT") for _ in range(3000))
        refs.append((name, 3000))
        contig = ref[200:2800]
        recs.append(read_record(f"ctg_{c}", c, 200, contig,
                                [(len(contig), BAM_CMATCH)]))
        for r in range(3):
            s = 500 + 600 * r
            bed_lines.append(f"{name}\t{s}\t{s + 80}\n")
    bam = str(tmp_path / "asm_multi.bam")
    make_bam(bam, refs, recs)
    bed = str(tmp_path / "rois.bed")
    with open(bed, "w") as fh:
        fh.writelines(bed_lines)
    got, _want = _wgat_pair(bam, bed, threads=4)
    assert got == _wgat_pair(bam, bed, threads=1)[1]
    assert len([l for l in got.splitlines()
                if l and not l.startswith("@")]) == 12


def _compare_pair(bed, truth, query):
    backend = TorchDistBackend("cpu")
    p = PortOpts()
    p.device = "cpu"
    got = io.StringIO()
    compare(p, bed, truth, query, out=got, dist_backend=backend)
    scalar = io.StringIO()
    compare(p, bed, truth, query, out=scalar, pooled=False)
    want = io.StringIO()
    host = OtterOpts()
    host.device = "host"
    reference_compare(host, bed, truth, query, out=want)
    return got.getvalue(), scalar.getvalue(), want.getvalue(), backend


def test_compare_byte_identical(tmp_path):
    """compare on test_e2e_wgat_compare.py's one-region pair: the pooled
    engine path, the scalar path and otter_tpu's host path agree."""
    truth = _otter_bam_from_alleles(
        tmp_path, "truth.bam",
        {("100-200", 100): [("ACGTACGTAC", "b"), ("ACGTTTTTAC", "b")]},
        "T1")
    query = _otter_bam_from_alleles(
        tmp_path, "query.bam",
        {("100-200", 100): [("ACGTACGTAC", "b"), ("ACGTTTTGAC", "b")]},
        "Q1")
    bed = str(tmp_path / "r.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t100\t200\n")
    got, scalar, want, _b = _compare_pair(bed, truth, query)
    assert got == scalar == want
    assert [r.split("\t")[4] for r in got.splitlines()] == ["0", "1"]


def test_compare_pooled_matches_scalar(tmp_path):
    """The pooled engine path (the port's distance engine, then the batched
    composite DP) on test_e2e_wgat_compare.py's 30-region fixture (N/NDNNN,
    equal sequences, pure indels, high divergence) equals the scalar path
    and otter_tpu's host path."""
    rng = random.Random(4242)

    def acgt(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    def mut(s, rate):
        o = []
        for ch in s:
            x = rng.random()
            if x < rate * 0.4:
                o.append(rng.choice([b for b in "ACGT" if b != ch]))
            elif x < rate * 0.7:
                o.extend([ch, rng.choice("ACGT")])
            elif x < rate:
                pass
            else:
                o.append(ch)
        return "".join(o)

    truth_by_region, query_by_region, bed_rows = {}, {}, []
    start = 100
    for r in range(30):
        region = f"{start}-{start + 60}"
        base = acgt(rng.randint(40, 400))
        kind = r % 6
        if kind == 0:
            t = [(base, "b"), (base + "ACG", "b")]
            q = [(base, "b"), (base + "ACG", "b")]
        elif kind == 1:
            t = [("N", "b"), (base, "b")]
            q = [("NDNNN", "b"), (mut(base, 0.02), "b")]
        elif kind == 2:
            t = [(base, "b"), (base + "CAGCAGCAG", "l")]
            q = [(base + "CAG", "b")]
        elif kind == 3:
            t = [(base, "b"), (mut(base, 0.5), "b")]
            q = [(mut(base, 0.3), "b"), (acgt(len(base)), "b")]
        else:
            t = [(base, "b"), (mut(base, 0.05), "r")]
            q = [(mut(base, 0.01), "b"), (mut(base, 0.03), "b")]
        truth_by_region[(region, start)] = t
        query_by_region[(region, start)] = q
        bed_rows.append(f"chr1\t{start}\t{start + 60}\n")
        start += 200
    truth = _otter_bam_from_alleles(tmp_path, "truth_many.bam",
                                    truth_by_region, "T1")
    query = _otter_bam_from_alleles(tmp_path, "query_many.bam",
                                    query_by_region, "Q1")
    bed = str(tmp_path / "many.bed")
    with open(bed, "w") as fh:
        fh.writelines(bed_rows)
    got, scalar, want, backend = _compare_pair(bed, truth, query)
    assert got == scalar == want
    assert got.count("\n") >= 40
    assert backend.engine.pairs_k1 > 0
