"""The PyTorch port's -t on the CPU: assemble at -t 4 (region prep stays
on one thread), its opt-in finish pool (OTTER_TPU_FINISH_POOL=1, spawned
workers in otter_tpu_torch/models/_finish_worker.py), and genotype's region
pools, against -t 1 and ``otter_tpu`` with ``device="host"``. Every
comparison is exact: the outputs must be byte-identical."""

import io

import pytest

from otter_tpu.models.assemble import assemble as reference_assemble
from otter_tpu_torch.config import OtterOpts as PortOpts
from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
from otter_tpu_torch.models.assemble import assemble
from otter_tpu_torch.utils import metrics

from test_torch_assemble import FIXTURES, _params, fixtures  # noqa: F401

# name: (params, with the reference FASTA, reads only)
VARIANTS = {"sam": ({}, False, False),
            "fasta": ({"is_fa": True}, False, False),
            "sam_reference": ({}, True, False),
            "reads_only": ({}, True, True),
            "reads_only_fasta": ({"is_fa": True}, True, True)}


@pytest.fixture(scope="module")
def all_fixtures(fixtures, tmp_path_factory):  # noqa: F811
    """test_torch_assemble.py's one-locus fixtures, and six loci in one BAM
    with a fifth of the reads ending inside their allele (the finish pool
    then has regions to share, and realignment has reads to rescue)."""
    import random

    from fixtures import write_fasta
    from otter_tpu_torch.utils.synth import tandem_repeat_loci

    tmp = tmp_path_factory.mktemp("loci6")
    bam, bed = tandem_repeat_loci(str(tmp), n_regions=6, cov=12, err=0.002,
                                  expansion=30, region_len=500, seed=5,
                                  name="loci6", partial=0.2)
    # the loci's reference: tandem_repeat_loci's first draws from its seed
    ref_len = 1000 + 6 * (500 + 2 * 500 + 2 * 1000) + 2000
    rng = random.Random(5)
    fa = str(tmp / "ref.fa")
    write_fasta(fa, [("chr1", "".join(rng.choice("ACGT")
                                      for _ in range(ref_len)))])
    return {**fixtures, "loci6": (bam, bed, fa)}


def _run(fn, fx, variant, threads=1, backend=None):
    """``fn`` (the port's assemble on the CPU, or otter_tpu's on the host)
    on one fixture and variant."""
    bam, bed, fa = fx
    kw, with_ref, reads_only = VARIANTS[variant]
    if fn is reference_assemble:
        p = _params("host", **kw)
    else:
        p = PortOpts(read_group="S1", device="cpu", **kw)
        p.init_threads(threads)
    out = io.StringIO()
    extra = {"dist_backend": backend} if backend is not None else {}
    fn(bam, bed, fa if with_ref else "", reads_only, p, out=out, **extra)
    return out.getvalue()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", list(FIXTURES) + ["loci6"])
def test_threads_byte_identical(all_fixtures, name, variant):
    """assemble -t 4 writes -t 1's bytes and otter_tpu --device host's,
    for SAM, FASTA, with a reference, and the reads-only SAM and FASTA."""
    fx = all_fixtures[name]
    got = _run(assemble, fx, variant, threads=4)
    assert got == _run(assemble, fx, variant, threads=1)
    assert got == _run(reference_assemble, fx, variant)
    assert got.count("\n") >= 2


@pytest.mark.parametrize("name", ["het", "loci6"])
def test_finish_pool_byte_identical(all_fixtures, name, monkeypatch):
    """OTTER_TPU_FINISH_POOL=1 -t 2: two spawned workers take the host half
    of every region (float64 KDE, hclust, reassignment with the distances
    this process's engine gave, native affine ladder, python POA) and the
    bytes are -t 1's and otter_tpu's; no consensus member went to K5, so
    the pool did the work."""
    fx = all_fixtures[name]
    want = _run(reference_assemble, fx, "sam")
    assert _run(assemble, fx, "sam", threads=1) == want
    monkeypatch.setenv("OTTER_TPU_FINISH_POOL", "1")
    backend = TorchDistBackend("cpu")
    metrics.reset()
    got = _run(assemble, fx, "sam", threads=2, backend=backend)
    snap = metrics.snapshot()
    assert got == want
    c = backend.engine.counters()
    assert c["pairs_k1"] > 0 and c["jobs_k5"] == 0
    assert "time.consensus_batch" not in snap


@pytest.mark.parametrize("with_reference", [True, False])
def test_genotype_threads_byte_identical(tmp_path, with_reference):
    """genotype -t 4 equals -t 1 on an 8-sample x 6-region cohort: the
    batched pipeline's prep and finish pools (with the reference) and the
    region pool of the no-reference TSV."""
    from otter_tpu_torch.models.genotype import genotype
    from otter_tpu_torch.utils.synth import cohort_fixture

    bam, bed, fa = cohort_fixture(str(tmp_path), 8, 6, seed=11)
    outs = []
    for threads in (1, 4):
        p = PortOpts()
        p.device = "cpu"
        p.init_threads(threads)
        out = io.StringIO()
        genotype(p, bam, bed, fa if with_reference else "", out=out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") >= 6
