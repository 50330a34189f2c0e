"""The PyTorch port's ``genotype`` and ``vcf2mat``
(otter_tpu_torch/models/) on the CPU against ``otter_tpu`` with
``device="host"`` (the sequential pure-host path). Every comparison is
exact: the outputs must be byte-identical."""

import io
import random

import pytest
import torch

from otter_tpu.config import OtterOpts
from otter_tpu.io.bai import index_bam
from otter_tpu.io.bam import parse_sam_to_bam
from otter_tpu.models.assemble import assemble as reference_assemble
from otter_tpu.models.genotype import genotype as reference_genotype
from otter_tpu.models.vcf2mat import vcf2mat as reference_vcf2mat
from otter_tpu_torch.config import OtterOpts as PortOpts
from otter_tpu_torch.models import genotype as port_genotype
from otter_tpu_torch.models.vcf2mat import vcf2mat
from otter_tpu_torch.utils.synth import cohort_fixture

from fixtures import make_reference, simulate_region_bam, write_fasta


def _merge(sam_texts, path):
    """samtools-merge analog of test_e2e_genotype.py: the first header,
    every @RG line, then every body line."""
    merged = []
    for i, text in enumerate(sam_texts):
        for line in text.rstrip("\n").split("\n"):
            if not line.startswith("@") or i == 0 or line.startswith("@RG"):
                merged.append(line)
    hdr = [l for l in merged if l.startswith("@")]
    body = [l for l in merged if not l.startswith("@")]
    parse_sam_to_bam("\n".join(hdr + body) + "\n", path)
    index_bam(path)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """test_e2e_genotype.py's cohort: S1 hom-ref, S2 het, S3 hom-alt at one
    CAG locus, assembled by otter_tpu --device host and merged."""
    tmp = tmp_path_factory.mktemp("cohort")
    rng = random.Random(321)
    ref = make_reference(rng, length=3000, repeat="CAG", repeat_at=1500,
                         repeat_units=20)
    start, end = 1500, 1560
    region_seq = ref[start:end]
    long_allele = "CAG" * 32
    fa = str(tmp / "ref.fa")
    write_fasta(fa, [("chr1", ref)])
    bed = str(tmp / "regions.bed")
    with open(bed, "w") as fh:
        fh.write(f"chr1\t{start}\t{end}\n")
    pairs = {"S1": [region_seq, region_seq],
             "S2": [region_seq, long_allele],
             "S3": [long_allele, long_allele]}
    sams = []
    for si, (sample, alleles) in enumerate(pairs.items()):
        bam = str(tmp / f"{sample}.reads.bam")
        simulate_region_bam(bam, "chr1", ref, (start, end), alleles,
                            per_allele_cov=10, error_rate=0.002, seed=40 + si)
        params = OtterOpts()
        params.read_group = sample
        params.device = "host"
        out = io.StringIO()
        reference_assemble(bam, bed, "", False, params, out=out)
        sams.append(out.getvalue())
    merged = str(tmp / "cohort.bam")
    _merge(sams, merged)
    return merged, bed, fa


@pytest.fixture(scope="module")
def cohort64(tmp_path_factory):
    """bench_e2e's 64-sample cohort (its genotype64 data), 6 regions."""
    return cohort_fixture(str(tmp_path_factory.mktemp("c64")), n_samples=64,
                          n_regions=6, seed=5)


def _reference(bam, bed, fa):
    p = OtterOpts()
    p.device = "host"
    out = io.StringIO()
    reference_genotype(p, bam, bed, fa, out=out)
    return out.getvalue()


def _port(bam, bed, fa, threads=1, device="cpu"):
    p = PortOpts()
    p.device = device
    p.init_threads(threads)
    out = io.StringIO()
    port_genotype.genotype(p, bam, bed, fa, out=out)
    return out.getvalue()


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("with_reference", [True, False])
def test_genotype_cohort_byte_identical(cohort, with_reference, threads):
    """VCF (with the reference) and the no-reference TSV, at -t 1 and 4."""
    bam, bed, fa = cohort
    fa = fa if with_reference else ""
    got = _port(bam, bed, fa, threads)
    assert got == _reference(bam, bed, fa)
    assert got.count("\n") >= 3


def test_vcf2mat_byte_identical(cohort, tmp_path):
    """vcf2mat of the cohort's VCF (REF + one ALT row, 65 k-mer columns)."""
    bam, bed, fa = cohort
    vcf = str(tmp_path / "c.vcf")
    with open(vcf, "w") as fh:
        fh.write(_reference(bam, bed, fa))
    got, want = io.StringIO(), io.StringIO()
    vcf2mat(PortOpts(), bed, vcf, 3, out=got)
    reference_vcf2mat(OtterOpts(), bed, vcf, 3, out=want)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().count("\n") == 2


@pytest.mark.parametrize("threads", [1, 4])
def test_genotype64_batched_byte_identical(cohort64, threads):
    """The batched pipeline (pooled k-mer pass, host f64 BLAS GEMM, native
    hclust) on the 64-sample cohort equals otter_tpu's and the port's
    sequential host paths."""
    got = _port(*cohort64, threads)
    assert got == _reference(*cohort64)
    p = PortOpts()
    p.device = "cpu"
    seq = io.StringIO()
    port_genotype.genotype(p, *cohort64, out=seq, batched=False)
    assert got == seq.getvalue()
    rows = [l for l in got.splitlines() if l and not l.startswith("#")]
    assert len(rows) == 6 and all(len(r.split("\t")) == 9 + 64
                                  for r in rows)


def test_genotype64_f32_gemm_byte_identical(cohort64, monkeypatch):
    """OTTER_TPU_GENOTYPE_DEVICE=1 takes the f32 torch.bmm route (here on
    the CPU) with its 1e-2 certification guard: byte-identical."""
    calls = []
    real = port_genotype.cosine_gemm_f32

    def spy(Vs, device):
        calls.append(len(Vs))
        return real(Vs, device)

    monkeypatch.setattr(port_genotype, "cosine_gemm_f32", spy)
    monkeypatch.setenv("OTTER_TPU_GENOTYPE_DEVICE", "1")
    assert _port(*cohort64) == _reference(*cohort64)
    assert calls == [6]


def test_gemm_full_f32_under_global_tf32(monkeypatch):
    """The GEMM runs with TF32 off even when the caller turned it on
    globally, and the caller's setting comes back afterwards."""
    import numpy as np

    mm = torch.backends.cuda.matmul
    new_api = hasattr(mm, "fp32_precision")

    def tf32_state():
        if new_api:
            return mm.fp32_precision
        return "tf32" if mm.allow_tf32 else "ieee"

    seen = []
    real_bmm = torch.bmm

    def spy(a, b):
        seen.append(tf32_state())
        return real_bmm(a, b)

    monkeypatch.setattr(torch, "bmm", spy)
    rng = np.random.default_rng(0)
    Vs = [rng.random((5, 65)), rng.random((3, 65))]
    before = mm.fp32_precision if new_api else mm.allow_tf32
    mm.allow_tf32 = True
    try:
        S = port_genotype.cosine_gemm_f32(Vs, "cpu")
        after = tf32_state()
    finally:
        if new_api:
            mm.fp32_precision = before
        else:
            mm.allow_tf32 = before
    assert seen == ["ieee"] and after == "tf32"
    # f32 products of values in [0, 1): relative 1e-5 covers 65 roundings
    assert np.allclose(S[0], Vs[0] @ Vs[0].T, rtol=1e-5, atol=0)
    assert np.allclose(S[1, :3, :3], Vs[1] @ Vs[1].T, rtol=1e-5, atol=0)
    assert np.all(S[1, 3:, :] == 0.0)


def test_gemm_route_defaults_to_host_blas(monkeypatch):
    """The pooled cosine GEMM takes the host f64 BLAS unless
    OTTER_TPU_GENOTYPE_DEVICE=1, whatever the device (the JAX package's
    choice off a TPU; the card's f32 route ties or loses on an H100)."""
    monkeypatch.delenv("OTTER_TPU_GENOTYPE_DEVICE", raising=False)
    assert not port_genotype._use_device_gemm()
    monkeypatch.setenv("OTTER_TPU_GENOTYPE_DEVICE", "0")
    assert not port_genotype._use_device_gemm()
    monkeypatch.setenv("OTTER_TPU_GENOTYPE_DEVICE", "1")
    assert port_genotype._use_device_gemm()


def test_genotype_cuda_without_card_raises(cohort):
    """--device cuda raises without a card, though the default GEMM route
    never touches it."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        _port(*cohort, device="cuda")


@pytest.mark.parametrize("device", ["tpu", "auto"])
def test_genotype_unknown_device_raises(cohort, device):
    """A device the port refuses (the JAX package's tpu and auto) raises."""
    with pytest.raises(ValueError):
        _port(*cohort, device=device)
