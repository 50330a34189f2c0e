"""The whole otter workflow on synthetic data, on the card:

    python -m otter_tpu_torch.demo [OUTDIR]

the counterpart of the JAX package's ``examples/demo.py``, with the same
seeded inputs: a reference FASTA with a CAG repeat and three samples of
simulated HiFi-like reads over it (hom-ref, het and hom-alt for a 30-unit
allele, indexed BAMs from the package's own writers), then

  assemble (each sample, SAM)  ->  merge (a BAM without samtools)
  -> genotype (joint VCF)      ->  vcf2mat (feature matrix)
  -> wgat on a simulated assembly  ->  compare (S2 against it, TSV)

with every output under OUTDIR (default ``demo_out``). ``assemble``,
``genotype`` and ``compare`` run on ``cuda``; without a card the demo
raises before its first step.
"""

from __future__ import annotations

import io
import os
import random
import sys


def main(outdir: str = "demo_out", device: str = "cuda") -> dict:
    """Runs the six steps into ``outdir`` on ``device`` and returns each
    step's text output by name (sample SAMs, ``vcf``, ``vcf2mat``,
    ``wgat``, ``compare``)."""
    from .bench.e2e import merge_sams
    from .config import OtterOpts
    from .io.bai import index_bam
    from .io.bam import BAM_CINS, BAM_CMATCH, parse_sam_to_bam
    from .models.assemble import assemble
    from .models.compare import compare
    from .models.genotype import genotype
    from .models.vcf2mat import vcf2mat
    from .models.wgat import wgat
    from .utils.synth import (make_bam, make_reference, read_record,
                              simulate_region_bam, write_fasta)

    if device == "cuda":
        from .bench.e2e import card_line

        print(f"[demo] card: {card_line()}")
    os.makedirs(outdir, exist_ok=True)

    def opts(read_group: str = "") -> OtterOpts:
        params = OtterOpts()
        params.device = device
        if read_group:
            params.read_group = read_group
        return params

    rng = random.Random(42)
    ref = make_reference(rng, length=6000, repeat="CAG", repeat_at=3000,
                         repeat_units=20)
    start, end = 3000, 3060
    fa = os.path.join(outdir, "ref.fa")
    write_fasta(fa, [("chr1", ref)])
    bed = os.path.join(outdir, "regions.bed")
    with open(bed, "w") as fh:
        fh.write(f"chr1\t{start}\t{end}\n")
    ref_allele = ref[start:end]
    alt_allele = "CAG" * 30
    genotypes = {"S1": [ref_allele, ref_allele],
                 "S2": [ref_allele, alt_allele],
                 "S3": [alt_allele, alt_allele]}
    texts = {}
    for i, (sample, alleles) in enumerate(genotypes.items()):
        bam = os.path.join(outdir, f"{sample}.reads.bam")
        simulate_region_bam(bam, "chr1", ref, (start, end), alleles,
                            per_allele_cov=12, error_rate=0.005, seed=7 + i)
        out = io.StringIO()
        assemble(bam, bed, fa, False, opts(sample), out=out)
        texts[sample] = out.getvalue()
        with open(os.path.join(outdir, f"{sample}.otter.sam"), "w") as fh:
            fh.write(texts[sample])
        print(f"[demo] assembled {sample}")

    merged = os.path.join(outdir, "cohort.bam")
    merge_sams(list(texts.values()), merged)
    print("[demo] merged cohort BAM")

    out = io.StringIO()
    genotype(opts(), merged, bed, fa, out=out)
    texts["vcf"] = out.getvalue()
    vcf = os.path.join(outdir, "cohort.vcf")
    with open(vcf, "w") as fh:
        fh.write(texts["vcf"])
    print("[demo] joint VCF:")
    for line in texts["vcf"].rstrip("\n").split("\n"):
        if not line.startswith("##"):
            print("   ", line[:110])

    out = io.StringIO()
    vcf2mat(opts(), bed, vcf, 3, out=out)
    texts["vcf2mat"] = out.getvalue()
    with open(os.path.join(outdir, "features.tsv"), "w") as fh:
        fh.write(texts["vcf2mat"])
    print(f"[demo] vcf2mat -> {len(texts['vcf2mat'].splitlines())} "
          "feature rows")

    # a simulated whole-genome assembly carrying the alt allele -> wgat
    asm_seq = ref[:start] + alt_allele + ref[end:]
    cig = [(start, BAM_CMATCH), (end - start, BAM_CMATCH)]
    if len(alt_allele) > end - start:
        cig.append((len(alt_allele) - (end - start), BAM_CINS))
    cig.append((len(ref) - end, BAM_CMATCH))
    asm_bam = os.path.join(outdir, "assembly.bam")
    make_bam(asm_bam, [("chr1", len(ref))],
             [read_record("contig_1", 0, asm_seq, cig, ())])
    params = opts("ASM")
    out = io.StringIO()
    wgat(params, asm_bam, bed, out=out)
    texts["wgat"] = out.getvalue()
    with open(os.path.join(outdir, "assembly.otter.sam"), "w") as fh:
        fh.write(texts["wgat"])
    print("[demo] wgat emitted", sum(
        1 for l in texts["wgat"].splitlines() if not l.startswith("@")),
        "alleles")

    # compare S2's alleles against the wgat truth
    truth_bam = os.path.join(outdir, "assembly.otter.bam")
    parse_sam_to_bam(texts["wgat"], truth_bam)
    index_bam(truth_bam)
    s2_bam = os.path.join(outdir, "S2.otter.bam")
    parse_sam_to_bam(texts["S2"], s2_bam)
    index_bam(s2_bam)
    out = io.StringIO()
    compare(params, bed, truth_bam, s2_bam, out=out)
    texts["compare"] = out.getvalue()
    print("[demo] compare TSV:")
    for line in texts["compare"].rstrip("\n").split("\n"):
        print("   ", line)
    print(f"[demo] all outputs in {outdir}/")
    return texts


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "demo_out")
