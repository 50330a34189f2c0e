"""What the traffic generators share: the fixture they hand the harness,
seeded draws, fixed quantiles, repeat alleles and the read walk.

A fixture is one or more samples' BAMs over one BED and one reference
FASTA. Every size comes from fixed quantiles of its range, so every seed
gives the same set of sizes; the seed picks the order, the bases, the
read ends and the sequencing errors.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..fixtures.bam import (BAM_CDEL, BAM_CINS, BAM_CSOFT_CLIP, BamRecord)
from ..fixtures.synth import (read_record, walk_template, write_bam,
                              write_fasta)

CHROM = "chr1"
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class Sample:
    name: str
    bam: str
    alleles: List[Tuple[str, str]]     # a locus's haplotype 0 and 1
    reads: int
    bases: int


@dataclass
class Fixture:
    bed: str
    fasta: str
    loci: List[Tuple[int, int]]        # reference [start, end) of each locus
    samples: List[Sample]

    def regions(self) -> List[Tuple[str, int, int]]:
        return [(CHROM, s, e) for s, e in self.loci]

    @property
    def reads(self) -> int:
        return sum(s.reads for s in self.samples)

    @property
    def bases(self) -> int:
        return sum(s.bases for s in self.samples)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), stream])


def quantiles(lo: float, hi: float, count: int,
              spread: str = "uniform") -> List[float]:
    """``count`` values at the mid-quantiles of [lo, hi], uniform or
    log-uniform."""
    qs = [(i + 0.5) / count for i in range(count)]
    if spread == "log_uniform":
        return [math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
                for q in qs]
    if spread == "uniform":
        return [lo + q * (hi - lo) for q in qs]
    raise ValueError(f"unknown spread {spread!r}")


def bases(r: np.random.Generator, n: int) -> str:
    return _ACGT[r.integers(0, 4, n)].tobytes().decode()


def repeat(r: np.random.Generator, motif: str, length: int,
           impurity: float) -> str:
    """``motif`` repeated to ``length`` bases, a share ``impurity`` of them
    substituted."""
    s = np.frombuffer((motif * (length // len(motif) + 1))[:length].encode(),
                      dtype=np.uint8).copy()
    hit = r.random(length) < impurity
    s[hit] = _ACGT[(np.searchsorted(_ACGT, s[hit])
                    + r.integers(1, 4, int(hit.sum()))) % 4]
    return s.tobytes().decode()


def tidy_cigar(pos: int, cigar: List[Tuple[int, int]]):
    """A read's (pos, CIGAR) as an aligner reports it: an insertion at
    either end soft-clipped, a deletion at either end dropped (the start
    moved past a leading one)."""
    cigar = list(cigar)
    while cigar and cigar[0][1] == BAM_CDEL:
        pos += cigar.pop(0)[0]
    while cigar and cigar[-1][1] == BAM_CDEL:
        cigar.pop()
    if cigar and cigar[0][1] == BAM_CINS:
        cigar[0] = (cigar[0][0], BAM_CSOFT_CLIP)
    if cigar and cigar[-1][1] == BAM_CINS:
        cigar[-1] = (cigar[-1][0], BAM_CSOFT_CLIP)
    return pos, cigar


class Haplotype:
    """One haplotype of a contig: the reference with each locus replaced
    by its allele, and the walk of a read over it back onto the
    reference."""

    def __init__(self, ref: str, loci: Sequence[Tuple[int, int]],
                 alleles: Sequence[str]):
        parts, self.pieces = [], []     # (ref start, ref end, hap start, allele?)
        at = hat = 0
        for (s, e), allele in zip(loci, alleles):
            parts += [ref[at:s], allele]
            self.pieces.append((at, s, hat, False))
            hat += s - at
            self.pieces.append((s, e, hat, True))
            hat += len(allele)
            at = e
        parts.append(ref[at:])
        self.pieces.append((at, len(ref), hat, False))
        self.seq = "".join(parts)
        self.hap_starts = np.array([p[2] for p in self.pieces])

    def read(self, name: str, a: int, b: int, err: float,
             nprng: np.random.Generator) -> BamRecord:
        """The read of haplotype bases [a, b) with errors at rate ``err``,
        placed on the reference. A locus the read covers in whole consumes
        the locus's reference length; one it enters or leaves consumes as
        much of it as the read holds of the allele, at most the whole."""
        stretches, pos = [], None
        i = int(np.searchsorted(self.hap_starts, a, side="right")) - 1
        while i < len(self.pieces):
            rs, re_, hs, is_locus = self.pieces[i]
            hlen = (self.pieces[i + 1][2] if i + 1 < len(self.pieces)
                    else len(self.seq)) - hs
            if hs >= b:
                break
            lo, hi = max(a, hs), min(b, hs + hlen)
            if not is_locus:
                if pos is None:
                    pos = rs + (lo - hs)
            else:
                used = min(hi - lo, re_ - rs)
                if pos is None:
                    pos = re_ - used if hi == hs + hlen else rs
                stretches.append((lo - a, hi - a, used))
            i += 1
        seq, cigar = walk_template(self.seq[a:b], stretches, err, nprng)
        pos, cigar = tidy_cigar(pos, cigar)
        return read_record(name, pos, seq, cigar)


def write_outputs(tmpdir: str, ref: str, loci, samples_reads, names,
                  alleles) -> Fixture:
    """``ref.fa``, ``loci.bed`` and one indexed BAM a sample under
    ``tmpdir``."""
    fasta = os.path.join(tmpdir, "ref.fa")
    write_fasta(fasta, [(CHROM, ref)])
    bed = os.path.join(tmpdir, "loci.bed")
    with open(bed, "w") as fh:
        for s, e in loci:
            fh.write(f"{CHROM}\t{s}\t{e}\n")
    samples = []
    for k, (name, records, al) in enumerate(zip(names, samples_reads,
                                                alleles)):
        records.sort(key=lambda rec: rec.pos)
        bam = os.path.join(tmpdir, f"sample{k}.bam")
        write_bam(bam, [(CHROM, len(ref))], records)
        samples.append(Sample(name, bam, al, len(records),
                              sum(len(r.seq) for r in records)))
    return Fixture(bed, fasta, list(loci), samples)
