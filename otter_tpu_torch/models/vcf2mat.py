"""``otter vcf2mat`` (hidden) on the PyTorch port (parity with
src/vcf2mat.cpp); counterpart of ``otter_tpu/models/vcf2mat.py``, host code.

VCF -> per-allele feature matrix TSV: region, allele index, GC content,
length, Hill-Shannon diversity, and the k-mer usage vector
(vcf2mat.cpp:38-73). ``<DEL>`` maps back to "N" (:32).
"""

from __future__ import annotations

import sys
from typing import List, Optional, TextIO, Tuple

from ..config import OtterOpts
from ..io.bed import parse_bed_file
from ..io.gzip_iter import iter_lines
from ..seqs.kmer import Kusage, _NT2CODE, seq2kcounts
from ..utils.fmt import fmt_double


def parse_alleles(line: str) -> Tuple[str, List[str]]:
    """(vcf2mat.cpp:23-36)"""
    region = ""
    alleles: List[str] = []
    for index, column in enumerate(line.split("\t")):
        if index == 2:
            region = column
        elif index == 3:
            alleles.append(column)
        elif index == 4 and column != ".":
            if column == "<DEL>":
                alleles.append("N")
            else:
                alleles.extend(column.split(","))
    return region, alleles


def get_gc_content(seq: str) -> float:
    """(vcf2mat.cpp:38-46)"""
    gc = 0.0
    for nt in seq:
        e = _NT2CODE[ord(nt)]
        if e == 1 or e == 2:
            gc += 1
    return gc / len(seq)


def vcf2mat(params: OtterOpts, bed: str, vcf: str, k_l: int,
            out: Optional[TextIO] = None) -> None:
    """(vcf2mat.cpp:48-77)"""
    if out is None:
        out = sys.stdout
    parse_bed_file(bed)  # loaded for parity (regions unused downstream)
    for line in iter_lines(vcf):
        if not line or line[0] == "#":
            continue
        region, alleles = parse_alleles(line)
        for i, allele in enumerate(alleles):
            kcounts = seq2kcounts(k_l, allele)
            kusage = Kusage(kcounts)
            parts = [
                f"{region}\t{i}\t{fmt_double(get_gc_content(allele))}\t"
                f"{len(allele)}\t{fmt_double(kusage.hsdiv())}"
            ]
            for ku in kusage.vec:
                parts.append("\t" + fmt_double(ku))
            out.write("".join(parts) + "\n")
