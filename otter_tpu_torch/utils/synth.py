"""Seeded synthetic tandem-repeat loci: an indexed BAM of noisy long reads
and the BED of their regions, written with the package's own BAM writer.

Each locus carries two alleles, the reference's and one expanded by a CAG
run; every read walks the left flank, an allele and the right flank with
substitutions, insertions and deletions at rate ``err`` (0.4 / 0.3 / 0.3)
and a CIGAR that projects the allele back onto the region. Optionally a
share of the reads ends inside the allele (non-spanning reads) and some
reads carry N bases in the allele. With neither option the data equal
``bench_e2e.build_ont_fixture``'s for the same arguments.
"""

from __future__ import annotations

import os
import random
from typing import List, Tuple

import numpy as np

from ..io.bai import index_bam
from ..io.bam import (BAM_CDEL, BAM_CINS, BAM_CMATCH, BamRecord, BamWriter,
                      encode_aux)

_NT = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE = np.zeros(256, dtype=np.uint8)
_CODE[_NT] = np.arange(4, dtype=np.uint8)


def noisy_walk(piece: str, err: float, nprng: np.random.Generator,
               out: List[str], cig: List[Tuple[int, int]]) -> int:
    """Append ``piece`` read with errors to ``out`` and its run-length
    merged CIGAR to ``cig``; returns the reference chars consumed."""
    L = len(piece)
    if L == 0:
        return 0
    u = nprng.random(L)
    cat = np.where(u < err * 0.4, 1,
                   np.where(u < err * 0.7, 2, np.where(u < err, 3, 0)))
    codes = _CODE[np.frombuffer(piece.encode(), np.uint8)]
    n_chars = np.where(cat == 3, 0, np.where(cat == 2, 2, 1))
    starts_c = np.zeros(L, dtype=np.int64)
    np.cumsum(n_chars[:-1], out=starts_c[1:])
    chars = np.zeros(int(n_chars.sum()), dtype=np.uint8)
    keep = cat != 3
    newb = np.where(cat == 1, (codes + nprng.integers(1, 4, L)) % 4, codes)
    chars[starts_c[keep]] = _NT[newb[keep]]
    ins = cat == 2
    if ins.any():
        chars[starts_c[ins] + 1] = _NT[nprng.integers(0, 4, int(ins.sum()))]
    out.append(chars.tobytes().decode("latin-1"))
    n_ops = np.where(cat == 2, 2, 1)
    starts_o = np.zeros(L, dtype=np.int64)
    np.cumsum(n_ops[:-1], out=starts_o[1:])
    ops = np.zeros(int(n_ops.sum()), dtype=np.uint8)
    ops[starts_o] = np.where(cat == 3, BAM_CDEL, BAM_CMATCH)
    if ins.any():
        ops[starts_o[ins] + 1] = BAM_CINS
    bounds = np.nonzero(np.diff(ops))[0] + 1
    seg_start = np.concatenate([[0], bounds])
    seg_end = np.concatenate([bounds, [len(ops)]])
    for s0, s1 in zip(seg_start.tolist(), seg_end.tolist()):
        op = int(ops[s0])
        ln = s1 - s0
        if cig and cig[-1][1] == op:
            cig[-1] = (cig[-1][0] + ln, op)
        else:
            cig.append((ln, op))
    return L


def _project(cig: List[Tuple[int, int]], consumed: int,
             region_len: int) -> List[Tuple[int, int]]:
    """Rebalance the allele's reference consumption to the region length:
    the excess becomes a trailing insertion run, a shortfall a deletion."""
    extra = consumed - region_len
    if extra > 0:
        trimmed = []
        for ln, op in reversed(cig):
            if extra > 0 and op == BAM_CMATCH:
                take = min(ln, extra)
                extra -= take
                trimmed.append((take, BAM_CINS))
                if take < ln:
                    trimmed.append((ln - take, op))
            else:
                trimmed.append((ln, op))
        return list(reversed(trimmed))
    if extra < 0:
        cig.append((-extra, BAM_CDEL))
    return cig


def read_record(name: str, pos: int, seq: str,
                cigar: List[Tuple[int, int]]) -> BamRecord:
    rec = BamRecord()
    rec.name = name
    rec.flag = 0
    rec.ref_id = 0
    rec.pos = pos
    rec.mapq = 60
    rec.cigar = cigar
    rec.seq = seq
    rec.qual = b"\x28" * len(seq)
    rec.aux = bytes(encode_aux("rq", "f", 0.99))
    return rec


def write_bam(path: str, ref_len: int, records: List[BamRecord]) -> None:
    """Coordinate-sorted BAM over one contig ``chr1``, and its BAI."""
    header = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:{ref_len}\n"
    with BamWriter(path, header, [("chr1", ref_len)]) as w:
        for rec in sorted(records, key=lambda r: r.pos):
            w.write(rec)
    index_bam(path)


def tandem_repeat_loci(tmp: str, n_regions: int, cov: int, err: float,
                       expansion: int, region_len: int, seed: int,
                       name: str, flank_lo: int = 300, flank_hi: int = 500,
                       partial: float = 0.0, n_bases: int = 0
                       ) -> Tuple[str, str]:
    """Write ``{name}_reads.bam`` and ``{name}_regions.bed`` under ``tmp``
    and return their paths: ``n_regions`` loci, ``cov`` reads each (half per
    allele). ``partial`` is the share of reads that end inside their allele;
    ``n_bases`` reads per locus get three N bases inside the allele."""
    rng = random.Random(seed)
    nprng = np.random.Generator(np.random.PCG64(seed * 7919 + 13))
    span = region_len + 2 * flank_hi + 2 * max(1000, region_len // 2)
    ref_len = 1000 + n_regions * span + 2000
    ref = "".join(rng.choice("ACGT") for _ in range(ref_len))
    records: List[BamRecord] = []
    bed = os.path.join(tmp, f"{name}_regions.bed")
    with open(bed, "w") as fh:
        for r in range(n_regions):
            start = 1000 + r * span
            end = start + region_len
            fh.write(f"chr1\t{start}\t{end}\n")
            with_n = 0
            for allele in (ref[start:end],
                           ref[start:end] + "CAG" * expansion):
                for _c in range(cov // 2):
                    lf = rng.randint(flank_lo, flank_hi)
                    rf = rng.randint(flank_lo, flank_hi)
                    out: List[str] = []
                    cig: List[Tuple[int, int]] = []
                    noisy_walk(ref[start - lf : start], err, nprng, out, cig)
                    spanning = not (partial > 0 and rng.random() < partial)
                    if spanning:
                        consumed = noisy_walk(allele, err, nprng, out, cig)
                        cig = _project(cig, consumed, region_len)
                    else:
                        cut = rng.randint(200, len(allele) - 200)
                        noisy_walk(allele[:cut], err, nprng, out, cig)
                    if with_n < n_bases:  # substitutions: the CIGAR holds
                        chars = list(out[1])
                        for i in rng.sample(range(len(chars)), 3):
                            chars[i] = "N"
                        out[1] = "".join(chars)
                        with_n += 1
                    if spanning:
                        noisy_walk(ref[end : end + rf], err, nprng, out, cig)
                    records.append(read_record(
                        f"o{r}_{len(records)}", start - lf, "".join(out),
                        cig))
    bam = os.path.join(tmp, f"{name}_reads.bam")
    write_bam(bam, ref_len, records)
    return bam, bed
