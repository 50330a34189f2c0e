"""Seeded synthetic inputs, written with the package's own BAM writer and
BAI indexer: tandem-repeat loci (an indexed BAM of noisy long reads and the
BED of their regions) and a merged genotyping cohort.

Each locus carries two alleles, the reference's and one expanded by a CAG
run; every read walks the left flank, an allele and the right flank with
substitutions, insertions and deletions at rate ``err`` (0.4 / 0.3 / 0.3)
and a CIGAR that projects the allele back onto the region. Optionally a
share of the reads ends inside the allele (non-spanning reads) and some
reads carry N bases in the allele. With neither option the data equal
``bench_e2e.build_ont_fixture``'s for the same arguments.

``cohort_fixture`` writes ``bench_e2e.build_cohort_fixture``'s merged
cohort BAM, BED and reference FASTA, byte for byte, and ``region_fixture``
``bench_e2e.build_fixture``'s short tandem-repeat regions (the JAX
package's regions bench leg and multichip dry run). ``poa_shaped_graph``
gives the edges of a seeded graph shaped like a POA graph.
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


def _primes(lo: int, hi: int) -> List[int]:
    """The primes in [lo, hi)."""
    sieve = np.ones(hi, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(hi ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    return [int(p) for p in np.flatnonzero(sieve) if p >= lo]


def cohort_fixture(tmp: str, n_samples: int = 64, n_regions: int = 32,
                   seed: int = 5, vntr: bool = False,
                   prime_lengths: bool = False) -> Tuple[str, str, str]:
    """A merged otter cohort BAM (one allele record per sample haplotype,
    with its ta/RG/tc/ac/sc/se/ic tags and one @RG line per sample), its BED
    and the reference FASTA under ``tmp``: the joint-genotyping input of
    genotype.cpp:173-192. Odd samples are het for a CAG expansion of 10-29
    units of a 120 bp region, even ones hom-ref; each allele carries 0-2
    substitutions. ``vntr``: instead, every haplotype carries its own
    random insert of 1-2,999 bp (a locus with as many allele lengths as
    haplotypes, so its length distances are nearly all distinct).
    ``prime_lengths`` (with ``vntr``): the haplotypes of a region take
    distinct prime lengths below 3,120, so its length distances |x - y| /
    max(x, y) are all distinct, in float32 too (two distinct fractions with
    denominators below 3,120 differ by more than 1 / 3120^2, over a
    float32 ulp below 1); at most 207 samples. Returns (bam, bed,
    fasta)."""
    rng = random.Random(seed)
    span = 2500
    ref_len = 1000 + n_regions * span + 2000
    ref = "".join(rng.choice("ACGT") for _ in range(ref_len))
    bed = os.path.join(tmp, "cohort_regions.bed")
    records: List[BamRecord] = []
    with open(bed, "w") as fh:
        for r in range(n_regions):
            start = 1000 + r * span
            end = start + 120
            fh.write(f"chr1\t{start}\t{end}\n")
            region = f"chr1:{start}-{end}"
            base = ref[start:end]
            exp = base + "CAG" * rng.randrange(10, 30)
            if prime_lengths:
                lengths = rng.sample(_primes(len(base) + 2, 3120),
                                     2 * n_samples)
            for s in range(n_samples):
                if prime_lengths:
                    haps = tuple(base + "".join(
                        rng.choice("ACGT") for _ in range(L - len(base)))
                        for L in lengths[2 * s : 2 * s + 2])
                elif vntr:
                    haps = tuple(base + "".join(rng.choice("ACGT") for _ in
                                                range(rng.randrange(1, 3000)))
                                 for _ in range(2))
                else:
                    haps = (base, exp) if s % 2 else (base, base)
                for hap, seq in enumerate(haps):
                    sv = list(seq)
                    for _ in range(rng.randrange(0, 3)):
                        p = rng.randrange(len(sv))
                        sv[p] = rng.choice("ACGT")
                    rec = read_record(f"a{r}_{s}_{hap}", start, "".join(sv),
                                      [(len(sv), BAM_CMATCH)])
                    rec.aux = b"".join(bytes(encode_aux(*t)) for t in (
                        ("ta", "Z", region), ("RG", "Z", f"S{s}"),
                        ("tc", "i", 20), ("ac", "i", 10), ("sc", "i", 8),
                        ("se", "f", 0.01), ("ic", "i", 1)))
                    records.append(rec)
    bam = os.path.join(tmp, "cohort64.bam")
    header = "\n".join(
        ["@HD\tVN:1.6\tSO:coordinate", f"@SQ\tSN:chr1\tLN:{ref_len}",
         "@PG\tID:otter\tOF:1,0"]
        + [f"@RG\tID:S{s}" for s in range(n_samples)]) + "\n"
    with BamWriter(bam, header, [("chr1", ref_len)]) as w:
        for rec in sorted(records, key=lambda x: (x.ref_id, x.pos)):
            w.write(rec)
    index_bam(bam)
    fa = os.path.join(tmp, "cohort_ref.fa")
    with open(fa, "w") as fh:
        fh.write(">chr1\n")
        for i in range(0, len(ref), 60):
            fh.write(ref[i : i + 60] + "\n")
    return bam, bed, fa


def _mutated(rng: random.Random, s: str, rate: float) -> str:
    """``s`` with substitutions, insertions and deletions at total rate
    ``rate`` (0.4 / 0.3 / 0.3)."""
    out = []
    for ch in s:
        x = rng.random()
        if x < rate * 0.4:
            out.append(rng.choice([b for b in "ACGT" if b != ch]))
        elif x < rate * 0.7:
            out += [ch, rng.choice("ACGT")]
        elif x >= rate:
            out.append(ch)
    return "".join(out)


def compare_fixture(tmp: str, n_regions: int, seed: int, lo: int = 300,
                    hi: int = 2500) -> Tuple[str, str, str]:
    """A truth and a query otter BAM (two assembled alleles a region, sample
    T1 and Q1) and their BED under ``tmp``, the input of ``compare``: each
    region's truth alleles are a random sequence of ``lo``-``hi`` bp and a
    copy with 2% error and a CAG run; the query's are copies of those at
    0.5% error. Every fourth region's second query allele carries an N base,
    every seventh truth allele is "N" (compare.cpp's special case). Returns
    (truth_bam, query_bam, bed)."""
    from ..io.bam import parse_sam_to_bam

    rng = random.Random(seed)
    ref_len = 2000 + 200 * n_regions
    sams = {}
    rows = {"T1": [], "Q1": []}
    bed = os.path.join(tmp, "compare_regions.bed")
    with open(bed, "w") as fh:
        for r in range(n_regions):
            start = 100 + 200 * r
            region = f"{start}-{start + 60}"
            fh.write(f"chr1\t{start}\t{start + 60}\n")
            base = "".join(rng.choice("ACGT")
                           for _ in range(rng.randint(lo, hi)))
            alt = _mutated(rng, base, 0.02) + "CAG" * rng.randint(3, 30)
            truth = [base, "N" if r % 7 == 6 else alt]
            query = [_mutated(rng, base, 0.005), _mutated(rng, alt, 0.005)]
            if r % 4 == 3:
                q = list(query[1])
                q[rng.randrange(len(q))] = "N"
                query[1] = "".join(q)
            for sample, alleles in (("T1", truth), ("Q1", query)):
                for i, seq in enumerate(alleles):
                    rows[sample].append(
                        f"chr1:{region}_{i}\t0\tchr1\t{start + 1}\t0\t"
                        f"{len(seq)}M\t*\t0\t0\t{seq}\t{'!' * len(seq)}\t"
                        f"RG:Z:{sample}\tta:Z:chr1:{region}\ttc:i:10\t"
                        f"ac:i:5\tsc:i:5\tsp:A:b\tic:i:2\tse:f:0")
    for sample, name in (("T1", "truth"), ("Q1", "query")):
        path = os.path.join(tmp, f"compare_{name}.bam")
        parse_sam_to_bam("\n".join(
            [f"@SQ\tSN:chr1\tLN:{ref_len}", f"@RG\tID:{sample}",
             "@PG\tID:otter\tOF:1,0"] + rows[sample]) + "\n", path)
        index_bam(path)
        sams[sample] = path
    return sams["T1"], sams["Q1"], bed


def region_fixture(tmp: str, n_regions: int = 100, cov: int = 12,
                   err: float = 0.01, region_len: int = 120, seed: int = 11
                   ) -> Tuple[str, str, str]:
    """``reads.bam`` (indexed), ``regions.bed`` and ``ref.fa`` under
    ``tmp``, byte for byte ``bench_e2e.build_fixture``'s: regions of
    ``region_len`` bp 2,500 bp apart; even regions het for a CAG run of
    region_len / 6 + 20 units (cov / 2 + 2 reads an allele), odd ones hom-ref
    (cov reads); every read walks 200-400 bp flanks and its allele at error
    rate ``err``, with an rq tag of 0.999. Returns (bam, bed, fasta)."""
    rng = random.Random(seed)
    nprng = np.random.Generator(np.random.PCG64(seed * 104729 + 7))
    span = 2500
    ref_len = 1000 + n_regions * span + 2000
    ref = _NT[nprng.integers(0, 4, ref_len)].tobytes().decode("latin-1")
    bed = os.path.join(tmp, "regions.bed")
    records: List[BamRecord] = []
    with open(bed, "w") as fh:
        for r in range(n_regions):
            start = 1000 + r * span
            end = start + region_len
            fh.write(f"chr1\t{start}\t{end}\n")
            alleles = [ref[start:end]]
            if r % 2 == 0:
                alleles.append("CAG" * (region_len // 2 // 3 + 20))
            for a_i, allele in enumerate(alleles):
                n_reads = cov if len(alleles) == 1 else cov // 2 + 2
                for c in range(n_reads):
                    lf = rng.randint(200, 400)
                    rf = rng.randint(200, 400)
                    out: List[str] = []
                    cig: List[Tuple[int, int]] = []
                    noisy_walk(ref[start - lf : start], err, nprng, out, cig)
                    consumed = noisy_walk(allele, err, nprng, out, cig)
                    if consumed > region_len:
                        cig = _project(cig, consumed, region_len)
                    elif consumed < region_len:
                        if cig and cig[-1][1] == BAM_CDEL:
                            cig[-1] = (cig[-1][0] + region_len - consumed,
                                       BAM_CDEL)
                        else:
                            cig.append((region_len - consumed, BAM_CDEL))
                    noisy_walk(ref[end : end + rf], err, nprng, out, cig)
                    rec = read_record(f"r{r}_{a_i}_{c}", start - lf,
                                      "".join(out), cig)
                    rec.aux = bytes(encode_aux("rq", "f", 0.999))
                    records.append(rec)
    bam = os.path.join(tmp, "reads.bam")
    write_bam(bam, ref_len, records)
    fa = os.path.join(tmp, "ref.fa")
    with open(fa, "w") as fh:
        fh.write(">chr1\n")
        for i in range(0, len(ref), 60):
            fh.write(ref[i : i + 60] + "\n")
    return bam, bed, fa


def poa_shaped_graph(rs, backbone: int, snps: int, insertions: int,
                     deletions: int):
    """(src, sink, w, depth) of a seeded graph shaped like a POA graph: a
    backbone chain, SNP nodes beside it, inserted nodes on it (the backbone
    edge kept), deletions (an edge over a backbone node); node ids in a
    topological order, edges by source, weights counts x 0.37 in float32,
    depth each node's Kahn level."""
    at = np.arange(1, backbone - 1)
    snp = np.zeros(backbone, dtype=np.int64)
    ins = np.zeros(backbone, dtype=np.int64)
    snp[rs.choice(at, snps, replace=False)] = 1
    ins[rs.choice(at, insertions, replace=False)] = 1
    dels = np.sort(rs.choice(at, deletions, replace=False))
    extra = snp + ins
    bid = np.arange(backbone) + np.concatenate([[0], np.cumsum(extra)[:-1]])
    b = np.nonzero(snp)[0]
    c = np.nonzero(ins)[0]
    src = np.concatenate([bid[:-1], bid[b - 1], bid[b] + 1, bid[c],
                          bid[c] + 1 + snp[c], bid[dels - 1]])
    sink = np.concatenate([bid[1:], bid[b] + 1, bid[b + 1], bid[c] + 1 +
                           snp[c], bid[c + 1], bid[dels + 1]])
    order = np.argsort(src, kind="stable")
    src, sink = src[order], sink[order]
    n = int(bid[-1]) + 1
    depth = np.zeros(n, dtype=np.int64)
    for u, v in zip(src.tolist(), sink.tolist()):  # sources ascend
        depth[v] = max(depth[v], depth[u] + 1)
    w = (rs.integers(1, 100, len(src)) * np.float32(0.37)).astype(np.float32)
    return src, sink, w, depth
