"""Seeded read walkers for the benchmark's fixtures.

``read_record`` is a frozen copy of ``otter_tpu_torch/utils/synth.py``
at commit eda140f, and ``walk_template`` that file's ``noisy_walk`` and
``_project`` over a whole read at once; ``write_bam`` is its
``make_bam`` without the header options, writing records in the order
given (the generator emits them sorted) and indexing the BAM.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .bai import index_bam
from .bam import (BAM_CDEL, BAM_CINS, BAM_CMATCH, BamRecord, BamWriter,
                  encode_aux)

_NT = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE = np.zeros(256, dtype=np.uint8)
_CODE[_NT] = np.arange(4, dtype=np.uint8)


def walk_template(template: str, alleles: Sequence[Tuple[int, int, int]],
                  err: float, nprng: np.random.Generator):
    """A read of ``template`` with errors at rate ``err`` (substitutions
    0.4, insertions 0.3, deletions 0.3 of them) and its run-length CIGAR
    against the reference, in one pass over the whole template.
    ``alleles`` are the template's (begin, end, region length) stretches
    that stand for a reference locus: each one's reference consumption is
    rebalanced to the locus length, the excess made an insertion from its
    last matches back, a shortfall a deletion at its end (``_project`` of
    ``otter_tpu_torch/utils/synth.py``). The error model is that file's
    ``noisy_walk``, drawn for the whole template at once."""
    L = len(template)
    u = nprng.random(L)
    cat = np.where(u < err * 0.4, 1,
                   np.where(u < err * 0.7, 2, np.where(u < err, 3, 0)))
    codes = _CODE[np.frombuffer(template.encode(), np.uint8)]
    n_chars = np.where(cat == 3, 0, np.where(cat == 2, 2, 1))
    starts_c = np.zeros(L, dtype=np.int64)
    np.cumsum(n_chars[:-1], out=starts_c[1:])
    chars = np.zeros(int(n_chars.sum()), dtype=np.uint8)
    keep = cat != 3
    newb = np.where(cat == 1, (codes + nprng.integers(1, 4, L)) % 4, codes)
    chars[starts_c[keep]] = _NT[newb[keep]]
    ins = cat == 2
    chars[starts_c[ins] + 1] = _NT[nprng.integers(0, 4, int(ins.sum()))]
    n_ops = np.where(ins, 2, 1)
    starts_o = np.zeros(L + 1, dtype=np.int64)
    np.cumsum(n_ops, out=starts_o[1:])
    ops = np.zeros(int(starts_o[-1]), dtype=np.uint8)
    ops[starts_o[:-1]] = np.where(cat == 3, BAM_CDEL, BAM_CMATCH)
    ops[starts_o[:-1][ins] + 1] = BAM_CINS
    gaps = []
    for t0, t1, region_len in alleles:
        o0, o1 = int(starts_o[t0]), int(starts_o[t1])
        extra = (t1 - t0) - region_len
        if extra > 0:
            m_at = np.flatnonzero(ops[o0:o1] == BAM_CMATCH) + o0
            ops[m_at[-extra:]] = BAM_CINS
        elif extra < 0:
            gaps.append((o1, -extra))
    if gaps:
        ops = np.insert(ops, np.repeat([g[0] for g in gaps],
                                       [g[1] for g in gaps]), BAM_CDEL)
    bounds = np.flatnonzero(np.diff(ops)) + 1
    seg_start = np.concatenate([[0], bounds])
    seg_len = np.diff(np.concatenate([seg_start, [len(ops)]]))
    cigar = list(zip(seg_len.tolist(), ops[seg_start].tolist()))
    return chars.tobytes().decode("latin-1"), cigar


def read_record(name: str, pos: int, seq: str,
                cigar: List[Tuple[int, int]],
                tags: Sequence[Tuple[str, str, object]] = (("rq", "f", 0.99),)
                ) -> BamRecord:
    """A mapped forward read on contig 0 with mapq 60, quality 40 a base
    and the aux ``tags`` (an rq of 0.99 unless given)."""
    rec = BamRecord()
    rec.name = name
    rec.flag = 0
    rec.ref_id = 0
    rec.pos = pos
    rec.mapq = 60
    rec.cigar = cigar
    rec.seq = seq
    rec.qual = b"\x28" * len(seq)
    rec.aux = b"".join(bytes(encode_aux(*t)) for t in tags)
    return rec


def write_bam(path: str, refs: List[Tuple[str, int]],
              records: List[BamRecord]) -> None:
    """Coordinate-sorted BAM of ``records`` (sorted by the caller) over the
    contigs ``refs`` ((name, length)), and its BAI."""
    hdr = ["@HD\tVN:1.6\tSO:coordinate"]
    hdr += [f"@SQ\tSN:{name}\tLN:{ln}" for name, ln in refs]
    with BamWriter(path, "\n".join(hdr) + "\n", refs, level=1) as w:
        for rec in records:
            w.write(rec)
    index_bam(path)


def write_fasta(path: str, entries: List[Tuple[str, str]],
                width: int = 60) -> None:
    """(name, sequence) entries as FASTA, ``width`` bases a line."""
    with open(path, "w") as fh:
        for name, seq in entries:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")
