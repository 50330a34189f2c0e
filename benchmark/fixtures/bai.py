"""BAI index reader/writer + builder, implemented from the SAM spec §5.

Provides the region-query capability the reference gets from htslib's
``bam_index_load``/``bam_itr_querys`` (src/anbamfilehelper.cpp:20,
src/anseqs.cpp:441). Also includes an index *builder* so the framework can
index its own BAM outputs without external samtools.

Frozen copy of ``otter_tpu_torch/io/bai.py`` at commit eda140f, so that
changes to the program cannot move the benchmark's inputs or its
reference's reads.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


def reg2bin(beg: int, end: int) -> int:
    """Compute the smallest bin containing [beg, end) (SAM spec §5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end) (SAM spec §5.3)."""
    bins = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


@dataclass
class BaiRef:
    bins: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)
    ioffsets: List[int] = field(default_factory=list)


class BaiIndex:
    def __init__(self, refs: List[BaiRef]):
        self.refs = refs

    @classmethod
    def load(cls, path: str) -> "BaiIndex":
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise IOError(f"{path}: not a BAI index")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((beg, end))
                bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ioff = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            refs.append(BaiRef(bins, ioff))
        return cls(refs)

    def query(self, tid: int, beg: int, end: int) -> List[Tuple[int, int]]:
        """Merged virtual-offset chunks overlapping [beg, end)."""
        if tid < 0 or tid >= len(self.refs) or end <= beg:
            return []
        ref = self.refs[tid]
        min_off = 0
        iv = beg >> 14
        if ref.ioffsets:
            if iv >= len(ref.ioffsets):
                iv = len(ref.ioffsets) - 1
            # first non-zero linear offset at or before the window
            while iv >= 0 and ref.ioffsets[iv] == 0:
                iv -= 1
            if iv >= 0:
                min_off = ref.ioffsets[iv]
        chunks: List[Tuple[int, int]] = []
        for b in reg2bins(beg, end):
            for cbeg, cend in ref.bins.get(b, ()):
                if cend > min_off:
                    chunks.append((max(cbeg, min_off), cend))
        chunks.sort()
        merged: List[Tuple[int, int]] = []
        for c in chunks:
            if merged and c[0] <= merged[-1][1]:
                if c[1] > merged[-1][1]:
                    merged[-1] = (merged[-1][0], c[1])
            else:
                merged.append(c)
        return merged

    def save(self, path: str) -> None:
        out = bytearray(b"BAI\x01")
        out += struct.pack("<i", len(self.refs))
        for ref in self.refs:
            out += struct.pack("<i", len(ref.bins))
            for bin_id in sorted(ref.bins):
                chunks = ref.bins[bin_id]
                out += struct.pack("<Ii", bin_id, len(chunks))
                for beg, end in chunks:
                    out += struct.pack("<QQ", beg, end)
            out += struct.pack("<i", len(ref.ioffsets))
            for v in ref.ioffsets:
                out += struct.pack("<Q", v)
        with open(path, "wb") as fh:
            fh.write(bytes(out))


def build_bai(bam_path: str) -> BaiIndex:
    """Build a BAI index by scanning a BAM file (samtools-index equivalent)."""
    from .bam import BamReader  # local import to avoid cycle

    rd = BamReader(bam_path, load_index=False)
    refs = [BaiRef() for _ in rd.ref_names]
    voff = rd._data_voffset
    rd._bgzf.seek_virtual(voff)
    while True:
        start_v = rd._bgzf.tell_virtual()
        rec = rd._read_record()
        if rec is None:
            break
        end_v = rd._bgzf.tell_virtual()
        if rec.ref_id < 0:
            continue
        ref = refs[rec.ref_id]
        b = reg2bin(rec.pos, max(rec.pos + 1, rec.end_pos()))
        ref.bins.setdefault(b, []).append((start_v, end_v))
        iv_beg = rec.pos >> 14
        iv_end = (max(rec.pos, rec.end_pos() - 1)) >> 14
        while len(ref.ioffsets) <= iv_end:
            ref.ioffsets.append(0)
        for iv in range(iv_beg, iv_end + 1):
            if ref.ioffsets[iv] == 0 or start_v < ref.ioffsets[iv]:
                ref.ioffsets[iv] = start_v
    rd.close()
    # merge adjacent chunks per bin
    for ref in refs:
        for b, chunks in ref.bins.items():
            chunks.sort()
            merged = []
            for c in chunks:
                if merged and c[0] <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], c[1]))
                else:
                    merged.append(list(c))
            ref.bins[b] = [tuple(c) for c in merged]
    idx = BaiIndex(refs)
    return idx


def index_bam(bam_path: str) -> None:
    build_bai(bam_path).save(bam_path + ".bai")
