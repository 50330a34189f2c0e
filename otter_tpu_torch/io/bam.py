"""BAM container reader/writer, implemented from the SAM spec §4.2.

Replaces the reference's htslib-lite BAM layer (src/sam.c, src/hts.c) and the
per-thread ``BamInstance`` handle (src/anbamfilehelper.cpp:13-35). Region
queries use the BAI index when ``<bam>.bai`` exists (like bam_itr_querys,
src/anseqs.cpp:441) and fall back to a full linear scan otherwise.

The writer exists for building test fixtures and for interop (the reference
itself never writes BAM — its outputs are SAM text on stdout).
"""

from __future__ import annotations

import os
import struct
import sys
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

from .bai import BaiIndex, reg2bin
from .bgzf import BgzfReader, BgzfWriter
from .. import native
from ..utils.timestamp import antimestamp

SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"
_NT16_OF = {c: i for i, c in enumerate(SEQ_NT16_STR)}
_NT16_OF.update({c.lower(): i for i, c in enumerate(SEQ_NT16_STR) if c.isalpha()})
CIGAR_OPS = "MIDNSHP=X"
_CIGAR_OF = {c: i for i, c in enumerate(CIGAR_OPS)}

BAM_CMATCH, BAM_CINS, BAM_CDEL, BAM_CREF_SKIP = 0, 1, 2, 3
BAM_CSOFT_CLIP, BAM_CHARD_CLIP, BAM_CPAD, BAM_CEQUAL, BAM_CDIFF = 4, 5, 6, 7, 8

FLAG_UNMAP = 4
FLAG_REVERSE = 16
FLAG_SECONDARY = 256
FLAG_SUPPLEMENTARY = 2048

# a record's block_size, ref_id and pos
_REC_HEAD = struct.Struct("<Iii")


@dataclass
class BamRecord:
    name: str = ""
    flag: int = 0
    ref_id: int = -1
    pos: int = -1          # 0-based leftmost
    mapq: int = 0
    cigar: List[Tuple[int, int]] = field(default_factory=list)  # (oplen, op)
    seq: str = ""
    qual: bytes = b""
    aux: bytes = b""
    next_ref_id: int = -1
    next_pos: int = -1
    tlen: int = 0

    # -- derived -------------------------------------------------------------

    @property
    def l_qseq(self) -> int:
        return len(self.seq)

    def ref_len(self) -> int:
        """Reference bases consumed by the alignment (bam_cigar2rlen)."""
        n = 0
        for ol, op in self.cigar:
            if op in (BAM_CMATCH, BAM_CDEL, BAM_CREF_SKIP, BAM_CEQUAL, BAM_CDIFF):
                n += ol
        return n

    def end_pos(self) -> int:
        return self.pos + self.ref_len()

    # -- aux tags ------------------------------------------------------------

    def get_aux(self, tag: str):
        """Return the decoded value of a two-char aux tag, or None."""
        data = self.aux
        i = 0
        n = len(data)
        want = tag.encode()
        while i + 3 <= n:
            t = data[i : i + 2]
            typ = chr(data[i + 2])
            i += 3
            val, i = _decode_aux_value(data, i, typ)
            if t == want:
                return val
        return None

    def get_aux_int(self, tag: str) -> Optional[int]:
        v = self.get_aux(tag)
        return int(v) if isinstance(v, (int, float)) else None

    def get_aux_float(self, tag: str) -> Optional[float]:
        v = self.get_aux(tag)
        return float(v) if isinstance(v, (int, float)) else None

    def get_aux_str(self, tag: str) -> Optional[str]:
        v = self.get_aux(tag)
        return v if isinstance(v, str) else None

    def get_aux_map(self) -> dict:
        """Decode every aux tag in one pass (first occurrence wins, matching
        get_aux). Cheaper than one walk per tag for multi-tag consumers."""
        data = self.aux
        i = 0
        n = len(data)
        out: dict = {}
        while i + 3 <= n:
            t = data[i : i + 2].decode("latin-1")
            typ = chr(data[i + 2])
            val, i = _decode_aux_value(data, i + 3, typ)
            if t not in out:
                out[t] = val
        return out

    def strip_aux(self, tag: str) -> None:
        """Remove a two-char aux tag in place (no-op if absent)."""
        data = self.aux
        i = 0
        n = len(data)
        want = tag.encode()
        while i + 3 <= n:
            t = data[i : i + 2]
            typ = chr(data[i + 2])
            _, j = _decode_aux_value(data, i + 3, typ)
            if t == want:
                self.aux = data[:i] + data[j:]
                return
            i = j


def _decode_aux_value(data: bytes, i: int, typ: str):
    if typ == "A":
        return chr(data[i]), i + 1
    if typ == "c":
        return struct.unpack_from("<b", data, i)[0], i + 1
    if typ == "C":
        return data[i], i + 1
    if typ == "s":
        return struct.unpack_from("<h", data, i)[0], i + 2
    if typ == "S":
        return struct.unpack_from("<H", data, i)[0], i + 2
    if typ == "i":
        return struct.unpack_from("<i", data, i)[0], i + 4
    if typ == "I":
        return struct.unpack_from("<I", data, i)[0], i + 4
    if typ == "f":
        return struct.unpack_from("<f", data, i)[0], i + 4
    if typ in ("Z", "H"):
        j = data.index(0, i)
        return data[i:j].decode(), j + 1
    if typ == "B":
        sub = chr(data[i])
        cnt = struct.unpack_from("<I", data, i + 1)[0]
        size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
        vals = []
        j = i + 5
        for _ in range(cnt):
            v, j = _decode_aux_value(data, j, sub)
            vals.append(v)
        return vals, j
    raise IOError(f"unknown aux type {typ!r}")


def encode_aux(tag: str, typ: str, value) -> bytes:
    out = tag.encode() + typ.encode()
    if typ == "A":
        return out + value.encode()
    if typ == "i":
        return out + struct.pack("<i", value)
    if typ == "f":
        return out + struct.pack("<f", value)
    if typ == "Z":
        return out + value.encode() + b"\x00"
    raise ValueError(f"unsupported aux type {typ!r}")


import numpy as _np

# nibble-pair -> two ASCII chars lookup (vectorized seq decode)
_NYB2ASCII = _np.zeros((256, 2), dtype=_np.uint8)
for _b in range(256):
    _NYB2ASCII[_b, 0] = ord(SEQ_NT16_STR[_b >> 4])
    _NYB2ASCII[_b, 1] = ord(SEQ_NT16_STR[_b & 0xF])


def _decode_record(blob: bytes) -> BamRecord:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar_op, flag, l_seq,
     next_ref_id, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", blob, 0)
    off = 32
    name = blob[off : off + l_read_name - 1].decode()
    off += l_read_name
    if n_cigar_op:
        cig = _np.frombuffer(blob, dtype="<u4", count=n_cigar_op, offset=off)
        cigar = list(zip((cig >> 4).tolist(), (cig & 0xF).tolist()))
    else:
        cigar = []
    long_cigar_placeholder = (
        n_cigar_op == 2 and cigar[0][1] == BAM_CSOFT_CLIP
        and cigar[0][0] == l_seq and cigar[1][1] == BAM_CREF_SKIP)
    off += 4 * n_cigar_op
    n_nyb = (l_seq + 1) // 2
    if l_seq:
        nyb = _np.frombuffer(blob, dtype=_np.uint8, count=n_nyb, offset=off)
        chars = _NYB2ASCII[nyb].reshape(-1)[:l_seq]
        seq = chars.tobytes().decode("ascii")
    else:
        seq = ""
    off += n_nyb
    qual = blob[off : off + l_seq]
    off += l_seq
    aux = blob[off:]
    rec = BamRecord(name, flag, ref_id, pos, mapq, cigar, seq, qual, aux,
                    next_ref_id, next_pos, tlen)
    if long_cigar_placeholder:
        # >65535-op alignments carry the real cigar in the CG:B,I tag
        # (SAM spec §4.2.2); the record cigar is the kSmN placeholder
        cg = rec.get_aux("CG")
        if isinstance(cg, list) and cg:
            arr = _np.asarray(cg, dtype=_np.uint32)
            rec.cigar = list(zip((arr >> 4).tolist(), (arr & 0xF).tolist()))
            rec.strip_aux("CG")
    return rec


def _encode_record(rec: BamRecord) -> bytes:
    l_seq = len(rec.seq)
    name_b = rec.name.encode() + b"\x00"
    cigar = rec.cigar
    extra_aux = b""
    if len(cigar) > 0xFFFF:
        # long-cigar convention (SAM spec §4.2.2): kSmN placeholder in the
        # record, real cigar in CG:B,I. Any stale CG from a read round-trip
        # is dropped first so the tag never duplicates.
        rec.strip_aux("CG")
        cg = bytearray(b"CGBI")
        cg += struct.pack("<I", len(cigar))
        for ol, op in cigar:
            cg += struct.pack("<I", (ol << 4) | op)
        extra_aux = bytes(cg)
        cigar = [(l_seq, BAM_CSOFT_CLIP), (rec.ref_len(), BAM_CREF_SKIP)]
    body = bytearray()
    body += struct.pack(
        "<iiBBHHHiiii",
        rec.ref_id, rec.pos, len(name_b), rec.mapq,
        reg2bin(rec.pos, max(rec.pos + 1, rec.end_pos())),
        len(cigar), rec.flag, l_seq,
        rec.next_ref_id, rec.next_pos, rec.tlen,
    )
    body += name_b
    for ol, op in cigar:
        body += struct.pack("<I", (ol << 4) | op)
    nyb = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(rec.seq):
        code = _NT16_OF.get(ch, 15)
        if (i & 1) == 0:
            nyb[i >> 1] |= code << 4
        else:
            nyb[i >> 1] |= code
    body += nyb
    body += rec.qual if rec.qual else b"\xff" * l_seq
    body += rec.aux + extra_aux
    return struct.pack("<I", len(body)) + bytes(body)


class BamReader:
    """Indexed BAM reader (the TPU-native analog of BamInstance)."""

    def __init__(self, path: str, load_index: bool = True):
        self.path = path
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise IOError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", self._bgzf.read(4))[0]
        self.header_text = self._bgzf.read(l_text).decode(errors="replace")
        n_ref = struct.unpack("<i", self._bgzf.read(4))[0]
        self.ref_names: List[str] = []
        self.ref_lens: List[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._bgzf.read(4))[0]
            self.ref_names.append(self._bgzf.read(l_name)[:-1].decode())
            self.ref_lens.append(struct.unpack("<i", self._bgzf.read(4))[0])
        self._data_voffset = self._bgzf.tell_virtual()
        self._name2tid = {n: i for i, n in enumerate(self.ref_names)}
        self.index: Optional[BaiIndex] = None
        if load_index and os.path.exists(path + ".bai"):
            self.index = BaiIndex.load(path + ".bai")

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def tid(self, name: str) -> int:
        return self._name2tid.get(name, -1)

    def _read_record(self) -> Optional[BamRecord]:
        raw = self._bgzf.read(4)
        if len(raw) < 4:
            return None
        block_size = struct.unpack("<I", raw)[0]
        blob = self._bgzf.read(block_size)
        if len(blob) < block_size:
            return None
        return _decode_record(blob)

    def _native_records(self, raw: bytes,
                        region=None) -> Optional[List[BamRecord]]:
        """Decode a raw record stream with the C++ feeder (native/otter_native
        .cpp); None when OTTER_TPU_NATIVE_IO=0 selects the python decoder.

        region=(tid, start, end) applies the fetch overlap/unmapped filter on
        the numpy columns BEFORE building BamRecord objects — most decoded
        records in a BAI chunk don't overlap the query, so this skips the
        bulk of the python-object construction."""
        if not native.enabled("IO"):
            return None
        d = native.parse_bam_records(raw)
        recs: List[BamRecord] = []
        n = len(d["ref_id"])
        names, seqs, auxs, cigars = d["names"], d["seqs"], d["auxs"], d["cigars"]
        no, co, so, ao = d["name_off"], d["cigar_off"], d["seq_off"], d["aux_off"]
        idxs = range(n)
        if region is not None and n:
            tid, qstart, qend = region
            lens = (cigars >> 4).astype(_np.int64)
            ops = cigars & _np.uint32(0xF)
            # ref-consuming ops: M, D, N, =, X (CG fake cigar's N carries the
            # true ref span, so end_pos is right for long-cigar records too)
            refmask = ((ops == 0) | (ops == 2) | (ops == 3)
                       | (ops == 7) | (ops == 8))
            cs = _np.concatenate(
                [[0], _np.cumsum(lens * refmask)])
            refspan = cs[co[1:]] - cs[co[:-1]]
            end_pos = d["pos"].astype(_np.int64) + refspan
            keep = ((d["ref_id"] == tid) & (d["pos"] < qend)
                    & (end_pos > qstart)
                    & ((d["flag"] & FLAG_UNMAP) == 0))
            idxs = _np.nonzero(keep)[0].tolist()
        for i in idxs:
            cg = cigars[co[i] : co[i + 1]]
            rec = BamRecord(
                name=names[no[i] : no[i + 1]].decode(),
                flag=int(d["flag"][i]),
                ref_id=int(d["ref_id"][i]),
                pos=int(d["pos"][i]),
                mapq=int(d["mapq"][i]),
                cigar=list(zip((cg >> 4).tolist(), (cg & 0xF).tolist())),
                seq=seqs[so[i] : so[i + 1]].decode("ascii"),
                qual=b"",
                aux=auxs[ao[i] : ao[i + 1]].tobytes(),
            )
            if (len(rec.cigar) == 2 and rec.cigar[0][1] == BAM_CSOFT_CLIP
                    and rec.cigar[0][0] == rec.l_qseq
                    and rec.cigar[1][1] == BAM_CREF_SKIP):
                cgv = rec.get_aux("CG")
                if isinstance(cgv, list) and cgv:
                    arr = _np.asarray(cgv, dtype=_np.uint32)
                    rec.cigar = list(zip((arr >> 4).tolist(),
                                         (arr & 0xF).tolist()))
                    rec.strip_aux("CG")
            recs.append(rec)
        return recs

    def __iter__(self) -> Iterator[BamRecord]:
        self._bgzf.seek_virtual(self._data_voffset)
        while True:
            rec = self._read_record()
            if rec is None:
                return
            yield rec

    def _walk(self, tid: int, start: int, end: int) -> Iterator[bytes]:
        """The record streams of the BAI chunks of [start, end) on tid, in
        file order, a chunk at a time. The walk ends at the first record
        that cannot overlap the region (``ref_id != tid or pos >= end``),
        as htslib's iterator does: the BAM is sorted by coordinate and the
        chunks by offset, so no later record can overlap. A truncated
        record ends its chunk."""
        for cbeg, cend in self.index.query(tid, start, end):
            raw = self._bgzf.read_span(cbeg, cend)
            off, past = 0, False
            while off + 12 <= len(raw):
                bs, ref_id, pos = _REC_HEAD.unpack_from(raw, off)
                past = ref_id != tid or pos >= end
                if past or off + 4 + bs > len(raw):
                    break
                off += 4 + bs
            if off:
                yield raw[:off]
            if past:
                return

    def fetch_raw(self, chrom: str, start: int, end: int):
        """(tid, raw record stream) of the region's BAI walk (``_walk``), or
        None when unindexed / unknown chrom (callers fall back to
        fetch()). Record order matches fetch()."""
        tid = self.tid(chrom)
        if tid < 0 or self.index is None:
            return None
        return tid, b"".join(self._walk(tid, start, end))

    def fetch(self, chrom: str, start: int, end: int) -> Iterator[BamRecord]:
        """Yield records overlapping [start, end) on chrom (0-based half-open)."""
        tid = self.tid(chrom)
        if tid < 0:
            sys.stderr.write(
                f"({antimestamp()}): WARNING: query failed at region {chrom}:{start}-{end}\n"
            )
            return
        if self.index is not None:
            for raw in self._walk(tid, start, end):
                # decode a chunk with the native feeder, or with
                # OTTER_TPU_NATIVE_IO=0 in python
                recs = self._native_records(raw, region=(tid, start, end))
                if recs is None:
                    recs = []
                    off = 0
                    while off < len(raw):
                        bs = struct.unpack_from("<I", raw, off)[0]
                        rec = _decode_record(raw[off + 4 : off + 4 + bs])
                        off += 4 + bs
                        if rec.end_pos() > start and \
                                not (rec.flag & FLAG_UNMAP):
                            recs.append(rec)
                yield from recs
        else:
            for rec in self:
                if rec.ref_id == tid and rec.pos < end and rec.end_pos() > start \
                        and not (rec.flag & FLAG_UNMAP):
                    yield rec

    def header_lines(self) -> List[str]:
        return [ln for ln in self.header_text.split("\n") if ln]


class BamWriter:
    """BAM writer used for fixtures and interop output."""

    def __init__(self, path: str, header_text: str,
                 refs: List[Tuple[str, int]], level: int = 6):
        self._w = BgzfWriter(path, level=level)
        hdr = header_text.encode()
        out = bytearray(b"BAM\x01")
        out += struct.pack("<i", len(hdr)) + hdr
        out += struct.pack("<i", len(refs))
        for name, ln in refs:
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        self._w.write(bytes(out))

    def write(self, rec: BamRecord) -> None:
        self._w.write(_encode_record(rec))

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def parse_sam_to_bam(sam_text: str, path: str) -> None:
    """Convert SAM text (as emitted by our writers) to a BAM file.

    A minimal samtools-view equivalent used by tests and the fixture
    pipeline (the reference relies on external samtools; README.md:56-63).
    """
    header_lines = []
    refs: List[Tuple[str, int]] = []
    records = []
    for line in sam_text.split("\n"):
        if not line:
            continue
        if line.startswith("@"):
            header_lines.append(line)
            if line.startswith("@SQ"):
                d = dict(f.split(":", 1) for f in line.split("\t")[1:])
                refs.append((d["SN"], int(d["LN"])))
            continue
        records.append(line)
    name2tid = {n: i for i, (n, _) in enumerate(refs)}
    with BamWriter(path, "\n".join(header_lines) + "\n", refs) as w:
        for line in records:
            f = line.split("\t")
            rec = BamRecord()
            rec.name = f[0]
            rec.flag = int(f[1])
            rec.ref_id = name2tid.get(f[2], -1)
            rec.pos = int(f[3]) - 1
            rec.mapq = int(f[4])
            if f[5] != "*":
                cig = []
                num = ""
                for ch in f[5]:
                    if ch.isdigit():
                        num += ch
                    else:
                        cig.append((int(num), _CIGAR_OF[ch]))
                        num = ""
                rec.cigar = cig
            rec.next_ref_id = -1
            rec.next_pos = -1
            rec.tlen = int(f[8])
            rec.seq = f[9] if f[9] != "*" else ""
            rec.qual = bytes((min(93, ord(c) - 33)) for c in f[10]) if f[10] != "*" else b""
            aux = bytearray()
            for tagf in f[11:]:
                tag, typ, val = tagf.split(":", 2)
                if typ == "i":
                    aux += encode_aux(tag, "i", int(val))
                elif typ == "f":
                    aux += encode_aux(tag, "f", float(val))
                elif typ == "A":
                    aux += encode_aux(tag, "A", val)
                else:
                    aux += encode_aux(tag, "Z", val)
            rec.aux = bytes(aux)
            w.write(rec)
