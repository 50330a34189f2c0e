"""Random-access compressed sequence containers (RAZF / BGZF / gzip).

The reference's faidx reads razip-compressed FASTA through RAZF
(src/razf.c, src/faidx.c:16-31): a gzip stream whose extra field is the
7-byte blob ``"RAZF" 0x01 <block_size BE16>``, deflated with a
``Z_FULL_FLUSH`` at every 32 KiB (``RZ_BLOCK_SIZE``, razf.h:57) of
*uncompressed* input, followed by a big-endian random-access index
(``save_zindex``, razf.c:92-108: ``int32 size``, ``int64
bin_offsets[size/131072 + 1]``, ``uint32 cell_offsets[size]``) and a
16-byte big-endian trailer ``(src_end, end)`` = (uncompressed size, file
offset where the index starts) (razf_close, razf.c).  Entry ``idx`` maps
uncompressed offset ``(idx+1)*32768`` to the compressed offset
``cell_offsets[idx] + bin_offsets[idx // 131072]`` (razf_seek,
razf.c:743-770); block 0 starts right after the gzip header.

``open_seqfile`` sniffs the container and returns a file-like object
(seek/tell/read/readline) over the *uncompressed* byte stream, so faidx
offsets are uncompressed offsets exactly as in the reference
(razf_tell):

  * plain file        -> the raw file handle
  * RAZF              -> index-backed random access (``RazfReader``)
  * BGZF (BC field)   -> per-block random access via a linear offset
                         table (headers hopped, nothing decompressed up
                         front) — a capability the reference lacks
  * other gzip        -> whole-stream inflate held in memory (the
                         reference can only read these sequentially,
                         faidx on them is not seekable; divergence noted
                         in PARITY.md)

``razf_compress`` writes conformant ``.rz`` files (round-trip tested; the
environment has no razip binary).
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from bisect import bisect_right
from typing import List, Tuple

RZ_BLOCK_SIZE = 1 << 15
RZ_BIN_SIZE = (1 << 32) // RZ_BLOCK_SIZE

_FTEXT, _FHCRC, _FEXTRA, _FNAME, _FCOMMENT = 1, 2, 4, 8, 16


def _parse_gz_header(data: bytes) -> Tuple[int, bytes]:
    """Return (header_size, extra_blob) or (0, b"") if not a gzip header
    (mirrors _read_gz_header, razf.c:314-348)."""
    if len(data) < 10 or data[0] != 0x1F or data[1] != 0x8B or data[2] != 8:
        return 0, b""
    flags = data[3]
    if flags & 0xE0:
        return 0, b""
    n = 10
    extra = b""
    if flags & _FEXTRA:
        if len(data) < n + 2:
            return 0, b""
        xlen = data[n] | (data[n + 1] << 8)
        n += 2
        if len(data) < n + xlen:
            return 0, b""
        extra = data[n:n + xlen]
        n += xlen
    if flags & _FNAME:
        while n < len(data) and data[n] != 0:
            n += 1
        n += 1
    if flags & _FCOMMENT:
        while n < len(data) and data[n] != 0:
            n += 1
        n += 1
    if flags & _FHCRC:
        n += 2
    if n > len(data):
        return 0, b""
    return n, extra


class _UncompressedView:
    """seek/tell/read/readline over an uncompressed byte space backed by
    ``_read_at(pos, n)`` and ``size``."""

    size: int = 0

    def __init__(self):
        self._pos = 0

    def tell(self) -> int:
        return self._pos

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            pos += self._pos
        elif whence == 2:
            pos += self.size
        self._pos = max(0, int(pos))
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = max(0, self.size - self._pos)
        data = self._read_at(self._pos, n)
        self._pos += len(data)
        return data

    def readline(self) -> bytes:
        parts = []
        while True:
            chunk = self._read_at(self._pos, 8192)
            if not chunk:
                break
            i = chunk.find(b"\n")
            if i >= 0:
                parts.append(chunk[:i + 1])
                self._pos += i + 1
                break
            parts.append(chunk)
            self._pos += len(chunk)
        return b"".join(parts)

    def _read_at(self, pos: int, n: int) -> bytes:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class RazfReader(_UncompressedView):
    """Random access over a RAZF file via its trailing block index."""

    def __init__(self, path: str):
        super().__init__()
        self._fh = open(path, "rb")
        head = self._fh.read(4096)
        hsize, extra = _parse_gz_header(head)
        if hsize == 0 or not extra.startswith(b"RAZF"):
            self._fh.close()
            raise IOError(f"{path}: not a RAZF file")
        if len(extra) < 7 or ((extra[5] << 8) | extra[6]) != RZ_BLOCK_SIZE:
            self._fh.close()
            raise IOError(f"{path}: RAZF block size != {RZ_BLOCK_SIZE}")
        self._header_size = hsize
        fsize = os.fstat(self._fh.fileno()).st_size
        if fsize < hsize + 16:
            self._fh.close()
            raise IOError(f"{path}: truncated RAZF")
        self._fh.seek(fsize - 16)
        self.size, self._end = struct.unpack(">qq", self._fh.read(16))
        if not (hsize <= self._end <= fsize - 16):
            self._fh.close()
            raise IOError(f"{path}: corrupt RAZF trailer")
        self._fh.seek(self._end)
        raw = self._fh.read(fsize - 16 - self._end)
        (isize,) = struct.unpack(">i", raw[:4])
        nbins = isize // RZ_BIN_SIZE + 1
        off = 4
        bins = struct.unpack(f">{nbins}q", raw[off:off + 8 * nbins])
        off += 8 * nbins
        cells = struct.unpack(f">{isize}I", raw[off:off + 4 * isize])
        self._block_comp: List[int] = [
            cells[i] + bins[i // RZ_BIN_SIZE] for i in range(isize)]
        # decompress cursor
        self._d = None
        self._cur_out = 0      # uncompressed offset of next byte to produce
        self._cur_in = 0       # compressed file offset of next feed
        self._buf = b""        # produced, unconsumed
        self._buf_off = 0

    def _jump(self, pos: int) -> None:
        """Reset the inflate cursor to the indexed block containing pos
        (razf_seek, razf.c:743-770)."""
        idx = pos // RZ_BLOCK_SIZE - 1
        if idx < 0:
            comp, out = self._header_size, 0
        else:
            idx = min(idx, len(self._block_comp) - 1)
            comp, out = self._block_comp[idx], (idx + 1) * RZ_BLOCK_SIZE
        self._d = zlib.decompressobj(-15)
        self._cur_in = comp
        self._cur_out = out
        self._buf = b""
        self._buf_off = 0

    def _pump(self) -> bool:
        """Feed the inflater one compressed chunk; False at stream end."""
        if self._d is None or self._d.eof:
            return False
        self._fh.seek(self._cur_in)
        chunk = self._fh.read(65536)
        if not chunk:
            return False
        self._cur_in += len(chunk)
        self._buf = self._d.decompress(chunk)
        self._buf_off = 0
        return True

    def _read_at(self, pos: int, n: int) -> bytes:
        n = min(n, max(0, self.size - pos))
        if n <= 0:
            return b""
        consumed_to = self._cur_out - (len(self._buf) - self._buf_off)
        if self._d is None or pos < consumed_to or \
                pos > self._cur_out + RZ_BLOCK_SIZE:
            self._jump(pos)
            consumed_to = self._cur_out
        # skip forward to pos
        while consumed_to < pos:
            avail = len(self._buf) - self._buf_off
            if avail == 0:
                if not self._pump():
                    return b""
                self._cur_out += len(self._buf)
                continue
            step = min(avail, pos - consumed_to)
            self._buf_off += step
            consumed_to += step
        out = []
        need = n
        while need > 0:
            avail = len(self._buf) - self._buf_off
            if avail == 0:
                if not self._pump():
                    break
                self._cur_out += len(self._buf)
                continue
            take = min(avail, need)
            out.append(self._buf[self._buf_off:self._buf_off + take])
            self._buf_off += take
            need -= take
        return b"".join(out)

    def close(self) -> None:
        self._fh.close()


class LinearBgzf(_UncompressedView):
    """Linear-offset random access over a BGZF file (block table built by
    hopping headers; blocks inflate lazily through BgzfReader's cache)."""

    def __init__(self, path: str):
        super().__init__()
        from .bgzf import BgzfReader
        self._bgzf = BgzfReader(path)
        self._u_offs: List[int] = []
        self._c_offs: List[int] = []
        u = 0
        c = 0
        with open(path, "rb") as fh:
            fsize = os.fstat(fh.fileno()).st_size
            while c + 18 <= fsize:
                fh.seek(c)
                hdr = fh.read(12)
                if len(hdr) < 12 or hdr[0] != 0x1F or hdr[1] != 0x8B:
                    break
                xlen = hdr[10] | (hdr[11] << 8)
                extra = fh.read(xlen)
                bsize = None
                i = 0
                while i + 4 <= len(extra):
                    slen = extra[i + 2] | (extra[i + 3] << 8)
                    if extra[i] == 66 and extra[i + 1] == 67 and slen == 2:
                        bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1
                        break
                    i += 4 + slen
                if bsize is None or bsize <= 0:
                    break
                fh.seek(c + bsize - 4)
                (isz,) = struct.unpack("<I", fh.read(4))
                if isz:
                    self._u_offs.append(u)
                    self._c_offs.append(c)
                u += isz
                c += bsize
        self.size = u

    def _read_at(self, pos: int, n: int) -> bytes:
        n = min(n, max(0, self.size - pos))
        if n <= 0:
            return b""
        out = []
        while n > 0:
            bi = bisect_right(self._u_offs, pos) - 1
            if bi < 0:
                break
            data, _ = self._bgzf._read_block_at(self._c_offs[bi])
            lo = pos - self._u_offs[bi]
            take = min(n, len(data) - lo)
            if take <= 0:
                break
            out.append(data[lo:lo + take])
            pos += take
            n -= take
        return b"".join(out)

    def close(self) -> None:
        self._bgzf.close()


class _MemoryView(_UncompressedView):
    def __init__(self, data: bytes):
        super().__init__()
        self._data = data
        self.size = len(data)

    def _read_at(self, pos: int, n: int) -> bytes:
        return self._data[pos:pos + n]


def open_seqfile(path: str):
    """Sniff the container and return an uncompressed-space file object."""
    with open(path, "rb") as fh:
        head = fh.read(4096)
    hsize, extra = _parse_gz_header(head)
    if hsize == 0:
        return open(path, "rb")
    if extra.startswith(b"RAZF"):
        return RazfReader(path)
    i = 0
    while i + 4 <= len(extra):
        slen = extra[i + 2] | (extra[i + 3] << 8)
        if extra[i] == 66 and extra[i + 1] == 67 and slen == 2:
            return LinearBgzf(path)
        i += 4 + slen
    with open(path, "rb") as fh:
        return _MemoryView(zlib.decompress(fh.read(), 47))


def razf_compress(data: bytes, path: str, level: int = 6) -> None:
    """Write ``data`` as a RAZF file (razf_open_w/razf_write/razf_close
    layout: full flush per 32 KiB block, big-endian zindex + trailer)."""
    with open(path, "wb") as fh:
        hdr = (b"\x1f\x8b\x08\x04" + b"\x00\x00\x00\x00" + b"\x00\x03"
               + struct.pack("<H", 7) + b"RAZF\x01"
               + struct.pack(">H", RZ_BLOCK_SIZE))
        fh.write(hdr)
        out_pos = len(hdr)
        comp = zlib.compressobj(level, zlib.DEFLATED, -15)
        boundaries: List[int] = []
        full_end = (len(data) // RZ_BLOCK_SIZE) * RZ_BLOCK_SIZE
        for beg in range(0, full_end, RZ_BLOCK_SIZE):
            co = comp.compress(data[beg:beg + RZ_BLOCK_SIZE]) \
                + comp.flush(zlib.Z_FULL_FLUSH)
            fh.write(co)
            out_pos += len(co)
            boundaries.append(out_pos)
        tail = data[full_end:]
        co = (comp.compress(tail) if tail else b"") + comp.flush(zlib.Z_FINISH)
        fh.write(co)
        out_pos += len(co)
        trailer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                              len(data) & 0xFFFFFFFF)
        fh.write(trailer)
        out_pos += len(trailer)
        end = out_pos
        boundaries.append(end)  # razf_close's final add_zindex
        isize = len(boundaries)
        nbins = isize // RZ_BIN_SIZE + 1
        bins = [boundaries[i * RZ_BIN_SIZE] if i * RZ_BIN_SIZE < isize else 0
                for i in range(nbins)]
        cells = [boundaries[i] - bins[i // RZ_BIN_SIZE] for i in range(isize)]
        fh.write(struct.pack(">i", isize))
        fh.write(struct.pack(f">{nbins}q", *bins))
        fh.write(struct.pack(f">{isize}I", *cells))
        fh.write(struct.pack(">qq", len(data), end))
