"""BGZF (blocked gzip) reader/writer, implemented from the SAM spec §4.1.

Replaces the reference's vendored htslib-lite BGZF layer (src/bgzf.c) with a
small pure-Python implementation on top of zlib. Supports virtual file
offsets (coffset << 16 | uoffset) so BAI index queries can seek, a block
cache for random access, and a writer (used to build test fixtures and by
the BAM writer).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

from ..utils import metrics

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HDR = struct.Struct("<4BI2BH")  # magic(4), mtime, xfl, os, xlen


class BgzfReader:
    """Random-access reader over a BGZF file with virtual-offset seeks."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._block_coffset = -1
        self._block_data = b""
        self._next_coffset = 0
        self._uoffset = 0
        self._cache: dict[int, tuple[bytes, int]] = {}
        self._cache_order: list[int] = []
        self._cache_max = 64

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -- block layer ---------------------------------------------------------

    def _read_block_at(self, coffset: int) -> tuple[bytes, int]:
        """Return (uncompressed data, compressed size) of the block at coffset.
        Each inflate (a cache miss) adds one to counter ``bgzf_inflates``."""
        hit = self._cache.get(coffset)
        if hit is not None:
            return hit
        self._fh.seek(coffset)
        hdr = self._fh.read(12)
        if len(hdr) == 0:
            return b"", 0
        if len(hdr) < 12:
            raise IOError("truncated BGZF block header")
        magic0, magic1, _cm, flg, _mtime, _xfl, _os, xlen = _HDR.unpack(hdr)
        if magic0 != 0x1F or magic1 != 0x8B or not (flg & 4):
            raise IOError(f"not a BGZF block at offset {coffset}")
        extra = self._fh.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack("<H", extra[i + 2 : i + 4])[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            raise IOError("BGZF BC subfield missing")
        cdata_len = bsize - 12 - xlen - 8
        cdata = self._fh.read(cdata_len)
        self._fh.read(8)  # crc32 + isize
        data = zlib.decompress(cdata, -15)
        metrics.add("bgzf_inflates")
        self._cache[coffset] = (data, bsize)
        self._cache_order.append(coffset)
        if len(self._cache_order) > self._cache_max:
            old = self._cache_order.pop(0)
            self._cache.pop(old, None)
        return data, bsize

    # -- stream layer --------------------------------------------------------

    def seek_virtual(self, voffset: int) -> None:
        coffset = voffset >> 16
        uoffset = voffset & 0xFFFF
        data, bsize = self._read_block_at(coffset)
        self._block_coffset = coffset
        self._block_data = data
        self._next_coffset = coffset + bsize
        self._uoffset = uoffset

    def tell_virtual(self) -> int:
        if self._block_coffset < 0:
            return 0
        if self._uoffset >= len(self._block_data):
            return self._next_coffset << 16
        return (self._block_coffset << 16) | self._uoffset

    def read_span(self, vbeg: int, vend: int) -> bytes:
        """All uncompressed bytes between two virtual offsets (one python
        call per 64 KiB block instead of per caller read). BAI chunk
        boundaries are record-aligned, so [vbeg, vend) is exactly the
        chunk's record stream."""
        cbeg, ubeg = vbeg >> 16, vbeg & 0xFFFF
        cend, uend = vend >> 16, vend & 0xFFFF
        parts = []
        coffset = cbeg
        while True:
            data, bsize = self._read_block_at(coffset)
            if bsize == 0:
                break  # EOF
            lo = ubeg if coffset == cbeg else 0
            hi = uend if coffset == cend else len(data)
            if hi > lo:
                parts.append(data[lo:hi])
            if coffset >= cend:
                break
            coffset += bsize
        # leave the stream positioned at vend (matches the read() loop)
        self.seek_virtual(vend)
        return b"".join(parts)

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._block_coffset < 0 or self._uoffset >= len(self._block_data):
                coffset = self._next_coffset if self._block_coffset >= 0 else 0
                data, bsize = self._read_block_at(coffset)
                if bsize == 0 or len(data) == 0:
                    if bsize == 0:
                        break  # true EOF
                    # empty block (EOF marker) — skip it
                    self._block_coffset = coffset
                    self._block_data = b""
                    self._next_coffset = coffset + bsize
                    self._uoffset = 0
                    continue
                self._block_coffset = coffset
                self._block_data = data
                self._next_coffset = coffset + bsize
                self._uoffset = 0
            take = min(n, len(self._block_data) - self._uoffset)
            out += self._block_data[self._uoffset : self._uoffset + take]
            self._uoffset += take
            n -= take
        return bytes(out)


class BgzfWriter:
    """BGZF writer (64 KiB blocks + EOF marker)."""

    def __init__(self, path: str, level: int = 6):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._level = level

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= 0xFF00:
            self._flush_block(self._buf[:0xFF00])
            del self._buf[:0xFF00]

    def _flush_block(self, payload: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
        bsize = len(cdata) + 12 + 6 + 8
        if bsize > 0x10000:
            raise IOError("BGZF block too large")
        hdr = _HDR.pack(0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
        extra = struct.pack("<2BH H", 66, 67, 2, bsize - 1)
        tail = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
        self._fh.write(hdr + extra + cdata + tail)

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
