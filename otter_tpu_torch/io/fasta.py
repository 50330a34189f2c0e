"""Indexed FASTA access (faidx equivalent; replaces src/faidx.c + anfahelper).

``fetch(chr, start, end)`` uses htslib ``faidx_fetch_seq`` semantics: 0-based
*inclusive* coordinates, clamped to the sequence, upper-cased on return
(src/anfahelper.cpp:8-18 upper-cases each base). Returns "" when out of range
(the reference leaves the output string empty when ref_l <= 0).

Compressed FASTA is supported through ``io/razf.py``'s container layer:
RAZF (razip) files get true index-backed random access like the
reference's razf-built faidx (src/faidx.c:16-31, razf.c); BGZF and plain
gzip also work (see razf.py's docstring for the capability matrix). All
.fai offsets are *uncompressed* offsets, as in the reference
(``razf_tell``, faidx.c:81,105).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

from .razf import open_seqfile


class Faidx:
    def __init__(self, path: str):
        self.path = path
        self._fh = open_seqfile(path)
        self.index: Dict[str, Tuple[int, int, int, int]] = {}
        self.order = []
        fai = path + ".fai"
        if os.path.exists(fai):
            with open(fai) as fh:
                for line in fh:
                    f = line.rstrip("\n").split("\t")
                    if len(f) >= 5:
                        self.index[f[0]] = (int(f[1]), int(f[2]), int(f[3]), int(f[4]))
                        self.order.append(f[0])
        else:
            self._build_index()
            self.save_fai(fai)

    def _build_index(self) -> None:
        self._fh.seek(0)
        name = None
        seq_len = 0
        seq_off = 0
        linebases = 0
        linewidth = 0
        first_line = True
        while True:
            line_off = self._fh.tell()
            line = self._fh.readline()
            if not line:
                break
            if line.startswith(b">"):
                if name is not None:
                    self.index[name] = (seq_len, seq_off, linebases, linewidth)
                    self.order.append(name)
                name = line[1:].split()[0].decode()
                seq_len = 0
                seq_off = self._fh.tell()
                first_line = True
            elif name is not None and line.strip():
                bases = len(line.rstrip(b"\r\n"))
                if first_line:
                    linebases = bases
                    linewidth = len(line)
                    first_line = False
                seq_len += bases
        if name is not None:
            self.index[name] = (seq_len, seq_off, linebases, linewidth)
            self.order.append(name)

    def save_fai(self, path: str) -> None:
        with open(path, "w") as fh:
            for name in self.order:
                ln, off, lb, lw = self.index[name]
                fh.write(f"{name}\t{ln}\t{off}\t{lb}\t{lw}\n")

    def fetch(self, chrom: str, start: int, end: int) -> str:
        """0-based inclusive [start, end], clamped; uppercased; "" if invalid."""
        meta = self.index.get(chrom)
        if meta is None:
            return ""
        seq_len, seq_off, linebases, linewidth = meta
        if start < 0:
            start = 0
        if end >= seq_len:
            end = seq_len - 1
        if end < start:
            return ""
        n = end - start + 1
        first_line_i = start // linebases
        in_line = start % linebases
        self._fh.seek(seq_off + first_line_i * linewidth + in_line)
        # read enough raw bytes to cover n bases incl. newlines
        lines_spanned = (in_line + n + linebases - 1) // linebases + 1
        raw = self._fh.read(n + lines_spanned * (linewidth - linebases))
        out = bytearray()
        for b in raw:
            if b not in (0x0A, 0x0D):
                out.append(b)
                if len(out) == n:
                    break
        return out.decode().upper()

    def close(self) -> None:
        self._fh.close()
