"""GZIP(-or-plain) line iterator (parity with src/angzipiter.hpp).

Used only by vcf2mat on the VCF input (vcf2mat.cpp:55); handles both plain
and gzip files like zlib's gzopen does.
"""

from __future__ import annotations

import gzip
from typing import Iterator


def iter_lines(path: str) -> Iterator[str]:
    with open(path, "rb") as probe:
        magic = probe.read(2)
    opener = gzip.open if magic == b"\x1f\x8b" else open
    with opener(path, "rt") as fh:  # type: ignore[arg-type]
        for line in fh:
            yield line.rstrip("\n")
