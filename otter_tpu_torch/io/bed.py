"""BED parsing (parity with reference src/anbed.{hpp,cpp}).

Accepts 3+-column BED lines or single-column ``chr:start-end`` lines
(anbed.cpp:23-63); skips ``#`` comments and warns on empty lines
(anbed.cpp:70-76); logs total loaded annotations (anbed.cpp:79).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional

from ..utils.timestamp import antimestamp


@dataclass
class BED:
    chr: str = ""
    start: int = 0
    end: int = 0

    def to_string(self) -> str:
        return f"{self.chr}\t{self.start}\t{self.end}"

    def to_sc_string(self) -> str:
        return f"{self.chr}:{self.start}-{self.end}"


def parse_sc_bed(line: str) -> Optional[BED]:
    chr_ = ""
    start = -1
    end = -1
    fields = line.split(":")
    if fields:
        chr_ = fields[0]
    if len(fields) > 1:
        coords = fields[1].split("-")
        try:
            if len(coords) > 0 and coords[0] != "":
                start = int(coords[0])
            if len(coords) > 1 and coords[1] != "":
                end = int(coords[1])
        except ValueError:
            pass
    if not chr_ or start < 0 or end < 0:
        sys.stderr.write(f"({antimestamp()}): Skipping ambiguous multi-BED line: {line}\n")
        return None
    return BED(chr_, start, end)


def parse_bed(line: str) -> Optional[BED]:
    columns = line.split("\t")
    if len(columns) == 1:
        return parse_sc_bed(columns[0])
    if len(columns) < 3:
        sys.stderr.write(f"({antimestamp()}): Skipping ambiguous BED line: {line}\n")
        return None
    return BED(columns[0], int(columns[1]), int(columns[2]))


def parse_bed_file(bedfile: str) -> List[BED]:
    out: List[BED] = []
    with open(bedfile) as fh:
        for raw in fh:
            line = raw.rstrip("\n")
            if not line:
                sys.stderr.write(f"({antimestamp()}): [WARNING] Skipping empty BED line\n")
            elif line[0] != "#":
                bed = parse_bed(line)
                if bed is not None:
                    out.append(bed)
    sys.stderr.write(f"({antimestamp()}): Loaded {len(out)} total annotation(s)\n")
    return out
