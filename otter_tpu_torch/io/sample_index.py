"""Sample index from merged otter BAM headers (parity with src/anbamdb.cpp).

Parses ``@RG ID:`` sample names and the inter-stage offset contract
``@PG ID:otter OF:l,r`` back out of BAM headers (anbamdb.cpp:13-40); errors
if no read group is present (:57-60).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List

from ..utils.timestamp import antimestamp
from .bam import BamReader


@dataclass
class SampleIndex:
    offset_l: int = 1
    offset_r: int = 0
    index2sample: List[str] = field(default_factory=list)
    sample2index: Dict[str, int] = field(default_factory=dict)

    def _init_line(self, line: str) -> None:
        if line[:2] == "RG":
            if line[3:5] == "ID":
                self.index2sample.append(line[6:])
            else:
                sys.stderr.write(
                    f"({antimestamp()}): [WARNING] unable to parse sample-name from "
                    f"following BAM-header line: {line}\n")
        elif line[:2] == "PG":
            if len(line) >= 15 and line[:15] == "PG\tID:otter\tOF:":
                columns = line[15:].split(",")
                if len(columns) == 1:
                    self.offset_l = int(columns[0])
                    self.offset_r = int(columns[0])
                elif len(columns) == 2:
                    self.offset_l = int(columns[0])
                    self.offset_r = int(columns[1])
                else:
                    sys.stderr.write(
                        f"({antimestamp()}): [ERROR] unable to parse offset value from "
                        f"the following BAM-header line: {line}\n")
                    raise SystemExit(1)

    def init(self, bam: str) -> None:
        self.offset_l = 1
        self.offset_r = 0
        rd = BamReader(bam, load_index=True)
        # replicate the char-walk tokenizer (anbamdb.cpp:47-55): '@' and '\n'
        # terminate tags, every other char accumulates
        tag = []
        for ch in rd.header_text:
            if ch != "@" and ch != "\n":
                tag.append(ch)
            elif tag:
                self._init_line("".join(tag))
                tag = []
        if tag:
            self._init_line("".join(tag))
        if not self.index2sample:
            sys.stderr.write(
                f"({antimestamp()}): [ERROR] unable to parse sample-name (read-group) "
                f"from the following BAM file{bam}\n")
            raise SystemExit(1)
        rd.close()
        for i, s in enumerate(self.index2sample):
            self.sample2index[s] = i
