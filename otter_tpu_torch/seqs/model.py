"""Read/allele data model + SAM/FASTA emission with aux tags.

Parity with reference src/anseqs.{hpp,cpp}: ANREAD (anseqs.hpp:56-76),
ANALLELE (:40-54), HAPLOTAG (:29-38), tag constants (anseqs.cpp:9-19),
spanning tag values b/l/r/n (:21-27), SAM/FASTA emission (:42-106).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..utils.fmt import fmt_double, fmt_float

PS_TAG, HP_TAG, RQ_TAG, RG_TAG = "PS", "HP", "rq", "RG"
TA_TAG, TC_TAG, AC_TAG, SC_TAG = "ta", "tc", "ac", "sc"
SE_TAG, SP_TAG, IC_TAG = "se", "sp", "ic"


def spanning_tag_value(is_spanning_l: bool, is_spanning_r: bool) -> str:
    if is_spanning_l and is_spanning_r:
        return "b"
    if is_spanning_l:
        return "l"
    if is_spanning_r:
        return "r"
    return "n"


@dataclass(slots=True)
class Haplotag:
    ps: int = -1
    hp: int = -1

    def is_defined(self) -> bool:
        return self.ps >= 0 and self.hp >= 0

    def __eq__(self, other) -> bool:
        return self.ps == other.ps and self.hp == other.hp

    def __ne__(self, other) -> bool:
        return self.ps != other.ps or self.hp != other.hp


@dataclass(slots=True)
class AnRead:
    seq: str = ""
    name: str = ""
    rq: float = 0.0
    is_spanning_l: bool = False
    is_spanning_r: bool = False
    hpt: Haplotag = field(default_factory=Haplotag)
    ccoords: Tuple[int, int] = (-1, -1)

    def is_spanning(self) -> bool:
        return self.is_spanning_l and self.is_spanning_r

    def set_is_spanning(self) -> None:
        self.is_spanning_l = True
        self.is_spanning_r = True

    def to_sam(self, chr: str, start: int, end: int, rg: str) -> str:
        """SAM line with ta/sp/PS/HP/rq tags (anseqs.cpp:83-97)."""
        out = [
            f"{self.name}\t0\t{chr}\t{start}\t0\t{len(self.seq)}M\t*\t0\t0\t"
            f"{self.seq}\t{'!' * len(self.seq)}"
        ]
        if rg:
            out.append(f"\t{RG_TAG}:Z:{rg}")
        out.append(f"\t{TA_TAG}:Z:{chr}:{start}-{end}\t{SP_TAG}:A:")
        out.append(spanning_tag_value(self.is_spanning_l, self.is_spanning_r))
        if self.hpt.ps >= 0:
            out.append(f"\t{PS_TAG}:i:{self.hpt.ps}")
        if self.hpt.hp >= 0:
            out.append(f"\t{HP_TAG}:i:{self.hpt.hp}")
        # rq is a C++ double (ANREAD.rq) streamed directly (anseqs.cpp:95);
        # its value came from a float aux tag so it is float32-representable
        out.append(f"\t{RQ_TAG}:f:{fmt_double(self.rq)}")
        return "".join(out)

    def to_fa(self, region: str) -> str:
        """FASTA entry with '#'-joined tags (anseqs.cpp:99-106)."""
        out = [f">{self.name}#{region}"]
        out.append(f"#{SP_TAG}:A:{spanning_tag_value(self.is_spanning_l, self.is_spanning_r)}")
        if self.hpt.ps >= 0:
            out.append(f"#{PS_TAG}:i:{self.hpt.ps}")
        if self.hpt.hp >= 0:
            out.append(f"#{HP_TAG}:i:{self.hpt.hp}")
        out.append(f"\n{self.seq}")
        return "".join(out)


@dataclass(slots=True)
class AnAllele:
    seq: str = ""
    scov: int = 1
    acov: int = 1
    tcov: int = 1
    se: float = 0.0
    ic: int = 1
    hpt: Haplotag = field(default_factory=lambda: Haplotag(-1, -1))

    def to_sam(self, name: str, chr: str, start: int, end: int, rg: str,
               is_read: bool = False, is_spanning_l: bool = False,
               is_spanning_r: bool = False) -> str:
        """SAM line with RG/ta/tc/ac/sc[/sp]/ic/se[/PS/HP] tags (anseqs.cpp:42-54)."""
        out = [
            f"{name}\t0\t{chr}\t{start}\t0\t{len(self.seq)}M\t*\t0\t0\t"
            f"{self.seq}\t{'!' * len(self.seq)}"
        ]
        if rg:
            out.append(f"\t{RG_TAG}:Z:{rg}")
        out.append(
            f"\t{TA_TAG}:Z:{chr}:{start}-{end}\t{TC_TAG}:i:{self.tcov}"
            f"\t{AC_TAG}:i:{self.acov}\t{SC_TAG}:i:{self.scov}"
        )
        if is_read:
            out.append(f"\t{SP_TAG}:A:{spanning_tag_value(is_spanning_l, is_spanning_r)}")
        out.append(f"\t{IC_TAG}:i:{self.ic}")
        out.append(f"\t{SE_TAG}:f:{fmt_float(self.se)}")
        if self.hpt.ps >= 0:
            out.append(f"\t{PS_TAG}:i:{self.hpt.ps}")
        if self.hpt.hp >= 0:
            out.append(f"\t{HP_TAG}:i:{self.hpt.hp}")
        return "".join(out)

    def to_fa(self, name: str, region: str, is_read: bool = False,
              is_spanning_l: bool = False, is_spanning_r: bool = False) -> str:
        """FASTA entry with '#'-joined tags (anseqs.cpp:56-63)."""
        out = [
            f">{name}#{region}#{TC_TAG}:i:{self.tcov}"
            f"#{AC_TAG}:i:{self.acov}#{SC_TAG}:i:{self.scov}"
        ]
        if is_read:
            out.append(f"#{SP_TAG}:A:{spanning_tag_value(is_spanning_l, is_spanning_r)}")
        if self.hpt.ps >= 0:
            out.append(f"#{PS_TAG}:i:{self.hpt.ps}")
        if self.hpt.hp >= 0:
            out.append(f"#{HP_TAG}:i:{self.hpt.hp}")
        out.append(f"\n{self.seq}")
        return "".join(out)
