"""CIGAR -> parallel (reference interval, query OpInterval) vectors.

Parity with src/opinterval.cpp:12-34 (``get_op_intervals``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..io.bam import (
    BAM_CDEL,
    BAM_CDIFF,
    BAM_CEQUAL,
    BAM_CINS,
    BAM_CMATCH,
    BAM_CSOFT_CLIP,
    BamRecord,
)


@dataclass
class OpInterval:
    start: int = 0
    end: int = 0
    op: int = 0


def get_op_intervals(rec: BamRecord) -> Tuple[List[Tuple[int, int]], List[OpInterval]]:
    ref_intervals: List[Tuple[int, int]] = []
    op_intervals: List[OpInterval] = []
    rpos = rec.pos
    rpos_acc = rpos
    qpos = 0
    qpos_acc = 0
    for ol, op in rec.cigar:
        if op == BAM_CSOFT_CLIP:
            qpos_acc += ol
        elif op in (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF):
            rpos_acc += ol
            qpos_acc += ol
        elif op == BAM_CINS:
            qpos_acc += ol
        elif op == BAM_CDEL:
            rpos_acc += ol
        ref_intervals.append((rpos, rpos_acc))
        op_intervals.append(OpInterval(qpos, qpos_acc, op))
        rpos = rpos_acc
        qpos = qpos_acc
    return ref_intervals, op_intervals
