"""CIGAR-walk projection of region coordinates onto the query.

Exact semantics port of the subtlest pure logic in the reference:
``get_breakpoints`` (src/anseqs.cpp:286-408) and ``parse_alignment``
(src/anseqs.cpp:412-435), including the clip-readjustment rules and the
spanning-status transfer (PARSEMSG, src/anseqs.cpp:218-239).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional, Tuple

from ..io.bam import (
    BAM_CDEL,
    BAM_CDIFF,
    BAM_CEQUAL,
    BAM_CHARD_CLIP,
    BAM_CINS,
    BAM_CMATCH,
    BAM_CSOFT_CLIP,
    BamRecord,
)
from ..utils.timestamp import antimestamp
from .model import AnRead


@dataclass
class ParseMsg:
    successful: bool = True
    spanning_l: bool = True
    spanning_r: bool = True
    alignment_coords: Tuple[int, int] = (-1, -1)

    def is_spanning(self) -> bool:
        return self.spanning_l and self.spanning_r

    def transfer_status(self, anread: AnRead) -> None:
        # anseqs.cpp:233-239 — note the elif chain (only one side set otherwise)
        if self.is_spanning():
            anread.set_is_spanning()
        elif self.spanning_l:
            anread.is_spanning_l = True
        elif self.spanning_r:
            anread.is_spanning_r = True
        anread.ccoords = self.alignment_coords


def get_breakpoints(start: int, end: int, rec: BamRecord,
                    msg: ParseMsg) -> Optional[Tuple[int, int]]:
    """Project region [start, end] to query coords; returns subseq (qlo, qhi).

    Walks every aligned base tracking the query positions closest to the
    region start/end on the reference (anseqs.cpp:299-343), then applies the
    non-spanning/deleted-region special cases (:346-360) and the
    clipped-alignment readjustments (:364-390). Returns None when the
    alignment does not span either coordinate (msg.successful False).
    """
    clipped_l = False
    clipped_r = False
    qstart_dist = -1
    qend_dist = -1
    leftmost_q = -1
    rightmost_q = -1
    leftmost_r = -1
    rightmost_r = -1
    qstart_q = -1
    qend_q = -1
    qstart_cigar_i = 0
    qend_cigar_i = 0
    cigar = rec.cigar
    n_cigar = len(cigar)
    rpos = rec.pos
    qpos = 0
    for i in range(n_cigar):
        ol, op = cigar[i]
        if op in (BAM_CHARD_CLIP, BAM_CSOFT_CLIP):
            if i == 0:
                clipped_l = True
            if i == n_cigar - 1:
                clipped_r = True
            if op == BAM_CSOFT_CLIP:
                qpos += ol
        elif op in (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF):
            # vectorizable closed-form per-op update of the scalar walk
            # (anseqs.cpp:308-339): positions rpos..rpos+ol-1 map to
            # qpos..qpos+ol-1 monotonically.
            if leftmost_q == -1:
                leftmost_q = qpos
                leftmost_r = rpos
            last_r = rpos + ol - 1
            if rightmost_q == -1 or last_r > rightmost_r:
                rightmost_q = qpos + (last_r - rpos)
                rightmost_r = last_r
            # closest ref position >= start within [rpos, last_r]
            if last_r >= start:
                cand_r = rpos if rpos >= start else start
                cstart_dist = cand_r - start
                if cstart_dist >= 0 and (qstart_dist < 0 or cstart_dist < qstart_dist):
                    qstart_dist = cstart_dist
                    qstart_q = qpos + (cand_r - rpos)
                    qstart_cigar_i = i
            # closest ref position <= end within [rpos, last_r]
            if rpos <= end:
                cand_r = last_r if last_r <= end else end
                cend_dist = end - cand_r
                if cend_dist >= 0 and (qend_dist < 0 or cend_dist < qend_dist):
                    qend_dist = cend_dist
                    qend_q = qpos + (cand_r - rpos)
                    qend_cigar_i = i
            rpos += ol
            qpos += ol
        elif op == BAM_CINS:
            qpos += ol
        elif op == BAM_CDEL:
            rpos += ol

    if rightmost_r < start or leftmost_r > end:
        # alignment does not span either start/end coord (anseqs.cpp:346-352)
        msg.successful = False
        msg.spanning_l = False
        msg.spanning_r = False
        return None
    if qstart_q > -1 and qend_q > -1 and qstart_q > qend_q:
        # region deleted in the read (anseqs.cpp:354-360)
        qstart_q = -1
        qend_q = -1
        msg.successful = True
        msg.spanning_l = True
        msg.spanning_r = True
    else:
        msg.alignment_coords = (qstart_q, qend_q)
        # readjust if alignment is clipped on the left (anseqs.cpp:364-376)
        if leftmost_r > start and clipped_l and qstart_cigar_i == 1:
            while qstart_q > 0 and qstart_cigar_i > 0:
                ol, op = cigar[qstart_cigar_i - 1]
                if op == BAM_CDEL:
                    qstart_cigar_i -= 1
                elif op in (BAM_CHARD_CLIP, BAM_CSOFT_CLIP, BAM_CINS):
                    qstart_q -= ol
                    qstart_cigar_i -= 1
                else:
                    break
        # readjust if alignment is clipped on the right (anseqs.cpp:378-390)
        # note: the reference reads cigar[qend_cigar_i - 1] here (as written)
        if rightmost_r < end and clipped_r and qend_cigar_i == n_cigar - 1:
            while qend_q < rec.l_qseq - 1 and qend_cigar_i < n_cigar:
                ol, op = cigar[qend_cigar_i - 1]
                if op == BAM_CDEL:
                    qend_cigar_i += 1
                elif op in (BAM_CHARD_CLIP, BAM_CSOFT_CLIP, BAM_CINS):
                    qend_q += ol
                    qend_cigar_i += 1
                else:
                    break
        msg.spanning_l = leftmost_q >= 0 and leftmost_r <= start
        msg.spanning_r = rightmost_q >= 0 and rightmost_r >= end
        msg.successful = True

    # final query window by spanning status (anseqs.cpp:397-406)
    if msg.spanning_l and msg.spanning_r:
        return (qstart_q, qend_q)
    if msg.spanning_l:
        return (qstart_q, rec.l_qseq)
    if msg.spanning_r:
        return (0, qend_q)
    return (0, rec.l_qseq)


def parse_alignment(rstart: int, rend: int, rec: BamRecord,
                    msg: ParseMsg) -> str:
    """Extract the region subsequence of a read (anseqs.cpp:412-435)."""
    query = get_breakpoints(rstart, rend, rec, msg)
    if not msg.successful:
        return ""
    qlo, qhi = query
    if (qlo == -1) != (qhi == -1):
        sys.stderr.write(
            f"({antimestamp()}): ERROR: unexpected querty start/end coords found "
            f"for read {rec.name}\n"
        )
        raise SystemExit(1)
    if qlo == -1 or rec.l_qseq < (qhi - qlo):
        return "N"
    l_og = msg.alignment_coords[1] - msg.alignment_coords[0]
    new_first = msg.alignment_coords[0] - qlo
    msg.alignment_coords = (new_first, new_first + l_og)
    seq = rec.seq[qlo:qhi]
    return seq if seq else "N"
