"""Centered interval tree, a faithful port of the vendored interval_tree.h
(E. Garrison) used by wgat (src/wgat.cpp:41,64).

Traversal order matters for output line order, so construction mirrors the
original: center = (min start + max stop)/2, intervals sorted by start,
leaf when depth exhausted or fewer than minbucket intervals, node keeps
center-crossing intervals, left/right recurse. ``find_overlapping`` uses the
same inclusive [start, stop] overlap test and visit order
(node -> left -> right).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional


@dataclass
class Interval:
    start: int
    stop: int
    value: Any

    def __init__(self, s: int, e: int, v: Any):
        self.start = min(s, e)
        self.stop = max(s, e)
        self.value = v


class IntervalTree:
    def __init__(self, ivals: Optional[List[Interval]] = None, depth: int = 16,
                 minbucket: int = 64, maxbucket: int = 512,
                 leftextent: int = 0, rightextent: int = 0):
        self.left: Optional[IntervalTree] = None
        self.right: Optional[IntervalTree] = None
        self.center = 0
        self.intervals: List[Interval] = []
        if not ivals:
            return
        depth -= 1
        min_start = min(i.start for i in ivals)
        max_stop = max(i.stop for i in ivals)
        self.center = (min_start + max_stop) // 2
        ivals = sorted(ivals, key=lambda i: i.start)
        if depth == 0 or (len(ivals) < minbucket and len(ivals) < maxbucket):
            self.intervals = ivals
            return
        lefts: List[Interval] = []
        rights: List[Interval] = []
        for iv in ivals:
            if iv.stop < self.center:
                lefts.append(iv)
            elif iv.start > self.center:
                rights.append(iv)
            else:
                self.intervals.append(iv)
        if lefts:
            self.left = IntervalTree(lefts, depth, minbucket, maxbucket,
                                     lefts[0].start, self.center)
        if rights:
            self.right = IntervalTree(rights, depth, minbucket, maxbucket,
                                      self.center, max(i.stop for i in rights))

    def _visit_near(self, start: int, stop: int, f) -> None:
        if self.intervals and not (stop < self.intervals[0].start):
            for iv in self.intervals:
                f(iv)
        if self.left is not None and start <= self.center:
            self.left._visit_near(start, stop, f)
        if self.right is not None and stop >= self.center:
            self.right._visit_near(start, stop, f)

    def find_overlapping(self, start: int, stop: int) -> List[Interval]:
        out: List[Interval] = []

        def f(iv: Interval) -> None:
            if iv.stop >= start and iv.start <= stop:
                out.append(iv)

        self._visit_near(start, stop, f)
        return out
