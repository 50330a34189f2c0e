"""Condensed upper-triangle distance matrix (parity with src/andistmat.cpp).

Layout identical to hclust-cpp's condensed input: for n points, entry (i,j)
with i<j lives at index (2n-3-i)*i/2 + j - 1 (andistmat.cpp:20). Values
default to 1.0 (:10). Medoid = min row-sum with first-wins ties (:36-50).
"""

from __future__ import annotations

import functools
from typing import Iterable, List

import numpy as np

from .. import native


@functools.lru_cache(maxsize=256)
def triu_pair_indices(n: int):
    """Cached upper-triangle (i, j) index pair for (n, n) matrices — the
    condensed layout used across the clustering stack; rebuilt thousands of
    times per cohort otherwise."""
    iu, ju = np.triu_indices(n, k=1)
    iu.setflags(write=False)
    ju.setflags(write=False)
    return iu, ju


class DistMatrix:
    def __init__(self, n: int, values: np.ndarray | None = None):
        self.n = int(n)
        size = (self.n * (self.n - 1)) // 2
        if values is not None:
            self.values = np.asarray(values, dtype=np.float64)
            assert len(self.values) == size
        else:
            self.values = np.full(size, 1.0, dtype=np.float64)

    def _index(self, i: int, j: int) -> int:
        if i == j:
            raise ValueError("diagonal access")
        a, b = (i, j) if i < j else (j, i)
        return ((2 * self.n - 3 - a) * a >> 1) + b - 1

    def set_dist(self, i: int, j: int, d: float) -> None:
        self.values[self._index(i, j)] = d
        self._square_cache = None  # in-place write: identity check blind

    def get_dist(self, i: int, j: int) -> float:
        return float(self.values[self._index(i, j)])

    def get_medoid(self, indeces: Iterable[int]) -> int:
        """Min-row-sum medoid (andistmat.cpp:36-50). Vectorized with the
        scalar loop's exact float64 accumulation: sums advance one j at a
        time across all rows (the i==j skip is an exact +0.0), and
        np.argmin keeps the scalar loop's first-strict-min winner."""
        idx = list(indeces)
        if len(idx) <= 2:
            return idx[0]
        ia = np.asarray(idx, dtype=np.int64)
        if (self.n >= 64 or len(idx) >= 64) and native.enabled("MEDOID"):
            # condensed-space C++ row sums (exact accumulation order, see
            # otter_medoid_sums): no (n, n) square is materialized — the
            # to_square below dominated the 1001-allele cohort medoid
            # remap. argmin stays numpy (NaN propagation semantics).
            sums = native.medoid_sums_native(self.values, self.n, ia)
            return idx[int(np.argmin(sums))]
        sub = self.to_square()[np.ix_(ia, ia)]  # 0.0 diagonal
        # cumsum is a sequential left-to-right accumulation per row — the
        # exact f64 addition order of the scalar j-loop (starting from an
        # explicit 0.0, hence the zero column), in one numpy call
        zero = np.zeros((len(idx), 1), dtype=np.float64)
        sums = np.concatenate([zero, sub], axis=1).cumsum(axis=1)[:, -1]
        return idx[int(np.argmin(sums))]

    @classmethod
    def from_square(cls, sq: np.ndarray) -> "DistMatrix":
        n = sq.shape[0]
        dm = cls(n)
        dm.values = np.ascontiguousarray(sq[triu_pair_indices(n)],
                                         dtype=np.float64)
        return dm

    def to_square(self) -> np.ndarray:
        # cached per values-array identity: medoid calls cluster-by-cluster
        # on the same matrix, and rebuilding the square dominates them
        cached = getattr(self, "_square_cache", None)
        if cached is not None and cached[0] is self.values:
            return cached[1]
        sq = np.zeros((self.n, self.n), dtype=np.float64)
        sq[triu_pair_indices(self.n)] = self.values
        sq += sq.T
        self._square_cache = (self.values, sq)
        return sq
