"""The needed work and the bound, on pairs worked by hand."""

import random

import numpy as np
import pytest

from benchmark import roofline
from benchmark.reference import dp


@pytest.mark.parametrize("m, n, d, cells", [
    (10, 10, 2, 30),        # delta 0, p 1: 3 diagonals
    (5, 8, 3, 32),          # delta 3, p 0: 4 diagonals, 8 columns
    (4, 4, 3, 16),          # p 2: 5 diagonals, capped at m = 4
    (100, 110, 15, 1870),   # delta 10, p 3: 17 diagonals
    (7, 7, 0, 7),           # identical lengths and bases: one diagonal
])
def test_needed_cells_by_hand(m, n, d, cells):
    assert roofline.needed_cells([m], [n], [d]) == cells


def test_needed_cells_sum():
    assert roofline.needed_cells([10, 5], [10, 8], [2, 3]) == 62


def _banded(x: str, y: str, lo: int, hi: int) -> int:
    """Edit distance over the diagonals [lo, hi] only (plain Python)."""
    big = 1 << 30
    m, n = len(x), len(y)
    prev = [j if lo <= j <= hi else big for j in range(n + 1)]
    for i in range(1, m + 1):
        cur = [big] * (n + 1)
        for j in range(n + 1):
            if not lo <= j - i <= hi:
                continue
            if j == 0:
                cur[j] = i
                continue
            cur[j] = min(prev[j - 1] + (x[i - 1] != y[j - 1]), prev[j] + 1,
                         cur[j - 1] + 1)
        prev = cur
    return prev[n]


def test_needed_band_proves_the_distance():
    """The band the count assumes holds an optimal path: the banded DP
    over it gives the full distance."""
    rnd = random.Random(4)
    for _ in range(60):
        m = rnd.randint(1, 30)
        n = m + rnd.randint(0, 8)
        x = "".join(rnd.choice("ACGT") for _ in range(m))
        y = "".join(rnd.choice("ACGT") for _ in range(n))
        d = int(dp.edit_distances([(x, y)], "cpu")[0])
        delta = n - m
        p = (max(d - delta, 0) + 1) // 2
        assert _banded(x, y, -p, delta + p) == d


def test_bound_by_hand():
    hz = 1.98e9
    cells = roofline.INT32_LANES * hz * 64 / 36    # one second of operations
    t, by = roofline.bound_seconds(cells, 1e9, hz)
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = roofline.bound_seconds(1.0, 3.35e12 * 2, hz)
    assert t == pytest.approx(2.0) and by == "bytes"
    assert roofline.needed_bytes(1000, 10) == 1040


def test_shares_stay_below_one():
    """No implementation of the pairs' work can take less than the bound:
    a kernel that computes exactly the needed cells at the card's full
    int32 rate reads 100%."""
    m = np.array([300, 7000])
    n = np.array([320, 7100])
    d = np.array([25, 160])
    cells = roofline.needed_cells(m, n, d)
    hz = 1.98e9
    t, _ = roofline.bound_seconds(cells, roofline.needed_bytes(14720, 2), hz)
    kernel = cells * roofline.OPS_PER_CELL / (roofline.INT32_LANES * hz)
    assert t / kernel == pytest.approx(1.0)
