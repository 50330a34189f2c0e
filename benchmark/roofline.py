"""The distance kernels' bound: the least time the card could take for
the all-vs-all work the inputs need, whatever implements it.

The arithmetic is copied from ``chip_smoke.py::bound`` at commit eda140f
(``OPS_PER_CELL``, ``INT32_LANES``, ``HBM_BYTES_PER_S``, the SM clock from
``nvidia-smi``); what it counts is not the implementation's cells but the
cells the inputs need. A pair of lengths m <= n at edit distance d is
proven by the band of diagonals [-p, (n - m) + p] with
p = ceil((d - (n - m)) / 2): any path leaving it costs more than d. So it
needs n * min(m, (n - m) + 2 p + 1) cells, at 36 int32 operations a
64-cell word of bit-parallel Myers, over 132 SMs x 64 int32 lanes at the
card's highest SM clock. Its bytes are each distinct read's bases once and
4 bytes a distance, at 3.35 TB/s. The larger of the two times bounds it.
"""

from __future__ import annotations

import subprocess

import numpy as np

OPS_PER_CELL = 36 / 64
INT32_LANES = 132 * 64
HBM_BYTES_PER_S = 3.35e12


def needed_cells(m: np.ndarray, n: np.ndarray, d: np.ndarray) -> int:
    """DP cells the pairs (m <= n, distance d) need, summed."""
    m = np.asarray(m, dtype=np.int64)
    n = np.asarray(n, dtype=np.int64)
    d = np.asarray(d, dtype=np.int64)
    delta = n - m
    p = (np.maximum(d - delta, 0) + 1) // 2
    return int((n * np.minimum(m, delta + 2 * p + 1)).sum())


def needed_bytes(bases: int, pairs: int) -> int:
    return int(bases) + 4 * int(pairs)


def bound_seconds(cells: float, moved: float, sm_hz: float):
    """(least seconds, what bounds it)."""
    t_ops = cells * OPS_PER_CELL / (INT32_LANES * sm_hz)
    t_bytes = moved / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sm_clock_hz() -> float:
    """The card's highest SM clock, from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def card_line() -> str:
    """The card's name and power limit, from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
