"""Lightweight observability: phase timers + counters.

The reference has no tracing at all (SURVEY.md §5 — timestamped stderr lines
only). Here every workload can account regions/sec, pair-alignment counts,
and device dispatch time; a summary is printed to stderr at exit when
``OTTER_TPU_METRICS=1``.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict

_times: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_enabled = os.environ.get("OTTER_TPU_METRICS", "") == "1"


def add(counter: str, n: int = 1) -> None:
    _counts[counter] += n


def reset() -> None:
    """Clear accumulated timers/counters (profiling: isolate a steady-state
    pass from warmup/compile time)."""
    _times.clear()
    _counts.clear()


def snapshot() -> Dict[str, float]:
    out: Dict[str, float] = {f"time.{k}": v for k, v in _times.items()}
    out.update({f"count.{k}": float(v) for k, v in _counts.items()})
    return out


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _times[name] += time.perf_counter() - t0


def summary() -> str:
    lines = ["otter-tpu metrics:"]
    for name in sorted(_times):
        lines.append(f"  time.{name}: {_times[name]:.3f}s")
    for name in sorted(_counts):
        lines.append(f"  count.{name}: {_counts[name]}")
    t = _times.get("region_total", 0.0)
    n = _counts.get("regions", 0)
    if t > 0 and n > 0:
        lines.append(f"  regions_per_sec: {n / t:.2f}")
    return "\n".join(lines)


def _dump():
    if _enabled and (_times or _counts):
        sys.stderr.write(summary() + "\n")


atexit.register(_dump)
