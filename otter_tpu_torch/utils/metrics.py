"""Lightweight observability: a tree of timed spans, and counters.

The reference has no tracing at all (SURVEY.md §5 — timestamped stderr lines
only). Here every workload can account regions/sec, pair-alignment counts,
and where each pass's time goes; a summary is printed to stderr at exit when
``OTTER_TPU_METRICS=1``.

``with phase(name):`` opens a span. Spans nest a thread at a time: on exit a
span adds its duration to ``time.<name>`` (inclusive) and its duration less
its child spans' to ``self.<name>``, so the self times of a tree add up to
its root's time. While a ``torch.profiler`` is active each span is also a
``record_function("otter.<name>")`` range, on the clock of the profiler's
device trace; with none active no range is opened. ``to_host`` is the one
blocking device-to-host read: span ``device_wait``, counter
``device_syncs``. ``io/bgzf.py`` counts each BGZF block it inflates in
``bgzf_inflates``; ``kernels/affine_tb.py`` each consensus member it is
given in ``affine_cigar_members``, and each whose cigar it reads from K5 /
K6's bytes in ``affine_card_cigars``.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

_times: Dict[str, float] = defaultdict(float)
_self: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_enabled = os.environ.get("OTTER_TPU_METRICS", "") == "1"
# the innermost open span of each thread (``_local.top``)
_local = threading.local()
_profiling = torch.autograd._profiler_enabled


def add(counter: str, n: int = 1) -> None:
    _counts[counter] += n


def reset() -> None:
    """Clear accumulated timers/counters (profiling: isolate a steady-state
    pass from warmup/compile time). A span still open stays open and adds
    its whole duration when it closes."""
    _times.clear()
    _self.clear()
    _counts.clear()


def snapshot() -> Dict[str, float]:
    out: Dict[str, float] = {f"time.{k}": v for k, v in _times.items()}
    out.update({f"self.{k}": v for k, v in _self.items()})
    out.update({f"count.{k}": float(v) for k, v in _counts.items()})
    return out


class phase:
    """``with phase(name):`` times one span under the innermost span this
    thread has open."""

    __slots__ = ("name", "_t0", "_child", "_parent", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "phase":
        self._parent = getattr(_local, "top", None)
        _local.top = self
        self._child = 0.0
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function("otter." + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dur = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        _times[self.name] += dur
        _self[self.name] += dur - self._child
        if self._parent is not None:
            self._parent._child += dur
        _local.top = self._parent


def to_host(tensor: torch.Tensor) -> np.ndarray:
    """``tensor.cpu().numpy()``: the read waits for the device."""
    with phase("device_wait"):
        out = tensor.cpu().numpy()
    _counts["device_syncs"] += 1
    return out


def summary() -> str:
    lines = ["otter-tpu metrics:"]
    for name in sorted(_times):
        lines.append(f"  time.{name}: {_times[name]:.3f}s "
                     f"(self {_self[name]:.3f}s)")
    for name in sorted(_counts):
        lines.append(f"  count.{name}: {_counts[name]}")
    t = _times.get("assemble", 0.0)
    n = _counts.get("regions", 0)
    if t > 0 and n > 0:
        lines.append(f"  regions_per_sec: {n / t:.2f}")
    return "\n".join(lines)


def _dump():
    if _enabled and (_times or _counts):
        sys.stderr.write(summary() + "\n")


atexit.register(_dump)
