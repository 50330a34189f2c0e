"""One run of one cell of the port's benchmark.

``BENCHMARK.json`` names the cell; the harness finds its deployment
(``configs/<name>.json`` by the file the spec gives), its mix
(``traffic/<traffic>.json``), its per-layer metrics
(``layer_metrics/<metric>.py``, each a ``read(ctx)``) and the spans of the
traced run (``spans.json``) by name, so a new cell, mix or metric is new
files and entries, not an edit.

The mix names its traffic generator (``generators/<generator>.py``,
``make(tmpdir, seed, config, traffic)``) and the deployment its entry
point (``entries/<entry>.py``: what a pass runs, the work it counts, the
plain reference and the comparison), so a new layout or entry point is a
new file too.

A run: the fixture from the seed, one untimed warm pass, then passes
until ``--seconds`` have gone by (a pass that starts before the deadline
finishes). A pass runs the program's entry once a sample, as its command
line does: it builds its engine and reads the inputs anew. After the
window the program's state is freed and the plain reference
(``reference/``) works out a seeded sample of the units, the longest
among them; every pass's output of those units is held to it.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import re
import shutil
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# the JAX stack and the JAX package, by whole top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "otter_tpu")


class BenchError(RuntimeError):
    pass


# -- the spec ------------------------------------------------------------------


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _listed(metric: dict, cell: dict, spec: dict) -> bool:
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if metric in spec["end_to_end"]:
        return True
    moved = next(m for m in spec["end_to_end"] if m["name"] == metric["moves"])
    return _listed(moved, cell, spec)


def load_cell(workload: str, root: str = ROOT,
              overrides: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json, with its
    deployment and mix read from their files (``overrides`` merged over
    them: the CPU tests' small sizes)."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    cell = next((c for c in spec["workloads"] if c["name"] == workload), None)
    if cell is None:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as fh:
        config = json.load(fh)
    bench = os.path.join(root, spec["paths"][0])
    with open(os.path.join(bench, "traffic", f"{cell['traffic']}.json")) as fh:
        traffic = json.load(fh)
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return Cell(workload, cell["chips"], config, traffic,
                [m for m in spec["end_to_end"] if _listed(m, cell, spec)],
                [m for m in spec["per_layer"] if _listed(m, cell, spec)])


def component(kind: str, name: str, root: str = ROOT):
    """The module ``<kind>/<name>.py`` of ``root``'s benchmark: a traffic
    generator (``generators``, named by a mix's ``generator``) or an entry
    point (``entries``, named by a deployment's ``entry``)."""
    path = os.path.join(root, "benchmark", kind, f"{name}.py")
    if not re.fullmatch(r"[A-Za-z0-9_]+", name) or not os.path.exists(path):
        raise BenchError(f"no {kind} module {name!r}")
    importlib.import_module(f"benchmark.{kind}")
    mod_name = f"benchmark.{kind}.{name}"
    if root == ROOT:
        return importlib.import_module(mod_name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = ROOT) -> Callable:
    """``read(ctx)`` of ``layer_metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "layer_metrics", f"{name}.py")
    mod_name = "benchmark_layer_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the traced window ----------------------------------------------------------


@dataclass
class LayerContext:
    """What a per-layer reader reads: the program's phases and counters
    over the traced window, the engines' cells, the work the inputs need,
    and the profiler's device activity."""
    snapshot: Dict[str, float]
    regions: int
    window_s: float
    busy_s: Optional[float]
    engine_cells: Optional[int]
    needed_cells: int
    needed_bytes: int
    sm_hz: float
    device_time: Dict[str, float] = field(default_factory=dict)

    def has_phase(self, name: str) -> bool:
        return f"time.{name}" in self.snapshot

    def phase(self, name: str) -> float:
        return self.snapshot.get(f"time.{name}", 0.0)

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(s for n, s in self.device_time.items() if match(n))


@contextmanager
def _spans(torch):
    """Wrap ``spans.json``'s layer entry points in record_function spans;
    the originals come back at exit."""
    with open(os.path.join(BENCH_DIR, "spans.json")) as fh:
        entries = json.load(fh)["spans"]
    saved = []
    for e in entries:
        mod = importlib.import_module(e["module"])
        orig = getattr(mod, e["function"])

        def wrapped(*a, _orig=orig, _name=e["function"], **kw):
            with torch.profiler.record_function(_name):
                return _orig(*a, **kw)

        saved.append((mod, e["function"], orig))
        setattr(mod, e["function"], wrapped)
    try:
        yield [e["function"] for e in entries]
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def _union(intervals):
    """Merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(prof, torch, span_names) -> dict:
    """Device busy seconds inside the window span, device seconds by
    kernel name, and the longest idle gaps labelled by the innermost
    harness span open on the host."""
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    spans = []
    device = []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == cuda:
            # a record_function span also leaves an annotation on the
            # card's timeline: no operation ran in it
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name in span_names or ev.name == "bench_window"):
                device.append((tr.start, tr.end, ev.name))
        elif ev.name == "bench_window":
            window = (tr.start, tr.end)
        elif ev.name in span_names:
            spans.append((tr.start, tr.end, ev.name))
    if window is None:
        raise BenchError("the profiler trace has no window span")
    w0, w1 = window
    by_name: Dict[str, float] = {}
    inside = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            inside.append((s, e))
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    merged = _union(inside)
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps = []
    at = w0
    for s, e in merged + [[w1, w1]]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    spans.sort()
    labelled = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (g0 + g1) / 2
        best = None
        for s, e, name in spans:
            if s > mid:
                break
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        labelled.append([best[2] if best else "outside_spans",
                         (g1 - g0) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy,
            "device_time": by_name,
            "breakdown": {"device_ops": [[n[:160], s] for n, s in ops],
                          "idle_gaps": labelled}}


# -- a run -----------------------------------------------------------------------


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             overrides: Optional[dict] = None, log=sys.stderr) -> dict:
    """One run; returns the result line's object. ``device`` is "cuda" on
    the card; the CPU tests pass "cpu", where the kernels' plain versions
    run and no device metric is read."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = load_cell(workload, overrides=overrides)
    import torch

    from otter_tpu_torch.utils import metrics

    from . import roofline

    generator = component("generators", cell.traffic["generator"])
    entry = component("entries", cell.config["entry"])
    on_card = device == "cuda"
    tmp = tempfile.mkdtemp(prefix="otter-bench-")
    try:
        fixture = generator.make(tmp, seed, cell.config, cell.traffic)
        n_units = entry.units(fixture)
        log.write(f"fixture: {len(fixture.samples)} samples, {n_units} "
                  f"{entry.UNITS}, {fixture.reads} reads, {fixture.bases} "
                  "bases\n")
        if on_card:
            log.write(f"card: {roofline.card_line()}\n")
        try:
            one_pass = entry.Pass(cell.config, fixture, device)
        except ValueError as exc:
            raise BenchError(str(exc)) from exc
        warm = one_pass()
        log.write(one_pass.stderr[-2000:])
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        outputs: list = []
        if trace:
            engines_cm = entry.engines()
            engines = engines_cm.__enter__()
            span_cm = _spans(torch)
            span_names = span_cm.__enter__()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            metrics.reset()
        try:
            with (torch.profiler.record_function("bench_window") if trace
                  else nullcontext()):
                w0 = time.perf_counter()
                deadline = w0 + seconds
                pass_s = []
                while not outputs or time.perf_counter() < deadline:
                    t_pass = time.perf_counter()
                    outputs.append(one_pass())
                    pass_s.append(time.perf_counter() - t_pass)
                if on_card:
                    torch.cuda.synchronize()
                w1 = time.perf_counter()
        finally:
            if trace:
                snapshot = metrics.snapshot()
                prof.__exit__(None, None, None)
                span_cm.__exit__(None, None, None)
                engines_cm.__exit__(None, None, None)
        window_s = w1 - w0
        passes = len(outputs)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        loaded = sorted({m.split(".")[0] for m in sys.modules}
                        & set(FORBIDDEN))
        if loaded:
            raise BenchError(f"modules of the JAX stack are loaded: {loaded}")

        if trace:
            traced = read_trace(prof, torch, set(span_names))
            engine_cells = entry.engine_cells(engines)
            prof = None
            engines.clear()
        one_pass = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # the reference, on the sample the seed draws
        keys = entry.picks(fixture, cell.traffic, seed)
        t_ref = time.perf_counter()
        stages: Dict[str, float] = {}
        want = entry.reference(cell.config, fixture, keys, device,
                               times=stages)
        ref_s = time.perf_counter() - t_ref
        bad = 0
        failed = 0      # the window's (pass, unit) pairs found wrong
        for k, got in enumerate([warm] + outputs):
            for key in keys:
                miss = entry.mismatched(got.get(key, []), want[key])
                bad += miss
                failed += bool(miss) and k > 0
        records = sum(len(v) for v in want.values())
        log.write(f"reference: {len(keys)} {entry.UNITS}, {records} records,"
                  f" {ref_s:.3f} s ("
                  + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
                  + ")\n")

        result = {"correct": bad == 0, "attempted": passes * n_units,
                  "failed": failed}
        if trace:
            sm_hz = roofline.sm_clock_hz() if on_card else 0.0
            m, n, d, bases = entry.needed(cell.config, fixture, device)
            layer_ctx = LayerContext(
                snapshot, passes * n_units, traced["window_s"],
                traced["busy_s"] if on_card else None, engine_cells,
                passes * roofline.needed_cells(m, n, d),
                passes * roofline.needed_bytes(bases, len(m)), sm_hz,
                traced["device_time"])
            values = {}
            for metric in cell.per_layer:
                v = metric_reader(metric["name"])(layer_ctx)
                if v is not None:
                    values[metric["name"]] = {"value": float(v),
                                              "unit": metric["unit"]}
            result["metrics"] = values
        else:
            rate = f"{entry.UNITS}_per_s"
            result["metrics"] = {
                rate: {"value": passes * n_units / window_s,
                       "unit": f"{entry.UNITS}/s"},
                "setup_s": {"value": setup_s, "unit": "s"}}
            result["metrics"] = {k: v for k, v in result["metrics"].items()
                                 if any(m["name"] == k
                                        for m in cell.end_to_end)}
        result["device"] = {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": cell.chips if on_card else 0,
            "memory_peak_bytes": int(peak)}
        if trace:
            result["device"]["busy_s"] = traced["busy_s"]
            result["device"]["window_s"] = traced["window_s"]
            result["breakdown"] = traced["breakdown"]
        result["compared"] = {
            "mismatched_records": {"value": bad, "limit": 0}}
        log.write("pass seconds " + " ".join(f"{t:.3f}" for t in pass_s)
                  + "\n")
        log.write(f"passes {passes} in {window_s:.3f} s, setup "
                  f"{setup_s:.3f} s; checked {len(keys)} {entry.UNITS} of "
                  f"{passes + 1} passes\n")
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
