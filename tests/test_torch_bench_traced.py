"""A traced benchmark run of each cell on the CPU, at the small sizes of
the benchmark's own CPU tests (``benchmark/tests/conftest.py::TINY``), in
a fresh process (the harness refuses a process with JAX loaded): every
per-layer metric that can read on the CPU reads a number, the span
readers included."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOADS = ("hifi30x.catalog", "panel200x.expansions")
# read from the profiler's device trace: only on the card
DEVICE_TRACE = {"device_idle_pct", "dist_roofline_pct"}
SPAN_READERS = ("extract_ms_per_region", "realign_ms_per_region",
                "ladder_ms_per_region", "device_wait_ms_per_region",
                "device_syncs_per_region", "affine_ladder_ms_per_region",
                "untraced_ms_per_region")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_reads_every_metric(workload):
    code = (
        "import io, json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'benchmark', 'tests')!r})\n"
        "from conftest import TINY\n"
        "from benchmark.harness import run_cell\n"
        f"r = run_cell({workload!r}, 4100000019, 0.1, True, 'cpu',"
        f" overrides=TINY[{workload!r}], log=io.StringIO())\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    listed = {m["name"] for m in spec["per_layer"]
              if workload in m.get("workloads", [workload])}
    assert r["correct"]
    assert set(SPAN_READERS) <= listed
    assert set(r["metrics"]) == listed - DEVICE_TRACE
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert (m["extract_ms_per_region"] + m["realign_ms_per_region"]
            <= m["host_io_ms_per_region"])
    assert m["affine_ladder_ms_per_region"] <= m["consensus_ms_per_region"]
    assert m["device_syncs_per_region"] > 0
