"""Nothing the benchmark runs loads JAX or the JAX package; the reference
reads nothing of the program; without a card, or without the program, a
run fails and prints no result."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _imports(path: str):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_in_any_source():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "otter_tpu"}, path


def test_reference_imports_nothing_of_the_program():
    paths = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    paths += glob.glob(os.path.join(BENCH, "fixtures", "*.py"))
    paths += glob.glob(os.path.join(BENCH, "generators", "*.py"))
    paths += [os.path.join(BENCH, "roofline.py")]
    for path in paths:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "otter_tpu_torch" not in tops, path


def test_cpu_run_loads_no_jax():
    """A whole run of a small cell on the CPU in a fresh process, then its
    modules by whole top-level name."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {BENCH + '/tests'!r})\n"
        "from conftest import TINY\n"
        "from benchmark.harness import run_cell\n"
        "r = run_cell('hifi30x.catalog', 5, 0.5, False, 'cpu',"
        " overrides=TINY['hifi30x.catalog'], log=open('/dev/null', 'w'))\n"
        "assert r['correct'], r\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps(tops))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "otter_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "otter_tpu"}


def _run(cwd: str):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "hifi30x.catalog",
         "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=cwd)


def test_run_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card exit cannot be reached")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's own
    files has no program to run."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
