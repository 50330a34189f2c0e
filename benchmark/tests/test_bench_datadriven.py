"""A new deployment, mix, traffic generator, entry point and per-layer
metric are new files and new entries in BENCHMARK.json: the harness finds
them by name, and no file it already had changes."""

import hashlib
import json
import os
import shutil

from benchmark.harness import (LayerContext, component, load_cell,
                               metric_reader)

from conftest import ROOT


def _hashes(root):
    out = {}
    for d, _dirs, files in os.walk(os.path.join(root, "benchmark")):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _hashes(root)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "hifi-wgs-30x.json")) as fh:
        cfg = json.load(fh)
    cfg["coverage"] = 20
    cfg["reduced"] = ["loci", "coverage"]
    cfg["entry"] = "assemble_twice"
    with open(os.path.join(bench, "configs", "hifi-wgs-20x.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(bench, "traffic", "catalog_dense.json"),
              "w") as fh:
        json.dump({"generator": "tiled_wgs_short", "spacing": 3000,
                   "ref_len": [40, 800], "ref_spread": "log_uniform",
                   "motif_len": [2, 6], "impurity": 0.02, "het_share": 0.5,
                   "alt_units": [1, 10], "check_regions": 16}, fh)
    with open(os.path.join(bench, "generators", "tiled_wgs_short.py"),
              "w") as fh:
        fh.write("from .tiled_wgs import make as _make\n"
                 "def make(tmpdir, seed, config, traffic):\n"
                 "    return _make(tmpdir, seed, dict(config,"
                 " read_len_mean=5000), traffic)\n")
    with open(os.path.join(bench, "entries", "assemble_twice.py"),
              "w") as fh:
        fh.write("from .assemble import *  # noqa\n"
                 "from .assemble import Pass as _Pass\n"
                 "def units(fixture):\n"
                 "    return 2 * len(fixture.loci)\n")
    with open(os.path.join(bench, "layer_metrics", "host_io_share_pct.py"),
              "w") as fh:
        fh.write("def read(ctx):\n"
                 "    total = ctx.phase('region_total')\n"
                 "    return 100 * ctx.phase('host_io') / total if total"
                 " else None\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "hifi-wgs-20x", "source": "x",
                            "file": "benchmark/configs/hifi-wgs-20x.json",
                            "reduced": ["loci", "coverage"], "why": "x"})
    spec["workloads"].append({"name": "hifi20x.dense",
                              "config": "hifi-wgs-20x",
                              "traffic": "catalog_dense", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "host_io_share_pct", "unit": "%",
                              "better": "lower", "source": "program_span",
                              "layer": "x", "moves": "regions_per_s",
                              "workloads": ["hifi20x.dense"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)

    cell = load_cell("hifi20x.dense", root=root)
    assert cell.config["coverage"] == 20
    assert cell.traffic["spacing"] == 3000
    gen = component("generators", cell.traffic["generator"], root=root)
    entry = component("entries", cell.config["entry"], root=root)
    assert gen.make.__module__ == "benchmark.generators.tiled_wgs_short"
    assert entry.units(type("F", (), {"loci": [1, 2, 3]})) == 6
    assert [m["name"] for m in cell.per_layer] == ["host_io_share_pct"]
    assert [m["name"] for m in cell.end_to_end] == ["regions_per_s",
                                                    "setup_s"]
    read = metric_reader("host_io_share_pct", root=root)
    ctx = LayerContext({"time.host_io": 1.0, "time.region_total": 4.0}, 10,
                       1.0, None, None, 0, 0, 0.0)
    assert read(ctx) == 25.0
    old = load_cell("hifi30x.catalog", root=root)
    assert "host_io_share_pct" not in [m["name"] for m in old.per_layer]
    after = _hashes(root)
    assert {k: v for k, v in after.items() if k in before} == before
