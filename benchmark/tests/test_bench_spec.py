"""BENCHMARK.json keeps to the benchmark's contract: its names, units and
keys, and a file for every configuration, mix and per-layer metric."""

import json
import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in spec["paths"])
    assert len(spec["command"]) <= 32
    assert all(_line(w) for w in spec["command"])
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units():
    spec = _spec()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in spec["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
        assert _line(c["why"])
        assert c["chips"] in (1, 4)
    for c in spec["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert _line(c["source"]) and _line(c["why"])


def test_entry_keys():
    spec = _spec()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for c in spec["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])


def test_files_for_every_name():
    spec = _spec()
    bench = os.path.join(ROOT, spec["paths"][0])
    files = set()
    for c in spec["configs"]:
        assert c["file"].startswith(spec["paths"][0] + "/")
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert {"source", "reduced", "assumed"} <= set(cfg)
        assert cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(bench, "entries",
                                           cfg["entry"] + ".py"))
    assert len(files) == len(spec["configs"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    for c in spec["workloads"]:
        with open(os.path.join(bench, "traffic",
                               c["traffic"] + ".json")) as fh:
            mix = json.load(fh)
        assert os.path.exists(os.path.join(bench, "generators",
                                           mix["generator"] + ".py"))
        assert any(c["config"] == k["name"] for k in spec["configs"])
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(bench, "layer_metrics",
                                           m["name"] + ".py"))
    used = {c["config"] for c in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
