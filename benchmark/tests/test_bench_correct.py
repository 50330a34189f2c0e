"""``correct`` holds the timed path to the reference: a sound run passes;
the control (the reference in float32, one precision below the float64
that otter computes in) and each fault the cells can have fail."""

import tempfile

import pytest

from benchmark.harness import component, load_cell, run_cell

from conftest import TINY


class _Null:
    def write(self, _text):
        pass


def _run(workload, seed=5, extra=None):
    ov = {k: dict(v) for k, v in TINY[workload].items()}
    for k, v in (extra or {}).items():
        ov[k].update(v)
    return run_cell(workload, seed, 0.2, False, "cpu", overrides=ov,
                    log=_Null())


@pytest.mark.parametrize("workload", sorted(TINY))
def test_sound_run_is_correct(workload):
    r = _run(workload)
    assert r["correct"] and r["failed"] == 0
    assert r["compared"]["mismatched_records"] == {"value": 0, "limit": 0}
    assert r["attempted"] >= len(TINY[workload]) and r["metrics"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails(seed):
    """The reference computed in float32 differs from the float64
    reference on every seed, at 24 loci."""
    import numpy as np

    ov = {k: dict(v) for k, v in TINY["hifi30x.catalog"].items()}
    ov["config"].update(loci=24, coverage=10)
    cell = load_cell("hifi30x.catalog", overrides=ov)
    gen = component("generators", cell.traffic["generator"])
    entry = component("entries", cell.config["entry"])
    with tempfile.TemporaryDirectory() as d:
        fx = gen.make(d, seed, cell.config, cell.traffic)
        keys = [(0,) + r for r in fx.regions()]
        want = entry.reference(cell.config, fx, keys, "cpu")
        ctrl = entry.reference(cell.config, fx, keys, "cpu", np.float32)
    assert sum(entry.mismatched(ctrl[k], want[k]) for k in keys) > 0


def _unchanged_consensus(monkeypatch):
    """The consensus step hands back its backbone unchanged."""
    import otter_tpu_torch.ops.consensus as cons

    def apply(tasks, engine=None):
        for t in tasks:
            t.allele.seq = t.rep_read.seq

    monkeypatch.setattr(cons, "consensus_apply_batched", apply)


def _half_batch(monkeypatch):
    """Half of each batch of regions left out."""
    import otter_tpu_torch.models.assemble as asm

    orig = asm._dispatch_batch
    monkeypatch.setattr(asm, "_dispatch_batch",
                        lambda p, batch, b: orig(p, batch[: len(batch) // 2],
                                                 b))


def _altered_base(monkeypatch):
    """One base of each region's first allele altered where it is
    emitted."""
    import otter_tpu_torch.models.assemble as asm

    orig = asm.emit_region

    def emit(params, work, clustmsg, alleles, out):
        s = alleles[0].seq
        alleles[0].seq = s[:-1] + ("A" if s[-1] != "A" else "C")
        return orig(params, work, clustmsg, alleles, out)

    monkeypatch.setattr(asm, "emit_region", emit)


@pytest.mark.parametrize("fault", [_unchanged_consensus, _half_batch,
                                   _altered_base])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_fault_is_caught(monkeypatch, workload, fault):
    fault(monkeypatch)
    # 3% errors, so no read equals its allele's consensus
    r = _run(workload, extra={"config": {"error": 0.03}})
    assert not r["correct"]
    assert r["compared"]["mismatched_records"]["value"] > 0
