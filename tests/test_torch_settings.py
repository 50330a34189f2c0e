"""Settings of the JAX package in the PyTorch port, on the CPU: each one
that selects a path the port does not take raises, in every entry point
that reads settings (assemble, genotype, compare), so that none is
silently ignored. The honoured ones (OTTER_TPU_FINISH_POOL on the CPU,
OTTER_TPU_GENOTYPE_DEVICE, OTTER_TPU_MESH_KDE, OTTER_TPU_GATHER) are held
to the bytes of otter_tpu in test_torch_pools.py, test_torch_genotype.py,
test_torch_assemble.py and test_torch_distributed.py."""

import io
from types import SimpleNamespace

import pytest
import torch

from otter_tpu_torch.config import (FIXED_ROUTE_SETTINGS, UNPORTED_SETTINGS,
                                    OtterOpts)
from otter_tpu_torch.models.assemble import assemble, assemble_process
from otter_tpu_torch.models.compare import compare
from otter_tpu_torch.models.genotype import genotype

ENTRY_POINTS = {
    "assemble": lambda: assemble("r.bam", "r.bed", "", False,
                                 OtterOpts(device="cpu"), out=io.StringIO()),
    "genotype": lambda: genotype(OtterOpts(device="cpu"), "c.bam", "r.bed",
                                 "", out=io.StringIO()),
    "compare": lambda: compare(OtterOpts(device="cpu"), "r.bed", "t.bam",
                               "q.bam", out=io.StringIO()),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("name", UNPORTED_SETTINGS)
def test_unported_setting_raises(name, entry, monkeypatch):
    """OTTER_TPU_KMER_DEVICE=1, OTTER_TPU_POA_DEVICE=1 and
    OTTER_TPU_HCLUST_DEVICE=1 select device paths of the JAX package the
    port does not have: every entry point raises, naming the setting,
    before it reads an input."""
    monkeypatch.setenv(name, "1")
    with pytest.raises(RuntimeError, match=name):
        ENTRY_POINTS[entry]()


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("name,value", FIXED_ROUTE_SETTINGS)
def test_consensus_route_setting_raises(name, value, entry, monkeypatch):
    """OTTER_TPU_AFFINE_DEVICE=0 and OTTER_TPU_AFFINE_HINTS=0/1 reroute the
    JAX package's consensus (the host ladder, band seeds on or off); the
    port always takes K5 with seeded bands, so every entry point raises,
    naming the setting, before it reads an input."""
    monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match=f"{name}={value}"):
        ENTRY_POINTS[entry]()


@pytest.mark.parametrize("case", ["card_engine", "one_thread"])
def test_finish_pool_refused(case, monkeypatch):
    """OTTER_TPU_FINISH_POOL=1 would move each region's host half off the
    card, and at -t 1 the pool has no workers: with an engine on the card
    (a stand-in: there is no card here) or -t 1, assemble_process raises
    before it reads an input or starts a worker."""
    monkeypatch.setenv("OTTER_TPU_FINISH_POOL", "1")
    params = OtterOpts(device="cpu")
    params.init_threads(1 if case == "one_thread" else 2)
    backend = (SimpleNamespace(engine=SimpleNamespace(
        device=torch.device("cuda"))) if case == "card_engine" else None)
    match = "--device cpu" if case == "card_engine" else "-t > 1"
    with pytest.raises(RuntimeError, match=match):
        assemble_process(params, "r.bam", [], "", False, io.StringIO(),
                         dist_backend=backend)
