"""Settings of the JAX package in the PyTorch port, on the CPU: each one
that selects a path the port does not take raises, in every entry point
that reads settings (assemble, genotype, compare), so that none is
silently ignored; the JAX package's opt-in device paths
(OTTER_TPU_KMER_DEVICE, OTTER_TPU_HCLUST_DEVICE, OTTER_TPU_POA_DEVICE)
run on K10-K12 and change no byte. The other honoured ones
(OTTER_TPU_FINISH_POOL on the CPU, OTTER_TPU_GENOTYPE_DEVICE,
OTTER_TPU_MESH_KDE, OTTER_TPU_GATHER) are held to the bytes of otter_tpu in
test_torch_pools.py, test_torch_genotype.py, test_torch_assemble.py and
test_torch_distributed.py."""

import io
import random
from types import SimpleNamespace

import pytest
import torch

from otter_tpu_torch.config import FIXED_ROUTE_SETTINGS, OtterOpts
from otter_tpu_torch.kernels import kmer_counts, poa_heaviest
from otter_tpu_torch.models.assemble import assemble, assemble_process
from otter_tpu_torch.models.compare import compare
from otter_tpu_torch.models.genotype import genotype
from otter_tpu_torch.utils import metrics
from otter_tpu_torch.utils.synth import cohort_fixture, compare_fixture

from fixtures import make_reference, simulate_region_bam

ENTRY_POINTS = {
    "assemble": lambda: assemble("r.bam", "r.bed", "", False,
                                 OtterOpts(device="cpu"), out=io.StringIO()),
    "genotype": lambda: genotype(OtterOpts(device="cpu"), "c.bam", "r.bed",
                                 "", out=io.StringIO()),
    "compare": lambda: compare(OtterOpts(device="cpu"), "r.bed", "t.bam",
                               "q.bam", out=io.StringIO()),
}

# the opt-in device paths: setting -> (the entry point whose path it
# reaches, the plain version it sends work to, other settings it needs
# there: with the native NN-chain batch on, genotype never reaches the
# per-matrix hclust route, as in the JAX package)
DEVICE_SETTINGS = {
    "OTTER_TPU_KMER_DEVICE": ("genotype", (kmer_counts,
                                           "kmer_counts_torch"), {}),
    "OTTER_TPU_HCLUST_DEVICE": ("genotype", None,
                                {"OTTER_TPU_NATIVE_HCLUST": "0"}),
    "OTTER_TPU_POA_DEVICE": ("assemble", (poa_heaviest,
                                          "poa_heaviest_torch"), {}),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Small CPU inputs of the three entry points: one tandem-repeat locus
    (assemble), a 6-sample cohort of 3 regions (genotype), a truth / query
    pair of 3 regions (compare)."""
    tmp = tmp_path_factory.mktemp("settings")
    ref = make_reference(random.Random(123), length=3000, repeat="CAG",
                         repeat_at=1500, repeat_units=20)
    bam = str(tmp / "reads.bam")
    simulate_region_bam(bam, "chr1", ref, (1500, 1560),
                        [ref[1500:1560], "CAG" * 30], per_allele_cov=10,
                        error_rate=0.002, seed=99)
    bed = str(tmp / "regions.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t1500\t1560\n")
    cohort = cohort_fixture(str(tmp), n_samples=6, n_regions=3, seed=9)
    truth, query, cbed = compare_fixture(str(tmp), 3, seed=31, hi=800)
    return {"assemble": (bam, bed), "genotype": cohort,
            "compare": (cbed, truth, query)}


def _entry_text(entry: str, args) -> str:
    out = io.StringIO()
    if entry == "assemble":
        p = OtterOpts(device="cpu")
        p.read_group = "S1"
        assemble(*args, "", False, p, out=out)
    elif entry == "genotype":
        genotype(OtterOpts(device="cpu"), *args, out=out)
    else:
        compare(OtterOpts(device="cpu"), *args, out=out)
    return out.getvalue()


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("name", sorted(DEVICE_SETTINGS))
def test_device_setting_honoured(name, entry, inputs, monkeypatch):
    """OTTER_TPU_KMER_DEVICE=1, OTTER_TPU_HCLUST_DEVICE=1 and
    OTTER_TPU_POA_DEVICE=1 run in every entry point: the output is byte
    for byte the entry's without the setting, and where the setting
    reaches the entry's path, its route was taken (K10's or K12's plain
    version was called; every hclust matrix was counted as run on K11 or
    declined by its exactness guards)."""
    reached, plain, needs = DEVICE_SETTINGS[name]
    for key, value in needs.items():
        monkeypatch.setenv(key, value)
    want = _entry_text(entry, inputs[entry])
    calls = []
    if plain is not None:
        module, fn = plain
        real = getattr(module, fn)
        monkeypatch.setattr(module, fn,
                            lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv(name, "1")
    metrics.reset()
    got = _entry_text(entry, inputs[entry])
    snap = metrics.snapshot()
    assert got == want and want.count("\n") >= 2
    routed = (len(calls) if plain is not None else
              snap.get("count.hclust_device", 0)
              + snap.get("count.hclust_device_declined", 0))
    assert (routed > 0) == (entry == reached)


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
