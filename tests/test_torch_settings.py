"""Settings of the JAX package in the PyTorch port, on the CPU: the
consensus routes (OTTER_TPU_AFFINE_DEVICE=0, OTTER_TPU_AFFINE_HINTS=0 and
=1) and the finish pool (OTTER_TPU_FINISH_POOL=1 at -t 1 and -t 2) run in
every entry point and change no byte; the settings the port lists as
no-ops (config.NO_OP_SETTINGS) change no byte of assemble; the JAX
package's opt-in device paths (OTTER_TPU_KMER_DEVICE,
OTTER_TPU_HCLUST_DEVICE, OTTER_TPU_POA_DEVICE) run on K10-K12 and change no
byte. The other honoured ones (OTTER_TPU_GENOTYPE_DEVICE,
OTTER_TPU_MESH_KDE, OTTER_TPU_GATHER, OTTER_TPU_FUSED_KDE) are held to the
bytes of otter_tpu in test_torch_genotype.py, test_torch_assemble.py,
test_torch_distributed.py and test_torch_region_step.py."""

import io
import random

import pytest

from otter_tpu_torch.config import NO_OP_SETTINGS, OtterOpts
from otter_tpu_torch.kernels import affine_tb, kmer_counts, poa_heaviest
from otter_tpu_torch.models.assemble import assemble
from otter_tpu_torch.models.compare import compare
from otter_tpu_torch.models.genotype import genotype
from otter_tpu_torch.utils import metrics
from otter_tpu_torch.utils.synth import cohort_fixture, compare_fixture

from fixtures import make_reference, simulate_region_bam

ENTRY_POINTS = ("assemble", "compare", "genotype")

# the consensus settings of the JAX package: (name, value) -> whether K5
# and the band-seed dispatch run in assemble (the fixture's jobs are short,
# so with K5 off no long-job hint subset is taken)
CONSENSUS_SETTINGS = {("OTTER_TPU_AFFINE_DEVICE", "0"): (False, False),
                      ("OTTER_TPU_AFFINE_HINTS", "0"): (True, False),
                      ("OTTER_TPU_AFFINE_HINTS", "1"): (True, True)}

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


def _entry_text(entry: str, args, threads: int = 1) -> str:
    out = io.StringIO()
    if entry == "assemble":
        p = OtterOpts(device="cpu")
        p.read_group = "S1"
        p.init_threads(threads)
        assemble(*args, "", False, p, out=out)
    elif entry == "genotype":
        genotype(OtterOpts(device="cpu"), *args, out=out)
    else:
        compare(OtterOpts(device="cpu"), *args, out=out)
    return out.getvalue()


@pytest.mark.parametrize("entry", ENTRY_POINTS)
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


@pytest.mark.parametrize("entry", ENTRY_POINTS)
@pytest.mark.parametrize("name,value", sorted(CONSENSUS_SETTINGS))
def test_consensus_setting_honoured(name, value, entry, inputs,
                                    monkeypatch):
    """OTTER_TPU_AFFINE_DEVICE=0 (every member on the native ladder) and
    OTTER_TPU_AFFINE_HINTS=0 / =1 (band seeds off / on for every job) run
    in every entry point, routed as the JAX package routes them: the
    output is byte for byte the entry's without the setting; in assemble
    K5 (``affine_cigars_tb``) and the hint dispatch run as the setting
    says, and genotype and compare reach neither."""
    want = _entry_text(entry, inputs[entry])
    real = affine_tb.affine_cigars_tb
    calls = []
    monkeypatch.setattr(affine_tb, "affine_cigars_tb",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv(name, value)
    metrics.reset()
    got = _entry_text(entry, inputs[entry])
    snap = metrics.snapshot()
    assert got == want and want.count("\n") >= 2
    k5, hints = CONSENSUS_SETTINGS[(name, value)]
    reached = entry == "assemble"
    assert (len(calls) > 0) == (k5 and reached)
    assert ("time.consensus_hints" in snap) == (hints and reached)
    assert ("time.consensus_affine" in snap) == reached


@pytest.mark.parametrize("threads,mesh_kde", [(1, ""), (2, ""), (2, "1")])
def test_finish_pool_setting_honoured(threads, mesh_kde, inputs,
                                      monkeypatch):
    """OTTER_TPU_FINISH_POOL=1, as the JAX package makes its pool: at -t 1
    no pool (the consensus runs here), at -t 2 two spawned workers take
    each region's hclust, reassignment and consensus; with
    OTTER_TPU_MESH_KDE=1 the KDE still runs here (K8's plain version) and
    its certified densities go to the workers. The bytes are -t 1's
    without the setting."""
    want = _entry_text("assemble", inputs["assemble"])
    monkeypatch.setenv("OTTER_TPU_FINISH_POOL", "1")
    if mesh_kde:
        monkeypatch.setenv("OTTER_TPU_MESH_KDE", mesh_kde)
    metrics.reset()
    got = _entry_text("assemble", inputs["assemble"], threads=threads)
    snap = metrics.snapshot()
    assert got == want and want.count("\n") >= 2
    assert ("time.consensus_batch" in snap) == (threads == 1)
    assert (snap.get("count.kde_device_regions", 0) > 0) == bool(mesh_kde)


@pytest.mark.parametrize("name", sorted(NO_OP_SETTINGS))
def test_no_op_setting_changes_no_byte(name, inputs, monkeypatch):
    """Each setting the port lists as a no-op (a TPU layout or dispatch
    shape of the JAX package) leaves assemble's bytes as they are, set to
    0 or to 1."""
    want = _entry_text("assemble", inputs["assemble"])
    for value in ("0", "1"):
        monkeypatch.setenv(name, value)
        assert _entry_text("assemble", inputs["assemble"]) == want
