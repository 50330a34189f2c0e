"""One rule for the port's native C++ stages (otter_tpu_torch/native.py):
the OTTER_TPU_NATIVE_<name> switch alone picks the native half or the
Python oracle of a stage.

For every native site on a device path, two cases:

* ``raises``: the native function fails, and the failure reaches the
  port's caller; no stage answers in its place with the oracle.
* ``oracle``: with the stage's switch at 0 the oracle runs and the native
  function is not called (it would raise), and the answer is the native
  one."""

import io
import random

import numpy as np
import pytest

from otter_tpu.io.bam import BAM_CMATCH
from otter_tpu_torch import native
from otter_tpu_torch.config import OtterOpts
from otter_tpu_torch.io.bam import BamReader
from otter_tpu_torch.io.bed import BED
from otter_tpu_torch.models.assemble import assemble
from otter_tpu_torch.models.genotype import genotype
from otter_tpu_torch.ops import align_batch, cluster, hclust
from otter_tpu_torch.ops.distmat import DistMatrix
from otter_tpu_torch.seqs import extract, kmer
from otter_tpu_torch.utils.synth import cohort_fixture

from fixtures import (make_bam, make_reference, read_record,
                      simulate_region_bam)

START, END = 1500, 1560


class NativeFault(RuntimeError):
    pass


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A read BAM of one CAG locus (two alleles), an allele BAM of that
    locus as genotype reads it, the region, and a cohort of two regions
    (BAM, BED, FASTA) for genotype's batched pipeline."""
    tmp = tmp_path_factory.mktemp("routing")
    ref = make_reference(random.Random(123), length=3000, repeat="CAG",
                         repeat_at=1500, repeat_units=20)
    reads = str(tmp / "reads.bam")
    simulate_region_bam(reads, "chr1", ref, (START, END),
                        [ref[START:END], "CAG" * 30], per_allele_cov=6,
                        error_rate=0.002, seed=99)
    rng = random.Random(7)
    region = f"chr1:{START}-{END}"
    alleles = []
    for i, sample in enumerate(["S1", "S1", "S2", "S2", "S3"]):
        seq = "CAG" * rng.randint(18, 32)
        alleles.append(read_record(
            f"{sample}_{i}", 0, START, seq, [(len(seq), BAM_CMATCH)],
            tags=[("ta", "Z", region), ("RG", "Z", sample),
                  ("tc", "i", 10 + i), ("ac", "i", 5), ("sc", "i", 4),
                  ("se", "f", 0.25), ("ic", "i", 1)]))
    alleles_bam = str(tmp / "alleles.bam")
    make_bam(alleles_bam, [("chr1", len(ref))], alleles,
             extra_header="\n".join(f"@RG\tID:{s}" for s in
                                    ("S1", "S2", "S3")))
    bed = str(tmp / "regions.bed")
    with open(bed, "w") as fh:
        fh.write(f"chr1\t{START}\t{END}\n")
    cohort = cohort_fixture(str(tmp), n_samples=4, n_regions=2, seed=5)
    return reads, alleles_bam, bed, cohort


def _params():
    p = OtterOpts()
    p.read_group = "S1"
    p.device = "cpu"
    return p


def _condensed(n, seed):
    return np.random.default_rng(seed).random(n * (n - 1) // 2)


def _hclust():
    return cluster._hclust_route(12, _condensed(12, 1), 0.5, "cpu")


def _cutree():
    merge, _height = hclust.hclust_average(12, _condensed(12, 2))
    return hclust.cutree_k(12, merge, 3)


def _medoid():
    return DistMatrix(70, _condensed(70, 3)).get_medoid(range(70))


def _cosine():
    n = 256
    V = np.random.default_rng(4).integers(0, 6, (n, 65)).astype(np.float64)
    norms = np.sqrt(np.sum(V * V, axis=1))
    scaled = (V @ V.T) / np.outer(norms, norms) * 1000.0
    return cluster.kusage_cosine_condensed_batch(
        [scaled], [V], [norms], cluster._ROUND_GUARD)[0]


def _kcounts():
    rng = random.Random(5)
    seqs = ["".join(rng.choice("ACGT") for _ in range(rng.randint(0, 40)))
            for _ in range(9)]
    return kmer._batch_counts(3, seqs)


def _affine():
    rng = random.Random(6)
    jobs = []
    for _ in range(4):
        p = "".join(rng.choice("ACGT") for _ in range(72))
        t = p[:30] + "CAG" * rng.randint(0, 4) + p[30:]
        jobs.append((p, t, 0, 0, 0, 0))
    return align_batch.affine_cigars_multi(jobs)


def _assemble(data):
    reads, _alleles, bed, _cohort = data
    out = io.StringIO()
    assemble(reads, bed, "", False, _params(), out=out)
    return out.getvalue()


def _genotype(data):
    out = io.StringIO()
    genotype(_params(), *data[3], out=out)
    return out.getvalue()


def _anreads(data):
    with BamReader(data[0]) as bam:
        reads = extract.parse_anreads(_params(), BED("chr1", START, END), bam)
    return [(r.name, r.seq, r.is_spanning_l, r.is_spanning_r, r.ccoords,
             r.rq) for r in reads]


def _analleles(data):
    with BamReader(data[1]) as bam:
        block, idx = extract.parse_analleles(
            _params(), bam, BED("chr1", START, END),
            {"S1": 0, "S2": 1, "S3": 2})
    return [(a.seq, a.scov, a.acov, a.tcov, a.se, a.ic) for a in block], idx


def _bam_records(data):
    with BamReader(data[0]) as bam:
        return [(r.name, r.pos, r.cigar, r.seq)
                for r in bam.fetch("chr1", START, END)]


def _raise_fetch_raw(monkeypatch):
    def fault(self, *a, **k):
        raise NativeFault("fetch_raw")
    monkeypatch.setattr(BamReader, "fetch_raw", fault)


# site: (switch, the native function that fails, run(data))
SITES = {
    "hclust": ("HCLUST", "hclust_average_native", lambda d: _hclust()),
    "hclust_batch": ("HCLUST", "hclust_average_native_batch", _genotype),
    "cutree": ("HCLUST", "cutree_k_native", lambda d: _cutree()),
    "medoid": ("MEDOID", "medoid_sums_native", lambda d: _medoid()),
    "cosine": ("COSINE", "cosine_condensed_native", lambda d: _cosine()),
    "kcounts": ("KMER", "kcounts_native", lambda d: _kcounts()),
    "ppoa": ("POA", "poa_consensus_batch", _assemble),
    "affine_ladder": ("AFFINE", "get_lib", lambda d: _affine()),
    "anreads": ("ANREADS", "anreads_parse", _anreads),
    "anreads_fetch_raw": ("ANREADS", _raise_fetch_raw, _anreads),
    "analleles": ("ANALLELES", "analleles_parse", _analleles),
    "analleles_fetch_raw": ("ANALLELES", _raise_fetch_raw, _analleles),
    "bam_records": ("IO", "parse_bam_records", _bam_records),
}


def _fail(monkeypatch, target):
    if callable(target):
        target(monkeypatch)
        return

    def fault(*a, **k):
        raise NativeFault(target)
    monkeypatch.setattr(native, target, fault)


def _same(got, want):
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("mode", ["raises", "oracle"])
@pytest.mark.parametrize("site", sorted(SITES))
def test_native_switch_routes(site, mode, data, monkeypatch):
    switch, target, run = SITES[site]
    monkeypatch.setenv(f"OTTER_TPU_NATIVE_{switch}", "1")
    if mode == "raises":
        _fail(monkeypatch, target)
        with pytest.raises(NativeFault):
            run(data)
    else:
        want = run(data)
        _fail(monkeypatch, target)
        monkeypatch.setenv(f"OTTER_TPU_NATIVE_{switch}", "0")
        _same(run(data), want)


def test_enabled_reads_the_switch(monkeypatch):
    monkeypatch.delenv("OTTER_TPU_NATIVE_KMER", raising=False)
    assert native.enabled("KMER")
    monkeypatch.setenv("OTTER_TPU_NATIVE_KMER", "0")
    assert not native.enabled("KMER")
    monkeypatch.setenv("OTTER_TPU_NATIVE_KMER", "1")
    assert native.enabled("KMER")
