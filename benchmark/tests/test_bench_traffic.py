"""The traffic generators are deterministic in the seed, every seed gives
the same set of sizes, and the committed mixes have the shapes they
state."""

import hashlib
import os

import pytest

from benchmark.fixtures.bam import BamReader
from benchmark.generators import cas9_panel, tiled_wgs
from benchmark.generators.common import quantiles
from benchmark.harness import component, load_cell

from conftest import TINY


def _make(tmp_path, workload, seed, overrides=None):
    cell = load_cell(workload, overrides=overrides)
    gen = component("generators", cell.traffic["generator"])
    os.makedirs(tmp_path, exist_ok=True)
    return gen.make(str(tmp_path), seed, cell.config, cell.traffic)


def _digest(fx) -> str:
    h = hashlib.sha256()
    paths = [fx.bed, fx.fasta]
    for s in fx.samples:
        paths += [s.bam, s.bam + ".bai"]
    for path in paths:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


@pytest.mark.parametrize("workload", sorted(TINY))
def test_same_seed_same_bytes(tmp_path, workload):
    seed = 3_000_000_017  # past 32 signed bits
    a, b, c = (_make(tmp_path / sub, workload, s, TINY[workload])
               for sub, s in (("a", seed), ("b", seed), ("c", seed + 1)))
    assert _digest(a) == _digest(b)
    assert _digest(c) != _digest(a)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_every_seed_same_sizes(tmp_path, workload):
    sizes = []
    for seed in (1, 2, 99):
        fx = _make(tmp_path / str(seed), workload, seed, TINY[workload])
        sizes.append(sorted(tuple(sorted(map(len, pair)))
                            for s in fx.samples for pair in s.alleles))
    assert sizes[0] == sizes[1] == sizes[2]


def _read_ends(fx):
    """Per sample, the reads' reference ends that fall strictly inside a
    locus, and the number of reads."""
    out = []
    for s in fx.samples:
        inside = n = 0
        with BamReader(s.bam, load_index=True) as bam:
            for rec in bam:
                n += 1
                for p in (rec.pos, rec.pos + rec.ref_len()):
                    inside += any(a < p < b for a, b in fx.loci)
        out.append((inside, n))
    return out


def test_wgs_reads_end_inside_loci(tmp_path):
    """No read end is moved clear of a locus: at the catalog's density a
    share of the read ends falls inside one."""
    fx = _make(tmp_path, "hifi30x.catalog", 5,
               {"config": {"loci": 40}, "traffic": {}})
    (inside, n), = _read_ends(fx)
    assert n > 100 and inside > 0.04 * 2 * n


def test_panel_reads_span_their_target(tmp_path):
    fx = _make(tmp_path, "panel200x.expansions", 5, TINY[
        "panel200x.expansions"])
    assert all(inside == 0 and n > 0 for inside, n in _read_ends(fx))


def test_full_size_plans():
    """The cells as committed: 256 catalog loci of 40-2,000 bp, half of
    them heterozygous; the panel's four samples over 20 loci, normal
    alleles inside their STRchive normal range, and the three expanded
    samples' alleles as the mix states."""
    cat = load_cell("hifi30x.catalog")
    plan = tiled_wgs.plan_loci(cat.config, cat.traffic, 5)
    assert len(plan) == 256
    assert min(len(a) for a, _b in plan) >= 40
    assert max(len(a) for a, _b in plan) <= 2000
    assert sum(a != b for a, b in plan) == 128
    panel = load_cell("panel200x.expansions")
    refs, samples = cas9_panel.plan_alleles(panel.config, panel.traffic, 5)
    loci = panel.traffic["loci"]
    assert len(refs) == 20 and len(samples) == 4
    expanded = {}
    for k, s in enumerate(samples):
        for L, pair in zip(loci, s):
            for h, allele in enumerate(pair):
                units = len(allele) // len(L["motif"])
                lo, hi = L["normal"]
                if not lo <= units <= hi:
                    expanded[(k, L["gene"], h)] = units
    assert expanded == {(1, "DMPK", 0): 1000, (2, "C9orf72", 0): 800,
                        (3, "FXN", 0): 650, (3, "FXN", 1): 900}


def test_quantiles():
    assert quantiles(0, 10, 5, "uniform") == [1, 3, 5, 7, 9]
    v = quantiles(10, 1000, 2, "log_uniform")
    assert v[0] == pytest.approx(10 * 10 ** 0.5)
    assert v[1] == pytest.approx(10 * 10 ** 1.5)
