"""The ``otter assemble`` entry: a pass runs
``otter_tpu_torch.models.assemble.assemble(bam, bed, ref.fa, False,
params)`` once a sample, as ``otter-torch assemble`` runs it, every
setting from the deployment's ``otter`` block (otter's defaults) and the
device the harness gives; the plain reference (``reference/otter.py``)
assembles the sample the harness draws, and every pass's records of it
are held to the reference's.

Work a pass: the regions of every sample (``units`` "regions").
"""

from __future__ import annotations

import dataclasses
import io
import re
from contextlib import contextmanager, redirect_stderr
from typing import Dict, List, Tuple

UNITS = "regions"

Key = Tuple[int, str, int, int]          # (sample, chrom, start, end)


def units(fixture) -> int:
    return len(fixture.samples) * len(fixture.loci)


def _params(config: dict, device: str, read_group: str):
    from otter_tpu_torch.config import OtterOpts

    params = OtterOpts()
    for key, value in config["otter"].items():
        if not hasattr(params, key):
            raise ValueError(f"unknown otter setting {key!r}")
        setattr(params, key, value)
    params.read_group = read_group
    params.device = device
    return params


class Pass:
    """Runs passes; each returns every record with the SE the program
    computed for it before printing, by region."""

    def __init__(self, config: dict, fixture, device: str):
        from otter_tpu_torch.models import assemble as asm

        self.asm = asm
        self.fixture = fixture
        self.reference = fixture.fasta if config.get("with_reference") else ""
        self.params = [_params(config, device, s.name)
                       for s in fixture.samples]
        self.stderr = ""

    def __call__(self) -> Dict[Key, List[Tuple[str, float]]]:
        asm = self.asm
        emit_region = asm.emit_region
        out: Dict[Key, List[Tuple[str, float]]] = {}
        for k, (sample, params) in enumerate(zip(self.fixture.samples,
                                                 self.params)):
            buf = io.StringIO()
            se: Dict[str, List[float]] = {}

            def emit(params, work, clustmsg, alleles, out_):
                se[work.bed.to_sc_string()] = [
                    float(alleles[l].se) for l in range(clustmsg.fc)]
                return emit_region(params, work, clustmsg, alleles, out_)

            asm.emit_region = emit
            try:
                with redirect_stderr(io.StringIO()) as err:
                    asm.assemble(sample.bam, self.fixture.bed,
                                 self.reference, False, params, out=buf)
            finally:
                asm.emit_region = emit_region
            self.stderr = err.getvalue()
            for region, lines in records_by_region(buf.getvalue()).items():
                chrom, span = region.rsplit(":", 1)
                s, e = (int(v) for v in span.split("-"))
                ses = se.get(region, [])
                out[(k, chrom, s, e)] = (
                    list(zip(lines, ses))
                    + [(l, None) for l in lines[len(ses):]])
        return out


def records_by_region(sam: str) -> Dict[str, List[str]]:
    """SAM record lines keyed by their ``ta:Z:`` region."""
    out: Dict[str, List[str]] = {}
    for line in sam.splitlines():
        if not line or line.startswith("@"):
            continue
        m = re.search(r"\tta:Z:([^\t]+)", line)
        out.setdefault(m.group(1) if m else "?", []).append(line)
    return out


def picks(fixture, traffic: dict, seed: int) -> List[Key]:
    """The regions the reference checks: ``check_regions`` of every
    sample's regions drawn from the seed, and the region of the longest
    allele."""
    from ..generators.common import rng

    keys = [(k, c, s, e) for k in range(len(fixture.samples))
            for c, s, e in fixture.regions()]
    n = len(keys)
    take = min(int(traffic.get("check_regions", n)), n)
    pick = set(rng(seed, 9).permutation(n)[:take].tolist())
    nl = len(fixture.loci)
    pick.add(max(range(n), key=lambda i: max(map(
        len, fixture.samples[i // nl].alleles[i % nl]))))
    return [keys[i] for i in sorted(pick)]


def reference(config: dict, fixture, keys: List[Key], device, fdt=None,
              times=None) -> Dict[Key, List[Tuple[str, float]]]:
    """The plain reference's records of ``keys``."""
    import numpy as np

    from ..reference import otter as ref

    base = ref.Opts.of(config["otter"])
    fasta = fixture.fasta if config.get("with_reference") else None
    out = {}
    for k, sample in enumerate(fixture.samples):
        regions = [(c, s, e) for kk, c, s, e in keys if kk == k]
        if not regions:
            continue
        opts = dataclasses.replace(base, read_group=sample.name)
        got = ref.assemble(opts, sample.bam, fasta, regions, device,
                           fdt or np.float64, times=times)
        out.update({(k,) + r: v for r, v in got.items()})
    return out


def mismatched(got: List[Tuple[str, float]],
               want: List[Tuple[str, float]]) -> int:
    """Records of one region that differ from the reference's, in their
    bytes or in the SE computed before printing; a missing or extra
    record counts once."""
    return (sum(1 for a, b in zip(got, want) if a != b)
            + abs(len(got) - len(want)))


def needed(config: dict, fixture, device):
    """(m, n, d, bases) of the all-vs-all pairs a pass aligns, over every
    sample: the work the inputs need (``roofline.py``)."""
    import numpy as np

    from ..reference import otter as ref

    opts = ref.Opts.of(config["otter"])
    fasta = fixture.fasta if config.get("with_reference") else None
    ms, ns, ds, total = [], [], [], 0
    for sample in fixture.samples:
        m, n, d, b = ref.needed_pairs(opts, sample.bam, fasta,
                                      fixture.regions(), device)
        ms.append(m)
        ns.append(n)
        ds.append(d)
        total += b
    return (np.concatenate(ms), np.concatenate(ns), np.concatenate(ds),
            total)


@contextmanager
def engines():
    """The distance engines the passes build, for their cell counts."""
    from otter_tpu_torch.models import assemble as asm

    made: list = []
    make = asm._make_dist_backend

    def capture(*a, **kw):
        backend = make(*a, **kw)
        made.append(backend.engine)
        return backend

    asm._make_dist_backend = capture
    try:
        yield made
    finally:
        asm._make_dist_backend = make


def engine_cells(made) -> int:
    return sum(int(e.counters()["cells"]) for e in made)
