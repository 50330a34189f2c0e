"""Pin the bench's two host baselines on the card's host:

    python -m otter_tpu_torch.bench.calibrate [cpu|refscale|all]

The counterpart of the JAX package's ``tools/calibrate_cpu.py`` and
``tools/calibrate_refscale.py``, writing ``baselines.json`` beside this
file:

- ``cpu``: the best of 9 one-core native rates (``native.py``'s
  ``edit_distance_batch``, 1 thread, after a warm call) on the kernel leg's
  own subsample, the first 256 pairs of ``pair_workload(Random(20260817),
  n_pairs=65536, length=1024)``;
- ``refscale``: the best of 3 walls of what ``e2e.bench_refscale`` times
  live: region 1 of its fixture (2 regions, coverage 200, 10 kb alleles,
  seed 77) through ``assemble`` on ``NativeDistBackend``.

Each entry keeps its workload, every rep, ``loadavg`` at its start and
end, ``nproc``, the CPU model, the date and the card's ``nvidia-smi`` name
and power limit; without a card the command raises before it measures.
An entry already in the file is kept unless ``BENCH_RECALIBRATE=1``.

The bench applies the JAX bench's rule to them: the kernel leg divides by
the larger of the live and the pinned one-core rate, and
``refscale_vs_native`` takes the smaller of the live and the pinned native
wall, so a loaded host can only lower either ratio, never raise it. A pin
applies only to its own workload (the reads' length; coverage and allele
length); without one the live value stands.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import random
import sys
import tempfile
import time
from typing import Optional, Tuple

BASELINES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "baselines.json")
KINDS = ("cpu", "refscale")


def load() -> dict:
    """The pinned entries by kind ({} without the file)."""
    try:
        with open(BASELINES) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return {}


def cpu_denominator(live: float, length: int
                    ) -> Tuple[float, Optional[float]]:
    """(the kernel leg's one-core rate to divide by, the pin): the larger
    of the live best rate and the pinned one for reads of ``length`` (the
    pin None where the file has none)."""
    entry = load().get("cpu") or {}
    pin = None
    if entry.get("workload", {}).get("length") == length:
        pin = entry["cpu_1core_cells_per_sec"]
    return (live if pin is None else max(live, pin)), pin


def native_region_claim(live: float, cov: int, allele_bp: int
                        ) -> Tuple[float, Optional[float]]:
    """(the native region wall ``refscale_vs_native`` takes, the pin): the
    smaller of the live wall and the pinned one at ``cov`` and
    ``allele_bp`` (the pin None where the file has none)."""
    entry = load().get("refscale") or {}
    work = entry.get("workload", {})
    pin = None
    if (work.get("cov"), work.get("allele_bp")) == (cov, allele_bp):
        pin = entry["native_region_sec_best"]
    return (live if pin is None else min(live, pin)), pin


def cpu_model() -> Optional[str]:
    """The ``model name`` of /proc/cpuinfo, else ``platform.processor()``
    (None where neither says)."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or None


def _conditions(load0) -> dict:
    from .e2e import card_line

    return {"loadavg_at_start": list(load0),
            "loadavg_at_end": list(os.getloadavg()),
            "nproc": os.cpu_count(), "cpu_model": cpu_model(),
            "card": card_line(), "date": time.strftime("%Y-%m-%d")}


def calibrate_cpu(reps: int = 9, n_pairs: int = 65536,
                  length: int = 1024, sample: int = 256) -> dict:
    """The ``cpu`` entry: the best of ``reps`` one-core native rates on
    the first ``sample`` pairs of ``pair_workload(n_pairs, length)``."""
    from ..native import edit_distance_batch
    from ..utils.synth import pair_workload

    pairs = pair_workload(random.Random(20260817), n_pairs=n_pairs,
                          length=length)[0][:sample]
    load0 = os.getloadavg()
    edit_distance_batch(pairs, 1)  # warm: page-in, branch predictors
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _d, cells = edit_distance_batch(pairs, 1)
        rates.append(cells / (time.perf_counter() - t0))
    return {"cpu_1core_cells_per_sec": round(max(rates), 1),
            "median_cells_per_sec": round(sorted(rates)[reps // 2], 1),
            "reps_cells_per_sec": [round(r, 1) for r in rates],
            "workload": {"seed": 20260817, "n_pairs": n_pairs,
                         "length": length, "sample": len(pairs),
                         "threads": 1, "reps": reps},
            **_conditions(load0)}


def calibrate_refscale(reps: int = 3, device: str = "cuda",
                       n_regions: int = 2, cov: int = 200,
                       allele_bp: int = 10000) -> dict:
    """The ``refscale`` entry: the best of ``reps`` walls of
    ``e2e.native_region`` on region 1 of ``e2e.refscale_fixture``, as
    ``e2e.bench_refscale`` times it on ``device``."""
    from .. import native
    from . import e2e

    native.get_lib()
    with tempfile.TemporaryDirectory() as tmp:
        bam, _bed, bed1, _first = e2e.refscale_fixture(tmp, n_regions, cov,
                                                       allele_bp)
        load0 = os.getloadavg()
        walls = [round(e2e.native_region(device, bam, bed1)[0], 4)
                 for _ in range(reps)]
    return {"native_region_sec_best": min(walls),
            "native_region_sec_reps": walls,
            "workload": {"n_regions": n_regions, "region": 1, "cov": cov,
                         "allele_bp": allele_bp, "seed": 77,
                         "device": device, "reps": reps},
            **_conditions(load0)}


def calibrate(kinds, cpu: Optional[dict] = None,
              refscale: Optional[dict] = None) -> dict:
    """Measure each of ``kinds`` (``calibrate_cpu`` / ``calibrate_refscale``
    with the keyword arguments ``cpu`` / ``refscale``) that the file lacks,
    or every one with ``BENCH_RECALIBRATE=1``; writes the file and returns
    its entries. Raises without a card: the pins are the card host's."""
    from .e2e import card_line

    card_line()
    entries = load()
    redo = os.environ.get("BENCH_RECALIBRATE") == "1"
    calls = {"cpu": lambda: calibrate_cpu(**(cpu or {})),
             "refscale": lambda: calibrate_refscale(**(refscale or {}))}
    for kind in kinds:
        if kind in entries and not redo:
            print(f"{kind}: kept (BENCH_RECALIBRATE=1 measures it again)",
                  flush=True)
            continue
        entries[kind] = calls[kind]()
        with open(BASELINES, "w") as fh:
            json.dump(entries, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"{kind}: {json.dumps(entries[kind])}", flush=True)
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m otter_tpu_torch.bench.calibrate",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=KINDS + ("all",))
    args = ap.parse_args(argv)
    calibrate(KINDS if args.which == "all" else (args.which,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
