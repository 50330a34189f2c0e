#!/usr/bin/env python3
"""The K3 / K4 ladders of one checkout on one CUDA card, end to end.

    python3 tools/torch_ladder_ab.py ROOT [NAME]

imports ``otter_tpu_torch`` from the checkout at ROOT (so a commit and its
parent, unpacked side by side, can be compared: run them in turns, A B B
A, on one card) and runs ``assemble`` on four cells, each fixture made by
the checkout's own ``utils/synth.py``:

* ``bench refscale``: the refscale leg of ``python -m otter_tpu_torch.bench``
  (2 regions, coverage 200, 10 kb alleles, seed 77), 4 timed runs after a
  warm run on region 1;
* ``bench ONT``: its ONT leg (16 regions, 6% error, 2.3 kb expansions,
  seed 42), 3 timed runs after a warm run;
* ``refscale region`` and ``7.5 kb allele``: those cells of
  ``chip_smoke.py``'s phase 5 (seeds 77 and 79), 3 timed runs after a warm
  run.

Each timed run takes a fresh engine; the tool wraps the checkout's
``edit_engine.myers_banded`` and ``myers_banded_ef`` to record each
launch's band k and job count (no synchronisation). It prints the card
line, then one JSON line a cell: each run's wall and ``device_dispatch``
seconds (``utils/metrics``), and from the last run the engine's
``cells`` and route counters, the K3 / K4 launches and the jobs launched
at each rung, and a hash of the SAM text (equal hashes: equal outputs).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

# name -> (tandem_repeat_loci arguments, timed runs, warm on region 1 only)
CELLS = (
    ("bench refscale", dict(n_regions=2, cov=200, err=0.002, expansion=100,
                            region_len=10000, seed=77, name="refscale"),
     4, True),
    ("bench ONT", dict(n_regions=16, cov=18, err=0.06, expansion=720,
                       region_len=150, seed=42, name="ont"), 3, False),
    ("refscale region", dict(n_regions=1, cov=200, err=0.002, expansion=100,
                             region_len=10000, seed=77, name="refscale1"),
     3, False),
    ("7.5 kb allele", dict(n_regions=2, cov=24, err=0.002, expansion=2000,
                           region_len=1500, seed=79, name="long"), 3, False),
)


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    name = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(root)
    sys.path.insert(0, root)
    import torch

    from otter_tpu_torch.bench import e2e
    from otter_tpu_torch.kernels import edit_engine
    from otter_tpu_torch.kernels import myers_banded as K34
    from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
    from otter_tpu_torch.utils import metrics
    from otter_tpu_torch.utils.synth import tandem_repeat_loci

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if not edit_engine.__file__.startswith(root):
        raise SystemExit(f"imported {edit_engine.__file__}, not {root}'s")
    e2e.build_kernels()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rungs: list = []

    def recorded(kernel: str, fn, k_at: int):
        def wrapper(*args, **kw):
            rungs.append((kernel, args[k_at], int(args[1].shape[0])))
            return fn(*args, **kw)
        return wrapper

    edit_engine.myers_banded = recorded("K3", edit_engine.myers_banded, 5)
    edit_engine.myers_banded_ef = recorded("K4", edit_engine.myers_banded_ef,
                                           7)
    with tempfile.TemporaryDirectory() as tmp:
        for cell, kw, reps, warm_first in CELLS:
            bam, bed = tandem_repeat_loci(tmp, **kw)
            warm_bed = bed
            if warm_first:
                warm_bed = os.path.join(tmp, f"{kw['name']}_r1.bed")
                with open(bed) as fh, open(warm_bed, "w") as out:
                    out.write(fh.read().splitlines()[0] + "\n")
            e2e.run("cuda", bam, warm_bed)
            walls, dispatch = [], []
            for _ in range(reps):
                backend = TorchDistBackend("cuda")
                rungs.clear()
                K34.myers_banded_cuda.launches = 0
                K34.myers_banded_ef_cuda.launches = 0
                metrics.reset()
                t0 = time.perf_counter()
                _dt, text = e2e.run("cuda", bam, bed, dist_backend=backend)
                torch.cuda.synchronize()
                walls.append(round(time.perf_counter() - t0, 4))
                dispatch.append(round(
                    metrics.snapshot().get("time.device_dispatch", 0.0), 4))
            by_rung: dict = {}
            for kernel, k, n in rungs:
                launches, jobs = by_rung.get((kernel, k), (0, 0))
                by_rung[kernel, k] = (launches + 1, jobs + n)
            counters = backend.engine.counters()
            print(json.dumps({
                "tree": name, "cell": cell, "walls_s": walls,
                "device_dispatch_s": dispatch,
                "cells": counters["cells"],
                "counters": {k: v for k, v in counters.items()
                             if k != "cells" and v},
                "launches": {"K3": K34.myers_banded_cuda.launches,
                             "K4": K34.myers_banded_ef_cuda.launches},
                "rungs": {f"{kernel} k={k}": {"launches": a, "jobs": b}
                          for (kernel, k), (a, b) in sorted(by_rung.items())},
                "sam_sha1": hashlib.sha1(text.encode()).hexdigest()[:16]}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
