"""The port's bench on one CUDA card:

    python -m otter_tpu_torch.bench [--legs kernel,regions,...] [--pairs N]
        [--regions N] [--refscale-regions N] [--refscale-cov N]
        [--refscale-bp N]

runs the legs (``legs.py``) in one process, in the JAX bench's order
(kernel, regions, cohort, refscale, ont, device), after building the
kernels (``build_s``, not in any rep), and prints a cumulative JSON line
after each leg, ``bench.py``'s fields under its names with ``"platform":
"cuda"`` and ``"card"`` (the ``nvidia-smi`` name and power limit). The
last line holds every field. The options default to the JAX bench's
sizes.

There is no fallback: without a card the command raises before the first
leg, a leg that raises stops the run after the line so far, and a false
``*_identical`` or ``*_parity`` flag makes it exit 1 after the last line.
Nothing runs on the CPU in place of the card.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import legs as L
from .e2e import build_kernels, card_line

LEGS = ("kernel", "regions", "cohort", "refscale", "ont", "device")


def leg_calls(args) -> dict:
    """Leg name -> the call that runs it at ``args``' sizes."""
    return {
        "kernel": lambda: L.bench_kernel(args.pairs),
        "regions": lambda: L.bench_regions(args.regions),
        "cohort": L.bench_cohort,
        "refscale": lambda: L.bench_refscale_leg(
            n_regions=args.refscale_regions, cov=args.refscale_cov,
            allele_bp=args.refscale_bp),
        "ont": L.bench_ont_leg,
        "device": L.bench_device_kernels,
    }


def failed_flags(result: dict) -> list:
    """The parity flags of ``result`` that are not true."""
    return sorted(k for k, v in result.items()
                  if k.endswith(("_identical", "_parity")) and v is not True)


def emit(result: dict) -> None:
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m otter_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--legs", default=",".join(LEGS),
                    help="comma-separated legs, run in the order "
                    + ",".join(LEGS))
    ap.add_argument("--pairs", type=int, default=65536)
    ap.add_argument("--regions", type=int, default=128)
    ap.add_argument("--refscale-regions", type=int, default=2)
    ap.add_argument("--refscale-cov", type=int, default=200)
    ap.add_argument("--refscale-bp", type=int, default=10000)
    args = ap.parse_args(argv)
    want = args.legs.split(",")
    unknown = sorted(set(want) - set(LEGS))
    if unknown:
        ap.error(f"unknown legs {unknown}; choose from {','.join(LEGS)}")
    result = {"platform": "cuda", "card": card_line()}
    result["build_s"] = round(build_kernels(), 2)
    emit(result)
    calls = leg_calls(args)
    for name in LEGS:
        if name in want:
            try:
                result.update(calls[name]())
            finally:
                emit(result)
    bad = failed_flags(result)
    if bad:
        sys.stderr.write(f"parity flags not true: {bad}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
