"""Steady-state phase profile of the assemble path on the card, the
counterpart of the JAX package's ``tools/profile_e2e.py``:

    python -m otter_tpu_torch.bench.profile [--regions 96]

builds the kernels, assembles ``synth.region_fixture(n_regions)`` once to
warm up, clears ``utils/metrics``, then times a second pass and prints its
wall and the metrics' phase breakdown (``host_io``, ``device_dispatch``,
``kde_device`` / ``kde_certify``, ``consensus_*``, ...), then the same as
one JSON line: the per-layer numbers of the e2e path.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time


def profile(n_regions: int = 96, device: str = "cuda") -> dict:
    """The timed pass's wall and ``metrics.snapshot()`` after a warm pass,
    on ``device``."""
    from ..utils import metrics
    from ..utils.synth import region_fixture
    from .e2e import run

    with tempfile.TemporaryDirectory() as tmp:
        bam, bed, _fa = region_fixture(tmp, n_regions=n_regions)
        run(device, bam, bed)  # warm
        metrics.reset()
        t0 = time.perf_counter()
        run(device, bam, bed)
        wall = time.perf_counter() - t0
        snap = metrics.snapshot()
        text = metrics.summary()
        metrics.reset()
    return {"regions": n_regions, "wall_s": round(wall, 4),
            "regions_per_sec": round(n_regions / wall, 2),
            "summary": text,
            "phases": {k: round(v, 6) for k, v in sorted(snap.items())}}


def main(argv=None) -> int:
    from .e2e import build_kernels, card_line

    ap = argparse.ArgumentParser(prog="python -m otter_tpu_torch.bench.profile",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--regions", type=int, default=96)
    args = ap.parse_args(argv)
    card = card_line()
    build_s = build_kernels()
    got = profile(args.regions)
    print(f"== steady-state pass: {got['regions']} regions in "
          f"{got['wall_s']:.3f} s = {got['regions_per_sec']:.1f} regions/s "
          f"({card}; kernels built in {build_s:.2f} s) ==")
    print(got.pop("summary"), flush=True)
    print(json.dumps(dict(got, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
