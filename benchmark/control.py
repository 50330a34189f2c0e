"""The comparison's control, on the card at a cell's own size: the plain
reference computed in float32 (one precision below otter's float64) in
the program's place, held to the float64 reference on the regions a run
checks, on each seed given.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

Prints one JSON line a seed: the records the control gets wrong of those
the reference emits, in their bytes or in their SE before printing. The
benchmark's runs never run it.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import component, load_cell

    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device\n")
        return 1
    cell = load_cell(args.workload)
    generator = component("generators", cell.traffic["generator"])
    entry = component("entries", cell.config["entry"])
    for seed in args.seeds:
        tmp = tempfile.mkdtemp(prefix="otter-control-")
        try:
            fx = generator.make(tmp, seed, cell.config, cell.traffic)
            keys = entry.picks(fx, cell.traffic, seed)
            t = time.perf_counter()
            stages = {}
            want = entry.reference(cell.config, fx, keys, "cuda",
                                   times=stages)
            t_ref = time.perf_counter() - t
            ctrl = entry.reference(cell.config, fx, keys, "cuda", np.float32)
            bad = sum(entry.mismatched(ctrl[k], want[k]) for k in keys)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "units": len(keys),
                "records": sum(len(v) for v in want.values()),
                "control_mismatched_records": bad,
                "reference_s": t_ref, "stages": stages}), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
