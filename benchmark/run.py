"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. The last line of standard output is the result's JSON object;
the last lines of standard error are the numbers held to the reference,
each beside its limit. Exits 1, with no result, without a card, when the
cell asks for more cards than there are, or when a module of the JAX
stack or the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    # the program's kernel builds and any Triton cache stay in the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build",
                                                  "triton-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch-extensions")
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark.harness import BenchError, load_cell, run_cell

    import torch

    chips = load_cell(args.workload).chips
    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device: the benchmark runs on the card "
                         "only\n")
        return 1
    if torch.cuda.device_count() < chips:
        sys.stderr.write(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible\n")
        return 1
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T0)
    except BenchError as exc:
        sys.stderr.write(f"{exc}\n")
        return 1
    for name, c in result["compared"].items():
        sys.stderr.write(f"{name} {c['value']} limit {c['limit']}\n")
    sys.stdout.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
