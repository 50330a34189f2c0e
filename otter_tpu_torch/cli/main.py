"""``otter-torch``: the command line of the PyTorch port.

``python -m otter_tpu_torch.cli.main assemble <BAM> -b <BED> -R <NAME> ...``
takes the flags and defaults of ``otter assemble`` (otter_tpu/cli/main.py,
command_assemble.cpp:20-45); ``--device`` chooses ``cuda`` (the default)
or ``cpu`` (the kernels' plain PyTorch versions). The other subcommands are
not ported yet.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .. import OTTER_VERSION
from ..config import OtterOpts


def _print_help() -> None:
    print("Usage:\n otter-torch [command]")
    print("      assemble      Locally assembly a given set of target regions.")
    print("      version       Output current version.\n")


def _cmd_assemble(argv: List[str]) -> int:
    # add_help off: the reference binds -h to --bandwidth (command_assemble.cpp:42)
    p = argparse.ArgumentParser(prog="otter-torch assemble", add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("inputs", nargs="*", help="<BAM>")
    p.add_argument("-b", "--bed")
    p.add_argument("-R", "--sample-name", dest="sample_name")
    p.add_argument("-r", "--reference", default="")
    p.add_argument("--fasta", action="store_true", default=False)
    p.add_argument("--haps", action="store_true", default=False)
    p.add_argument("--reads-only", dest="reads_only", action="store_true", default=False)
    p.add_argument("-p", "--non-primary", dest="nonprimary", action="store_true", default=False)
    p.add_argument("-l", "--omit-nonspanning", dest="omitnonspanning",
                   action="store_true", default=False)
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("-o", "--offset", default="1,0")
    p.add_argument("-a", "--max-alleles", dest="max_alleles", type=int, default=2)
    p.add_argument("-m", "--mapq", type=int, default=0)
    p.add_argument("-q", "--read-quality", dest="read_quality", type=float, default=0)
    p.add_argument("-c", "--max-cov", dest="max_cov", type=int, default=200)
    p.add_argument("-F", "--cov-fraction", dest="cov_fraction", type=float, default=0.2)
    p.add_argument("-A", "--cov-fraction-large", dest="cov_fraction_large",
                   default="500,0.1")
    p.add_argument("-e", "--max-error", dest="max_error", type=float, default=0.01)
    p.add_argument("-h", "--bandwidth", dest="bandwidth", default="0.01,500,0.015")
    p.add_argument("-f", "--flank-size", dest="flank_size", type=int, default=100)
    p.add_argument("-s", "--min-sim", dest="min_sim", type=float, default=0.9)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--resume", default="",
                   help="Skip regions already present in this partial output file.")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Where the distance kernels run.")
    args = p.parse_args(argv)
    if not args.inputs:
        p.print_help()
        return 0
    params = OtterOpts()
    if args.bed is None:
        sys.stderr.write("[ERROR] '--bed' parameter required\n")
        return 1
    if args.sample_name is None:
        sys.stderr.write("[ERROR] '--sample-name' parameter required\n")
        return 1
    params.read_group = args.sample_name
    params.nonprimary = args.nonprimary
    params.omitnonspanning = args.omitnonspanning
    params.is_fa = args.fasta
    params.ignore_haps = not args.haps
    params.init_offset(args.offset)
    params.init_max_alleles(args.max_alleles)
    params.init_mapq(args.mapq)
    params.init_read_quality(args.read_quality)
    params.init_max_cov(args.max_cov)
    params.init_min_cov_fraction(args.cov_fraction)
    params.init_threads(args.threads)
    params.init_max_error(args.max_error)
    params.init_bandwidth(args.bandwidth)
    params.init_flank(args.flank_size)
    params.init_min_sim(args.min_sim)
    params.init_min_cov_fraction2(args.cov_fraction_large)
    params.is_debug = args.debug
    params.device = args.device
    from ..models.assemble import assemble
    assemble(args.inputs[0], args.bed, args.reference, args.reads_only, params,
             resume_from=args.resume)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        _print_help()
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "assemble":
        return _cmd_assemble(rest)
    if cmd == "version":
        print(OTTER_VERSION)
        return 0
    _print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
