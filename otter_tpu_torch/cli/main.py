"""``otter-torch``: the command line of the PyTorch port.

``python -m otter_tpu_torch.cli.main assemble <BAM> -b <BED> -R <NAME> ...``
and the ``genotype``, ``wgat``, ``vcf2mat`` and ``compare`` subcommands take
the flags and defaults of ``otter_tpu/cli/main.py`` (command_assemble.cpp:
20-45, command_genotype.cpp:20-28, command_wgat.cpp:20-28,
command_vcf2mat.cpp:20-25, command_compare.cpp:20-25). ``--device`` of
``assemble`` and ``genotype`` chooses ``cuda`` (the default), ``cpu`` (the
kernels' plain PyTorch versions, and host BLAS for genotype's GEMM) or
``host`` (the JAX package's pure-host exact mode: no kernel, no engine, no
process sharding). The JAX CLI's ``auto`` and ``tpu`` are refused: ``auto``
would carry on on the CPU when no card is found, and ``tpu`` names another
chip. ``compare`` runs on the default device, as the JAX CLI's does. The
help text lists assemble, genotype, wgat and version, like the reference.
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
    print("      genotype      Genotype target regions across one or more samples.")
    print("      wgat          Genotype target regions in a whole-genome aligned assembly.")
    print("      version       Output current version.\n")


def _add_device_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   choices=["cuda", "cpu", "host"],
                   help="cuda: the kernels on the card (raises without "
                   "one); cpu: their plain PyTorch versions; host: no "
                   "kernel, the sequential pure-host exact path (numpy "
                   "pair DP, slow on long reads).")


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
    _add_device_args(p)
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


def _cmd_genotype(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="otter-torch genotype")
    p.add_argument("inputs", nargs="*", help="<BAM>")
    p.add_argument("-b", "--bed", required=False)
    p.add_argument("-r", "--reference", default="")
    p.add_argument("-e", "--max-error", dest="max_error", type=float, default=0.025)
    p.add_argument("-s", "--max-cosdis", dest="max_cosdis", type=float, default=0.025)
    p.add_argument("-t", "--threads", type=int, default=1)
    _add_device_args(p)
    args = p.parse_args(argv)
    if not args.inputs:
        p.print_help()
        return 0
    params = OtterOpts()
    params.init_max_error(args.max_error)
    params.init_max_cosdis(args.max_cosdis)
    params.init_threads(args.threads)
    params.device = args.device
    from ..models.genotype import genotype
    genotype(params, args.inputs[0], args.bed, args.reference)
    return 0


def _cmd_wgat(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="otter-torch wgat")
    p.add_argument("inputs", nargs="*", help="<BAM>")
    p.add_argument("-b", "--bed")
    p.add_argument("-R", "--sample-name", dest="sample_name")
    p.add_argument("--fasta", action="store_true", default=False)
    p.add_argument("-o", "--offset", default="1,0")
    p.add_argument("-t", "--threads", type=int, default=1)
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
    params.is_fa = args.fasta
    params.init_offset(args.offset)
    params.init_threads(args.threads)
    from ..models.wgat import wgat
    wgat(params, args.inputs[0], args.bed)
    return 0


def _cmd_vcf2mat(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="otter-torch vcf2mat")
    p.add_argument("inputs", nargs="*", help="<VCF[.GZ]>")
    p.add_argument("-b", "--bed")
    p.add_argument("-k", "--kmer-size", dest="kmer_size", type=int, default=3)
    p.add_argument("-t", "--threads", type=int, default=1)
    args = p.parse_args(argv)
    if not args.inputs:
        p.print_help()
        return 0
    if args.kmer_size < 1 or args.kmer_size > 32:
        sys.stderr.write(
            f"[ERROR] invalid '--kmer-size' ({args.kmer_size}). "
            f"Needs to be 1 <= x <= 32.\n")
        return 1
    params = OtterOpts()
    params.init_threads(args.threads)
    from ..models.vcf2mat import vcf2mat
    vcf2mat(params, args.bed, args.inputs[0], args.kmer_size)
    return 0


def _cmd_compare(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="otter-torch compare")
    p.add_argument("inputs", nargs="*", help="<BAM> <BAM>")
    p.add_argument("-b", "--bed")
    p.add_argument("-R", "--sample-name", dest="sample_name", default="")
    p.add_argument("-t", "--threads", type=int, default=1)
    args = p.parse_args(argv)
    if len(args.inputs) < 2:
        p.print_help()
        return 0
    params = OtterOpts()
    if args.bed is None:
        sys.stderr.write("[ERROR] '--bed' parameter required\n")
        return 1
    params.read_group = args.sample_name
    params.init_threads(args.threads)
    from ..models.compare import compare
    compare(params, args.bed, args.inputs[0], args.inputs[1])
    return 0


COMMANDS = {"assemble": _cmd_assemble, "genotype": _cmd_genotype,
            "wgat": _cmd_wgat, "vcf2mat": _cmd_vcf2mat,
            "compare": _cmd_compare}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        _print_help()
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd in COMMANDS:
        return COMMANDS[cmd](rest)
    if cmd == "version":
        print(OTTER_VERSION)
        return 0
    _print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
