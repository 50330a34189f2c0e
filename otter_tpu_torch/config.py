"""Validated configuration object (parity with reference src/otter_opts.{hpp,cpp}).

Defaults live in the CLI parsers (see cli/_parsers.py), matching the
reference's cxxopts defaults (src/command_assemble.cpp:34-45,
src/command_genotype.cpp:25-26). Validation rules mirror
src/otter_opts.cpp: threads clamped 1..32 (:93), mapq 0..60 (:56),
flank 21..<10000 (:150), [0,1] range checks (:21-24).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from .utils.timestamp import antimestamp

# Settings the JAX package reads that pick a TPU layout or dispatch shape;
# no output byte depends on them and the port has no such choice to make,
# so it reads none of them. Every other setting of the JAX package is
# honoured: the consensus routes (OTTER_TPU_AFFINE_DEVICE,
# OTTER_TPU_AFFINE_HINTS, ops/consensus.py), the finish pool
# (OTTER_TPU_FINISH_POOL), the fused distance and KDE collect
# (OTTER_TPU_FUSED_KDE) and the opt-in device paths (OTTER_TPU_KMER_DEVICE,
# OTTER_TPU_HCLUST_DEVICE, OTTER_TPU_POA_DEVICE on K10-K12) all run.
NO_OP_SETTINGS = {
    "OTTER_TPU_MYERS_POOL": "the Myers pair pool: K1 always reads the pool",
    "OTTER_TPU_MYERS_PACKED": "the packed Myers layout: K1 has one layout",
    "OTTER_TPU_NATIVE_PACK": "the C++ packer of the TPU's Myers inputs",
    "OTTER_TPU_SPEC_CELLS": "the TPU ladder's speculative rungs, not ported",
    "OTTER_TPU_PROFILE": "the jax.profiler hook, which nothing calls",
}


class OtterConfigError(SystemExit):
    pass


def _die(msg: str) -> None:
    sys.stderr.write(f"({antimestamp()}): [ERROR] {msg}\n")
    raise OtterConfigError(0)  # reference exits with code 0 on bad opts (otter_opts.cpp:41)


def _is_zero_one(x: float) -> bool:
    return 0.0 <= x <= 1.0


@dataclass
class OtterOpts:
    offset_l: int = 1
    offset_r: int = 0
    max_alleles: int = 2
    mapq: int = 0
    read_quality: float = 0.0
    max_cov: int = 200
    min_cov_fraction: float = 0.2
    min_cov_fraction2_l: int = 500
    min_cov_fraction2_f: float = 0.1
    threads: int = 1
    max_error: float = 0.01
    bandwidth_short: float = 0.01
    bandwidth_long: float = 0.015
    bandwidth_length: int = 500
    flank: int = 100
    min_sim: float = 0.9
    nonprimary: bool = False
    is_fa: bool = False
    omitnonspanning: bool = False
    ignore_haps: bool = True
    is_debug: bool = False
    read_group: str = ""
    max_cosdis: float = 0.025
    # execution knobs (no reference analog)
    # cuda|cpu|mesh|host: where the kernels run (the card, their plain
    # versions on the CPU, the visible cards); "host" runs none: the
    # sequential pure-host path of the JAX package's --device host
    device: str = "cuda"
    precise_kde: bool = True   # float64 host KDE for bit-parity

    def init_offset(self, tmp: str) -> None:
        parts = [p for p in "".join(tmp.split()).split(",")]
        try:
            if len(parts) == 1:
                self.offset_l = int(parts[0])
                self.offset_r = int(float(parts[0]))
            elif len(parts) == 2:
                self.offset_l = int(parts[0])
                self.offset_r = int(float(parts[1]))
            else:
                _die(f"Invalid offset value: {tmp}")
        except ValueError:
            _die(f"Invalid offset value: {tmp}")

    def init_max_alleles(self, v: int) -> None:
        if v >= 0:
            self.max_alleles = v
        else:
            _die(f"Invalid maximum-alleles value: {v}")

    def init_mapq(self, v: int) -> None:
        if 0 <= v <= 60:
            self.mapq = v
        else:
            _die(f"Invalid mapq value: {v}")

    def init_read_quality(self, v: float) -> None:
        if _is_zero_one(v):
            self.read_quality = v
        else:
            _die(f"Invalid read-quality value: {v}")

    def init_max_cov(self, v: int) -> None:
        if v >= 0:
            self.max_cov = v
        else:
            _die(f"Invalid max-coverage value: {v}")

    def init_min_cov_fraction(self, v: float) -> None:
        if _is_zero_one(v):
            self.min_cov_fraction = v
        else:
            _die(f"Invalid _min_cov_fraction value: {v}")

    def init_threads(self, v: int) -> None:
        if 0 < v <= 32:
            self.threads = v
        else:
            _die(f"Invalid threads value: {v}")

    def init_max_error(self, v: float) -> None:
        if _is_zero_one(v):
            self.max_error = v
        else:
            _die(f"Invalid max-error value: {v}")

    def init_max_cosdis(self, v: float) -> None:
        if _is_zero_one(v):
            self.max_cosdis = v
        else:
            _die(f"Invalid max cosine-dissimilarity value: {v}")

    def init_bandwidth(self, tmp: str) -> None:
        parts = [p for p in "".join(tmp.split()).split(",") if p != ""]
        if not parts:
            _die(f"expected single string or comma-separated values: {tmp}")
        self.bandwidth_short = float(parts[0])
        if len(parts) == 1:
            self.bandwidth_long = self.bandwidth_short
            self.bandwidth_length = 0
        elif len(parts) == 3:
            self.bandwidth_long = float(parts[2])
            self.bandwidth_length = int(parts[1])
        else:
            _die(f"expected three comma-separated values: {tmp}")
        if not (
            _is_zero_one(self.bandwidth_short)
            and _is_zero_one(self.bandwidth_long)
            and self.bandwidth_length >= 0
        ):
            _die(
                "Bandwidth values must be 0 <= x <= 1.0 and length >= 0, found: "
                f"({self.bandwidth_short},{self.bandwidth_length},{self.bandwidth_long})"
            )

    def init_flank(self, v: int) -> None:
        if 21 <= v < 10000:
            self.flank = v
        else:
            _die(f"Invalid flanking-sequence size for realignment: {v}")

    def init_min_sim(self, v: float) -> None:
        if _is_zero_one(v):
            self.min_sim = v
        else:
            _die(f"Invalid min-similarity for realignment: {v}")

    def init_min_cov_fraction2(self, tmp: str) -> None:
        parts = [p for p in "".join(tmp.split()).split(",")]
        if len(parts) == 2:
            self.min_cov_fraction2_l = int(parts[0])
            self.min_cov_fraction2_f = float(parts[1])
        else:
            _die(f"expected two comma-separated values: {tmp}")
