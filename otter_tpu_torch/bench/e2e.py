"""End-to-end bench legs: the port's ``assemble`` and ``genotype`` timed on
seeded fixtures, each held byte for byte against an exact oracle.

Counterpart of the JAX package's ``bench_e2e.py``, at its sizes and rep
counts. Its ``"auto"`` device is ``"cuda"`` here (``"cpu"`` runs the
kernels' plain versions), and ``"host"`` is the port's host mode
(``device="host"``). The fixtures are ``utils/synth.py``'s, byte for byte
the JAX bench's. What the JAX file did for a remote TPU is left out: the
device wait, the CPU fallback and the compile cache. The refscale leg's
native baseline is the smaller of its live run and the port's own pin
(``calibrate.py``, measured on the card's host; not the JAX package's
``REFSCALE_BASELINE.json``), as the JAX leg takes it.

    python -m otter_tpu_torch.bench.e2e [--regions N]

prints one JSON line: the regions leg's ``assemble_regions_per_sec`` on
the card against the host mode, and the genotype leg.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time
from typing import Optional

# build_ont_fixture's defaults: the ONT stress leg's loci
ONT_FIXTURE = dict(n_regions=16, cov=18, err=0.06, expansion=720,
                   region_len=150, seed=42, name="ont")


def card_line() -> str:
    """The card's ``nvidia-smi`` name and power limit; raises without a
    CUDA device."""
    import subprocess

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false): this runs on the card only")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()


def build_kernels() -> float:
    """Seconds to build and load the CUDA kernels and the host library."""
    from .. import native
    from ..kernels import _build

    t0 = time.perf_counter()
    _build.load()
    native.get_lib()
    return time.perf_counter() - t0


def _stats(times) -> dict:
    """Best, median, median absolute deviation and every rep's seconds."""
    ts = sorted(times)
    n = len(ts)
    med = ts[n // 2] if n % 2 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])
    mad = sorted(abs(t - med) for t in ts)[n // 2] if n else 0.0
    return {"best_s": round(min(ts), 4), "median_s": round(med, 4),
            "mad_s": round(mad, 4),
            "reps_s": [round(t, 4) for t in times]}


def _params(device: str, read_group: str = ""):
    from ..config import OtterOpts

    params = OtterOpts()
    params.device = device
    if read_group:
        params.read_group = read_group
    return params


def run(device: str, bam: str, bed: str, read_group: str = "S1",
        dist_backend=None):
    """(wall s, SAM text) of one ``assemble`` of (bam, bed) on ``device``,
    or on ``dist_backend``'s engine where one is given."""
    from ..models.assemble import assemble

    out = io.StringIO()
    t0 = time.perf_counter()
    assemble(bam, bed, "", False, _params(device, read_group), out=out,
             dist_backend=dist_backend)
    return time.perf_counter() - t0, out.getvalue()


def genotype_text(device: str, bam: str, bed: str, fa: str,
                  read_group: str = ""):
    """(wall s, VCF text) of one ``genotype`` on ``device``."""
    from ..models.genotype import genotype

    out = io.StringIO()
    t0 = time.perf_counter()
    genotype(_params(device, read_group), bam, bed, fa, out=out)
    return time.perf_counter() - t0, out.getvalue()


def merge_sams(sam_texts, path: str) -> None:
    """The samples' otter SAMs as one indexed cohort BAM at ``path``: the
    first header, every sample's @RG, every record (a merge without
    samtools)."""
    from ..io.bai import index_bam
    from ..io.bam import parse_sam_to_bam

    hdr, body = [], []
    for i, text in enumerate(sam_texts):
        for line in text.rstrip("\n").split("\n"):
            if not line.startswith("@"):
                body.append(line)
            elif i == 0 or line.startswith("@RG"):
                hdr.append(line)
    parse_sam_to_bam("\n".join(hdr + body) + "\n", path)
    index_bam(path)


def bench_genotype(tmp: str, bam: str, bed: str, n_regions: int,
                   n_samples: int = 3, device: str = "cuda",
                   reps: int = 3) -> dict:
    """Joint genotyping regions/s: ``n_samples`` samples assembled on
    ``device`` from (bam, bed), merged, then ``genotype`` timed (best of
    ``reps`` after one warm run) against ``tmp/ref.fa``."""
    texts = [run(device, bam, bed, f"S{si + 1}")[1]
             for si in range(n_samples)]
    merged = os.path.join(tmp, "cohort.bam")
    merge_sams(texts, merged)
    fa = os.path.join(tmp, "ref.fa")
    genotype_text(device, merged, bed, fa, "S1")  # warm
    times, vcf = [], ""
    for _ in range(reps):
        dt, vcf = genotype_text(device, merged, bed, fa, "S1")
        times.append(dt)
    rows = sum(1 for l in vcf.splitlines() if l and not l.startswith("#"))
    return {"genotype_regions_per_sec": round(n_regions / min(times), 2),
            "genotype_vcf_rows": rows,
            "genotype_samples": n_samples,
            "genotype_times": _stats(times)}


def _cohort_leg(tmp: str, tag: str, n_samples: int, n_regions: int,
                seed: int, reps: int, device: str) -> dict:
    """``cohort_fixture(n_samples, n_regions, seed)`` genotyped on
    ``device`` (best of ``reps`` after one warm run), its VCF against the
    host mode's."""
    from ..utils.synth import cohort_fixture

    bam, bed, fa = cohort_fixture(tmp, n_samples, n_regions, seed=seed)
    genotype_text(device, bam, bed, fa)  # warm
    times, vcf = [], ""
    for _ in range(reps):
        dt, vcf = genotype_text(device, bam, bed, fa)
        times.append(dt)
    _dt, vcf_host = genotype_text("host", bam, bed, fa)
    return {f"{tag}_regions_per_sec": round(n_regions / min(times), 2),
            f"{tag}_samples": n_samples,
            f"{tag}_vcf_identical": vcf == vcf_host,
            f"{tag}_times": _stats(times)}


def bench_genotype_cohort(tmp: str, n_samples: int = 64, n_regions: int = 32,
                          device: str = "cuda", reps: int = 5) -> dict:
    """Cohort-scale joint genotyping: n = 2 x samples + 1 alleles a
    region (genotype64)."""
    return _cohort_leg(tmp, "genotype64", n_samples, n_regions, 5, reps,
                       device)


def bench_genotype_cohort500(tmp: str, n_samples: int = 500,
                             n_regions: int = 8, device: str = "cuda",
                             reps: int = 3) -> dict:
    """The 500-sample cohort: n = 1,001 alleles a region (genotype500)."""
    return _cohort_leg(tmp, "genotype500", n_samples, n_regions, 23, reps,
                       device)


def bench_ont(tmp: str, device: str = "cuda", reps: int = 3,
              fixture: Optional[dict] = None) -> dict:
    """The ONT stress leg: 2.3 kb het expansions at 6% read error (the
    gap-affine consensus regime), best of ``reps`` after one warm run,
    against the native affine ladder (``OTTER_TPU_AFFINE_DEVICE=0``)."""
    from ..utils.synth import tandem_repeat_loci

    fx = dict(ONT_FIXTURE, **(fixture or {}))
    bam, bed = tandem_repeat_loci(tmp, **fx)

    def run_ont(env: dict):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            return run(device, bam, bed, "ONT1")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    run_ont({})  # warm
    times, out_card = [], ""
    for _ in range(reps):
        dt, out_card = run_ont({})
        times.append(dt)
    dt_nat, out_nat = run_ont({"OTTER_TPU_AFFINE_DEVICE": "0"})
    n = fx["n_regions"]
    return {"ont_regions_per_sec": round(n / min(times), 2),
            "ont_native_regions_per_sec": round(n / dt_nat, 2),
            "ont_outputs_identical": out_card == out_nat,
            "ont_times": _stats(times)}


def refscale_fixture(tmp: str, n_regions: int = 2, cov: int = 200,
                     allele_bp: int = 10000):
    """The reference-scale loci under ``tmp`` (coverage ``cov``,
    ``allele_bp`` alleles, 0.2% error, seed 77): (bam, bed, a bed of region
    1 alone, region 1's bed line)."""
    from ..utils.synth import tandem_repeat_loci

    bam, bed = tandem_repeat_loci(tmp, n_regions=n_regions, cov=cov,
                                  err=0.002, expansion=100,
                                  region_len=allele_bp, seed=77,
                                  name="refscale")
    with open(bed) as fh:
        first = fh.read().splitlines()[0]
    bed1 = os.path.join(tmp, "refscale_r1.bed")
    with open(bed1, "w") as fh:
        fh.write(first + "\n")
    return bam, bed, bed1, first


def native_region(device: str, bam: str, bed1: str):
    """(wall s, SAM text) of ``bed1``'s region on the native engine
    (``NativeDistBackend``): the refscale leg's baseline, live and
    pinned."""
    from ..kernels.dist_backend import NativeDistBackend

    return run(device, bam, bed1, "RS1", dist_backend=NativeDistBackend())


def bench_refscale(tmp: str, device: str = "cuda", n_regions: int = 2,
                   cov: int = 200, allele_bp: int = 10000, reps: int = 4,
                   native: bool = True) -> dict:
    """The reference-scale leg: the reference's defaults, coverage 200 and
    10 kb alleles at HiFi-grade error (19,900 pairs of ~10 kb a region).
    ``n_regions`` regions on ``device``, the median of ``reps`` after a
    warm run on region 1; with ``native``, region 1 on the native engine
    (``native_region``), its wall and its records byte for byte against
    the card's. ``refscale_vs_native`` divides the smaller of that wall
    and the pinned one (``calibrate.native_region_claim``) by the card's
    median region."""
    from . import calibrate

    bam, bed, bed1, first = refscale_fixture(tmp, n_regions, cov, allele_bp)
    run(device, bam, bed1, "RS1")  # warm
    times, out_card = [], ""
    for _ in range(reps):
        dt, out_card = run(device, bam, bed, "RS1")
        times.append(dt)
    med = _stats(times)["median_s"]
    out = {"refscale_regions_per_sec": round(n_regions / med, 4),
           "refscale_region_sec_median": round(med / n_regions, 3),
           "refscale_cov": cov, "refscale_allele_bp": allele_bp,
           "refscale_times": _stats(times)}
    if native:
        dt_nat, out_nat = native_region(device, bam, bed1)
        claim, pin = calibrate.native_region_claim(dt_nat, cov, allele_bp)
        chrom, start, end = first.split("\t")[:3]
        prefix = f"{chrom}:{start}-{end}_"
        r1 = [l for l in out_card.splitlines()
              if l.startswith("@") or l.split("\t")[0].startswith(prefix)]
        out.update({
            "refscale_native_region_sec": round(dt_nat, 2),
            "refscale_native_region_sec_pinned": (
                None if pin is None else round(pin, 2)),
            "refscale_vs_native": round(claim / (med / n_regions), 2),
            "refscale_region1_identical": r1 == out_nat.splitlines()})
    return out


def assemble_vs_host(tmp: str, n_regions: int, device: str, reps: int):
    """``region_fixture(n_regions)`` under ``tmp`` assembled on ``device``
    (``reps`` timed runs after a warm one) and in the host mode: (bam,
    bed, rep walls, SAM text, host-mode wall, host-mode SAM text)."""
    from ..utils.synth import region_fixture

    bam, bed, _fa = region_fixture(tmp, n_regions=n_regions)
    run(device, bam, bed)  # warm
    times, text = [], ""
    for _ in range(reps):
        dt, text = run(device, bam, bed)
        times.append(dt)
    dt_host, out_host = run("host", bam, bed)
    return bam, bed, times, text, dt_host, out_host


def bench_assemble(tmp: str, n_regions: int = 100, device: str = "cuda",
                   reps: int = 3) -> dict:
    """``bench_e2e.py``'s own leg: ``region_fixture(n_regions)`` assembled
    on ``device`` (best of ``reps`` after a warm run) against the host
    mode, then the genotype leg on its alleles."""
    bam, bed, times, text, dt_host, out_host = assemble_vs_host(
        tmp, n_regions, device, reps)
    dt = min(times)
    result = {
        "metric": "assemble_regions_per_sec",
        "value": round(n_regions / dt, 2),
        "unit": "regions/s",
        "vs_baseline": round(dt_host / dt, 2),
        "host_regions_per_sec": round(n_regions / dt_host, 2),
        "alleles": sum(1 for l in text.split("\n")
                       if l and not l.startswith("@")),
        "outputs_identical": text == out_host,
        "times": _stats(times),
    }
    result.update(bench_genotype(tmp, bam, bed, n_regions, device=device))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m otter_tpu_torch.bench.e2e",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--regions", type=int, default=100)
    args = ap.parse_args(argv)
    card = card_line()
    build_s = build_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        result = bench_assemble(tmp, args.regions)
    result.update({"platform": "cuda", "card": card,
                   "build_s": round(build_s, 2)})
    print(json.dumps(result), flush=True)
    return 0 if result["outputs_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
