"""The sharded forward step's example and the multichip dry run.

Counterpart of the JAX package's entry points in
``__graft_entry__.py`` (``_example_pair_batch``, ``entry``,
``dryrun_multichip``): the same pair batch from the same seed, the same
step (``parallel/mesh.py::region_batch_step``: K7 distances, K14
densities) and the same four checks of the mesh, on the cards of one
process or on the devices a caller passes (a CPU mesh ``(cpu,) * N`` in the
tests, one card in two shards ``(cuda:0, cuda:0)``).

    from otter_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8, devices=(torch.device("cpu"),) * 8)   # the CPU
    dryrun_multichip(torch.cuda.device_count())               # the cards
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import random
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels.edit_banded import pack_bucket
from .mesh import make_mesh, region_batch_step, run_sharded_region_step

GRID_PTS = 401


def example_pair_batch(n_pairs: int = 8, length: int = 96, seed: int = 0,
                       n_regions: int = 2):
    """The JAX package's ``_example_pair_batch``: ``n_pairs`` random
    ``length``-bp ACGT sequences each against a copy with ~1% each of
    substitutions, insertions and deletions, pair p in region p %
    n_regions, packed at k = 63 (``pack_bucket``: padding pairs invalid).
    Returns (a, bpad, mn, region_id, valid, k, L), numpy."""
    rng = random.Random(seed)

    def rand_seq(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < 0.01:
                out.append(rng.choice("ACGT"))
            elif r < 0.02:
                out.extend([ch, rng.choice("ACGT")])
            elif r < 0.03:
                pass
            else:
                out.append(ch)
        return "".join(out)

    pairs = []
    region_id = []
    for p in range(n_pairs):
        base = rand_seq(length)
        pairs.append((base, mutate(base)))
        region_id.append(p % n_regions)
    k = 63
    a, bp, mn, L = pack_bucket(pairs, k)
    B = a.shape[0]
    rid = np.zeros(B, dtype=np.int32)
    rid[: len(region_id)] = region_id
    valid = np.zeros(B, dtype=bool)
    valid[: len(pairs)] = True
    return a, bp, mn, rid, valid, k, L


def entry(device="cuda"):
    """(fn, example_args): the forward step of the assemble pipeline on
    ``device`` (a banded edit-distance pair batch through per-region KDE
    densities), with the example batch's tensors there."""
    a, bp, mn, rid, valid, k, L = example_pair_batch()
    n_regions = 2
    bw = np.full(n_regions, 0.01, dtype=np.float32)

    def fn(a, bp, m, n, rid, valid, bw):
        return region_batch_step(a, bp, m, n, rid, valid, bw, k=k,
                                 max_rows=L, n_regions=n_regions,
                                 grid_pts=GRID_PTS)

    example_args = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                         for x in (a, bp, mn[:, 0], mn[:, 1], rid, valid,
                                   bw))
    return fn, example_args


@contextlib.contextmanager
def _settings(**env):
    """Set the given settings (None unsets one) for the block."""
    old = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _assemble_text(bam: str, bed: str, read_group: str, mesh=None) -> str:
    """The port's assemble of (bam, bed): on ``mesh`` (its engine split
    over the devices, the device KDE forced on, as the JAX dry run forces
    its tree KDE), or with ``mesh`` None in the host mode
    (``device="host"``), as the JAX dry run's oracle runs."""
    from ..config import OtterOpts
    from ..kernels.dist_backend import TorchDistBackend
    from ..models.assemble import assemble

    params = OtterOpts()
    params.read_group = read_group
    out = io.StringIO()
    if mesh is None:
        params.device = "host"
        assemble(bam, bed, "", False, params, out=out)
        return out.getvalue()
    params.device = mesh[0].type
    with _settings(OTTER_TPU_MESH_KDE="1"):
        assemble(bam, bed, "", False, params, out=out,
                 dist_backend=TorchDistBackend(mesh=mesh))
    return out.getvalue()


def _genotype_text(bam: str, bed: str, fa: str, mesh=None) -> str:
    """The port's genotype: its batched pipeline's GEMM split over
    ``mesh``, or with ``mesh`` None the host mode's sequential path."""
    from ..config import OtterOpts
    from ..models.genotype import genotype

    params = OtterOpts()
    params.device = "host" if mesh is None else mesh[0].type
    out = io.StringIO()
    genotype(params, bam, bed, fa, out=out, mesh=mesh)
    return out.getvalue()


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> dict:
    """Check the mesh path end to end on a mesh of ``n_devices`` (the
    visible cards, or the first ``n_devices`` of ``devices``), as the JAX
    package's dry run does; raises on a failed check, returns what it
    measured:

    1. the sharded forward step (K7 a shard, K14 on the first device) on
       the example batch: densities (2, 401) finite, each row summing to 1,
       the valid pairs' distances under 40;
    2. the full ``assemble`` with the engine split over the mesh and the
       device KDE on, byte-identical to the port's host mode
       (``device="host"``: no kernel, no engine), as the JAX dry run
       holds its mesh run against its ``device="host"``;
    3. regions/s of that assemble on meshes of 1, 2, 4 and 8 devices (up to
       ``n_devices``), each output byte-identical again;
    4. ``genotype`` of two mesh-assembled samples merged into a cohort BAM,
       its GEMM split over the mesh, byte-identical to the host mode's
       sequential path."""
    from ..io.bai import index_bam
    from ..io.bam import parse_sam_to_bam
    from ..utils.synth import region_fixture

    mesh = make_mesh(n_devices, devices)
    if len(mesh) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(mesh)}")
    result = {"devices": [str(d) for d in mesh]}
    n_pairs = max(16, n_devices * 8)
    a, bp, mn, rid, valid, k, L = example_pair_batch(n_pairs=n_pairs)
    n_regions = 2
    bw = np.full(n_regions, 0.01, dtype=np.float32)
    dists, dens = run_sharded_region_step(
        mesh, a, bp, mn[:, 0], mn[:, 1], rid, valid, bw, k=k, max_rows=L,
        n_regions=n_regions, grid_pts=GRID_PTS)
    dists = dists.cpu().numpy()
    dens = dens.cpu().numpy()
    assert dens.shape == (n_regions, GRID_PTS)
    assert np.all(np.isfinite(dens))
    np.testing.assert_allclose(dens.sum(axis=1), 1.0, rtol=1e-3)
    assert dists[valid].max() < 40
    print(f"dryrun_multichip({n_devices}): kernel step ok - "
          f"{int(valid.sum())} pairs, {n_regions} regions, max dist "
          f"{int(dists[valid].max())}", flush=True)
    result["step_max_dist"] = int(dists[valid].max())

    n_loci = max(6, n_devices)
    with tempfile.TemporaryDirectory() as tmp:
        bam, bed, fa = region_fixture(tmp, n_regions=n_loci, cov=10)
        want = _assemble_text(bam, bed, "S1")
        got = _assemble_text(bam, bed, "S1", mesh)
        assert got == want, "mesh-sharded assemble diverged from the host mode"
        n_alleles = sum(1 for line in got.splitlines()
                        if line and not line.startswith("@"))
        print(f"dryrun_multichip({n_devices}): full assemble ok - {n_loci} "
              f"regions, {n_alleles} alleles, byte-identical to the host mode",
              flush=True)
        result["alleles"] = n_alleles

        per_size = {}
        for size in (s for s in (1, 2, 4, 8) if s <= n_devices):
            walls = []
            for _rep in range(3):  # the first run warms this mesh size
                t0 = time.perf_counter()
                text = _assemble_text(bam, bed, "S1", mesh[:size])
                if mesh[0].type == "cuda":
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                assert text == want
            per_size[str(size)] = n_loci / min(walls[1:])
        base = per_size["1"]
        scaling = {"workload_regions": n_loci, "devices": str(mesh[0]),
                   "host_cpu_count": os.cpu_count(),
                   "regions_per_sec": per_size,
                   "efficiency_vs_1dev": {s: r / (base * int(s))
                                          for s, r in per_size.items()}}
        print("dryrun_multichip scaling: " + json.dumps(scaling), flush=True)
        result["scaling"] = scaling

        merged = []
        for s_i in range(2):
            text = _assemble_text(bam, bed, f"S{s_i + 1}", mesh)
            for line in text.rstrip("\n").split("\n"):
                if not line.startswith("@") or s_i == 0 \
                        or line.startswith("@RG"):
                    merged.append(line)
        hdr = [line for line in merged if line.startswith("@")]
        body = [line for line in merged if not line.startswith("@")]
        cohort = os.path.join(tmp, "dryrun_cohort.bam")
        parse_sam_to_bam("\n".join(hdr + body) + "\n", cohort)
        index_bam(cohort)
        vcf_mesh = _genotype_text(cohort, bed, fa, mesh)
        vcf_host = _genotype_text(cohort, bed, fa)
        assert vcf_mesh == vcf_host, \
            "mesh-sharded genotype diverged from the host mode"
        rows = sum(1 for line in vcf_mesh.splitlines()
                   if line and not line.startswith("#"))
    print(f"dryrun_multichip({n_devices}): full genotype ok - {rows} VCF "
          "rows (2 samples), byte-identical to the host mode", flush=True)
    result["vcf_rows"] = rows
    return result
