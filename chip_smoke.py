#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``otter_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; a failed phase raises and the script
exits non-zero:

1. environment: torch and CUDA versions, the card's name and power limit
   (fails without a CUDA device);
2. build: compiles the kernels (``otter_tpu_torch/csrc/*.cu``) with nvcc,
   prints each kernel's registers and spills and its SASS longest loop
   (for K8, each step loop's SASS per (cell, value));
3. kernels: each kernel of the assemble path (K1 Myers pool, K2 striped
   Myers, K3 / K4 banded Myers, K7 banded edit DP, K9 banded two-sided
   ends-free edit DP, K5 / K6 affine traceback with all bits / with
   checkpoints, K8 scaled KDE)
   equals its plain PyTorch version on the card, exactly, and agrees with
   the package's host oracles (native C++ distances, the numpy ends-free DP,
   the native affine cigar ladder); then the time of the kernel and of the
   plain version on one workload of the shape the main path gives it, its
   band (or DP) Gcells/s and its bound; K9 (held against the numpy pass of
   ``edit_ends_free_batch`` too) at k = 32 ... 511 (the warp kernel),
   512 and 1023 ... 8191 on 10 kb reads (a block of P warps), 9000 on
   10 kb reads (the block kernel), each with the kernel and instance it
   takes, timed on 64 jobs shaped like the route-coverage cell's passes;
   K2 also at every lane-group size G on its timing set, K7 also at k = 1023 (its block kernel); K3 and K4 at
   every lane-group size on their timing sets and on sets shaped like the
   reference-default region's rungs (10 kb pairs at k = 63 and 511, K4 with
   free begins up to 2 kb); K5 and K6 are swept over every band they have
   an instance for (k = 63, 127, 255, 511), K7 over k = 31 ... 1023, K2
   over every (G, q) shape its wrapper can pick and K3 / K4 over every
   (G, q) theirs can, exact; K8 on three sets (hifi-tr-1.5k's batch of 32
   regions x 4,950 values, the refscale region's 1 x 19,900, the largest
   batch 256 x 19,900): m equal, s within a relative 1e-6 and the same
   certified decisions as its plain version, each set with the launch the
   kernel's rule picks (W warps a cell group, cells a thread, blocks) and
   the count of cells whose s is not bit-equal to the plain version's
   (expf against torch.exp);
4. small main path: the port's ``assemble`` on the card writes the same SAM
   and FASTA bytes as on the exact host engine
   (``kernels/dist_backend.py::NativeDistBackend``: native C++ distances,
   host ends-free DP, native affine ladder) and as the port's host mode
   (``device="host"``: no engine, the python read extractor, the numpy
   pair DP, region by region), with every kernel's launch count set to 0
   just before each host-mode run and still 0 after it;
5. full-size main path: cell hifi-tr-1.5k (32 HiFi tandem-repeat loci at
   coverage 100, het alleles of 1.5 and 1.8 kb), with its rates; and a
   route-coverage run (4 loci with non-spanning reads, a 2.4 kb allele and
   reads with N bases; 2 loci with a 7.5 kb allele) that reaches every
   kernel, checked for parity only; and one region at the reference's
   defaults (coverage 200, 10 kb alleles: every pair goes to the K3
   ladder), with its rates.
   Each runs on the card and on the host engine: byte-identical output
   (the host engine's runs, minutes of native C++ distances, go to a side
   process, ``--host-oracle``, started before phase 3).
   Every kernel's launch count is zeroed before the card runs and read
   after them; each must have launched, and K8 in hifi-tr-1.5k and the
   refscale region. Each card run prints its K3 / K4 ladder calls: the
   rungs each ran and the jobs launched and resolved at each (a job a
   rung did not resolve skips to the first rung >= min(its banded score,
   8 k)), and the jobs left to K2. Then those two cells with the device
   KDE on and off (``OTTER_TPU_MESH_KDE=0``) in turns, their walls and
   KDE phase seconds;
   then K2 is timed at the shape of its launch in hifi-tr-1.5k (that run's
   ``jobs_k2`` count of jobs);
6. the other entry points: ``genotype`` on bench_e2e's 64-sample x 32-region
   and 500-sample x 8-region cohorts, the card's GEMM route
   (``OTTER_TPU_GENOTYPE_DEVICE=1``) and the host BLAS route (the default)
   in turns with their regions/s, each VCF byte-identical to the port's
   host mode (the sequential path with the python allele parser);
   ``compare`` on a seeded truth / query pair on the card's engine,
   byte-identical to the host mode (the scalar path); every host-mode run
   with no kernel launched; ``vcf2mat`` on the 64-sample VCF and ``wgat``
   on a seeded aligned assembly, checked against what their inputs hold;
   then ``assemble --device host`` on phase 4's cells and ``genotype
   --device host`` on genotype64 in fresh processes (``--dist-worker``):
   the same bytes, no launch and no CUDA context made; and one line with
   the host mode's walls beside the card's;
7. ``-t`` and several processes: hifi-tr-1.5k at ``-t 1`` and ``-t 8`` in
   turns (walls, ``host_io``), each byte-identical to phase 5's card
   output, and with ``OTTER_TPU_FINISH_POOL=1 -t 8`` (eight spawned
   workers on the host; K1 and K8 must launch in this process),
   byte-identical again; then the port's command line in
   separate processes sharing the card (``--dist-worker``): hifi-tr-1.5k in
   one process, in two over gloo
   with per-process streams and with ``OTTER_TPU_GATHER=1``, and in one
   again, each output byte-identical to phase 5's, each process's kernel
   launches read from its own counters (K1, K2, K5 and K8 must launch in
   every process), walls from start to exit; genotype64 in two processes
   with the gather, its VCF byte-identical to phase 6's;
8. mesh mode (``params.device = "mesh"``: the distance pairs, the
   ends-free jobs, the pooled KDE and genotype's GEMM split over the cards
   of one process) on the mesh of every visible card and on two shards of
   card 0: every phase 5 cell, byte-identical to its phase 5 card output
   (K1, K2, K5 and K8 must launch in hifi-tr-1.5k, K9 in the route-coverage
   run, and every kernel across the cells), hifi-tr-1.5k once more through
   ``params.device = "mesh"`` with no backend, genotype64 (VCF
   byte-identical to phase 6's) and compare (TSV byte-identical to phase
   6's), with walls, each shard's pair and job counts and the kernel
   launches; then the route-coverage cell once more with K9's inputs
   recorded, and K9 and its plain version timed on its largest pass;
9. the JAX package's opt-in device paths, each end to end on the card with
   the opt-in kernels' counts zeroed just before and read just after, its
   output byte-identical to the default route's (phases 5 and 6), its
   kernel launched: hifi-tr-1.5k and the refscale region with
   ``OTTER_TPU_POA_DEVICE=1`` (K12; walls beside phase 5's), genotype64
   and genotype500 with ``OTTER_TPU_KMER_DEVICE=1`` (K10), genotype64 with
   ``OTTER_TPU_NATIVE_HCLUST=0 OTTER_TPU_HCLUST_DEVICE=1`` (its tie-full
   matrices: K11's launches and the guard's declines printed) and a
   16-sample cohort of 8 VNTR loci (a length allele a haplotype: tie-free
   length matrices, on which K11 must launch) and a 128-sample cohort of 4
   (distinct prime lengths, ``-e 0.1``: K11's cluster route must launch),
   hifi-tr-1.5k in mesh mode
   on two shards of card 0 with ``OTTER_TPU_POA_DEVICE=1`` (K12 on each
   shard); then each kernel exact against its plain version and timed:
   K10 on the two cohorts' allele batches (k = 3) and at k = 8 (the
   device-memory histogram), with ``torch.bincount`` of the window keys as
   its library call; K11 on seeded tie-free matrices at n = 129 and 1,001
   (the route each takes, bit for bit the L2 route's, the one-block
   kernel with D in device memory, and timed beside it), partitions equal
   to the native NN-chain's at three cuts; K12 on the graphs of the
   hifi-tr-1.5k and refscale runs (the route, bit for bit the global
   route's, a warp a graph level by level, timed beside);
10. the sharded forward step (``parallel/mesh.py::run_sharded_region_step``:
   K7 a shard, K14 on the first card) on the mesh of every visible card
   and on two shards of card 0, at the JAX dry run's shapes and at the
   JAX bench regions leg's (11,904 pairs over 128 regions), distances
   equal to K7's plain version and densities bit-identical across the
   meshes; ``dryrun_multichip`` in full on both meshes (its assemble and
   genotype byte-identical to the port's host mode); K14 (that batch, and
   hifi-tr-1.5k's 160,429 pairs over 32 regions; its grouping sort and the
   grouping + kernel timed beside it) and K13 (through
   ``kde_tree`` on K8's three sets) against their plain versions (a
   relative 1e-6 a cell, the cells not bit-equal counted) and timed; then
   hifi-tr-1.5k and the refscale region with ``OTTER_TPU_FUSED_KDE=1`` and
   ``=0`` in turns (walls, K8 on both routes), and hifi-tr-1.5k with
   ``OTTER_TPU_AFFINE_DEVICE=0`` (K5 must not launch),
   ``OTTER_TPU_AFFINE_HINTS=0`` and ``=1``, every output byte-identical to
   phase 5's;
11. the benches: the legs of ``python -m otter_tpu_torch.bench``
   (``otter_tpu_torch/bench/legs.py``: kernel, regions with genotype,
   genotype64 and genotype500, refscale, ONT, device affine) called in
   this process at the JAX bench's sizes, one timed rep each, the
   refscale leg on 1 region without its native wall (the line of cuts
   names them all), then ``bench/profile.py`` on 96 regions and
   ``demo.py``; each with every kernel's launch count zeroed before it
   and printed after it (K1 must launch in the kernel leg, K5 or K6 in the
   device leg), every ``*_identical`` / ``*_parity`` flag true; then
   each of the two ratios with its live value, its pinned value
   (``otter_tpu_torch/bench/baselines.json``, ``bench/calibrate.py``) and
   the value the max / min rule uses: ``vs_baseline`` from the kernel
   leg's one-core rate, ``refscale_vs_native`` from phase 5's host-engine
   wall of the same refscale region (measured beside phase 3) over this
   leg's region.

The line before the last is a JSON object with each kernel's launches in
phase 5 (K9's in phase 8, K10-K12's in phase 9, K13's and K14's in phase
10: their only paths), its largest disagreement with its plain version,
its times and its bound; the last line is ``{"ok": true, "device":
{...}}``. Every input is made from
a seed; nothing is read from the network.

    python3 chip_smoke.py --profile

runs phases 1-2 and then cell hifi-tr-1.5k three times untimed by the
profiler and once under ``torch.profiler``: the device's busy time and
share of the wall, and the device time of each kernel.

A kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its int32 operations over the card's
int32 rate (132 SMs x 64 lanes x the SM clock ``nvidia-smi`` reports as
``clocks.max.sm``), with the operations per DP cell in ``OPS_PER_CELL``,
counted from the sources; phase 2 prints the compiled SASS counts beside
them. K8's operations are its exps over the MUFU rate (132 x 16 a clock)
or its ``KDE_F32_OPS`` f32 operations a (cell, value) over the f32 rate
(132 x 128 a clock), whichever is longer. K10's are 3 k + 4 int32
operations a window; K11's 4 f32 operations an active row a step (its
pass over the rows, and the merged row's multiply, fma and division);
K12's 2 f32 operations an edge (the add and the compare); K13's and
K14's exps over the MUFU rate or their 6 f32 operations a term
(``KDE_TERM_F32_OPS``), whichever is longer. K11 and K12 are
chains of dependent steps (n - 1 merges; a graph's levels), so their
lines give the steps beside the share.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)

# name -> (source, TPU kernel it replaces)
KERNELS = {
    "myers_pool": ("otter_tpu_torch/csrc/myers.cu",
                   "otter_tpu/kernels/myers_pallas.py:146"),
    "myers_striped": ("otter_tpu_torch/csrc/myers_striped.cu",
                      "otter_tpu/kernels/myers_striped.py:47"),
    "myers_banded": ("otter_tpu_torch/csrc/myers_banded.cu",
                     "otter_tpu/kernels/myers_banded.py:176"),
    "myers_banded_ef": ("otter_tpu_torch/csrc/myers_banded.cu",
                        "otter_tpu/kernels/myers_banded.py:654"),
    "edit_banded": ("otter_tpu_torch/csrc/edit_banded.cu",
                    "otter_tpu/kernels/edit_pallas.py:227"),
    "affine_tb": ("otter_tpu_torch/csrc/affine_tb.cu",
                  "otter_tpu/kernels/affine_pallas.py:99"),
    "affine_tb_ckpt": ("otter_tpu_torch/csrc/affine_tb.cu",
                       "otter_tpu/kernels/affine_pallas.py:395"),
    "kde_scaled": ("otter_tpu_torch/csrc/kde_scaled.cu",
                   "otter_tpu/parallel/mesh.py:111 (jnp)"),
    "edit_banded_ends_free": ("otter_tpu_torch/csrc/edit_banded.cu",
                              "otter_tpu/kernels/edit_pallas.py:127 (jnp)"),
    "kmer_counts": ("otter_tpu_torch/csrc/kmer_counts.cu",
                    "otter_tpu/seqs/kmer.py:128 (jnp)"),
    "linkage": ("otter_tpu_torch/csrc/linkage.cu",
                "otter_tpu/ops/hclust_device.py:31 (jnp)"),
    "poa_heaviest": ("otter_tpu_torch/csrc/poa_heaviest.cu",
                     "otter_tpu/ops/poa_device.py:106 (jnp)"),
    "kde_tree": ("otter_tpu_torch/csrc/kde_scaled.cu",
                 "otter_tpu/parallel/mesh.py:82 (jnp)"),
    "kde_pairs": ("otter_tpu_torch/csrc/kde_pairs.cu",
                  "otter_tpu/parallel/mesh.py:64 (jnp)"),
}


# int32 operations per DP cell, counted from the sources: K1-K4 advance 64
# cells with ~36 int32 operations (myers.cu's note), K7 ~10 per band cell,
# K9 ~12 (K7's, the max of column 0 and the bounded text read), K5 / K6
# ~28 per band cell (the DP once; K6's recompute is not counted)
OPS_PER_CELL = {"myers_pool": 36 / 64, "myers_striped": 36 / 64,
                "myers_banded": 36 / 64, "myers_banded_ef": 36 / 64,
                "edit_banded": 10.0, "edit_banded_ends_free": 12.0,
                "affine_tb": 28.0, "affine_tb_ckpt": 28.0}
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 132 * 64
MUFU_LANES = 132 * 16
F32_LANES = 132 * 128
# K8's f32 operations a (cell, value): sub, div, 2 mul, max, sub, add
KDE_F32_OPS = 7
# K13's and K14's a (cell, value): sub, div, 2 mul, the product by
# INV_SQRT_2PI / h, add
KDE_TERM_F32_OPS = 6
# set by phase 1: the SM clock (Hz) and the card's nvidia-smi name and
# power limit
CARD = {"sm_hz": None, "line": None}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_wrappers() -> dict:
    """Kernel name -> the wrapper whose ``launches`` counts its launches."""
    from otter_tpu_torch.kernels import affine_tb, edit_banded, kde_scaled
    from otter_tpu_torch.kernels import myers_banded, myers_pallas
    from otter_tpu_torch.kernels import myers_striped

    return {"myers_pool": myers_pallas.myers_pool_cuda,
            "myers_striped": myers_striped.myers_striped_cuda,
            "myers_banded": myers_banded.myers_banded_cuda,
            "myers_banded_ef": myers_banded.myers_banded_ef_cuda,
            "edit_banded": edit_banded.edit_banded_cuda,
            "affine_tb": affine_tb.affine_tb_cuda,
            "affine_tb_ckpt": affine_tb.affine_tb_ckpt_cuda,
            "kde_scaled": kde_scaled.kde_scaled_cuda,
            "edit_banded_ends_free": edit_banded.edit_banded_ends_free_cuda}


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    by CUDA events on the current stream. A 20 ms sleep on the stream
    first lets the host queue the runs, so a short kernel is timed back to
    back and not at the pace of its wrapper's host code."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(0.02 * CARD["sm_hz"]))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def time_once(fn):
    """(ms, result) of one run of ``fn()`` by CUDA events, no warm-up: the
    plain versions take seconds, so a first call's overhead is noise, and
    their result is the reference the kernel is held against."""
    import torch

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1), out


def rand_acgt(rs: np.random.Generator, n: int) -> str:
    return ACGT[rs.integers(0, 4, n)].tobytes().decode()


def mutate(rs: np.random.Generator, s: str, err: float) -> str:
    """Substitutions, insertions and deletions at total rate ``err``."""
    if not s or err <= 0:
        return s
    codes = np.frombuffer(s.encode(), dtype=np.uint8)
    u = rs.random(len(codes))
    sub = u < err * 0.4
    ins = (u >= err * 0.4) & (u < err * 0.7)
    keep = ~((u >= err * 0.7) & (u < err))
    base = np.where(sub, ACGT[rs.integers(0, 4, len(codes))], codes)
    reps = keep.astype(np.int64) + ins
    out = np.repeat(base, reps)
    ins_at = np.cumsum(reps)[ins] - 1
    out[ins_at] = ACGT[rs.integers(0, 4, len(ins_at))]
    return out.tobytes().decode()


def with_n(rs: np.random.Generator, s: str, count: int) -> str:
    chars = bytearray(s.encode())
    for i in rs.integers(0, len(chars), count):
        chars[i] = ord("N")
    return chars.decode()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(key: str, cells: float, moved: int):
    """(bound ms, what bounds it) for ``cells`` DP cells and ``moved``
    bytes of inputs and outputs."""
    t_ops = cells * OPS_PER_CELL[key] / (INT32_LANES * CARD["sm_hz"]) * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def report(key, name, n, cells, kern, plain, ms, plain_ms, err,
           moved) -> dict:
    """Print one kernel's parity, time and bound line; returns its JSON
    fields. No PyTorch call computes any of these functions, so there is
    no library time."""
    bound_ms, bound_by = bound(key, cells, moved)
    log(f"{name}: {n} items, kernel == plain: {kern}, max |diff| {err} "
        f"(tolerance 0); oracle agreement: {plain}; time on the timing set: "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({cells / ms / 1e6:.2f}"
        f" Gcells/s kernel, {cells / plain_ms / 1e6:.2f} Gcells/s plain); "
        f"bound {bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / ms:.2f}% "
        f"of it; library call: none")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phases 1-2: environment and build
# ---------------------------------------------------------------------------


def phase_environment() -> str:
    import torch

    log("== phase 1: environment")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    CARD["line"] = card
    log(card)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    CARD["sm_hz"] = float(clk.stdout.strip().splitlines()[0]) * 1e6
    log(f"SM clock max {CARD['sm_hz'] / 1e6:.0f} MHz: int32 rate "
        f"{INT32_LANES * CARD['sm_hz'] / 1e12:.2f} Tops/s, f32 "
        f"{F32_LANES * CARD['sm_hz'] / 1e12:.2f} Tops/s, MUFU (exp) "
        f"{MUFU_LANES * CARD['sm_hz'] / 1e12:.2f} Tops/s")
    log(f"torch device: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from otter_tpu_torch import native
    from otter_tpu_torch.kernels import _build

    log("== phase 2: build")
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"built {os.path.relpath(path, REPO)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    sass_loops(path)
    t0 = time.perf_counter()
    native.get_lib()
    log(f"host library built in {time.perf_counter() - t0:.2f} s")


def sass_loops(lib: str) -> None:
    """Per kernel function of the library, by ``cuobjdump -sass``: its
    SASS instructions and those of its longest loop (the span of a
    backward branch before the function's last EXIT; the out-of-line
    blocks after it, such as the shuffles' divergence fallbacks, are
    cold). In K5 that loop is the row loop, one row per iteration, so over
    the L lanes a thread holds it gives SASS instructions per cell."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("  SASS: cuobjdump not found")
        return
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300).stdout
    for fn_name, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function :|\Z)",
                                    out, flags=re.S):
        labels, pending, ins = {}, [], []
        for line in body.splitlines():
            lab = re.match(r"\s*\.?(L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*)", line)
            if m:
                at = int(m.group(1), 16)
                labels.update((name, at) for name in pending)
                pending = []
                ins.append((at, m.group(2)))
        last_exit = max((at for at, text in ins if "EXIT" in text),
                        default=0)
        loops = []  # (instructions, first, last) of each backward branch
        for at, text in ins:
            br = re.search(r"\bBRA(?:\.\w+)*\s+(?:`\(\.?(L_x_\d+)\)|"
                           r"(0x[0-9a-f]+))", text)
            if br and at < last_exit:
                to = labels.get(br.group(1)) if br.group(1) \
                    else int(br.group(2), 16)
                if to is not None and to <= at:
                    loops.append(((at - to) // 16 + 1, to, at))
        longest = max(loops, default=(0, 0, 0))[0]
        # L, the lanes a thread: the first template argument, the second
        # of K9's P-warp kernel (whose longest loop is a row)
        lanes = re.search(r"(?:affine_tb|edit_banded_warp)_kernelILi(\d+)E|"
                          r"edit_banded_warps_kernelILi\d+ELi(\d+)E",
                          fn_name)
        L = int(lanes.group(1) or lanes.group(2)) if lanes else 0
        per_cell = (f" ({longest / L:.1f} per cell over L = {L} lanes)"
                    if lanes else "")
        if "kde_pairs_kernel" in fn_name and loops:
            # K14: the longest loop is the chunk's pairs at a thread's grid
            # point, unrolled; one exp (MUFU.EX2) a term
            size, first, last = max(loops)
            terms = sum("MUFU.EX2" in t for at, t in ins
                        if first <= at <= last)
            per_cell = (f" ({size / max(terms, 1):.1f} per term over its "
                        f"{terms} terms)")
        cells = re.search(r"kde_scaled_kernelILi(\d+)E", fn_name)
        if cells:
            # K8's step loops (with the reciprocal division or __fdiv_rn,
            # staged or not) each hold the four step variants: 4 + 3 + 2 +
            # 1 values of C cells (the first template argument), one exp
            # (MUFU.EX2) a term
            terms = 10 * int(cells.group(1))
            steps = []
            for size, first, last in loops:
                body = [t for at, t in ins if first <= at <= last]
                if sum("MUFU.EX2" in t for t in body) == terms:
                    steps.append(
                        f"{size} ({size / terms:.1f} per (cell, value); "
                        f"MUFU.RCP {sum('MUFU.RCP' in t for t in body)}, "
                        f"FCHK {sum('FCHK' in t for t in body)})")
            per_cell = (f"; step loops of {terms} terms each: "
                        + ", ".join(steps))
        log(f"  SASS {fn_name}: {len(ins)} instructions, longest loop "
            f"{longest}{per_cell}")


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def pool_args(dev, pairs, tbs=None, tes=None):
    """(pattern, text) pairs oriented pattern = shorter side (or as given,
    with tb/te) -> the pool launch arguments on ``dev`` (pool, idx_pat,
    idx_txt, nlen, minit, tb, te, n_words, text_len; the pool wide enough
    for K1's 64 words too) and the pairs' DP cells."""
    from otter_tpu_torch.kernels.myers_pallas import (int32_tensor,
                                                      pack_pool, pool_width)
    from otter_tpu_torch.kernels.myers_striped import (dedup_oriented,
                                                       striped_n_words)

    if tbs is None:
        pairs = [(a, b) if len(a) <= len(b) else (b, a) for a, b in pairs]
        tbs = tes = [0] * len(pairs)
    seqs, ip, it = dedup_oriented(pairs)
    m = [len(a) for a, _b in pairs]
    n = [len(b) for _a, b in pairs]
    nw = striped_n_words(max(m))
    pool = pack_pool(seqs, pool_width(max(nw, 64), max(n)))
    args = tuple(int32_tensor(x, dev) for x in (pool, ip, it, n, m, tbs, tes))
    cells = float(sum(a * b for a, b in zip(m, n)))
    return args + (nw, max(n)), cells


def kernel_k1(dev, rs) -> dict:
    from otter_tpu_torch.kernels import myers_pallas as K1
    from otter_tpu_torch.kernels.edit_engine import _NW_THRESHOLDS
    from otter_tpu_torch.native import edit_distance_batch

    import torch

    pairs = []
    for m in (1, 31, 32, 33, 63, 64, 65, 2047, 2048):
        s = rand_acgt(rs, m)
        pairs += [(s, s), (s, mutate(rs, s, 0.1) or "A"),
                  (s, rand_acgt(rs, m + int(rs.integers(0, 64))))]
    for lo, hi in ((1, 128), (129, 256), (257, 512), (513, 1024),
                   (1025, 2048)):
        for _ in range(1024):
            s = rand_acgt(rs, int(rs.integers(lo, hi + 1)))
            t = mutate(rs, s, float(rs.uniform(0.0, 0.3))) \
                if rs.random() < 0.7 else \
                rand_acgt(rs, len(s) + int(rs.integers(0, len(s) + 1)))
            pairs.append((s, t or "C"))
    for _ in range(32):  # short patterns in texts up to 32 kb
        s = rand_acgt(rs, int(rs.integers(1, 129)))
        pairs.append((s, rand_acgt(rs, int(rs.integers(16384, 32768)))))
    (pool, ip, it, nl, ml, _tb, _te, _nw, _tl), _c = pool_args(dev, pairs)
    m = ml.cpu().numpy()
    kern = np.zeros(len(pairs), dtype=np.int64)
    plain = np.zeros(len(pairs), dtype=np.int64)
    g = np.searchsorted(_NW_THRESHOLDS, m, side="left")
    for gi in np.unique(g):
        sel = torch.from_numpy(np.nonzero(g == gi)[0]).to(dev)
        a = (pool, ip[sel], it[sel], nl[sel], ml[sel], int(4 << gi),
             int(nl[sel].max()))
        kern[sel.cpu().numpy()] = K1.myers_pool(*a).cpu().numpy()
        plain[sel.cpu().numpy()] = K1.myers_pool_torch(*a).cpu().numpy()
    native, _cells = edit_distance_batch(pairs, os.cpu_count() or 1)
    err = int(np.abs(kern - plain).max())
    oracle = bool(np.array_equal(kern, native))
    check(err == 0 and oracle, "K1 disagrees with its plain version or the "
          "native distance")

    # timing: one 64-word bucket of 65,536 pairs of 1.5-1.8 kb reads
    seqs = []
    for _ in range(256):
        s = rand_acgt(rs, int(rs.integers(1500, 1801)))
        seqs += [s, mutate(rs, s, 0.02)]
    seqs = [s for s in seqs if 1025 <= len(s) <= 2048]
    iu, ju = np.triu_indices(len(seqs), 1)
    pick = rs.choice(len(iu), size=min(65536, len(iu)), replace=False)
    (pool, ip, it, nl, ml, _tb, _te, _nw, tl), cells = pool_args(
        dev, [(seqs[i], seqs[j]) for i, j in zip(iu[pick], ju[pick])])
    a = (pool, ip, it, nl, ml, 64, tl)
    ms = time_ms(lambda: K1.myers_pool(*a), 5)
    plain_ms, want = time_once(lambda: K1.myers_pool_torch(*a))
    check(bool(torch.equal(K1.myers_pool(*a), want)),
          "K1 disagrees with its plain version on the timing set")
    return report("myers_pool", "K1 myers_pool", len(pairs), cells, err == 0,
                  oracle, ms, plain_ms, err,
                  nbytes(pool, ip, it, nl, ml) + 4 * len(ip))


def one_sided_jobs(rs, n, lo, hi):
    """Ends-free jobs with the frees on one side: text-side tb / te / both,
    pattern-side (transposed), and no frees."""
    jobs = []
    for k in range(n):
        p = rand_acgt(rs, int(rs.integers(lo, hi + 1)))
        ld = int(rs.integers(0, min(len(p) // 2 + 2, 200)))
        cut = int(rs.integers(0, ld + 1))
        t = rand_acgt(rs, cut) + mutate(rs, p, float(rs.uniform(0, 0.1))) \
            + rand_acgt(rs, ld - cut)
        jobs.append([(p, t, 0, 0, ld, 0), (p, t, 0, 0, 0, ld),
                     (p, t, 0, 0, cut, ld - cut), (t, p, cut, ld - cut, 0, 0),
                     (p, t, 0, 0, 0, 0)][k % 5])
    return jobs


def text_side(jobs):
    """Jobs oriented frees-on-the-text: (pairs, tb list, te list)."""
    pairs, tbs, tes = [], [], []
    for p, t, pb, pe, tb, te in jobs:
        if pb or pe:
            pairs.append((t, p))
            tbs.append(pb)
            tes.append(pe)
        else:
            pairs.append((p, t))
            tbs.append(tb)
            tes.append(te)
    return pairs, tbs, tes


def kernel_k2(dev, rs) -> dict:
    import torch

    from otter_tpu_torch.kernels import myers_striped as K2
    from otter_tpu_torch.ops.align_np import edit_distance_ends_free

    jobs = one_sided_jobs(rs, 400, 1, 300) + one_sided_jobs(rs, 12, 1025,
                                                            4096)
    got = K2.myers_striped_ends_free(jobs, dev)
    oracle = bool(np.array_equal(
        got, [edit_distance_ends_free(*j) for j in jobs]))
    a, _c = pool_args(dev, *text_side(jobs))
    kern = K2.myers_striped(*a).cpu().numpy()
    plain = K2.myers_striped_torch(*a).cpu().numpy()
    err = int(np.abs(kern - plain).max())
    check(err == 0 and oracle, "K2 disagrees with its plain version or the "
          "numpy ends-free DP")

    # timing: reassignment-shaped jobs (a non-spanning read of 0.4-1.4 kb
    # against spanning reads of 1.5-2.4 kb, the read's missing end free)
    alleles = [rand_acgt(rs, int(rs.integers(1500, 2401))) for _ in range(64)]
    tjobs = []
    for k in range(16384):
        al = alleles[k % len(alleles)]
        cut = int(rs.integers(400, 1401))
        tjobs.append((mutate(rs, al[:cut], 0.002), al, 0, 0, 0,
                      len(al) - cut))
    a, cells = pool_args(dev, *text_side(tjobs))
    ms = time_ms(lambda: K2.myers_striped(*a), 3)
    plain_ms, want = time_once(lambda: K2.myers_striped_torch(*a))
    check(bool(torch.equal(K2.myers_striped(*a), want)),
          "K2 disagrees with its plain version on the timing set")
    moved = nbytes(*(x for x in a if isinstance(x, torch.Tensor)))
    striped_groups(a, cells, want, "timing set")
    return report("myers_striped", "K2 myers_striped", len(jobs), cells,
                  err == 0, oracle, ms, plain_ms, err,
                  moved + 4 * len(tjobs))


def striped_groups(a, cells, want, what) -> None:
    """K2 on one launch's inputs at every lane-group size G (q follows),
    each equal to the plain result ``want``, with its time."""
    import torch

    from otter_tpu_torch.kernels import myers_striped as K2

    auto = K2.striped_launch(a[4], a[3], a[7])[:2]
    parts = []
    for G in K2.GROUPS:
        fn = lambda: K2.myers_striped_cuda(*a, group=G)  # noqa: E731
        check(bool(torch.equal(fn(), want)), f"K2 at G = {G} disagrees with "
              f"its plain version on the {what}")
        shape = K2.striped_shape(len(want), a[7], G)
        ms = time_ms(fn, 3)
        parts.append(f"(G {shape[0]}, q {shape[1]}) {ms:.3f} ms "
                     f"({cells / ms / 1e6:.1f} Gcells/s)")
    log(f"K2 {what}, {len(want)} jobs, by lane group (the wrapper picks "
        f"G {auto[0]}, q {auto[1]}), each == plain: " + "; ".join(parts))


def k2_small_launch(dev, n_jobs: int) -> None:
    """K2 at the shape of its launch in cell hifi-tr-1.5k: ``n_jobs`` (the
    cell's jobs_k2 counter) reassignment jobs, a non-spanning read of
    0.4-1.4 kb against a spanning read of 1.5-2.4 kb, its missing end
    free; kernel and plain time, and every lane-group size."""
    import torch

    from otter_tpu_torch.kernels import myers_striped as K2

    rs = np.random.default_rng(17)
    alleles = [rand_acgt(rs, int(rs.integers(1500, 2401))) for _ in range(8)]
    tjobs = []
    for k in range(max(1, n_jobs)):
        al = alleles[k % len(alleles)]
        cut = int(rs.integers(400, 1401))
        tjobs.append((mutate(rs, al[:cut], 0.002), al, 0, 0, 0,
                      len(al) - cut))
    a, cells = pool_args(dev, *text_side(tjobs))
    plain_ms, want = time_once(lambda: K2.myers_striped_torch(*a))
    ms = time_ms(lambda: K2.myers_striped(*a), 5)
    check(bool(torch.equal(K2.myers_striped(*a), want)),
          "K2 disagrees with its plain version at the cell's launch shape")
    bound_ms, bound_by = bound("myers_striped", cells, nbytes(
        *(x for x in a if isinstance(x, torch.Tensor))) + 4 * len(tjobs))
    log(f"K2 at the shape of its hifi-tr-1.5k launch ({len(tjobs)} jobs): "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, == plain (max |diff| "
        f"0); bound {bound_ms:.4f} ms by {bound_by}, "
        f"{100 * bound_ms / ms:.2f}% of it")
    striped_groups(a, cells, want, "hifi-tr-1.5k launch shape")


def striped_sweep(dev) -> None:
    """K2 at every (G, q) its wrapper can pick, exact against the plain
    version: one-sided ends-free jobs of both orientations whose longest
    pattern fills G q words (past 2048 bp from q = 2 at G = 32), and a
    launch of one job."""
    import torch

    from otter_tpu_torch.kernels import myers_striped as K2

    rs = np.random.default_rng(13)
    for G, q in K2.striped_shapes():
        m_max = 64 * G * q - int(rs.integers(0, 40))
        jobs = [(rand_acgt(rs, m_max), rand_acgt(rs, 300), 0, 0, 5, 9)]
        jobs += one_sided_jobs(rs, 200, 1, min(m_max, 1500))
        for what, sel in (("all", jobs), ("one job", jobs[:1])):
            a, _c = pool_args(dev, *text_side(sel))
            check(K2.striped_launch(a[4], a[3], a[7], G)[:2] == (G, q),
                  f"K2 sweep: jobs do not give (G {G}, q {q})")
            check(bool(torch.equal(K2.myers_striped_cuda(*a, group=G),
                                   K2.myers_striped_torch(*a))),
                  f"K2 at (G {G}, q {q}) disagrees with its plain version "
                  f"({what})")
    log(f"K2 sweep: (G, q) = {K2.striped_shapes()}, {len(jobs)} jobs each "
        f"and a launch of one job: all == plain (max |diff| 0)")


def kernel_k3(dev, rs) -> dict:
    import torch

    from otter_tpu_torch.kernels import myers_banded as K3
    from otter_tpu_torch.native import edit_distance_batch

    pairs = []
    for _ in range(600):
        s = rand_acgt(rs, int(rs.integers(2049, 4097)))
        pairs.append((s, mutate(rs, s, float(rs.choice([0.0, 0.002, 0.02,
                                                         0.1])))))
    native, _cells = edit_distance_batch(pairs, os.cpu_count() or 1)
    (pool, ip, it, nl, ml, _tb, _te, nw, tl), _c = pool_args(dev, pairs)
    zero = torch.zeros_like(nl)
    err, oracle = 0, True
    for k in (63, 255):
        kern = K3.myers_banded(pool, ip, it, nl, ml, k, nw, tl).cpu().numpy()
        plain = K3.myers_banded_torch(pool, ip, it, nl, ml, zero, zero, k,
                                      nw, tl).cpu().numpy()
        err = max(err, int(np.abs(kern - plain).max()))
        oracle &= bool(np.all((kern >= native)
                              & ((native > k) | (kern == native))))
    check(err == 0 and oracle, "K3 disagrees with its plain version or the "
          "native distance")

    # timing: 8,128 pairs of 2.3-2.5 kb reads of 32 alleles at 0.2% error
    seqs = []
    for _ in range(32):
        s = rand_acgt(rs, int(rs.integers(2300, 2501)))
        seqs += [mutate(rs, s, 0.002) for _ in range(4)]
    iu, ju = np.triu_indices(len(seqs), 1)
    sel_p = rs.choice(len(iu), size=min(8192, len(iu)), replace=False)
    (pool, ip, it, nl, ml, _tb, _te, nw, tl), _cells = pool_args(
        dev, [(seqs[i], seqs[j]) for i, j in zip(iu[sel_p], ju[sel_p])])
    zero = torch.zeros_like(nl)
    cells = float((nl.cpu().numpy() * 128).sum())
    ms = time_ms(lambda: K3.myers_banded(pool, ip, it, nl, ml, 63, nw, tl), 3)
    plain_ms, want = time_once(lambda: K3.myers_banded_torch(
        pool, ip, it, nl, ml, zero, zero, 63, nw, tl))
    check(bool(torch.equal(
        K3.myers_banded(pool, ip, it, nl, ml, 63, nw, tl), want)),
        "K3 disagrees with its plain version on the timing set")
    banded_groups(lambda G: K3.myers_banded_cuda(pool, ip, it, nl, ml, 63,
                                                 nw, tl, group=G),
                  nl, None, 63, cells, want, "K3 timing set")
    return report("myers_banded", "K3 myers_banded (k 63, 255; band cells)",
                  len(pairs), cells, err == 0, oracle, ms, plain_ms, err,
                  nbytes(pool, ip, it, nl, ml) + 4 * len(ip))


def kernel_k4(dev, rs) -> dict:
    import torch

    from otter_tpu_torch.kernels import myers_banded as K4
    from otter_tpu_torch.ops.align_np import edit_distance_ends_free

    jobs = [j for j in one_sided_jobs(rs, 300, 2049, 3500)
            if j[2] or j[3] or j[4] or j[5]]
    pairs, tbs, tes = text_side(jobs)
    want = np.array([edit_distance_ends_free(*j) for j in jobs])
    (pool, ip, it, nl, ml, tb, te, nw, tl), _c = pool_args(dev, pairs, tbs,
                                                          tes)
    err, oracle = 0, True
    for k in (63, 255):
        kern = K4.myers_banded_ef(pool, ip, it, nl, ml, tb, te, k, nw,
                                  tl).cpu().numpy()
        plain = K4.myers_banded_torch(pool, ip, it, nl, ml, tb, te, k, nw,
                                      tl).cpu().numpy()
        err = max(err, int(np.abs(kern - plain).max()))
        oracle &= bool(np.all((kern >= want)
                              & ((want > k) | (kern == want))))
    check(err == 0 and oracle, "K4 disagrees with its plain version or the "
          "numpy ends-free DP")

    # timing: reassignment-shaped jobs past 2048 (a non-spanning read of
    # 2.1-2.4 kb against a 2.4-2.6 kb spanning read, the read's end free)
    alleles = [rand_acgt(rs, int(rs.integers(2400, 2601))) for _ in range(64)]
    tjobs = []
    for k in range(4096):
        al = alleles[k % len(alleles)]
        cut = int(rs.integers(2100, 2401))
        tjobs.append((mutate(rs, al[:cut], 0.002), al, 0, 0, 0,
                      len(al) - cut))
    (pool, ip, it, nl, ml, tb, te, nw, tl), _cells = pool_args(
        dev, *text_side(tjobs))
    cells = float((nl.cpu().numpy() * (64 + 128)).sum())
    tb_max = int(tb.max())
    ms = time_ms(lambda: K4.myers_banded_ef(pool, ip, it, nl, ml, tb, te, 63,
                                            nw, tl, tb_max=tb_max), 3)
    plain_ms, want = time_once(lambda: K4.myers_banded_torch(
        pool, ip, it, nl, ml, tb, te, 63, nw, tl))
    check(bool(torch.equal(
        K4.myers_banded_ef(pool, ip, it, nl, ml, tb, te, 63, nw, tl), want)),
        "K4 disagrees with its plain version on the timing set")
    banded_groups(lambda G: K4.myers_banded_ef_cuda(
        pool, ip, it, nl, ml, tb, te, 63, nw, tl, group=G, tb_max=tb_max),
        nl, tb, 63, cells, want, "K4 timing set")
    return report("myers_banded_ef",
                  "K4 myers_banded_ef (k 63, 255; band cells)", len(jobs),
                  cells, err == 0, oracle, ms, plain_ms, err,
                  nbytes(pool, ip, it, nl, ml, tb, te) + 4 * len(ip))


def banded_groups(fn, nlen, tb, k, cells, want, what) -> None:
    """K3 / K4 on one launch's inputs at every lane-group size G the
    window allows (q follows): ``fn(G)`` launches, each result equal to the
    plain result ``want``, with its time."""
    import torch

    from otter_tpu_torch.kernels import myers_banded as K

    tb_max = int(tb.max()) if tb is not None else 0
    auto = K.banded_launch(nlen, tb, k, tb_max=tb_max)[:2]
    window = K.banded_window(k, tb_max)
    parts = []
    for G in K.GROUPS:
        if G * K.QMAX < window:
            continue
        check(bool(torch.equal(fn(G), want)), f"{what} at G = {G} disagrees "
              "with its plain version")
        ms = time_ms(lambda: fn(G), 3)
        q = K.banded_shape(len(want), window, G)[1]
        parts.append(f"(G {G}, q {q}) {ms:.3f} ms ({cells / ms / 1e6:.1f} "
                     "band Gcells/s)")
    log(f"{what}, {len(want)} jobs, window {window} blocks, by lane group "
        f"(the wrapper picks G {auto[0]}, q {auto[1]}), each == plain: "
        + "; ".join(parts))


def refscale_reads(rs, n: int):
    """Reads of the reference-default region: n reads of each allele of a
    10 kb locus (the second with 100 CAG units more), at 0.2% error."""
    a = rand_acgt(rs, 10000)
    b = a + "CAG" * 100
    return ([mutate(rs, a, 0.002) for _ in range(n)],
            [mutate(rs, b, 0.002) for _ in range(n)])


def banded_set(dev, what, pairs, k, tbs=None, tes=None) -> None:
    """One K3 (``tbs`` None) or K4 launch on a set shaped like a main-path
    rung: the plain version once (timed by events, no warm-up), the
    kernel's time, exact agreement, band Gcells/s, bound, the jobs the rung
    resolves, and every lane-group size."""
    import torch

    from otter_tpu_torch.kernels import myers_banded as K

    (pool, ip, it, nl, ml, tb, te, nw, tl), _c = pool_args(dev, pairs, tbs,
                                                          tes)
    ef = tbs is not None
    tb_max = max(tbs) if ef else 0
    if not ef:
        tb = te = torch.zeros_like(nl)
    n = nl.cpu().numpy().astype(np.float64)
    m = ml.cpu().numpy().astype(np.float64)
    cells = float((n * np.minimum(m, 2 * k + 2 + tb.cpu().numpy())).sum())
    plain_ms, want = time_once(lambda: K.myers_banded_torch(
        pool, ip, it, nl, ml, tb, te, k, nw, tl))

    def fn(G=None):
        if ef:
            return K.myers_banded_ef_cuda(pool, ip, it, nl, ml, tb, te, k,
                                          nw, tl, group=G, tb_max=tb_max)
        return K.myers_banded_cuda(pool, ip, it, nl, ml, k, nw, tl, group=G)

    ms = time_ms(fn, 3)
    check(bool(torch.equal(fn(), want)), f"{what} disagrees with its plain "
          "version")
    key = "myers_banded_ef" if ef else "myers_banded"
    bound_ms, bound_by = bound(key, cells, nbytes(pool, ip, it, nl, ml)
                               + (nbytes(tb, te) if ef else 0) + 4 * len(ip))
    log(f"{what}: {len(pairs)} jobs at k {k}, {int((want <= k).sum())} "
        f"resolved (<= k); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, == "
        f"plain (max |diff| 0); {cells / ms / 1e6:.2f} band Gcells/s; bound "
        f"{bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / ms:.2f}% of it")
    banded_groups(fn, nl, tb if ef else None, k, cells, want, what)


def banded_refscale_sets(dev) -> None:
    """K3 at the shapes the reference-default region gives its ladder
    (cov 200, 10 kb alleles, 0.2% error): the 9,900 same-allele pairs at
    k = 63, the 10,000 cross-allele pairs (a 300 bp length gap) at
    k = 511; and K4 with wide free begins: 2,048 reads that miss up to
    2 kb of their allele's start against the allele, at k = 63."""
    rs = np.random.default_rng(21)
    ra, rb = refscale_reads(rs, 100)
    iu, ju = np.triu_indices(100, 1)
    same = [(r[i], r[j]) for r in (ra, rb) for i, j in zip(iu, ju)]
    cross = [(x, y) for x in ra for y in rb]
    banded_set(dev, "K3 refscale same-allele set", same, 63)
    banded_set(dev, "K3 refscale cross-allele set", cross, 511)
    allele = rb[0]
    pairs, tbs = [], []
    for _ in range(2048):
        cut = int(rs.integers(0, 2001))
        pairs.append((mutate(rs, allele[cut:], 0.002), allele))
        tbs.append(cut)
    banded_set(dev, "K4 wide-tb set (tb 0-2000)", pairs, 63, tbs,
               [0] * len(tbs))


def banded_sweep(dev) -> None:
    """K3 and K4 at every (G, q) their wrapper can pick, exact against the
    plain version: 150 jobs of 200-1500 bp (K4 with free ends of up to 40
    chars that differ by job), a pattern far longer than its text (2^30)
    and unrelated sides, at a band whose window is the largest of 2, 3, 5,
    9 and 17 blocks within G q, so it spans lanes and slides across their
    boundaries; and a launch of one job at each."""
    import torch

    from otter_tpu_torch.kernels import myers_banded as K

    rs = np.random.default_rng(14)
    by_window = {}
    for G, q in K.banded_shapes():
        wt = max(w for w in (2, 3, 5, 9, 17) if w <= G * q)
        by_window.setdefault(wt, []).append((G, q))
    for wt, shapes in sorted(by_window.items()):
        jobs = []
        for x in range(150):
            p = rand_acgt(rs, int(rs.integers(200, 1501)))
            tb, te = (int(v) for v in rs.integers(0, 41, 2))
            jobs.append((p, rand_acgt(rs, tb) + mutate(
                rs, p, [0.005, 0.05, 0.3][x % 3]) + rand_acgt(rs, te), tb,
                te))
        short = rand_acgt(rs, 30)
        jobs += [(rand_acgt(rs, 1100) + short, short, 0, 0),
                 (rand_acgt(rs, 1400), rand_acgt(rs, 1390), 0, 0)]
        for ef, k in ((False, 32 * (wt - 2) + 31), (True, 32 * (wt - 2) + 11)):
            (pool, ip, it, nl, ml, tb, te, nw, tl), _c = pool_args(
                dev, [j[:2] for j in jobs], [j[2] for j in jobs],
                [j[3] for j in jobs])
            if not ef:
                tb = te = torch.zeros_like(nl)
            want = K.myers_banded_torch(pool, ip, it, nl, ml, tb, te, k, nw,
                                        tl)
            for G, q in shapes:
                for what, sl in (("all", slice(None)), ("one job",
                                                         slice(0, 1))):
                    a = (pool, ip[sl], it[sl], nl[sl], ml[sl])
                    got = (K.myers_banded_ef_cuda(*a, tb[sl], te[sl], k, nw,
                                                  tl, group=G, q=q) if ef else
                           K.myers_banded_cuda(*a, k, nw, tl, group=G, q=q))
                    check(bool(torch.equal(got, want[sl])),
                          f"K{4 if ef else 3} at (G {G}, q {q}) disagrees "
                          f"with its plain version ({what})")
    log(f"K3 / K4 sweep: (G, q) = {K.banded_shapes()}, 152 jobs each at a "
        f"window of 2, 3, 5, 9 or 17 blocks and a launch of one job: all "
        f"== plain (max |diff| 0)")


def kernel_k7(dev, rs) -> dict:
    import torch

    from otter_tpu_torch.kernels import edit_banded as K7
    from otter_tpu_torch.kernels.myers_pallas import int32_tensor
    from otter_tpu_torch.native import edit_distance_batch

    pairs = []
    for _ in range(400):
        s = with_n(rs, rand_acgt(rs, int(rs.integers(1, 2500))), 3)
        pairs.append((s, mutate(rs, s, float(rs.choice([0.0, 0.01, 0.1])))
                      or "N"))
    native, _cells = edit_distance_batch(pairs, os.cpu_count() or 1)
    err, oracle = 0, True
    for k in (63, 511):
        a = [int32_tensor(x, dev) for x in K7.pack_banded(pairs, k)]
        kern = K7.edit_banded(*a, k).cpu().numpy()
        plain = K7.edit_banded_torch(*a, k).cpu().numpy()
        err = max(err, int(np.abs(kern - plain).max()))
        oracle &= bool(np.all((native > k) | (kern == native)))
    check(err == 0 and oracle, "K7 disagrees with its plain version or the "
          "native distance")

    # timing: 1,024 pairs of 1.5-1.8 kb reads with N bases, k = 63
    tpairs = []
    for _ in range(1024):
        s = with_n(rs, rand_acgt(rs, int(rs.integers(1500, 1801))), 3)
        tpairs.append((s, with_n(rs, mutate(rs, s, 0.002), 2)))
    a = [int32_tensor(x, dev) for x in K7.pack_banded(tpairs, 63)]
    cells = float(sum(max(len(x), len(y)) for x, y in tpairs) * 128)
    ms = time_ms(lambda: K7.edit_banded(*a, 63), 3)
    plain_ms, want = time_once(lambda: K7.edit_banded_torch(*a, 63))
    check(bool(torch.equal(K7.edit_banded(*a, 63), want)),
          "K7 disagrees with its plain version on the timing set")
    out = report("edit_banded", "K7 edit_banded (k 63, 511; band cells)",
                 len(pairs), cells, err == 0, oracle, ms, plain_ms, err,
                 nbytes(*a) + 4 * len(tpairs))

    # a rung past 511 (the block kernel): 256 pairs of 2.5-3 kb reads with
    # N bases, k = 1023
    wpairs = []
    for _ in range(256):
        s = with_n(rs, rand_acgt(rs, int(rs.integers(2500, 3001))), 3)
        wpairs.append((s, with_n(rs, mutate(rs, s, 0.002), 2)))
    a = [int32_tensor(x, dev) for x in K7.pack_banded(wpairs, 1023)]
    wcells = float(sum(max(len(x), len(y)) for x, y in wpairs) * 2048)
    wms = time_ms(lambda: K7.edit_banded(*a, 1023), 3)
    wplain, want = time_once(lambda: K7.edit_banded_torch(*a, 1023))
    check(bool(torch.equal(K7.edit_banded(*a, 1023), want)),
          "K7 disagrees with its plain version at k 1023")
    wb, wby = bound("edit_banded", wcells, nbytes(*a) + 4 * len(wpairs))
    log(f"K7 at k 1023 (block kernel), {len(wpairs)} pairs of 2.5-3 kb: "
        f"kernel {wms:.3f} ms, plain {wplain:.3f} ms, == plain (max |diff| "
        f"0); {wcells / wms / 1e6:.2f} band Gcells/s; bound {wb:.4f} ms by "
        f"{wby}, {100 * wb / wms:.2f}% of it")
    return out


def ends_free_jobs(rs, n, lo, hi, reach):
    """Two-sided and non-ACGT ends-free jobs of the host bucket: a read of
    lo-hi bp with 3 N bases against a mutated piece of it (up to ``reach``
    shorter), with frees on both sides within ``reach``."""
    jobs = []
    for q in range(n):
        t = with_n(rs, rand_acgt(rs, int(rs.integers(lo, hi + 1))), 3)
        a = int(rs.integers(0, reach // 2 + 1))
        b = len(t) - int(rs.integers(0, reach // 2 + 1))
        p = mutate(rs, t[a:b], float(rs.choice([0.002, 0.01, 0.05])))
        ld = abs(len(t) - len(p))
        frees = [(ld, ld, 0, 0), (0, 0, a, len(t) - b), (a, 0, 0, ld),
                 (0, ld, a, 0)][q % 4]
        jobs.append((p, t, *frees) if q % 2 else (t, p, *frees))
    return jobs


def reassignment_shaped_jobs(rs, n):
    """``n`` jobs shaped like the route-coverage cell's K9 passes: a
    spanning read of 1.5-1.8 kb with N bases against a non-spanning read
    200-450 bp shorter, the pattern's end free past the difference (reach
    <= 496, so the ladder's k = 512: the block kernel)."""
    jobs = []
    for _ in range(n):
        p = with_n(rs, rand_acgt(rs, int(rs.integers(1500, 1801))), 3)
        d = int(rs.integers(200, 451))
        t = mutate(rs, p[: len(p) - d], 0.002)
        jobs.append((p, t, 0, min(496, d + int(rs.integers(0, 40))), 0, 0))
    return jobs


def k9_args(dev, jobs, k):
    from otter_tpu_torch.kernels import edit_banded as K9
    from otter_tpu_torch.kernels.myers_pallas import int32_tensor

    return [int32_tensor(x, dev)
            for x in K9.pack_ends_free(jobs, range(len(jobs)), k)]


def kernel_k9(dev, rs) -> dict:
    """K9 against its plain version and the numpy pass of
    edit_ends_free_batch, exact: the warp kernel at k = 32 ... 511 on reads
    of 0.1-2 kb, P warps at k = 512 on such reads (W = 1026, two lanes past
    the warp kernel) and at k = 1023, 2047, 4095 and 8191 on 10 kb reads
    (every P-warp instance), the block kernel past k_max at k = 9000 on
    such reads; timed on a set shaped like the route-coverage cell's
    passes. The jobs at k = 512 and past 2047 come from seeds of their
    own, so the other sets and the timing set are those of the runs before
    they were added."""
    import torch

    from otter_tpu_torch.kernels import edit_banded as K9
    from otter_tpu_torch.ops.align_batch import _ends_free_banded_numpy

    for k, n, lo, hi in ((32, 64, 100, 400), (64, 64, 200, 800),
                         (128, 48, 300, 1200), (256, 32, 600, 2000),
                         (511, 24, 1100, 2000), (512, 24, 1100, 2000),
                         (1023, 2, 10000, 10400), (2047, 2, 10000, 10400),
                         (4095, 2, 10000, 10400), (8191, 2, 10000, 10400),
                         (9000, 2, 10000, 10400)):
        own = k == 512 or k > 2047
        jobs = ends_free_jobs(np.random.default_rng(k) if own else rs,
                              n, lo, hi, min(k - 16, lo // 2))
        a = k9_args(dev, jobs, k)
        kern = K9.edit_banded_ends_free(*a, k)
        plain = K9.edit_banded_ends_free_torch(*a, k)
        want = np.minimum(_ends_free_banded_numpy(jobs, range(len(jobs)), k),
                          K9.INF)
        one = K9.edit_banded_ends_free(*k9_args(dev, jobs[:1], k), k)
        check(bool(torch.equal(kern, plain)) and np.array_equal(
            kern.cpu().numpy(), want) and int(one[0]) == int(kern[0]),
            f"K9 disagrees with its plain version or the numpy pass at k {k}")
        kind, P, L = K9.ends_free_shape(k)
        inst = {"warp": f"{L} lanes a thread", "warps": f"{P} warps of {L} "
                "lanes", "block": f"{P} threads of {L} lanes"}[kind]
        log(f"K9 k {k} ({kind} kernel, {inst}): {n} jobs "
            f"of {lo}-{hi} bp and a launch of one job, == plain and the "
            f"numpy pass (max |diff| 0); "
            f"{int((kern < K9.INF).sum())} jobs with an end cell")
    tjobs = reassignment_shaped_jobs(rs, 64)
    a = k9_args(dev, tjobs, 512)
    cells = float(sum(len(p) for p, *_r in tjobs) * 2 * 513)
    ms = time_ms(lambda: K9.edit_banded_ends_free(*a, 512), 3)
    plain_ms, want = time_once(lambda: K9.edit_banded_ends_free_torch(*a, 512))
    check(bool(torch.equal(K9.edit_banded_ends_free(*a, 512), want)),
          "K9 disagrees with its plain version on the timing set")
    return report("edit_banded_ends_free",
                  "K9 edit_banded_ends_free (k 32-9000; timing set: 64 "
                  "route-coverage-shaped jobs at k 512, band cells)",
                  len(tjobs), cells, True, True, ms, plain_ms, 0,
                  nbytes(*a) + 4 * len(tjobs))


def edit_sweep(dev) -> None:
    """K7 at k = 31 ... 1023 (a warp per pair to 511, a block above),
    exact against the plain version: pairs of 30 bp to 2 kb with N bases,
    unrelated pairs, a length difference past k, an alignment along
    diagonal +min(k, 200), and a launch of one pair; with band Gcells/s."""
    import torch

    from otter_tpu_torch.kernels import edit_banded as K7
    from otter_tpu_torch.kernels.myers_pallas import int32_tensor

    rs = np.random.default_rng(12)
    for k in (31, 63, 127, 255, 511, 1023):
        pairs = []
        for _ in range(300):
            s = with_n(rs, rand_acgt(rs, int(rs.integers(30, 2000))), 2)
            pairs.append((s, mutate(rs, s, float(rs.choice([0.002, 0.05,
                                                             0.3]))) or "N"))
        g = min(k, 200)
        x = rand_acgt(rs, 4 * g + 40)
        pairs += [(rand_acgt(rs, 1500), rand_acgt(rs, 1490)),
                  (rand_acgt(rs, 30), rand_acgt(rs, 31 + k)),
                  (x + rand_acgt(rs, g + 1),
                   x[:20] + rand_acgt(rs, g) + x[20:])]
        cells = float(sum(max(len(p), len(t)) for p, t in pairs) * 2
                      * (k + 1))
        for what, sel in (("all", pairs), ("one pair", pairs[:1])):
            a = [int32_tensor(y, dev) for y in K7.pack_banded(sel, k)]
            check(bool(torch.equal(K7.edit_banded(*a, k),
                                   K7.edit_banded_torch(*a, k))),
                  f"K7 disagrees with its plain version at k {k} ({what})")
            if what == "all":
                ms = time_ms(lambda: K7.edit_banded(*a, k), 2)
        log(f"K7 sweep k {k}: {len(pairs)} pairs and a launch of one pair, "
            f"== plain (max |diff| 0); {ms:.3f} ms, "
            f"{cells / ms / 1e6:.2f} band Gcells/s")


def consensus_jobs(rs, n, lo, hi, err):
    """Consensus-shaped jobs: a member read against its allele's
    representative, End2End or with the member's missing end free."""
    reps = [rand_acgt(rs, int(rs.integers(lo, hi + 1))) for _ in range(32)]
    jobs = []
    for k in range(n):
        rep = reps[k % len(reps)]
        mem = mutate(rs, rep, err)
        cut = int(rs.integers(0, len(mem) // 3 + 1))
        jobs.append([(mem, rep, 0, 0, 0, 0), (mem[cut:], rep, 0, 0, cut, 0),
                     (mem[: len(mem) - cut], rep, 0, 0, 0, cut)][k % 3])
    return jobs


def kernel_k5(dev, rs) -> dict:
    import torch

    from otter_tpu_torch.kernels import affine_tb as K5
    from otter_tpu_torch.ops.align_batch import affine_cigars_multi

    jobs = consensus_jobs(rs, 300, 100, 2000, 0.01) + \
        consensus_jobs(rs, 60, 100, 1200, 0.08)
    err, same_ops = 0, True
    for k, rows in ((63, 2048), (255, 2048)):
        tw = K5._t_words(rows, k)
        a = [torch.from_numpy(x).to(dev)
             for x in K5.pack_affine_jobs(jobs, rows, k)]
        ops, end = K5.affine_tb(*a, k, tw)
        ops_p, end_p = K5.affine_tb_torch(*a, k, tw)
        err = max(err, int((end - end_p).abs().max()))
        same_ops &= bool(torch.equal(ops, ops_p))
    cigs, failed = K5.affine_cigars_tb(jobs, dev)
    want = affine_cigars_multi(jobs)
    walked = sorted(set(range(len(jobs))) - set(failed))
    oracle = all(cigs[i] == want[i] for i in walked)
    log(f"K5: {len(walked)} of {len(jobs)} members walked on the card, the "
        f"rest left to the native ladder")
    check(err == 0 and same_ops and oracle and len(walked) > len(jobs) // 2,
          "K5 disagrees with its plain version or the native cigar ladder")

    # timing: 2,048 consensus members of 1.5-1.8 kb alleles at 0.2% error
    tjobs = consensus_jobs(rs, 2048, 1500, 1800, 0.002)
    tw = K5._t_words(2048, 63)
    a = [torch.from_numpy(x).to(dev)
         for x in K5.pack_affine_jobs(tjobs, 2048, 63)]
    cells = float(sum(len(j[0]) for j in tjobs) * 128)
    ms = time_ms(lambda: K5.affine_tb(*a, 63, tw), 3)
    plain_ms, (o2, e2) = time_once(lambda: K5.affine_tb_torch(*a, 63, tw))
    o1, e1 = K5.affine_tb(*a, 63, tw)
    check(bool(torch.equal(o1, o2) and torch.equal(e1, e2)),
          "K5 disagrees with its plain version on the timing set")
    return report("affine_tb", "K5 affine_tb (k 63, 255; band cells)",
                  len(jobs), cells, err == 0 and same_ops, oracle, ms,
                  plain_ms, err, nbytes(*a, o1, e1))


def kernel_k6(dev, rs) -> dict:
    import torch

    from otter_tpu_torch.kernels import affine_tb as K6
    from otter_tpu_torch.ops.align_batch import affine_cigars_multi

    jobs = consensus_jobs(rs, 120, 2500, 4000, 0.005)
    err, same_ops = 0, True
    for k, rows in ((63, 4096), (127, 4096)):
        tw = K6._t_words(rows, k)
        a = [torch.from_numpy(x).to(dev)
             for x in K6.pack_affine_jobs(jobs, rows, k)]
        ops, end = K6.affine_tb_ckpt(*a, k, tw)
        ops_p, end_p = K6.affine_tb_torch(*a, k, tw)
        err = max(err, int((end - end_p).abs().max()))
        same_ops &= bool(torch.equal(ops, ops_p))
    before = K6.affine_tb_ckpt_cuda.launches
    cigs, failed = K6.affine_cigars_tb(jobs, dev)
    check(K6.affine_tb_ckpt_cuda.launches > before,
          "4 kb members did not take K6")
    want = affine_cigars_multi(jobs)
    walked = sorted(set(range(len(jobs))) - set(failed))
    oracle = all(cigs[i] == want[i] for i in walked)
    check(err == 0 and same_ops and oracle and len(walked) > len(jobs) // 2,
          "K6 disagrees with its plain version or the native cigar ladder")

    # timing: 512 members of 3.5-4 kb alleles at 0.2% error, k = 127
    tjobs = consensus_jobs(rs, 512, 3500, 4000, 0.002)
    tw = K6._t_words(4096, 127)
    a = [torch.from_numpy(x).to(dev)
         for x in K6.pack_affine_jobs(tjobs, 4096, 127)]
    cells = float(sum(len(j[0]) for j in tjobs) * 256)
    ms = time_ms(lambda: K6.affine_tb_ckpt(*a, 127, tw), 3)
    plain_ms, (o2, e2) = time_once(lambda: K6.affine_tb_torch(*a, 127, tw))
    o1, e1 = K6.affine_tb_ckpt(*a, 127, tw)
    check(bool(torch.equal(o1, o2) and torch.equal(e1, e2)),
          "K6 disagrees with its plain version on the timing set")
    # K5 on the same members: the two kernels at the K5 / K6 boundary
    # (4096 rows at k = 127; CKPT_CELLS sends it to K6)
    k5_ms = time_ms(lambda: K6.affine_tb(*a, 127, tw), 3)
    o5, e5 = K6.affine_tb(*a, 127, tw)
    check(bool(torch.equal(o5, o2) and torch.equal(e5, e2)),
          "K5 disagrees with its plain version on the K6 timing set")
    log(f"K5 on the K6 timing set (4096 rows, k 127): {k5_ms:.3f} ms "
        f"({cells / k5_ms / 1e6:.2f} Gcells/s), K6 {ms:.3f} ms")
    return report("affine_tb_ckpt",
                  "K6 affine_tb_ckpt (k 63, 127; band cells)", len(jobs),
                  cells, err == 0 and same_ops, oracle, ms, plain_ms, err,
                  nbytes(*a, o1, e1))


def affine_sweep(dev) -> None:
    """K5 and K6 at every band they have an instance for, exact against
    the plain version: members of 30 bp to 2 kb in one launch, unrelated
    members (not walked), pattern-end-free members, members with a long gap,
    and a launch of one member; with each kernel's band Gcells/s."""
    import torch

    from otter_tpu_torch.kernels import affine_tb as K

    rs = np.random.default_rng(11)
    for k in K.BANDS:
        jobs = consensus_jobs(rs, 150, 30, 2000, 0.01) + \
            consensus_jobs(rs, 30, 100, 1000, 0.08)
        for _ in range(10):
            s = rand_acgt(rs, int(rs.integers(200, 1200)))
            jobs.append((s, rand_acgt(rs, len(s)), 0, 0, 0, 0))
        for _ in range(10):
            s = rand_acgt(rs, int(rs.integers(200, 1200)))
            tail = rand_acgt(rs, int(rs.integers(1, 40)))
            jobs.append((mutate(rs, s, 0.01) + tail, s, 0, len(tail), 0, 0))
        for q in range(20):  # a long gap in the text or in the pattern
            s = rand_acgt(rs, int(rs.integers(200, 1200)))
            x, g = int(rs.integers(0, len(s))), int(rs.integers(8, k // 2))
            mem = s[:x] + s[x + g:] if q % 2 else \
                s[:x] + rand_acgt(rs, g) + s[x:]
            jobs.append((mutate(rs, mem, 0.005), s, 0, 0, 0, 0))
        cells = float(sum(len(j[0]) for j in jobs) * 2 * (k + 1))
        for name, sel in (("all", jobs), ("one member", jobs[:1])):
            rows = 2048
            tw = K._t_words(rows, k)
            a = [torch.from_numpy(x).to(dev)
                 for x in K.pack_affine_jobs(sel, rows, k)]
            ops_p, end_p = K.affine_tb_torch(*a, k, tw)
            same = True
            for fn in (K.affine_tb, K.affine_tb_ckpt):
                ops, end = fn(*a, k, tw)
                same &= bool(torch.equal(ops, ops_p)
                             and torch.equal(end, end_p))
            check(same, f"K5 / K6 disagree with the plain version at k {k} "
                  f"({name})")
            if name == "all":
                walked = int(end_p[:, 3].sum())
                ms5 = time_ms(lambda: K.affine_tb(*a, k, tw), 2)
                ms6 = time_ms(lambda: K.affine_tb_ckpt(*a, k, tw), 2)
                log(f"K5 / K6 sweep k {k}: {len(sel)} members ({walked} "
                    f"walked), both == plain (max |diff| 0); K5 {ms5:.3f} ms "
                    f"({cells / ms5 / 1e6:.2f} band Gcells/s), K6 "
                    f"{ms6:.3f} ms ({cells / ms6 / 1e6:.2f} band Gcells/s)")
        log(f"K5 / K6 sweep k {k}: a launch of one member == plain")


# K8's sets: (name, regions, values a region)
KDE_SETS = (("hifi-tr-1.5k batch", 32, 4950), ("refscale region", 1, 19900),
            ("largest batch", 256, 19900))
KDE_RADIUS = 4  # the certification's window at max_error 0.01


def kde_values(rs, R: int, n: int) -> np.ndarray:
    """(R, n) pair distances shaped like a two-allele locus at 0.2% read
    error: two thirds near 0.004 (same-allele pairs), a third near 0.17."""
    near = rs.normal(0.004, 0.0015, (R, n - n // 3))
    far = rs.normal(0.17, 0.01, (R, n // 3))
    return np.clip(np.concatenate([near, far], axis=1), 0.0,
                   1.0).astype(np.float32)


def kde_bound(evals: float, moved: int, ops: int = KDE_F32_OPS):
    """(bound ms, what bounds it) for ``evals`` (cell, value) evaluations:
    the exps over the MUFU rate or their ``ops`` f32 operations each over
    the f32 rate, whichever is longer, against the bytes over the memory
    rate."""
    t_ops = max(evals / MUFU_LANES, evals * ops / F32_LANES) \
        / CARD["sm_hz"] * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kde_decisions(m, s, values, bws):
    """Per region: certified or not, and where certified the density's
    extrema indices (the clustering decision surface)."""
    from otter_tpu_torch.ops.kde import (kde_decision_certified_scaled_batch,
                                         kde_maximas)

    certs = kde_decision_certified_scaled_batch(
        list(zip(m, s)), values, bws, KDE_RADIUS)
    return [(ok, None if d is None else [[i for i, _v in side] for side in
                                         kde_maximas(KDE_RADIUS, d)])
            for ok, d in certs]


def kernel_k8(dev, rs) -> dict:
    """K8 against its plain version on the card on each of KDE_SETS: m
    equal, s within a relative 1e-6, the same certified decisions; times
    and bound. Returns the JSON fields of the first set (the shape of
    hifi-tr-1.5k's launch)."""
    import torch

    from otter_tpu_torch.kernels import kde_scaled as K8
    from otter_tpu_torch.ops.kde import kde_grid

    xs = torch.from_numpy(kde_grid(0.0025).astype(np.float32)).to(dev)
    G = xs.shape[0]
    out = None
    for name, R, n in KDE_SETS:
        n_pad = 1 << (n - 1).bit_length()
        V = np.zeros((R, n_pad), dtype=np.float32)
        V[:, :n] = kde_values(rs, R, n)
        bw = np.where(np.arange(R) % 2, 0.015, 0.01).astype(np.float32)
        args = [torch.from_numpy(a).to(dev)
                for a in (V, np.full(R, n, dtype=np.int32), bw)] + [xs]
        m, s = K8.kde_scaled_cuda(*args, n_max=n)
        m_p, s_p = K8.kde_scaled_torch(*args)
        same_m = bool(torch.equal(m, m_p))
        rel = float(((s - s_p).abs() / s_p).max())
        s_differ = int((s != s_p).sum())
        W, C, blocks, threads = K8.kde_scaled_geometry(R, n_pad, n, G)
        err = float(max((m - m_p).abs().max(), (s - s_p).abs().max()))
        values = [V[r, :n].astype(np.float64) for r in range(R)]
        t0 = time.perf_counter()
        dec = kde_decisions(m.cpu().numpy(), s.cpu().numpy(), values, bw)
        dec_p = kde_decisions(m_p.cpu().numpy(), s_p.cpu().numpy(), values,
                              bw)
        cert_s = time.perf_counter() - t0
        check(same_m and rel <= 1e-6 and dec == dec_p,
              f"K8 disagrees with its plain version on the {name} set (m "
              f"equal {same_m}, s rel {rel:.3g}, decisions equal "
              f"{dec == dec_p})")
        ms = time_ms(lambda: K8.kde_scaled_cuda(*args, n_max=n), 5)
        plain_ms, _out = time_once(lambda: K8.kde_scaled_torch(*args))
        evals = float(R * n * G)
        moved = 4 * R * n + nbytes(*args[1:]) + 8 * R * G
        bound_ms, bound_by = kde_bound(evals, moved)
        log(f"K8 kde_scaled, {name} ({R} regions x {n} values, G {G}): "
            f"launch W {W} warps a cell group ({32 * W} lanes), {C} cells a "
            f"thread, {blocks} blocks of {threads} threads; s not bit-equal "
            f"to the plain version's in {s_differ} of {R * G} cells")
        log(f"K8 kde_scaled, {name} ({R} regions x {n} values, G {G}): m "
            f"equal {same_m}, s max rel diff {rel:.3g} (tolerance 1e-6), max "
            f"|diff| {err:.3g}; certified {sum(ok for ok, _d in dec)} of {R} "
            f"regions, decisions equal {dec == dec_p} (host certification "
            f"{cert_s:.2f} s for both); kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms ({evals / ms / 1e9:.2f} G evaluations/s "
            f"kernel); bound {bound_ms:.4f} ms by {bound_by}, "
            f"{100 * bound_ms / ms:.2f}% of it; library call: none")
        if out is None:
            out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
    return out


def phase_kernels(dev) -> dict:
    log("== phase 3: kernels against their plain versions and oracles")
    rs = np.random.default_rng(3)
    t0 = time.perf_counter()
    out = {}
    for key, fn in (("myers_pool", kernel_k1), ("myers_striped", kernel_k2),
                    ("myers_banded", kernel_k3),
                    ("myers_banded_ef", kernel_k4),
                    ("edit_banded", kernel_k7),
                    ("edit_banded_ends_free", kernel_k9),
                    ("affine_tb", kernel_k5),
                    ("affine_tb_ckpt", kernel_k6), ("kde_scaled", kernel_k8)):
        out[key] = fn(dev, rs)
        log(f"-- {key} checked, {time.perf_counter() - t0:.1f} s into phase 3")
    for fn in (banded_refscale_sets, affine_sweep, edit_sweep, striped_sweep,
               banded_sweep):
        fn(dev)
        log(f"-- {fn.__name__} done, {time.perf_counter() - t0:.1f} s into "
            "phase 3")
    return out


# ---------------------------------------------------------------------------
# Phases 4-5: the main path
# ---------------------------------------------------------------------------


def params(**kw):
    from otter_tpu_torch.config import OtterOpts

    p = OtterOpts()
    p.read_group = "S1"
    p.device = "cuda"
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def run(bam, bed, backend, ref="", **kw) -> str:
    """The port's assemble of (bam, bed) on ``backend``'s engine, or with
    ``device="host"`` in ``kw`` (and no backend) in the host mode."""
    from otter_tpu_torch.models.assemble import assemble

    out = io.StringIO()
    assemble(bam, bed, ref, False, params(**kw), out=out,
             dist_backend=backend)
    return out.getvalue()


def all_wrappers() -> dict:
    """Every kernel's wrapper (K1-K14) by name."""
    return {**cuda_wrappers(), **opt_in_wrappers(), **step_wrappers()}


# what -> {"host": wall s of the host mode, "card": wall s on the card}
HOST_WALLS: dict = {}


def host_run(what: str, fn):
    """(wall s, result) of ``fn()``, a run of the port's host mode
    (``device="host"``), with every kernel's launch count set to 0 just
    before and read just after: each must still be 0."""
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    launched = {k: w.launches for k, w in wrappers.items() if w.launches}
    check(not launched, f"{what}: the host mode launched {launched}")
    return wall, out


def phase_small(tmp: str) -> dict:
    """Returns the small cells' BAM and BED and the host mode's SAM."""
    import torch

    from otter_tpu_torch.kernels.dist_backend import (NativeDistBackend,
                                                      TorchDistBackend)
    from otter_tpu_torch.utils.synth import tandem_repeat_loci

    log("== phase 4: small main path against the host engine and the "
        "host mode")
    bam, bed = tandem_repeat_loci(tmp, n_regions=3, cov=24, err=0.003,
                                  expansion=30, region_len=300, seed=5,
                                  name="small")
    small = dict(bam=bam, bed=bed)
    for label, kw in (("sam", {}), ("fasta", {"is_fa": True})):
        t0 = time.perf_counter()
        got = run(bam, bed, TorchDistBackend("cuda"), **kw)
        torch.cuda.synchronize()
        card_wall = time.perf_counter() - t0
        want = run(bam, bed, NativeDistBackend(), **kw)
        host_wall, host = host_run(
            f"small {label}", lambda: run(bam, bed, None, device="host",
                                          **kw))
        HOST_WALLS[f"small {label}"] = {"host": host_wall, "card": card_wall}
        log(f"small {label}: {len(got)} bytes, identical to the host engine "
            f"{got == want}, to the host mode {got == host}; walls: card "
            f"{card_wall:.3f} s, host mode {host_wall:.3f} s (no launch)")
        check(got == want, f"small {label}: card output differs from the "
              "host engine")
        check(got == host, f"small {label}: card output differs from the "
              "host mode")
        small[label] = host
    return small


# kernels of mesh mode alone (phase 8): device="cuda" leaves their jobs on
# the host
MESH_KERNELS = ("edit_banded_ends_free",)

# phase 5's cells: (name, tandem_repeat_loci arguments, with rates)
CELLS = (
    ("cell hifi-tr-1.5k",
     dict(n_regions=32, cov=100, err=0.002, expansion=100, region_len=1500,
          seed=77, name="smoke"), True),
    ("route coverage (parity only)",
     dict(n_regions=4, cov=100, err=0.002, expansion=300, region_len=1500,
          seed=78, name="routes", partial=0.2, n_bases=2), False),
    ("route coverage, 7.5 kb allele (parity only)",
     dict(n_regions=2, cov=24, err=0.002, expansion=2000, region_len=1500,
          seed=79, name="long"), False),
    ("refscale region (reference defaults: cov 200, 10 kb)",
     dict(n_regions=1, cov=200, err=0.002, expansion=100, region_len=10000,
          seed=77, name="refscale"), True),
)


def cell_fixtures(tmp: str) -> list:
    """Phase 5's inputs under ``tmp``: (bam, bed) in CELLS order."""
    from otter_tpu_torch.utils.synth import tandem_repeat_loci

    t0 = time.perf_counter()
    out = [tandem_repeat_loci(tmp, **kw) for _name, kw, _rates in CELLS]
    log(f"phase 5 fixtures built in {time.perf_counter() - t0:.2f} s")
    return out


def start_host_oracle(tmp: str, fixtures: list) -> subprocess.Popen:
    """Phase 5's host-engine runs (the byte-identity oracle, minutes of
    native C++ distances) in a side process, started before phase 3 so they
    run while the card works; the caller stops it if it is still running
    at the end."""
    args = [sys.executable, os.path.abspath(__file__), "--host-oracle", tmp]
    for bam, bed in fixtures:
        args += [bam, bed]
    with open(os.path.join(tmp, "host_oracle.log"), "w") as fh:
        return subprocess.Popen(args, stdout=fh, stderr=subprocess.STDOUT,
                                cwd=REPO)


def host_oracle_main(argv: list) -> int:
    """``--host-oracle DIR BAM BED [BAM BED ...]``: each cell on the exact
    host engine; writes DIR/host_<i>.sam and its wall in DIR/host_<i>.wall."""
    from otter_tpu_torch.kernels.dist_backend import NativeDistBackend

    out_dir, rest = argv[0], argv[1:]
    for i in range(0, len(rest), 2):
        t0 = time.perf_counter()
        text = run(rest[i], rest[i + 1], NativeDistBackend())
        wall = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"host_{i // 2}.sam"), "w") as fh:
            fh.write(text)
        with open(os.path.join(out_dir, f"host_{i // 2}.wall"), "w") as fh:
            fh.write(repr(wall))
    return 0


def host_oracle_result(oracle: subprocess.Popen, tmp: str, i: int):
    """(output, wall s) of cell ``i`` on the host engine, after the side
    process has ended; raises if it failed."""
    rc = oracle.wait()
    if rc != 0:
        with open(os.path.join(tmp, "host_oracle.log")) as fh:
            raise RuntimeError(f"host oracle failed ({rc}):\n"
                               f"{fh.read()[-4000:]}")
    with open(os.path.join(tmp, f"host_{i}.sam")) as fh:
        text = fh.read()
    with open(os.path.join(tmp, f"host_{i}.wall")) as fh:
        return text, float(fh.read())


def run_cell(name: str, bam: str, bed: str, n_regions: int, rates: bool,
             want: str, host_wall: float):
    """The port on the card against the host engine's output ``want``:
    byte-identical. Returns the card run's (counters, output, wall)."""
    import torch

    from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
    from otter_tpu_torch.utils import metrics

    backend = TorchDistBackend("cuda")
    metrics.reset()
    t0 = time.perf_counter()
    got = run(bam, bed, backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = metrics.snapshot()
    c = backend.engine.counters()
    body = [l for l in got.splitlines() if l and not l.startswith("@")]
    log(f"{name}: {n_regions} regions, {len(body)} alleles, identical to the "
        f"host engine: {got == want}")
    log(f"{name}: counters {json.dumps(c)}")
    for i, line in enumerate(ladder_lines(backend.engine.ladders)):
        log(f"{name}: ladder call {i + 1}: {line}")
    log(f"{name}: {kde_summary(snap)}")
    check(got == want, f"{name}: card output differs from the host engine")
    if rates:
        pairs = c["pairs_k1"] + c["pairs_k3"] + c["pairs_k2"] + c["pairs_k7"]
        phases = {k[5:]: round(v, 4) for k, v in snap.items()
                  if k.startswith("time.")}
        log(f"{name}: wall {wall:.3f} s, {n_regions / wall:.3f} regions/s, "
            f"{pairs / wall:.1f} pairs/s, {c['cells'] / wall / 1e9:.3f} "
            f"Gcells/s (Myers DP cells) end to end; host engine wall "
            f"{host_wall:.3f} s (in the side process, beside phase 3)")
        log(f"{name}: phase seconds {json.dumps(phases, sort_keys=True)}")
    return c, got, wall


def ladder_lines(ladders) -> list:
    """One line per K3 / K4 ladder call of an engine (``ladders``): each
    rung run as ``k: launched -> resolved``, then the jobs left to K2."""
    return [f"{kernel} " + ", ".join(f"k={k}: {n} -> {ok}"
                                     for k, n, ok in rungs)
            + f"; left to K2: {left}" for kernel, rungs, left in ladders]


KDE_PHASES = ("kde_device", "kde_certify", "kde_f64_fallback", "kde_f64")


def kde_summary(snap: dict) -> str:
    """The KDE counters and phase seconds of a metrics snapshot."""
    counts = {k: int(snap.get(f"count.{k}", 0)) for k in (
        "kde_device_regions", "kde_f64_fallback_regions")}
    phases = {k: round(snap.get(f"time.{k}", 0.0), 4) for k in KDE_PHASES}
    return f"KDE {json.dumps(counts)}, seconds {json.dumps(phases)}"


def kde_on_off(name: str, bam: str, bed: str) -> None:
    """A cell on the card with the device KDE on (the default route) and
    off (OTTER_TPU_MESH_KDE=0), in turns on, off, off, on: each run's wall
    and KDE phase seconds. Output is byte-identical across the four."""
    import torch

    from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
    from otter_tpu_torch.utils import metrics

    texts = set()
    for kde in ("on", "off", "off", "on"):
        if kde == "off":
            os.environ["OTTER_TPU_MESH_KDE"] = "0"
        metrics.reset()
        t0 = time.perf_counter()
        try:
            texts.add(run(bam, bed, TorchDistBackend("cuda")))
            torch.cuda.synchronize()
        finally:
            os.environ.pop("OTTER_TPU_MESH_KDE", None)
        wall = time.perf_counter() - t0
        log(f"{name}, device KDE {kde}: wall {wall:.3f} s; "
            f"{kde_summary(metrics.snapshot())}")
    check(len(texts) == 1, f"{name}: output differs with the device KDE "
          "on and off")


def phase_full(tmp: str, fixtures: list, oracle):
    """Returns each kernel's launches, and each cell's (counters, card
    output, wall) by name."""
    log("== phase 5: full-size main path")
    wrappers = cuda_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    launches = dict.fromkeys(wrappers, 0)
    runs = {}
    for i, ((name, kw, rates), (bam, bed)) in enumerate(zip(CELLS,
                                                           fixtures)):
        want, host_wall = host_oracle_result(oracle, tmp, i)
        runs[name] = run_cell(name, bam, bed, kw["n_regions"], rates, want,
                              host_wall)
        cell = {}
        for k, fn in wrappers.items():  # the host run launches nothing
            cell[k] = fn.launches - launches[k]
            launches[k] = fn.launches
        log(f"{name}: kernel launches {json.dumps(cell)}")
        if rates:
            check(cell["kde_scaled"] > 0, f"{name}: K8 did not launch")
    log(f"kernel launches in phase 5: {json.dumps(launches)}")
    missing = [k for k, v in launches.items()
               if v == 0 and k not in MESH_KERNELS]
    check(not missing, f"kernels never launched on the main path: {missing}")
    kde_on_off("cell hifi-tr-1.5k", *fixtures[0])
    kde_on_off("refscale region", *fixtures[3])
    return launches, runs


# ---------------------------------------------------------------------------
# Phase 6: the other entry points
# ---------------------------------------------------------------------------


def genotype_text(bam, bed, fa, device="cuda", max_error=None):
    """(wall s, VCF text, metrics snapshot) of one port genotype run
    (``max_error``: genotype's -e, the length cut)."""
    import torch

    from otter_tpu_torch.config import OtterOpts
    from otter_tpu_torch.models.genotype import genotype
    from otter_tpu_torch.utils import metrics

    p = OtterOpts()
    p.device = device
    if max_error is not None:
        p.init_max_error(max_error)
    out = io.StringIO()
    metrics.reset()
    t0 = time.perf_counter()
    genotype(p, bam, bed, fa, out=out)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out.getvalue(), metrics.snapshot()


def genotype_cohort(tmp: str, name: str, n_samples: int, n_regions: int,
                    seed: int):
    """One cohort of bench_e2e's genotype cells: the card's GEMM route
    (OTTER_TPU_GENOTYPE_DEVICE=1) and the host-BLAS route (the default) in
    turns (card, host, host, card) after a warm-up of each, each VCF
    byte-identical to the port's host mode (``device="host"``: the
    sequential path, the python allele parser, no launch); regions/s of
    both. Returns the cohort's BAM, BED and FASTA paths, the VCF's path and
    the VCF."""
    from otter_tpu_torch.utils.synth import cohort_fixture

    d = os.path.join(tmp, name)
    os.makedirs(d)
    bam, bed, fa = cohort_fixture(d, n_samples, n_regions, seed)
    _w, (t_seq, want, _snap) = host_run(
        name, lambda: genotype_text(bam, bed, fa, "host"))
    walls = {"card": [], "host BLAS": []}
    gemm = {}
    for route in ("warm-up", "card", "host BLAS", "host BLAS", "card"):
        if route in ("warm-up", "card"):  # warm-up: cuBLAS
            os.environ["OTTER_TPU_GENOTYPE_DEVICE"] = "1"
        try:
            wall, text, snap = genotype_text(bam, bed, fa)
        finally:
            os.environ.pop("OTTER_TPU_GENOTYPE_DEVICE", None)
        if route == "warm-up":
            continue
        check(text == want, f"{name}: the {route} route's VCF differs from "
              "the host mode")
        walls[route].append(wall)
        gemm[route] = {k[5:]: round(v, 4) for k, v in snap.items()
                       if k.startswith("time.genotype_")}
    rows = sum(1 for l in want.splitlines() if l and not l.startswith("#"))
    check(rows == n_regions, f"{name}: {rows} VCF rows for {n_regions} "
          "regions")
    log(f"{name} ({n_samples} samples x {n_regions} regions, "
        f"{2 * n_samples + 1} alleles a region): VCF identical to the "
        f"host mode on both routes ({rows} rows)")
    for route, ws in walls.items():
        log(f"{name} {route} route: walls {', '.join(f'{w:.3f}' for w in ws)}"
            f" s, {n_regions / min(ws):.2f} regions/s (best); phase seconds "
            f"{json.dumps(gemm[route], sort_keys=True)}")
    log(f"{name} host mode: wall {t_seq:.3f} s, "
        f"{n_regions / t_seq:.2f} regions/s, no launch")
    HOST_WALLS[name] = {"host": t_seq, "card": min(walls["card"]),
                        "card, host BLAS": min(walls["host BLAS"])}
    vcf = os.path.join(d, f"{name}.vcf")
    with open(vcf, "w") as fh:
        fh.write(want)
    return dict(bam=bam, bed=bed, fa=fa, vcf=vcf, text=want)


def compare_entry(tmp: str) -> None:
    """compare on a seeded truth / query pair (32 regions of 0.3-2.5 kb
    alleles, N bases and N alleles among them): the pooled call on the
    card's engine, byte-identical to the host mode (``device="host"``: the
    scalar path, the python allele parser, no launch); pairs and kernel
    launches, counted from 0 just before the card run."""
    import torch

    from otter_tpu_torch.config import OtterOpts
    from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
    from otter_tpu_torch.models.compare import compare
    from otter_tpu_torch.utils.synth import compare_fixture

    d = os.path.join(tmp, "compare")
    os.makedirs(d)
    truth, query, bed = compare_fixture(d, 32, seed=31)
    p = OtterOpts()
    backend = TorchDistBackend("cuda")
    wrappers = cuda_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    got = io.StringIO()
    t0 = time.perf_counter()
    compare(p, bed, truth, query, out=got, dist_backend=backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    want = io.StringIO()
    host = OtterOpts()
    host.device = "host"
    t_scalar, _ = host_run("compare", lambda: compare(host, bed, truth,
                                                      query, out=want))
    HOST_WALLS["compare"] = {"host": t_scalar, "card": wall}
    c = backend.engine.counters()
    pairs = c["pairs_k1"] + c["pairs_k3"] + c["pairs_k2"] + c["pairs_k7"]
    log(f"compare: {got.getvalue().count(chr(10))} TSV rows, {pairs} engine "
        f"pairs ({json.dumps({k: c[k] for k in ('pairs_k1', 'pairs_k3', 'pairs_k2', 'pairs_k7')})}), "
        f"kernel launches {json.dumps(launched)}; identical to the host "
        f"mode: {got.getvalue() == want.getvalue()}; wall {wall:.3f} s on "
        f"the card, host mode {t_scalar:.3f} s")
    check(got.getvalue() == want.getvalue() and pairs > 0 and launched,
          "compare: the card's TSV differs from the host mode")
    return dict(truth=truth, query=query, bed=bed, text=got.getvalue())


def vcf2mat_entry(vcf: str, bed: str) -> None:
    """vcf2mat of a genotype VCF: one row per allele (REF and each ALT),
    region, index, GC, length, HSD and the 65 3-mer usages."""
    from otter_tpu_torch.config import OtterOpts
    from otter_tpu_torch.models.vcf2mat import vcf2mat

    alleles = 0
    with open(vcf) as fh:
        for line in fh:
            if not line.startswith("#"):
                f = line.split("\t")
                alleles += 1 + (f[4] != ".") * len(f[4].split(","))
    out = io.StringIO()
    t0 = time.perf_counter()
    vcf2mat(OtterOpts(), bed, vcf, 3, out=out)
    wall = time.perf_counter() - t0
    rows = out.getvalue().splitlines()
    check(len(rows) == alleles and all(len(r.split("\t")) == 70
                                       for r in rows),
          f"vcf2mat: {len(rows)} rows for {alleles} alleles")
    log(f"vcf2mat: {len(rows)} rows of 70 columns for the {alleles} alleles "
        f"of the 64-sample VCF, {wall:.3f} s")


def wgat_entry(tmp: str) -> None:
    """wgat on a seeded aligned assembly: three contigs over a 60 kb
    reference (one with a 30 bp deletion, one soft-clipped at its start)
    and 60 regions; every region inside a contig and clear of both events
    gives the reference's sequence (offset 1,0), the one over the clip is
    skipped, the one over the deletion loses 30 bp."""
    from otter_tpu_torch.config import OtterOpts
    from otter_tpu_torch.io.bam import BAM_CDEL, BAM_CMATCH, BAM_CSOFT_CLIP
    from otter_tpu_torch.models.wgat import wgat
    from otter_tpu_torch.utils.synth import make_bam, read_record

    import random

    rng = random.Random(41)
    ref = "".join(rng.choice("ACGT") for _ in range(60000))
    clip = "".join(rng.choice("ACGT") for _ in range(500))
    recs = [read_record("ctg_0", 1000, ref[1000:20000], [(19000, BAM_CMATCH)]),
            read_record("ctg_1", 20000, ref[20000:30000] + ref[30030:39000],
                        [(10000, BAM_CMATCH), (30, BAM_CDEL),
                         (8970, BAM_CMATCH)]),
            read_record("ctg_2", 40000, clip + ref[40000:59000],
                        [(500, BAM_CSOFT_CLIP), (19000, BAM_CMATCH)])]
    d = os.path.join(tmp, "wgat")
    os.makedirs(d)
    bam = os.path.join(d, "asm.bam")
    make_bam(bam, [("chr1", len(ref))], recs)
    regions = [(s, s + 60) for s in range(1500, 59000, 1000)]
    regions += [(29990, 30050), (39990, 40050)]
    bed = os.path.join(d, "asm.bed")
    with open(bed, "w") as fh:
        fh.writelines(f"chr1\t{a}\t{b}\n" for a, b in regions)
    p = OtterOpts()
    p.read_group = "ASM1"
    out = io.StringIO()
    t0 = time.perf_counter()
    wgat(p, bam, bed, out=out)
    wall = time.perf_counter() - t0
    seqs = {}
    for line in out.getvalue().splitlines():
        if not line.startswith("@"):
            f = line.split("\t")
            seqs[f[0].split("#")[1].rsplit("_", 1)[0]] = f[9]
    clean = [(a, b) for a, b in regions
             if (1000 < a and b <= 20000 or 20000 < a and b <= 30000
                 or 30030 < a and b <= 39000 or 40000 < a and b <= 59000)]
    ok = all(seqs.get(f"chr1:{a}-{b}") == ref[a - 1 : b] for a, b in clean)
    dele = seqs.get("chr1:29990-30050", "")
    check(ok and len(seqs) == len(clean) + 1 and len(dele) == 61 - 30
          and "chr1:39990-40050" not in seqs,
          f"wgat: {len(seqs)} alleles, clean regions right {ok}")
    log(f"wgat: {len(seqs)} alleles for {len(regions)} regions (the clipped "
        f"one skipped), {len(clean)} equal to the reference, the deletion's "
        f"{len(dele)} bp; {wall:.3f} s")


def host_processes(tmp: str, small: dict, g64: dict) -> None:
    """The port's command line with ``--device host`` in fresh processes
    (``--dist-worker``): assemble on phase 4's small cells and genotype64,
    each writing this process's host-mode bytes, with every kernel's
    launch count 0 and no CUDA context made."""
    runs = (("small", ["assemble", small["bam"], "-b", small["bed"], "-R",
                       "S1", "--device", "host"], small["sam"]),
            ("genotype64", ["genotype", g64["bam"], "-b", g64["bed"], "-r",
                            g64["fa"], "-e", "0.01", "--device", "host"],
             g64["text"]))
    for name, args, want in runs:
        outs, infos, wall = run_processes(tmp, f"host_{name}", args, 1, {})
        info = infos[0]
        launched = {k: v for k, v in info["launches"].items() if v}
        log(f"{name}, --device host in a fresh process: identical to the "
            f"host mode here: {outs[0] == want}; launches "
            f"{json.dumps(launched)}; CUDA context made: "
            f"{info['cuda_initialized']}; command wall {info['wall']:.3f} s, "
            f"{wall:.3f} s from start to exit")
        check(outs[0] == want and not launched
              and not info["cuda_initialized"],
              f"{name}, --device host in a fresh process: output differs, "
              "a kernel launched or a CUDA context was made")


def phase_entry_points(tmp: str, small: dict):
    """Returns genotype64's and genotype500's cohorts and VCFs
    (genotype_cohort), and compare's inputs and card TSV (compare_entry)."""
    log("== phase 6: the other entry points")
    g64 = genotype_cohort(tmp, "genotype64", 64, 32, 5)
    g500 = genotype_cohort(tmp, "genotype500", 500, 8, 23)
    cmp = compare_entry(tmp)
    vcf2mat_entry(g64["vcf"], g64["bed"])
    wgat_entry(tmp)
    host_processes(tmp, small, g64)
    log(f"host mode walls (s) beside the card's ({CARD['line']}): "
        + json.dumps(HOST_WALLS))
    return g64, g500, cmp


# ---------------------------------------------------------------------------
# Phase 7: -t and several processes sharing the card
# ---------------------------------------------------------------------------

# the kernels each process of hifi-tr-1.5k must launch: K1, K2, K5, K8
CELL_KERNELS = ("myers_pool", "myers_striped", "affine_tb", "kde_scaled")


def host_pools(bam: str, bed: str, want: str) -> None:
    """hifi-tr-1.5k on the card at -t 1 and -t 8 in turns (1, 8, 8, 1):
    walls and ``host_io`` (region prep stays on one thread whatever -t is),
    every output ``want``, phase 5's card output, byte for byte; then with
    OTTER_TPU_FINISH_POOL=1 at -t 8: eight spawned workers take each
    region's hclust, reassignment and consensus on the host while this
    process keeps the card (K1 and K8 must launch here), byte-identical
    again."""
    import torch

    from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
    from otter_tpu_torch.utils import metrics

    def once(threads: int, label: str) -> dict:
        wrappers = cuda_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        metrics.reset()
        t0 = time.perf_counter()
        text = run(bam, bed, TorchDistBackend("cuda"), threads=threads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = metrics.snapshot()
        check(text == want, f"hifi-tr-1.5k {label}: output differs from "
              "phase 5's")
        phases = {k: round(snap.get(f"time.{k}", 0.0), 4) for k in (
            "host_io", "device_dispatch", "cluster_consensus",
            "consensus_batch")}
        launched = {k: fn.launches for k, fn in wrappers.items()
                    if fn.launches}
        log(f"hifi-tr-1.5k {label}: wall {wall:.3f} s, identical to phase "
            f"5: True; phase seconds {json.dumps(phases)}; launches in "
            f"this process {json.dumps(launched)}")
        return launched

    for threads in (1, 8, 8, 1):
        once(threads, f"-t {threads}")
    os.environ["OTTER_TPU_FINISH_POOL"] = "1"
    try:
        launched = once(8, "-t 8, finish pool of 8 workers")
    finally:
        os.environ.pop("OTTER_TPU_FINISH_POOL", None)
    check(launched.get("myers_pool", 0) > 0
          and launched.get("kde_scaled", 0) > 0,
          "finish pool: K1 and K8 did not launch in the parent")


def dist_worker_main(argv: list) -> int:
    """``--dist-worker OUT INFO ARGS...``: the port's command line with
    ARGS in this process, its standard output into OUT; each kernel's
    launches in this process (counted from 0 just before the call), the
    call's wall and whether it made a CUDA context into INFO as JSON."""
    import contextlib

    import torch

    from otter_tpu_torch.cli.main import main as cli

    out_path, info_path, args = argv[0], argv[1], argv[2:]
    wrappers = all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with open(out_path, "w") as fh, contextlib.redirect_stdout(fh):
        rc = cli(args)
    cuda_initialized = torch.cuda.is_initialized()
    if cuda_initialized:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(info_path, "w") as fh:
        json.dump({"launches": {k: fn.launches for k, fn in wrappers.items()},
                   "wall": wall, "cuda_initialized": cuda_initialized}, fh)
    return rc


def run_processes(tmp: str, tag: str, args: list, n: int, env: dict):
    """``n`` processes of the port's command line (``--dist-worker``) on
    the card, with a coordinator when n > 1; each must exit 0 within 300 s
    (all are stopped otherwise). Returns (outputs, infos, wall from the
    first start to the last exit)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    paths = [[os.path.join(tmp, f"{tag}_{pid}.{x}") for x in
              ("out", "json", "log")] for pid in range(n)]
    procs = []
    t0 = time.perf_counter()
    try:
        for pid, (out, info, log_path) in enumerate(paths):
            penv = dict(os.environ, **env)
            if n > 1:
                penv.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                            JAX_NUM_PROCESSES=str(n),
                            JAX_PROCESS_ID=str(pid))
            with open(log_path, "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--dist-worker", out, info, *args],
                    env=penv, stdout=fh, stderr=subprocess.STDOUT, cwd=REPO))
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for pid, rc in enumerate(rcs):
        if rc != 0:
            with open(paths[pid][2]) as fh:
                raise RuntimeError(f"{tag}: process {pid} exited {rc}:\n"
                                   f"{fh.read()[-4000:]}")
    outs, infos = [], []
    for out, info, _log in paths:
        with open(out) as fh:
            outs.append(fh.read())
        with open(info) as fh:
            infos.append(json.load(fh))
    return outs, infos, wall


def processes_on_card(tmp: str, bam: str, bed: str, want: str,
                      g64: dict) -> None:
    """hifi-tr-1.5k through the port's command line in separate processes
    sharing the card, in turns: one process, two with per-process streams,
    two with OTTER_TPU_GATHER=1, one again; each output is ``want`` (the
    streams concatenated in process order, or process 0's), every process
    launched K1, K2, K5 and K8 by its own counters. Then genotype64 in two
    processes with the gather: the VCF of phase 6."""
    args = ["assemble", bam, "-b", bed, "-R", "S1"]
    runs = (("1 process", 1, {}), ("2 processes, streams", 2, {}),
            ("2 processes, gather", 2, {"OTTER_TPU_GATHER": "1"}),
            ("1 process", 1, {}))
    for r, (label, n, env) in enumerate(runs):
        outs, infos, wall = run_processes(tmp, f"hifi{r}", args, n, env)
        if env:
            ok = outs[0] == want and all(o == "" for o in outs[1:])
        else:
            ok = "".join(outs) == want
        check(ok, f"hifi-tr-1.5k, {label}: output differs from phase 5's")
        for pid, info in enumerate(infos):
            launched = {k: v for k, v in info["launches"].items() if v}
            log(f"hifi-tr-1.5k, {label}, process {pid}: launches "
                f"{json.dumps(launched)}, command wall {info['wall']:.3f} s")
            missing = [k for k in CELL_KERNELS if not launched.get(k)]
            check(not missing, f"hifi-tr-1.5k, {label}, process {pid}: "
                  f"{missing} not launched")
        log(f"hifi-tr-1.5k, {label}: wall {wall:.3f} s from start to exit "
            f"(interpreter start included), longest command wall "
            f"{max(i['wall'] for i in infos):.3f} s; identical to phase 5: "
            "True")
    # -e: phase 6 ran genotype with OtterOpts' max_error, not the CLI's
    outs, infos, wall = run_processes(
        tmp, "genotype64", ["genotype", g64["bam"], "-b", g64["bed"], "-r",
                            g64["fa"], "-e", "0.01"], 2,
        {"OTTER_TPU_GATHER": "1"})
    check(outs == [g64["text"], ""], "genotype64 in 2 processes: the "
          "gathered VCF differs from phase 6's")
    log(f"genotype64, 2 processes, gather: VCF identical to phase 6: True; "
        f"wall {wall:.3f} s, command walls "
        f"{', '.join(f'{i['wall']:.3f}' for i in infos)} s")


def phase_pools_processes(tmp: str, fixture, hifi_text: str,
                          g64: dict) -> None:
    log("== phase 7: -t and processes sharing the card")
    t0 = time.perf_counter()
    host_pools(*fixture, hifi_text)
    processes_on_card(tmp, *fixture, hifi_text, g64)
    log(f"phase 7 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 8: mesh mode
# ---------------------------------------------------------------------------

# the kernels each mesh run of a cell must launch
MESH_CELL_KERNELS = {"cell hifi-tr-1.5k": ("myers_pool", "myers_striped",
                                           "affine_tb", "kde_scaled"),
                     "route coverage (parity only)": (
                         "edit_banded_ends_free",)}


def mesh_assemble(name: str, bam: str, bed: str, mesh, want: str) -> dict:
    """One cell in mesh mode, byte-identical to phase 5's card output
    ``want``: with ``mesh`` None through ``params.device = "mesh"`` (the
    visible cards, as a user runs it), else over the given devices. Prints
    the wall, each shard's pair and job counts and the kernel launches;
    returns the launches."""
    import torch

    from otter_tpu_torch.kernels.dist_backend import TorchDistBackend

    wrappers = cuda_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    backend = TorchDistBackend("mesh", mesh=mesh)
    t0 = time.perf_counter()
    got = run(bam, bed, backend, device="mesh")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in wrappers.items()}
    shards = [{k: v for k, v in c.items() if v and k != "cells"}
              for c in backend.engine.shard_counters()]
    c = backend.engine.counters()
    log(f"  {name}: wall {wall:.3f} s, identical to phase 5: {got == want};"
        f" jobs_host {c['jobs_host']}, jobs_k9 {c['jobs_k9']}; per shard "
        f"{json.dumps(shards)}; launches "
        f"{json.dumps({k: v for k, v in launched.items() if v})}")
    check(got == want, f"mesh mode, {name}: output differs from phase 5's")
    missing = [k for k in MESH_CELL_KERNELS.get(name, ()) if not launched[k]]
    check(not missing, f"mesh mode, {name}: {missing} did not launch")
    return launched


def k9_route_capture(bam: str, bed: str, mesh, want: str) -> None:
    """The route-coverage cell over ``mesh`` with K9's inputs recorded,
    then K9 and its plain version timed on the largest pass it launched:
    the kernel at the cell's own shapes."""
    import torch

    from otter_tpu_torch.kernels import edit_banded as K9
    from otter_tpu_torch.kernels.dist_backend import TorchDistBackend

    passes = []
    real = K9.edit_banded_ends_free

    def record(ax, bxp, meta, k):
        passes.append((ax.clone(), bxp.clone(), meta.clone(), k))
        return real(ax, bxp, meta, k)

    K9.edit_banded_ends_free = record
    try:
        got = run(bam, bed, TorchDistBackend(mesh=mesh))
    finally:
        K9.edit_banded_ends_free = real
    check(got == want and passes, "route coverage: K9's capture run differs "
          "from phase 5 or launched no K9")
    sizes = [(int(p[0].shape[0]), p[3]) for p in passes]
    ax, bxp, meta, k = max(passes, key=lambda p: int(p[2][:, 0].sum())
                           * (p[3] + 1))
    cells = float(int(meta[:, 0].sum()) * 2 * (k + 1))
    ms = time_ms(lambda: K9.edit_banded_ends_free(ax, bxp, meta, k), 5)
    plain_ms, want_k = time_once(
        lambda: K9.edit_banded_ends_free_torch(ax, bxp, meta, k))
    check(bool(torch.equal(K9.edit_banded_ends_free(ax, bxp, meta, k),
                           want_k)),
          "K9 disagrees with its plain version on the cell's pass")
    b, by = bound("edit_banded_ends_free", cells,
                  nbytes(ax, bxp, meta) + 4 * ax.shape[0])
    log(f"  K9 in the route-coverage cell: {len(passes)} passes (jobs, k): "
        f"{sizes}; its largest, {ax.shape[0]} jobs at k {k}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, == plain; bound {b:.5f} ms "
        f"by {by}, {100 * b / ms:.2f}% of it")


def mesh_entry_points(mesh, g64: dict, cmp: dict) -> dict:
    """genotype64 and compare in mesh mode (``params.device = "mesh"`` when
    ``mesh`` is None), byte-identical to phase 6's VCF and TSV; returns
    the kernel launches of the compare run."""
    import torch

    from otter_tpu_torch.config import OtterOpts
    from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
    from otter_tpu_torch.models.compare import compare
    from otter_tpu_torch.models.genotype import genotype

    p = OtterOpts()
    p.device = "mesh" if mesh is None else mesh[0].type
    out = io.StringIO()
    t0 = time.perf_counter()
    genotype(p, g64["bam"], g64["bed"], g64["fa"], out=out, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"  genotype64: wall {wall:.3f} s, VCF identical to phase 6: "
        f"{out.getvalue() == g64['text']}")
    check(out.getvalue() == g64["text"],
          "mesh mode, genotype64: the VCF differs from phase 6's")
    wrappers = cuda_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    backend = TorchDistBackend("mesh", mesh=mesh)
    out = io.StringIO()
    t0 = time.perf_counter()
    compare(p, cmp["bed"], cmp["truth"], cmp["query"], out=out,
            dist_backend=backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in wrappers.items()}
    shards = [{k: v for k, v in c.items() if v and k != "cells"}
              for c in backend.engine.shard_counters()]
    log(f"  compare: wall {wall:.3f} s, TSV identical to phase 6: "
        f"{out.getvalue() == cmp['text']}; per shard {json.dumps(shards)}; "
        f"launches {json.dumps({k: v for k, v in launched.items() if v})}")
    check(out.getvalue() == cmp["text"] and launched["myers_pool"],
          "mesh mode, compare: the TSV differs from phase 6's")
    return launched


def phase_mesh(dev, fixtures: list, runs: dict, g64: dict, cmp: dict
               ) -> dict:
    """Mesh mode on the mesh of every visible card (through
    ``params.device = "mesh"``) and on two shards of card 0: every phase 5
    cell, genotype64 and compare byte-identical to phases 5 and 6; K9
    timed on the route-coverage cell's own largest pass. Returns K9's
    launches in the mesh runs of the main path (its only path)."""
    from otter_tpu_torch.parallel.mesh import make_mesh

    log("== phase 8: mesh mode")
    t0 = time.perf_counter()
    k9 = 0
    for label, mesh in (("all visible cards", None),
                        ("two shards of card 0", (dev, dev))):
        shown = make_mesh() if mesh is None else mesh
        log(f"mesh {label}: {[str(d) for d in shown]}")
        total = {}
        for (name, _kw, _r), (bam, bed) in zip(CELLS, fixtures):
            got = mesh_assemble(name, bam, bed, mesh, runs[name][1])
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
        k9 += total["edit_banded_ends_free"]
        if mesh is None:  # the user's path: assemble builds the mesh itself
            name = CELLS[0][0]
            t1 = time.perf_counter()
            got = run(*fixtures[0], None, device="mesh")
            log(f"  {name}, params.device = 'mesh' and no backend: wall "
                f"{time.perf_counter() - t1:.3f} s, identical to phase 5: "
                f"{got == runs[name][1]}")
            check(got == runs[name][1], f"mesh mode, {name}: the user's "
                  "path differs from phase 5's")
        mesh_entry_points(mesh, g64, cmp)
        missing = [k for k, v in total.items() if v == 0]
        check(not missing, f"mesh {label}: kernels never launched on the "
              f"main path: {missing}")
    k9_route_capture(*fixtures[1], (dev, dev),
                     runs["route coverage (parity only)"][1])
    log(f"phase 8 took {time.perf_counter() - t0:.1f} s")
    return {"edit_banded_ends_free": k9}


# ---------------------------------------------------------------------------
# Phase 9: the opt-in device paths (K10-K12)
# ---------------------------------------------------------------------------

# the kernels of the JAX package's opt-in device paths: each launches only
# with its setting, so only in phase 9
OPT_IN_KERNELS = ("kmer_counts", "linkage", "poa_heaviest")
# K10's set with the device-memory histogram (4^8 + 1 counts an allele)
K10_GLOBAL_K = 8


def opt_in_wrappers() -> dict:
    """Kernel name -> the wrapper whose ``launches`` counts its launches."""
    from otter_tpu_torch.kernels import kmer_counts, linkage, poa_heaviest

    return {"kmer_counts": kmer_counts.kmer_counts_cuda,
            "linkage": linkage.linkage_cuda,
            "poa_heaviest": poa_heaviest.poa_heaviest_cuda}


class Settings:
    """Environment settings for a block, restored after it."""

    def __init__(self, **env):
        self.env = env
        self.saved = {}

    def __enter__(self):
        for k, v in self.env.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Recorder:
    """Replaces ``module.name`` for a block with a function that records
    its arguments (in ``calls``) and then calls the original."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def record(*args):
            self.calls.append(args)
            return self.real(*args)

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def opt_in_run(what: str, fn, want: str, kernel: str, **env):
    """``fn()`` (the entry point's output) with the settings ``env``, the
    opt-in kernels' counts zeroed just before and read just after:
    byte-identical to ``want`` and ``kernel`` launched. Returns (wall,
    launches)."""
    import torch

    wrappers = opt_in_wrappers()
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "routes"):
            w.routes = dict.fromkeys(w.routes, 0)
    with Settings(**env):
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {k: w.launches for k, w in wrappers.items()}
    routes = {k: w.routes for k, w in wrappers.items()
              if getattr(w, "routes", None) and w.launches}
    log(f"{what}: wall {wall:.3f} s, identical: {got == want}; launches "
        f"{json.dumps(launched)}, by route {json.dumps(routes)}")
    check(got == want, f"{what}: the output differs")
    check(launched[kernel] > 0, f"{what}: {kernel} did not launch")
    return wall, launched


def opt_in_entry_points(tmp: str, fixtures: list, runs: dict, g64: dict,
                        g500: dict, dev):
    """Phase 9 (b): each opt-in path end to end on the card, byte-identical
    to the default path's output; returns the launches of each path's runs
    and the inputs its kernel took (K10's batches, K12's graphs)."""
    from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
    from otter_tpu_torch.ops import poa_device
    from otter_tpu_torch.kernels import kmer_counts as K10
    from otter_tpu_torch.utils import metrics
    from otter_tpu_torch.utils.synth import cohort_fixture

    launches = dict.fromkeys(OPT_IN_KERNELS, 0)
    graphs = {}
    hifi, refscale = CELLS[0][0], CELLS[3][0]
    for i, name in ((0, hifi), (3, refscale)):
        with Recorder(poa_device, "poa_heaviest") as rec:
            wall, got = opt_in_run(
                f"{name}, OTTER_TPU_POA_DEVICE=1",
                lambda: run(*fixtures[i], TorchDistBackend("cuda")),
                runs[name][1], "poa_heaviest", OTTER_TPU_POA_DEVICE="1")
        launches["poa_heaviest"] += got["poa_heaviest"]
        graphs[name] = rec.calls[0][0]
        log(f"{name}: wall {wall:.3f} s with the Python graph build and "
            f"K12, {runs[name][2]:.3f} s on the default route (native "
            f"PPOA, phase 5); {graphs[name].meta.shape[0]} graphs, up to "
            f"{graphs[name].max_nodes} nodes and {graphs[name].max_depth + 1}"
            " levels")
    batches = {}
    for name, g in (("genotype64", g64), ("genotype500", g500)):
        with Recorder(K10, "kmer_counts") as rec:
            _wall, got = opt_in_run(
                f"{name}, OTTER_TPU_KMER_DEVICE=1",
                lambda: genotype_text(g["bam"], g["bed"], g["fa"])[1],
                g["text"], "kmer_counts", OTTER_TPU_KMER_DEVICE="1")
        launches["kmer_counts"] += got["kmer_counts"]
        batches[name] = rec.calls[0]
    # with the native NN-chain batch on (the default) genotype never
    # reaches the per-matrix hclust route, so it is off here, as in the
    # JAX package; cohort matrices are full of ties, which the guard
    # declines: genotype64 may launch no K11 at all
    metrics.reset()
    with Settings(OTTER_TPU_NATIVE_HCLUST="0", OTTER_TPU_HCLUST_DEVICE="1"):
        wrapper = opt_in_wrappers()["linkage"]
        wrapper.launches = 0
        text = genotype_text(g64["bam"], g64["bed"], g64["fa"])[1]
    snap = metrics.snapshot()
    log(f"genotype64, OTTER_TPU_NATIVE_HCLUST=0 OTTER_TPU_HCLUST_DEVICE=1: "
        f"identical: {text == g64['text']}; K11 launches {wrapper.launches},"
        f" matrices on K11 {int(snap.get('count.hclust_device', 0))}, "
        f"declined by the exactness guards "
        f"{int(snap.get('count.hclust_device_declined', 0))}")
    check(text == g64["text"], "genotype64 with K11's route: VCF differs")
    # a VNTR locus with a length allele a haplotype: tie-free length
    # matrices, which K11 serves
    d = os.path.join(tmp, "vntr16")
    os.makedirs(d)
    vbam, vbed, vfa = cohort_fixture(d, 16, 8, 41, vntr=True)
    want = genotype_text(vbam, vbed, vfa)[1]
    metrics.reset()
    _wall, got = opt_in_run(
        "vntr16 (16 samples x 8 VNTR regions), OTTER_TPU_NATIVE_HCLUST=0 "
        "OTTER_TPU_HCLUST_DEVICE=1",
        lambda: genotype_text(vbam, vbed, vfa)[1], want, "linkage",
        OTTER_TPU_NATIVE_HCLUST="0", OTTER_TPU_HCLUST_DEVICE="1")
    snap = metrics.snapshot()
    log(f"vntr16: matrices on K11 {int(snap.get('count.hclust_device', 0))},"
        f" declined {int(snap.get('count.hclust_device_declined', 0))}")
    launches["linkage"] += got["linkage"]
    # 128 samples (n = 257): K11's cluster route; the haplotypes' distinct
    # prime lengths make the length matrices tie-free, and a length cut of
    # 0.1 (genotype -e 0.1) keeps every merge height clear of the cut
    d = os.path.join(tmp, "vntr128")
    os.makedirs(d)
    vbam, vbed, vfa = cohort_fixture(d, 128, 4, 41, vntr=True,
                                     prime_lengths=True)
    want = genotype_text(vbam, vbed, vfa, max_error=0.1)[1]
    metrics.reset()
    _wall, got = opt_in_run(
        "vntr128 (128 samples x 4 VNTR regions, prime lengths, -e 0.1), "
        "OTTER_TPU_NATIVE_HCLUST=0 OTTER_TPU_HCLUST_DEVICE=1",
        lambda: genotype_text(vbam, vbed, vfa, max_error=0.1)[1], want,
        "linkage", OTTER_TPU_NATIVE_HCLUST="0", OTTER_TPU_HCLUST_DEVICE="1")
    snap = metrics.snapshot()
    on_cluster = opt_in_wrappers()["linkage"].routes["cluster"]
    log(f"vntr128: matrices on K11 "
        f"{int(snap.get('count.hclust_device', 0))}, declined "
        f"{int(snap.get('count.hclust_device_declined', 0))}; launches on "
        f"the cluster route {on_cluster}")
    check(on_cluster > 0, "vntr128: K11's cluster route did not launch")
    launches["linkage"] += got["linkage"]
    # mesh mode: the graph axis split over two shards of card 0
    with Recorder(poa_device, "poa_heaviest") as rec:
        _wall, got = opt_in_run(
            f"{hifi}, mesh of two shards of card 0, OTTER_TPU_POA_DEVICE=1",
            lambda: run(*fixtures[0], TorchDistBackend("mesh",
                                                       mesh=(dev, dev)),
                        device="mesh"),
            runs[hifi][1], "poa_heaviest", OTTER_TPU_POA_DEVICE="1")
    shards = [b.meta.shape[0] for (b,) in rec.calls]
    log(f"{hifi}, mesh: K12 launches {got['poa_heaviest']}, graphs a launch "
        f"{shards}")
    check(len(shards) == 2 and min(shards) > 0,
          "mesh mode: K12 did not launch on each shard")
    launches["poa_heaviest"] += got["poa_heaviest"]
    return launches, batches, graphs


def kernel_k10(batches: dict) -> dict:
    """K10 against its plain version on the card on genotype64's and
    genotype500's batches (k = 3) and genotype64's first 256 alleles at
    k = 8 (device-memory histograms); times, bound, and torch.bincount of
    the window keys (the library call). Returns the fields of
    genotype500's batch."""
    import torch

    from otter_tpu_torch.kernels import kmer_counts as K10

    out = None
    sets = [(n, b[0], b[1], b[2]) for n, b in batches.items()]
    seqs, offsets = batches["genotype64"][:2]  # its first 256 alleles
    sets.append(("genotype64's first 256 alleles",
                 seqs[: int(offsets[256])].contiguous(),
                 offsets[:257].contiguous(), K10_GLOBAL_K))
    for name, seqs, offsets, k in sets:
        n = offsets.shape[0] - 1
        got = K10.kmer_counts_cuda(seqs, offsets, k)
        want = K10.kmer_counts_torch(seqs, offsets, k)
        err = int((got - want).abs().max())
        check(err == 0, f"K10 disagrees with its plain version ({name}, "
              f"k = {k})")
        keys = K10.window_keys(seqs, offsets, k)
        width = 4 ** k + 1
        ms = time_ms(lambda: K10.kmer_counts_cuda(seqs, offsets, k), 20)
        plain_ms = time_ms(lambda: K10.kmer_counts_torch(seqs, offsets, k),
                           5)
        lib_ms = time_ms(lambda: torch.bincount(keys, minlength=n * width),
                         20)
        windows = int(keys.shape[0])
        moved = nbytes(seqs, offsets) + 4 * n * width
        t_ops = windows * (3 * k + 4) / (INT32_LANES * CARD["sm_hz"]) * 1e3
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        b, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                                "bytes")
        log(f"K10 kmer_counts, {name} ({n} alleles, {seqs.shape[0]} bytes, "
            f"{windows} windows, k = {k}): kernel == plain: True, max |diff| "
            f"{err} (tolerance 0); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, torch.bincount of the keys {lib_ms:.4f} ms; bound "
            f"{b:.5f} ms by {by}, {100 * b / ms:.3f}% of it")
        if name == "genotype500":
            out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b, "bound_by": by, "library_ms": lib_ms}
    return out


def _canon(labels) -> list:
    seen = {}
    return [seen.setdefault(int(l), len(seen)) for l in labels]


def kernel_k11(dev) -> dict:
    """K11 against its plain version on the card on seeded tie-free
    matrices at n = 129 and 1,001 (genotype64's and genotype500's cohort
    sizes): merges and heights bit for bit, and partitions equal to the
    native NN-chain's at three cuts; times and bound. Returns the fields of
    n = 1,001."""
    import torch

    from otter_tpu_torch.kernels import linkage as K11
    from otter_tpu_torch.native import hclust_average_native
    from otter_tpu_torch.ops.hclust import cutree_cdist
    from otter_tpu_torch.ops.hclust_device import to_r_convention

    out = None
    rs = np.random.default_rng(11)
    for n in (129, 1001):
        m = n * (n - 1) // 2
        cond = (rs.permutation(m) + 1.0) / (m + 1.0)  # distinct in f32
        sq = np.zeros((n, n), dtype=np.float32)
        sq[np.triu_indices(n, 1)] = cond
        sq += sq.T
        D = torch.from_numpy(sq)[None].to(dev)
        recs, hs = K11.linkage_cuda(D)
        plain_ms, (recs_p, hs_p) = time_once(lambda: K11.linkage_torch(D))
        same = bool(torch.equal(recs, recs_p)) and bool(torch.equal(
            hs.view(torch.int32), hs_p.view(torch.int32)))
        err = float((hs - hs_p).abs().max())
        merge, height = to_r_convention(recs[0].cpu().numpy(),
                                        hs[0].cpu().numpy(), n)
        mh, hh = hclust_average_native(cond, n)
        cuts = []
        for q in (0.25, 0.5, 0.75):  # the widest gap near each quantile
            lo = int(q * (n - 2))
            win = range(max(0, lo - 8), min(n - 2, lo + 8))
            g = max(win, key=lambda k: hh[k + 1] - hh[k])
            cuts.append((hh[g] + hh[g + 1]) / 2)
        parts = all(_canon(cutree_cdist(n, merge, height, c)) ==
                    _canon(cutree_cdist(n, mh, hh, c)) for c in cuts)
        check(same and parts, f"K11 at n = {n}: kernel == plain {same}, "
              f"partitions equal to the native NN-chain's {parts}")
        ms = time_ms(lambda: K11.linkage_cuda(D), 5)
        route, cluster, smem = K11.linkage_plan(n)
        # the one-block kernel with D in device memory: the same bits, and
        # its time
        recs_l2, hs_l2 = K11.linkage_cuda(D, route="l2")
        same_l2 = bool(torch.equal(recs, recs_l2)) and bool(torch.equal(
            hs.view(torch.int32), hs_l2.view(torch.int32)))
        check(same_l2, f"K11 at n = {n}: the {route} route differs from "
              "the L2 route")
        l2_ms = time_ms(lambda: K11.linkage_cuda(D, route="l2"), 5)
        # operations: per step the pair's pass over the active rows and the
        # merged row (mul, fma, div a column); bytes: D's upper triangle
        # once (D is symmetric, so the function needs no more of it), the
        # records
        steps = n - 1
        ops = sum(4 * (n - k) for k in range(steps))
        t_ops = ops / (F32_LANES * CARD["sm_hz"]) * 1e3
        t_bytes = (2 * n * (n - 1) + 12 * steps) / HBM_BYTES_PER_S * 1e3
        b, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                                "bytes")
        shown = [round(float(c), 6) for c in cuts]
        log(f"K11 linkage, n = {n} ({steps} dependent steps; route "
            f"{route}, {cluster} block(s) of {smem} B of shared memory): "
            f"kernel == plain {same}, max |diff| {err} (tolerance 0), == "
            f"the L2 route {same_l2}; partitions equal to the native "
            f"NN-chain's at cuts {shown}: {parts}; kernel {ms:.4f} ms "
            f"({1e3 * ms / steps:.3f} us a step), the L2 route (D in "
            f"device memory) {l2_ms:.4f} ms ({1e3 * l2_ms / steps:.3f} us "
            f"a step), plain {plain_ms:.1f} ms; bound {b:.5f} ms by {by}, "
            f"{100 * b / ms:.4f}% of it; library call: none")
        out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b, "bound_by": by, "library_ms": None}
    return out


def kernel_k12(graphs: dict) -> dict:
    """K12 against its plain version on the card on the graphs the
    hifi-tr-1.5k and refscale runs gave it: h bit for bit, min_eid equal;
    times and bound. Returns the fields of hifi-tr-1.5k's batch."""
    import torch

    from otter_tpu_torch.kernels import poa_heaviest as K12

    out = None
    for name, batch in graphs.items():
        h, me = K12.poa_heaviest_cuda(batch)
        plain_ms, (h_p, me_p) = time_once(
            lambda: K12.poa_heaviest_torch(batch))
        same = bool(torch.equal(h.view(torch.int32), h_p.view(torch.int32))
                    and torch.equal(me, me_p))
        err = float(max((h - h_p).abs().max(), (me - me_p).abs().max()))
        check(same, f"K12 disagrees with its plain version ({name})")
        ms = time_ms(lambda: K12.poa_heaviest_cuda(batch), 5)
        route = "stream" if K12.stream_fits(batch) else "global"
        # the device-memory kernel, a warp a graph level by level: the
        # same bits
        h_g, me_g = K12.poa_heaviest_cuda(batch, route="global")
        same_g = bool(torch.equal(h.view(torch.int32),
                                  h_g.view(torch.int32))
                      and torch.equal(me, me_g))
        check(same_g, f"K12 ({name}): the {route} route differs from the "
              "global route")
        global_ms = time_ms(
            lambda: K12.poa_heaviest_cuda(batch, route="global"), 5)
        n_edges = int(batch.e_rec.shape[0])
        # the node order, in-edge bounds, edge records and graph table in,
        # h and min_eid out (the level bounds only the walk by levels needs)
        moved = (nbytes(batch.node_of, batch.in_ptr, batch.e_rec, batch.meta)
                 + 8 * batch.node_of.shape[0])
        t_ops = 2 * n_edges / (F32_LANES * CARD["sm_hz"]) * 1e3
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        b, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                                "bytes")
        levels = batch.max_depth + 1
        log(f"K12 poa_heaviest, {name} ({batch.meta.shape[0]} graphs, "
            f"{batch.node_of.shape[0]} nodes, {n_edges} edges, up to "
            f"{levels} levels and {batch.max_nodes} nodes a graph, the "
            f"longest chain of dependent steps; route {route}): kernel == "
            f"plain {same}, max |diff| {err} (tolerance 0), == the global "
            f"route {same_g}; kernel {ms:.4f} ms ({1e3 * ms / levels:.3f} "
            f"us a level), the global route (a warp a graph, level by "
            f"level) {global_ms:.4f} ms ({1e3 * global_ms / levels:.3f} us "
            f"a level), plain {plain_ms:.1f} ms; bound {b:.5f} ms by {by}, "
            f"{100 * b / ms:.4f}% of it; library call: none")
        if out is None:
            out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b, "bound_by": by, "library_ms": None}
    return out


def phase_device_paths(tmp: str, dev, fixtures: list, runs: dict, g64: dict,
                       g500: dict):
    """Phase 9: the JAX package's opt-in device paths (K10 k-mer counts,
    K11 average linkage, K12 the POA heaviest-path DP) end to end, then
    each kernel exact against its plain version on the inputs those runs
    gave it, timed. Returns (launches, timings) by kernel name."""
    log("== phase 9: the opt-in device paths")
    t0 = time.perf_counter()
    launches, batches, graphs = opt_in_entry_points(tmp, fixtures, runs,
                                                    g64, g500, dev)
    log(f"opt-in kernel launches on their paths: {json.dumps(launches)}")
    timings = {"kmer_counts": kernel_k10(batches),
               "linkage": kernel_k11(dev),
               "poa_heaviest": kernel_k12(graphs)}
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    return launches, timings


# ---------------------------------------------------------------------------
# Phase 10: the sharded forward step (K7, K14), K13, the fused collect and
# the consensus settings
# ---------------------------------------------------------------------------


def step_wrappers() -> dict:
    """K13 and K14 by name: the wrappers whose ``launches`` count them."""
    from otter_tpu_torch.kernels import kde_pairs, kde_scaled

    return {"kde_tree": kde_scaled.kde_tree_cuda,
            "kde_pairs": kde_pairs.kde_pairs_cuda}


def regions_leg_batch(rs, n_regions: int = 128, cov: int = 12):
    """The all-vs-all pairs of the JAX bench's regions leg
    (``build_fixture(n_regions=128, cov=12)``, bench.py:180-188) as one
    step batch: an even region's two alleles of cov / 2 + 2 reads give
    C(16, 2) = 120 pairs, an odd region's cov reads C(12, 2) = 66; each
    pair a 120-200 bp sequence against a copy at 3% error, the regions
    interleaved; packed at k = 63 as the step takes them."""
    from otter_tpu_torch.kernels.edit_banded import pack_bucket

    per = [(cov // 2 + 2) * 2 if r % 2 == 0 else cov for r in
           range(n_regions)]
    per = [c * (c - 1) // 2 for c in per]
    pairs, rid = [], []
    for j in range(max(per)):
        for r in range(n_regions):
            if j < per[r]:
                base = rand_acgt(rs, int(rs.integers(120, 201)))
                pairs.append((base, mutate(rs, base, 0.03)))
                rid.append(r)
    a, bp, mn, L = pack_bucket(pairs, 63)
    region_id = np.zeros(a.shape[0], dtype=np.int32)
    region_id[: len(rid)] = rid
    valid = np.zeros(a.shape[0], dtype=bool)
    valid[: len(rid)] = True
    bw = np.full(n_regions, 0.01, dtype=np.float32)
    return a, bp, mn, region_id, valid, bw, 63, L


def sharded_steps(dev, rs) -> dict:
    """The sharded forward step (K7 a shard, then K14 on the first card)
    on the mesh of every visible card and on two shards of card 0, at the
    JAX dry run's shapes and at the regions leg's (11,904 pairs, 128
    regions): distances equal to K7's plain version on every row,
    densities bit-identical across the meshes and within a relative 1e-6
    (1e-30 absolute) of K14's plain version. Returns the regions leg's
    inputs on the card, for K14's timing."""
    import torch

    from otter_tpu_torch.kernels.edit_banded import edit_banded_torch
    from otter_tpu_torch.kernels.kde_pairs import (kde_pairs_torch,
                                                   linspace_grid)
    from otter_tpu_torch.parallel.dryrun import example_pair_batch
    from otter_tpu_torch.parallel.mesh import (make_mesh,
                                               run_sharded_region_step)

    meshes = {"every card": make_mesh(), "two shards of card 0": (dev, dev)}
    a, bp, mn, rid, valid, k, L = example_pair_batch(n_pairs=32)
    sets = {"dry-run shapes": (a, bp, mn, rid, valid,
                               np.full(2, 0.01, dtype=np.float32), k, L),
            "regions leg": regions_leg_batch(rs)}
    for name, (a, bp, mn, rid, valid, bw, k, L) in sets.items():
        got = {}
        for mname, mesh in meshes.items():
            t0 = time.perf_counter()
            d, dens = run_sharded_region_step(
                mesh, a, bp, mn[:, 0], mn[:, 1], rid, valid, bw, k=k,
                max_rows=L, n_regions=len(bw))
            torch.cuda.synchronize()
            got[mname] = (d, dens, time.perf_counter() - t0)
        d, dens, _wall = got["every card"]
        plain_d = edit_banded_torch(*(torch.from_numpy(x).to(dev)
                                      for x in (a, bp, mn)), k)
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
            mn[:, 0], mn[:, 1], rid, valid, bw, linspace_grid(401))]
        plain = kde_pairs_torch(plain_d, *args)
        same = all(torch.equal(g[0], d) and torch.equal(g[1], dens)
                   for g in got.values())
        diff = (dens - plain).abs()
        ok = bool((diff <= 1e-6 * plain.abs() + 1e-30).all())
        rel = float((diff / plain.abs().clamp(min=1e-30)).max())
        log(f"step, {name}: {int(valid.sum())} pairs, {len(bw)} regions, "
            f"{a.shape[0]} rows, L {L}; distances equal to K7's plain "
            f"version {torch.equal(d, plain_d)}, "
            f"{int((d == 1 << 24).sum())} INF; densities bit-identical on "
            f"the two meshes {same}, against K14's plain version max rel "
            f"{rel:.3g} (tolerance 1e-6), {int((dens != plain).sum())} of "
            f"{dens.numel()} cells not bit-equal; walls " + ", ".join(
                f"{m} {g[2]:.3f} s" for m, g in got.items()))
        check(torch.equal(d, plain_d) and same and ok,
              f"the sharded step on the {name} set disagrees")
    return sets["regions leg"]


def hifi_pair_inputs(rs, dev, n_pairs: int = 160429, n_regions: int = 32):
    """K14's inputs at hifi-tr-1.5k's pair count over its 32 regions: 1.5
    and 1.8 kb lengths, two thirds of the distances near 0.4% of the
    longer side and a third near 17%, region p % 32."""
    import torch

    m = rs.integers(1500, 1800, n_pairs).astype(np.int32)
    n = (m + rs.integers(-10, 11, n_pairs)).astype(np.int32)
    frac = np.where(rs.random(n_pairs) < 2 / 3,
                    rs.normal(0.004, 0.0015, n_pairs),
                    rs.normal(0.17, 0.01, n_pairs)).clip(0, 1)
    d = (frac * np.maximum(m, n)).astype(np.int32)
    rid = (np.arange(n_pairs) % n_regions).astype(np.int32)
    valid = np.ones(n_pairs, dtype=bool)
    bw = np.full(n_regions, 0.015, dtype=np.float32)
    return [torch.from_numpy(x).to(dev) for x in (d, m, n, rid, valid, bw)]


def kernel_k14(dev, leg, rs) -> dict:
    """K14 against its plain version on the card, timed with its bound, on
    the regions leg's batch (its K7 distances) and at hifi-tr-1.5k's
    160,429 pairs over 32 regions; the grouping (``group_pairs``) and the
    grouping + kernel timed too. Returns the first set's JSON fields."""
    import torch

    from otter_tpu_torch.kernels import kde_pairs as K14
    from otter_tpu_torch.kernels.edit_banded import edit_banded

    a, bp, mn, rid, valid, bw, k, _L = leg
    d = edit_banded(*(torch.from_numpy(x).to(dev) for x in (a, bp, mn)), k)
    sets = {"regions leg (128 regions)": [d] + [
        torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        for x in (mn[:, 0], mn[:, 1], rid, valid, bw)],
        "hifi-tr-1.5k pairs (32 regions)": hifi_pair_inputs(rs, dev)}
    xs = torch.from_numpy(K14.linspace_grid(401)).to(dev)
    out = None
    for name, args in sets.items():
        args = args + [xs]
        grouped = K14.group_pairs(args[3], args[4], args[5].shape[0])
        got = K14.kde_pairs_cuda(*args, grouped=grouped)
        plain_ms, plain = time_once(lambda: K14.kde_pairs_torch(*args))
        diff = (got - plain).abs()
        ok = bool((diff <= 1e-6 * plain.abs() + 1e-30).all())
        rel = float((diff / plain.abs().clamp(min=1e-30)).max())
        check(ok, f"K14 disagrees with its plain version on the {name} set "
              f"(max rel {rel:.3g})")
        ms = time_ms(lambda: K14.kde_pairs_cuda(*args, grouped=grouped), 5)
        group_ms = time_ms(lambda: K14.group_pairs(args[3], args[4],
                                                   args[5].shape[0]), 5)
        step_ms = time_ms(lambda: K14.kde_pairs_cuda(*args), 5)
        pairs = int(args[4].sum())
        evals = float(pairs * xs.numel())
        moved = nbytes(*args) + 4 * got.numel()
        bound_ms, bound_by = kde_bound(evals, moved, KDE_TERM_F32_OPS)
        sizes = grouped[1][1:] - grouped[1][:-1]
        log(f"K14 kde_pairs, {name}: {pairs} pairs x {xs.numel()} grid "
            f"points, {int(sizes.max())} pairs in the largest region, "
            f"{int(((sizes + K14.CHUNK - 1) // K14.CHUNK).clamp(min=1).sum())}"
            f" chunks of {K14.CHUNK}; max rel diff {rel:.3g} (tolerance "
            f"1e-6, 1e-30 absolute), {int((got != plain).sum())} of "
            f"{got.numel()} cells not bit-equal; kernel {ms:.4f} ms "
            f"(grouping excluded), grouping (group_pairs) {group_ms:.4f} ms, "
            f"grouping + kernel {step_ms:.4f} ms, plain {plain_ms:.3f} ms "
            f"({evals / ms / 1e9:.2f} G evaluations/s kernel); bound "
            f"{bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / ms:.2f}% of "
            f"it; library call: none")
        if out is None:
            out = {"max_abs_err": float(diff.max()), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
    return out


def kernel_k13(dev, rs) -> tuple:
    """K13 through the port's ``kde_tree`` (the JAX ``kde_tree_step``) on
    K8's three sets (its only path: the JAX function has no caller),
    launches counted; then against its plain version on the card (a
    relative 1e-6 a cell, 1e-30 absolute; the cells not bit-equal counted)
    and timed with its bound. Returns (launches, the first set's JSON
    fields)."""
    import torch

    from otter_tpu_torch.kernels import kde_scaled as K8
    from otter_tpu_torch.ops.kde import kde_grid

    xs = torch.from_numpy(kde_grid(0.0025).astype(np.float32)).to(dev)
    G = xs.shape[0]
    sets = []
    for name, R, n in KDE_SETS:
        n_pad = 1 << (n - 1).bit_length()
        V = np.zeros((R, n_pad), dtype=np.float32)
        V[:, :n] = kde_values(rs, R, n)
        bw = np.where(np.arange(R) % 2, 0.015, 0.01).astype(np.float32)
        sets.append((name, R, n, [torch.from_numpy(x).to(dev) for x in (
            V, np.full(R, n, dtype=np.int32), bw)] + [xs]))
    K8.kde_tree_cuda.launches = 0
    path = [K8.kde_tree(*args, n_max=n) for _name, _R, n, args in sets]
    torch.cuda.synchronize()
    launches = K8.kde_tree_cuda.launches
    out = None
    for (name, R, n, args), got in zip(sets, path):
        plain_ms, plain = time_once(lambda: K8.kde_tree_torch(*args))
        diff = (got - plain).abs()
        ok = bool((diff <= 1e-6 * plain.abs() + 1e-30).all())
        rel = float((diff / plain.abs().clamp(min=1e-30)).max())
        check(ok and torch.isfinite(got).all(), f"K13 disagrees with its "
              f"plain version on the {name} set (max rel {rel:.3g})")
        ms = time_ms(lambda: K8.kde_tree_cuda(*args, n_max=n), 5)
        evals = float(R * n * G)
        moved = 4 * R * n + nbytes(*args[1:]) + 4 * R * G
        bound_ms, bound_by = kde_bound(evals, moved, KDE_TERM_F32_OPS)
        log(f"K13 kde_tree, {name} ({R} regions x {n} values, G {G}): max "
            f"rel diff {rel:.3g} (tolerance 1e-6, 1e-30 absolute), "
            f"{int((got != plain).sum())} of {R * G} cells not bit-equal; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
            f"({evals / ms / 1e9:.2f} G evaluations/s kernel); bound "
            f"{bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / ms:.2f}% "
            "of it; library call: none")
        if out is None:
            out = {"max_abs_err": float(diff.max()), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
    return launches, out


def setting_runs(name: str, bam: str, bed: str, want: str, runs) -> None:
    """``name`` on the card under each (label, settings) of ``runs``, in
    order: each output ``want`` (phase 5's) byte for byte, its wall, the
    kernel launches and the KDE and consensus phase seconds."""
    import torch

    from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
    from otter_tpu_torch.utils import metrics

    for label, env in runs:
        wrappers = cuda_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        metrics.reset()
        os.environ.update(env)
        t0 = time.perf_counter()
        try:
            text = run(bam, bed, TorchDistBackend("cuda"))
            torch.cuda.synchronize()
        finally:
            for key in env:
                os.environ.pop(key, None)
        wall = time.perf_counter() - t0
        snap = metrics.snapshot()
        launched = {k: fn.launches for k, fn in wrappers.items()
                    if fn.launches}
        phases = {k: round(snap.get(f"time.{k}", 0.0), 4) for k in (
            "device_dispatch", "kde_device", "kde_certify", "consensus_hints",
            "consensus_affine")}
        log(f"{name}, {label}: wall {wall:.3f} s, identical to phase 5: "
            f"{text == want}; launches {json.dumps(launched)}; KDE regions "
            f"{int(snap.get('count.kde_device_regions', 0))}; phase seconds "
            f"{json.dumps(phases)}")
        check(text == want, f"{name}, {label}: output differs from phase 5's")
        check(launched.get("kde_scaled", 0) > 0 or "FUSED" not in label,
              f"{name}, {label}: K8 did not launch")
        check(launched.get("affine_tb", 0) == 0
              or "AFFINE_DEVICE=0" not in label,
              f"{name}, {label}: K5 launched")


def phase_region_step(tmp: str, dev, fixtures: list, runs: dict) -> tuple:
    """Phase 10: the sharded forward step and the dry run on the card
    (K14's launches counted over them), K14 and K13 against their plain
    versions and timed, then hifi-tr-1.5k and the refscale region with the
    fused collect on and off in turns, and hifi-tr-1.5k under the consensus
    settings. Returns (launches, timings) by kernel name."""
    import torch

    from otter_tpu_torch.parallel.dryrun import dryrun_multichip

    log("== phase 10: the sharded forward step, K13, K14, the fused collect")
    t0 = time.perf_counter()
    rs = np.random.default_rng(10)
    for fn in step_wrappers().values():
        fn.launches = 0
    leg = sharded_steps(dev, rs)
    for n, devices in ((torch.cuda.device_count(), None), (2, (dev, dev))):
        t1 = time.perf_counter()
        out = dryrun_multichip(n, devices)
        log(f"dryrun_multichip({n}, {out['devices']}) passed in "
            f"{time.perf_counter() - t1:.1f} s")
    launches = {"kde_pairs": step_wrappers()["kde_pairs"].launches}
    check(launches["kde_pairs"] > 0, "K14 did not launch in the step")
    log(f"-- step and dry runs done, {time.perf_counter() - t0:.1f} s into "
        "phase 10")
    timings = {"kde_pairs": kernel_k14(dev, leg, rs)}
    launches["kde_tree"], timings["kde_tree"] = kernel_k13(dev, rs)
    check(launches["kde_tree"] > 0, "K13 did not launch")
    log(f"-- K13 and K14 done, {time.perf_counter() - t0:.1f} s into phase 10")
    fused = [("OTTER_TPU_FUSED_KDE=1", {"OTTER_TPU_FUSED_KDE": "1"}),
             ("OTTER_TPU_FUSED_KDE=0", {"OTTER_TPU_FUSED_KDE": "0"})]
    for i in (0, 3):  # hifi-tr-1.5k, the refscale region
        setting_runs(CELLS[i][0], *fixtures[i], runs[CELLS[i][0]][1],
                     fused + fused[::-1])
    setting_runs("cell hifi-tr-1.5k", *fixtures[0],
                 runs["cell hifi-tr-1.5k"][1], [
                     ("OTTER_TPU_AFFINE_DEVICE=0",
                      {"OTTER_TPU_AFFINE_DEVICE": "0"}),
                     ("OTTER_TPU_AFFINE_HINTS=0",
                      {"OTTER_TPU_AFFINE_HINTS": "0"}),
                     ("OTTER_TPU_AFFINE_HINTS=1",
                      {"OTTER_TPU_AFFINE_HINTS": "1"}),
                     ("default", {})])
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    return launches, timings


# ---------------------------------------------------------------------------
# Phase 11: the benches, the profiler and the demo
# ---------------------------------------------------------------------------

# what phase 11 cuts from ``python -m otter_tpu_torch.bench``'s defaults
BENCH_CUTS = ("one timed rep a leg (the bench: kernel 6, regions 3, genotype "
              "3, genotype64 5, genotype500 3, refscale 4, ONT 3, device 3); "
              "kernel leg's one-core native rate 1 rep (5); refscale leg 1 "
              "region (2) and no native wall (phase 5 holds that region "
              "byte-identical to NativeDistBackend)")


def bench_ratios(fields: dict, native_wall: float) -> None:
    """The bench's two ratios, each with its live value, its pin and the
    value the rule uses: ``vs_baseline`` by the larger one-core rate,
    ``refscale_vs_native`` by the smaller native wall of a region
    (``native_wall``, the host engine's live wall of phase 11's refscale
    region, measured in phase 5's side process). The kernel leg must have
    read its pin from the checkout's ``baselines.json``."""
    from otter_tpu_torch.bench import calibrate, legs

    live = fields["cpu_1core_cells_per_sec"]
    pin = fields["cpu_1core_pinned"]
    used = fields["cpu_1core_denominator"]
    scale = fields["value"] / legs.REFERENCE_THREADS
    log(f"vs_baseline: live one-core {live} cells/s -> {scale / live:.3f}; "
        f"pinned {pin} -> "
        f"{'none' if pin is None else format(scale / pin, '.3f')}; used "
        f"{used} (the larger) -> {fields['vs_baseline']}")
    check(pin is not None and used == max(live, pin),
          "kernel leg: no pinned one-core rate read, or not the larger")
    per_region = fields["refscale_region_sec_median"]
    claim, wall_pin = calibrate.native_region_claim(
        native_wall, fields["refscale_cov"], fields["refscale_allele_bp"])
    by_pin = ("none" if wall_pin is None
              else format(wall_pin / per_region, ".2f"))
    log(f"refscale_vs_native: live native region {native_wall:.2f} s "
        f"(phase 5's host engine, beside phase 3) -> "
        f"{native_wall / per_region:.2f}; pinned {wall_pin} s -> {by_pin}; "
        f"used {claim:.2f} s (the smaller) -> {claim / per_region:.2f}, "
        f"over a card region of {per_region} s")


def phase_benches(tmp: str, native_wall: float) -> dict:
    """The bench's legs (``otter_tpu_torch/bench/legs.py``) in process at
    the JAX bench's sizes with the cuts of ``BENCH_CUTS``, then the
    profiler and the demo; every kernel's launch count set to 0 before each
    and read after it; every parity flag must be true; then the two ratios
    (``bench_ratios``). Returns the legs' fields."""
    import torch

    from otter_tpu_torch import demo
    from otter_tpu_torch.bench import legs, profile
    from otter_tpu_torch.bench.__main__ import failed_flags

    log("== phase 11: the benches, the profiler and the demo")
    log(f"phase 11 cuts: {BENCH_CUTS}")
    t0 = time.perf_counter()
    runs = (
        ("kernel", lambda: legs.bench_kernel(65536, reps=1, cpu_reps=1)),
        ("regions", lambda: legs.bench_regions(128, reps=1,
                                               genotype_reps=1)),
        ("cohort", lambda: legs.bench_cohort(reps64=1, reps500=1)),
        ("refscale", lambda: legs.bench_refscale_leg(n_regions=1, reps=1,
                                                     native=False)),
        ("ont", lambda: legs.bench_ont_leg(reps=1)),
        ("device", lambda: legs.bench_device_kernels(reps=1)),
        ("profile", lambda: profile.profile(96)),
        ("demo", lambda: demo.main(os.path.join(tmp, "demo"))),
    )
    wrappers = all_wrappers()
    fields: dict = {}
    for name, fn in runs:
        for w in wrappers.values():
            w.launches = 0
        t1 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launched = {k: w.launches for k, w in wrappers.items() if w.launches}
        log(f"{name}: {wall:.1f} s; kernel launches {json.dumps(launched)}")
        if name == "profile":
            log(got.pop("summary"))
            log(f"profile: {json.dumps(got)}")
        elif name != "demo":
            log(f"{name}: {json.dumps(got)}")
            fields.update(got)
        if name == "kernel":
            check(launched.get("myers_pool", 0) > 0,
                  "kernel leg: K1 did not launch")
        if name == "device":
            check(launched.get("affine_tb", 0)
                  + launched.get("affine_tb_ckpt", 0) > 0,
                  "device leg: neither K5 nor K6 launched")
    bad = failed_flags(fields)
    log(f"bench legs: {json.dumps(fields)}")
    check(not bad, f"bench parity flags not true: {bad}")
    bench_ratios(fields, native_wall)
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    return fields


def phase_profile(tmp: str) -> None:
    """Cell hifi-tr-1.5k three times untraced, then once under
    torch.profiler: wall, device busy time (the union of kernel and copy
    intervals) and its share of the wall, device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from otter_tpu_torch.kernels.dist_backend import TorchDistBackend
    from otter_tpu_torch.utils.synth import tandem_repeat_loci

    log("== profile: cell hifi-tr-1.5k under torch.profiler")
    bam, bed = tandem_repeat_loci(tmp, n_regions=32, cov=100, err=0.002,
                                  expansion=100, region_len=1500, seed=77,
                                  name="smoke")

    def once() -> float:
        t0 = time.perf_counter()
        run(bam, bed, TorchDistBackend("cuda"))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for r in range(3):
        log(f"untraced run {r + 1}: wall {once():.3f} s")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = once()
    spans, per = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        n, us = per.get(e.name, (0, 0.0))
        per[e.name] = (n + 1, us + (t1 - t0))
    busy, reach = 0.0, None
    for t0, t1 in sorted(spans):
        if reach is None or t0 > reach:
            busy += t1 - t0
            reach = t1
        elif t1 > reach:
            busy += t1 - reach
            reach = t1
    log(f"traced run: wall {wall:.3f} s, device busy {busy / 1e6:.4f} s, "
        f"busy share {100 * busy / 1e6 / wall:.2f}%")
    for name, (n, us) in sorted(per.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"  {us / 1e3:.3f} ms in {n} launches: {name[:100]}")


def main() -> int:
    if sys.argv[1:2] == ["--host-oracle"]:
        return host_oracle_main(sys.argv[2:])
    if sys.argv[1:2] == ["--dist-worker"]:
        return dist_worker_main(sys.argv[2:])
    import torch

    t_start = time.perf_counter()

    def done(what: str) -> None:
        log(f"-- {what} done at {time.perf_counter() - t_start:.1f} s")

    phase_environment()
    dev = torch.device("cuda", 0)
    phase_build()
    done("phase 2")
    if "--profile" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as tmp:
            phase_profile(tmp)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        fixtures = cell_fixtures(tmp)
        oracle = start_host_oracle(tmp, fixtures)
        try:
            timings = phase_kernels(dev)
            done("phase 3")
            small = phase_small(tmp)
            done("phase 4")
            launches, runs = phase_full(tmp, fixtures, oracle)
            cell, hifi_text, _wall = runs["cell hifi-tr-1.5k"]
            done("phase 5")
            k2_small_launch(dev, cell["jobs_k2"])
            done("K2 at the cell's launch shape")
            g64, g500, cmp = phase_entry_points(tmp, small)
            done("phase 6")
            phase_pools_processes(tmp, fixtures[0], hifi_text, g64)
            done("phase 7")
            launches.update(phase_mesh(dev, fixtures, runs, g64, cmp))
            done("phase 8")
            opt_launches, opt_timings = phase_device_paths(
                tmp, dev, fixtures, runs, g64, g500)
            launches.update(opt_launches)
            timings.update(opt_timings)
            done("phase 9")
            step_launches, step_timings = phase_region_step(tmp, dev,
                                                            fixtures, runs)
            launches.update(step_launches)
            timings.update(step_timings)
            done("phase 10")
            # phase 11's refscale leg is phase 5's refscale cell, 1 region
            phase_benches(tmp, host_oracle_result(oracle, tmp, 3)[1])
            done("phase 11")
        finally:
            if oracle.poll() is None:
                oracle.kill()
            oracle.wait()
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name], **timings[name]}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
