"""``otter assemble`` on the PyTorch engine (parity with src/assemble.cpp).

Counterpart of ``otter_tpu/models/assemble.py``'s batched pipeline. Pipeline
per region (assemble.cpp:39-158): offsets -> parse_anreads -> skip
over-covered -> optional local realignment -> --reads-only early-out ->
valid/invalid partition (haplotag fallback) -> distance matrix ->
otter_hclust -> invalid reassignment -> consensus -> allele emission with
the ic tag.

Regions are prepared on the host; every region's all-vs-all pair workload
(and its reassignment pairs and ends-free jobs) goes to the distance engine
in one launch per batch, and the batch's consensus cigars go to the affine
traceback kernel in one launch. The batch's per-region KDE goes to kernel
K8 on the card once it is large (``_use_device_kde``), and every region's
clustering decisions are certified against the float64 KDE, which
recomputes any region they do not hold for; hclust is float64 host math.
So output is byte-identical to the JAX package's ``--device host`` path
(emission stays in region order).

With ``-t`` > 1 and ``OTTER_TPU_FINISH_POOL=1`` the host half of each
region (hclust, reassignment, consensus) goes to spawned worker processes
(``_finish_worker.py``) that touch no card; the distances, the reassignment
jobs and the device KDE stay with this process's engine. Under a coordinator
(``parallel/distributed.py``) each process handles its block of regions.

``device="host"`` is the JAX package's pure-host exact mode: no engine, no
pool, no process sharding; each region in BED order through
``assemble_region`` (the python read extractor, the numpy pair DP, the
float64 KDE, the host reassignment DP, the native affine ladder and the
python POA). It shares none of the batched pipeline and is its oracle.
"""

from __future__ import annotations

import io
import os
import sys

import numpy as np
from dataclasses import dataclass
from typing import List, Optional, TextIO

from ..config import OtterOpts
from ..io.bam import BamReader
from ..io.bed import BED, parse_bed_file
from ..io.fasta import Faidx
from ..ops.cluster import ClusteringStatus, otter_hclust
from ..ops.consensus import (
    fill_dist_matrix,
    invalid_reassignment,
    local_realignment,
)
from ..ops.distmat import DistMatrix
from ..seqs.extract import parse_anreads
from ..seqs.model import AnAllele, AnRead
from ..utils import metrics
from ..utils.timestamp import antimestamp
from ..kernels.dist_backend import TorchDistBackend
from ..kernels.edit_engine import IndexedPairs

DEVICES = ("cuda", "cpu", "mesh", "host")

DEFAULT_REGION_BATCH = int(os.environ.get("OTTER_TPU_REGION_BATCH", "256"))


def count_spanning_reads(anread_block: List[AnRead]) -> int:
    return sum(1 for r in anread_block if r.is_spanning())


def partition_valid_reads(ignore_haps: bool, anread_block: List[AnRead]):
    """(assemble.cpp:27-37)"""
    valid: List[int] = []
    invalid: List[int] = []
    for i, read in enumerate(anread_block):
        if not read.is_spanning():
            invalid.append(i)
        else:
            if ignore_haps:
                valid.append(i)
            elif read.hpt.is_defined():
                valid.append(i)
            else:
                invalid.append(i)
    return valid, invalid


@dataclass
class RegionWork:
    """A region after host-side preparation, awaiting its distance matrix."""
    bed: BED
    reads: List[AnRead]
    ignore_haps: bool
    valid_indeces: List[int]
    invalid_indeces: List[int]


def prepare_region(params: OtterOpts, local_bed: BED, bam: BamReader,
                   faidx: Optional[Faidx], reads_only: bool,
                   out: TextIO) -> Optional[RegionWork]:
    """Host I/O + filters (assemble.cpp:51-122). Returns None when the
    region was fully handled (reads-only output, skips, warnings)."""
    mod_bed = BED(local_bed.chr, local_bed.start - params.offset_l,
                  local_bed.end + params.offset_r)
    if params.is_debug:
        sys.stderr.write(
            f"({antimestamp()}): [DEBUG] Processing {local_bed.to_sc_string()}\n")
    with metrics.phase("extract"):
        anread_block = parse_anreads(params, mod_bed, bam)
    if params.is_debug:
        sys.stderr.write(
            f"({antimestamp()}): [DEBUG] Loaded {len(anread_block)} reads\n")
    if len(anread_block) > params.max_cov:
        sys.stderr.write(
            f"({antimestamp()}): [WARNING] Skipping region with abnormal coverage: "
            f"{local_bed.to_sc_string()} ({len(anread_block)})\n")
        return None
    if faidx is not None:
        with metrics.phase("realign"):
            local_realignment(mod_bed.chr, mod_bed.start, mod_bed.end,
                              params.flank, params.min_sim, faidx,
                              anread_block)
        if params.is_debug:
            sys.stderr.write(
                f"({antimestamp()}): [DEBUG] Locally realigned "
                f"{len(anread_block)} reads\n")
    if reads_only:
        for read in anread_block:
            if params.is_fa:
                out.write(read.to_fa(local_bed.to_sc_string()) + "\n")
            else:
                out.write(read.to_sam(local_bed.chr, local_bed.start,
                                      local_bed.end, params.read_group) + "\n")
        return None

    spanning_reads = count_spanning_reads(anread_block)
    if spanning_reads == 0:
        sys.stderr.write(
            f"({antimestamp()}): [WARNING] No spanning reads for "
            f"{local_bed.to_sc_string()}\n")
        return None
    local_ignore_haps = params.ignore_haps
    valid_indeces, invalid_indeces = partition_valid_reads(local_ignore_haps,
                                                           anread_block)
    if len(valid_indeces) < 2:
        local_ignore_haps = True
        valid_indeces, invalid_indeces = partition_valid_reads(
            local_ignore_haps, anread_block)
        if spanning_reads != len(valid_indeces):
            sys.stderr.write(
                f"({antimestamp()}): [ERROR] Unexpected number of valid reads "
                f"after switching to 'ignore-haps' mode: {spanning_reads} vs "
                f"{len(valid_indeces)}\n")
            raise SystemExit(1)
    if not valid_indeces:
        sys.stderr.write(
            f"({antimestamp()}): [WARNING] No spanning reads for "
            f"{local_bed.to_sc_string()}\n")
        return None
    return RegionWork(local_bed, anread_block, local_ignore_haps,
                      valid_indeces, invalid_indeces)


def cluster_labels(params: OtterOpts, work: RegionWork,
                   distmatrix: DistMatrix, densities=None):
    """Hierarchical clustering into initial labels (assemble.cpp:128-133)."""
    clustmsg = ClusteringStatus()
    otter_hclust(work.ignore_haps, params.max_alleles, params.bandwidth_short,
                 params.bandwidth_length, params.bandwidth_long,
                 params.max_error, params.min_cov_fraction,
                 params.min_cov_fraction2_l, params.min_cov_fraction2_f,
                 work.valid_indeces, distmatrix, work.reads, clustmsg,
                 densities=densities)
    labels = [-1] * len(work.reads)
    for i in range(len(clustmsg.labels)):
        labels[work.valid_indeces[i]] = clustmsg.labels[i]
    return clustmsg, labels


def cluster_finish(params: OtterOpts, work: RegionWork,
                   distmatrix: DistMatrix, clustmsg, labels, pre):
    """Reassignment (with precomputed distances) + consensus preparation
    (assemble.cpp:134-141)."""
    from ..ops.consensus import consensus_prepare

    if work.invalid_indeces:
        invalid_reassignment(work.ignore_haps, params.min_sim, params.max_error,
                             clustmsg.fc, work.reads, labels, precomputed=pre)
    alleles = [AnAllele() for _ in range(clustmsg.fc)]
    tasks = consensus_prepare(work.ignore_haps, work.reads, labels,
                              work.valid_indeces, clustmsg.fc, distmatrix,
                              alleles)
    return alleles, tasks


def emit_region(params: OtterOpts, work: RegionWork, clustmsg, alleles,
                out: TextIO) -> None:
    """Allele emission with the ic tag (assemble.cpp:143-149)."""
    local_bed = work.bed
    for l in range(clustmsg.fc):
        alleles[l].ic = clustmsg.ic
        if params.is_fa:
            out.write(alleles[l].to_fa(
                params.read_group, local_bed.to_sc_string() + "#" + str(l)) + "\n")
        else:
            out.write(alleles[l].to_sam(
                local_bed.to_sc_string() + "_" + str(l), local_bed.chr,
                local_bed.start, local_bed.end, params.read_group) + "\n")


def cluster_region(params: OtterOpts, work: RegionWork,
                   distmatrix: DistMatrix):
    """Clustering + reassignment (its distances by the host DP) +
    consensus preparation (assemble.cpp:128-141). Returns (clustmsg,
    alleles, poa_tasks)."""
    from ..ops.consensus import reassignment_distances_batched

    clustmsg, labels = cluster_labels(params, work, distmatrix)
    pre = None
    if work.invalid_indeces:
        pre = reassignment_distances_batched(work.reads, labels)
    alleles, tasks = cluster_finish(params, work, distmatrix, clustmsg,
                                    labels, pre)
    return clustmsg, alleles, tasks


def finish_region(params: OtterOpts, work: RegionWork,
                  distmatrix: DistMatrix, out: TextIO) -> None:
    """Clustering -> reassignment -> consensus -> emission
    (assemble.cpp:128-149), on the host."""
    from ..ops.consensus import consensus_apply_batched

    clustmsg, alleles, tasks = cluster_region(params, work, distmatrix)
    consensus_apply_batched(tasks)
    emit_region(params, work, clustmsg, alleles, out)


def _region_pair_coords(n: int) -> np.ndarray:
    """(P, 2) condensed-order (i, j) coordinates for n valid reads — the
    exact row-major upper-triangle order of fill_dist_matrix
    (analignments.cpp:117-124), so a region's kernel results ARE its
    DistMatrix.values block."""
    from ..ops.distmat import triu_pair_indices

    iu, ju = triu_pair_indices(n)
    return np.column_stack([iu, ju]).astype(np.int64)


def _pair_workload(params: OtterOpts, batch: List[RegionWork]):
    """The batch's pair workload on the host: (spans, pairs, reassignment
    infos, ends-free jobs, index of the first reassignment pair). Spans are
    (work, condensed coordinates or None, index of the region's first
    pair)."""
    from ..ops.consensus import reassignment_jobs

    # unique sequence pool by object identity: a region's pair set shares
    # each read.seq object ~n/2 times
    seq_ids: dict = {}
    seq_pool: List[str] = []

    def _sid(s: str) -> int:
        v = seq_ids.get(id(s))
        if v is None:
            v = seq_ids[id(s)] = len(seq_pool)
            seq_pool.append(s)
        return v

    xi_parts: List[np.ndarray] = []
    yi_parts: List[np.ndarray] = []
    total = 0
    spans = []  # (work, coords, start_index)
    for work in batch:
        if params.max_alleles == 1 or not work.ignore_haps:
            spans.append((work, None, 0))
            continue
        vid = work.valid_indeces
        rs = np.fromiter((_sid(work.reads[v].seq) for v in vid),
                         np.int64, len(vid))
        coords = _region_pair_coords(len(vid))
        spans.append((work, coords, total))
        xi_parts.append(rs[coords[:, 0]])
        yi_parts.append(rs[coords[:, 1]])
        total += len(coords)
    reassign_infos: List = [None] * len(spans)
    pool_ef: list = []
    e2e_base = total
    for si, (work, _c, _s) in enumerate(spans):
        if not work.invalid_indeces:
            continue
        pseudo = [-1] * len(work.reads)
        for i in work.valid_indeces:
            pseudo[i] = 0
        pre, e2e_p, e2e_k, ef_j, ef_k, ef_n = reassignment_jobs(
            work.reads, pseudo)
        reassign_infos[si] = (pre, e2e_p, e2e_k, ef_j, ef_k, ef_n,
                              total, len(pool_ef))
        if e2e_p:
            xi_parts.append(np.fromiter((_sid(x) for x, _y in e2e_p),
                                        np.int64, len(e2e_p)))
            yi_parts.append(np.fromiter((_sid(y) for _x, y in e2e_p),
                                        np.int64, len(e2e_p)))
            total += len(e2e_p)
        pool_ef.extend(ef_j)
    xi = (np.concatenate(xi_parts) if xi_parts
          else np.zeros(0, dtype=np.int64))
    yi = (np.concatenate(yi_parts) if yi_parts
          else np.zeros(0, dtype=np.int64))
    return (spans, IndexedPairs(seq_pool, xi, yi), reassign_infos, pool_ef,
            e2e_base)


def _dispatch_batch(params: OtterOpts, batch: List[RegionWork],
                    dist_backend):
    """Pool every region's pair workload and launch it asynchronously;
    returns the staged handle ``_finish_batch`` takes.

    The reassignment workload rides the same launch: its (unassigned i,
    labeled spanning j) pair set depends only on the valid/invalid read
    partition, not on the cluster labels, so its End2End pairs join the
    pooled distance pairs and its ends-free jobs launch here too."""
    with metrics.phase("pair_prep"):
        (spans, all_pairs, reassign_infos, pool_ef,
         e2e_base) = _pair_workload(params, batch)
    eng = dist_backend.engine
    with metrics.phase("device_dispatch"):
        handle = (eng.distances_async_indexed(all_pairs.seqs, all_pairs.xi,
                                              all_pairs.yi)
                  if len(all_pairs) else None)
        ef_handle = eng.ends_free_async(pool_ef) if pool_ef else None
    metrics.add("pair_alignments", len(all_pairs) + len(pool_ef))
    return spans, all_pairs, handle, reassign_infos, ef_handle, e2e_base


# pooled KDE evaluations (values x grid cells) from which the kernel K8 pays
# for its launch and copy on the card
DEVICE_KDE_MIN_EVALS = 2_000_000


def _use_device_kde(engine, kde_regions) -> bool:
    """Route the batch's KDE to K8? OTTER_TPU_MESH_KDE=1 forces it (the
    plain version on a CPU engine), =0 keeps the host float64 KDE; by
    default an engine on the card (or on a mesh of cards) takes it once
    the pooled evaluation count reaches DEVICE_KDE_MIN_EVALS, as the JAX
    package routes."""
    env = os.environ.get("OTTER_TPU_MESH_KDE", "")
    if env in ("0", "1"):
        return env == "1"
    total_vals = sum(len(v) for _si, v, _b in kde_regions)
    return (getattr(engine, "mode", "") == "cuda"
            and total_vals * 401 >= DEVICE_KDE_MIN_EVALS)


def _device_kde(params: OtterOpts, engine, kde_regions,
                scaled=None) -> dict:
    """Span index -> float64 densities from K8 (``scaled``, the fused
    collect's (m, s) rows, or one pooled K8 dispatch here), every region
    certified against the float64 oracle's decisions (ops/kde.py::
    kde_decision_certified_scaled_batch); an uncertified region is
    recomputed by the float64 KDE, so clustering is byte-identical to the
    host path."""
    from ..ops.kde import (kde_decision_certified_scaled_batch,
                           kde_densities_batched, kde_grid)
    from ..parallel.mesh import pooled_kde_scaled

    values = [v for _si, v, _b in kde_regions]
    bws = [b for _si, _v, b in kde_regions]
    if scaled is None:
        devices = (getattr(engine, "mesh", None)
                   or getattr(engine, "device", None) or "cpu")
        with metrics.phase("device_dispatch"), metrics.phase("kde_device"):
            scaled = pooled_kde_scaled(values, bws, devices)
    region_dens: dict = {}
    fallback = []
    with metrics.phase("cluster_consensus"):
        radius = max(1, int(params.max_error / 0.0025))
        with metrics.phase("kde_certify"):
            certs = kde_decision_certified_scaled_batch(scaled, values, bws,
                                                        radius)
        for r, (ok, d64) in enumerate(certs):
            if ok:
                region_dens[kde_regions[r][0]] = d64
            else:
                fallback.append(r)
        if fallback:
            with metrics.phase("kde_f64_fallback"):
                f64 = kde_densities_batched([values[r] for r in fallback],
                                            [bws[r] for r in fallback],
                                            kde_grid(0.0025))
            for r, d in zip(fallback, f64):
                region_dens[kde_regions[r][0]] = d
    metrics.add("kde_device_regions", len(kde_regions) - len(fallback))
    metrics.add("kde_f64_fallback_regions", len(fallback))
    return region_dens


def _kde_rows(params: OtterOpts, spans) -> list:
    """(span index, bandwidth) of the batch's regions that otter_hclust
    takes to the KDE (more than two valid reads, more than one allele)."""
    rows = []
    for si, (work, _c, _s) in enumerate(spans):
        if params.max_alleles == 1 or len(work.valid_indeces) <= 2:
            continue
        bw = params.bandwidth_short
        for i in work.valid_indeces:
            if len(work.reads[i].seq) >= params.bandwidth_length:
                bw = params.bandwidth_long
                break
        rows.append((si, bw))
    return rows


# the fused collect's largest (rows, grid, n_pad) KDE slab, as in the JAX
# package
FUSED_KDE_MAX_EVALS = 1 << 27


def _fused_collect(engine, handle, spans, matrices, kde_rows, n_pairs):
    """With OTTER_TPU_FUSED_KDE=1 (and OTTER_TPU_MESH_KDE not 0), the
    distances and the batch's scaled KDE in one collect
    (``engine.distances_collect_kde``: K8 reads the K1 results where they
    lie, one device-to-host copy): (distances, m, s), or None when the
    setting is off, the KDE slab is past FUSED_KDE_MAX_EVALS, or a pair
    went to a ladder; the caller then takes the two-step route, which
    gives the same bytes. Pair p of a KDE region fills its row's slot in
    condensed order; the values of the regions without pairs (haplotag
    grids) are scattered in as host-known entries."""
    collect = getattr(engine, "distances_collect_kde", None)
    if (handle is None or not kde_rows or collect is None
            or os.environ.get("OTTER_TPU_MESH_KDE", "") == "0"
            or os.environ.get("OTTER_TPU_FUSED_KDE", "") != "1"):
        return None
    n_rows = len(kde_rows)
    rid = np.full(n_pairs, n_rows, dtype=np.int32)
    slot = np.zeros(n_pairs, dtype=np.int32)
    nvals = np.zeros(n_rows, dtype=np.int32)
    bwv = np.zeros(n_rows, dtype=np.float32)
    ex_entries = []
    n_pad = 8
    for r, (si, bw) in enumerate(kde_rows):
        _work, coords, start = spans[si]
        if coords is not None:
            nv = len(coords)
            rid[start : start + nv] = r
            slot[start : start + nv] = np.arange(nv, dtype=np.int32)
        else:
            vals = matrices[si].values
            nv = len(vals)
            ex_entries.extend((r, k, np.float32(v))
                              for k, v in enumerate(vals))
        nvals[r] = nv
        bwv[r] = bw
        while n_pad < nv:
            n_pad *= 2
    if n_rows * 401 * n_pad > FUSED_KDE_MAX_EVALS:
        return None
    return collect(handle, rid, slot, ex_entries, nvals, bwv, n_rows, n_pad)


def _precomputed(info, dists, ef_d, pair_maxlen):
    """A region's reassignment distances from the batch's launches
    (``_dispatch_batch``), or None when it has no unassigned reads."""
    if info is None:
        return None
    pre, e2e_p, e2e_k, ef_j, ef_k, ef_n, eo, fo = info
    for key, d, ml in zip(e2e_k, dists[eo : eo + len(e2e_p)],
                          pair_maxlen[eo : eo + len(e2e_p)]):
        pre[key] = d / ml
    for key, d, nrm in zip(ef_k, ef_d[fo : fo + len(ef_j)], ef_n):
        pre[key] = d / nrm
    return pre


def _finish_batch(params: OtterOpts, staged, dist_backend, out: TextIO,
                  pool=None) -> None:
    """Collect a ``_dispatch_batch`` handle and run the host half (KDE,
    cluster, reassignment, consensus, emission) for its regions in order;
    with the finish pool (``pool``) the workers run hclust, reassignment
    and consensus, region by region, on the host, with the distances, the
    reassignment distances and any device KDE computed here."""
    spans, all_pairs, handle, reassign_infos, ef_handle, e2e_base = staged
    from ..ops.consensus import consensus_apply_batched
    from ..ops.kde import kde_densities_batched, kde_grid

    engine = dist_backend.engine
    # non-pair spans (haplotag 0/1 grids, single-allele) fill on the host
    # first: the fused collect scatters their values into its KDE rows
    matrices: List = [None] * len(spans)
    for idx, (work, coords, start) in enumerate(spans):
        if coords is None:
            distmatrix = DistMatrix(len(work.valid_indeces))
            if params.max_alleles != 1:
                fill_dist_matrix(work.ignore_haps, work.reads,
                                 work.valid_indeces, distmatrix)
            matrices[idx] = distmatrix
    kde_rows = _kde_rows(params, spans)
    scaled = None
    with metrics.phase("device_dispatch"):
        fused = _fused_collect(engine, handle, spans, matrices, kde_rows,
                               len(all_pairs))
        if fused is not None:
            dists, kde_m, kde_s = fused
            scaled = [(kde_m[r], kde_s[r]) for r in range(len(kde_rows))]
        else:
            dists = engine.distances_collect(handle) \
                if handle is not None else []

    pair_maxlen = all_pairs.maxlens().astype(np.float64)
    dists_arr = np.asarray(dists, dtype=np.float64)
    for idx, (work, coords, start) in enumerate(spans):
        if coords is None:
            continue
        # coords are exactly condensed order (_region_pair_coords), so the
        # result block IS the DistMatrix.values vector
        distmatrix = DistMatrix(len(work.valid_indeces))
        nv = len(coords)
        with np.errstate(divide="ignore", invalid="ignore"):
            distmatrix.values = (dists_arr[start : start + nv]
                                 / pair_maxlen[start : start + nv])
        matrices[idx] = distmatrix

    # per-region KDE densities, pooled across the batch: K8's certified
    # rows (fused, or one dispatch once the batch is large), else the
    # float64 KDE (in the workers, with the finish pool)
    kde_regions = [(si, matrices[si].values, bw) for si, bw in kde_rows]
    region_dens: dict = {}
    if scaled is not None or (kde_regions
                              and _use_device_kde(engine, kde_regions)):
        region_dens = _device_kde(params, engine, kde_regions, scaled)
    elif kde_regions and pool is None:
        with metrics.phase("cluster_consensus"), metrics.phase("kde_f64"):
            dens_list = kde_densities_batched(
                [v for _si, v, _b in kde_regions],
                [b for _si, _v, b in kde_regions], kde_grid(0.0025))
        region_dens = {si: d
                       for (si, _v, _b), d in zip(kde_regions, dens_list)}

    if pool is not None:
        # the reference's -t semantics over worker processes, which never
        # touch the card: hclust (and the float64 KDE K8 did not give),
        # reassignment and the native affine ladder with the python POA
        # (_finish_worker.py)
        from ._finish_worker import finish_region_worker

        with metrics.phase("device_dispatch"):
            ef_d = (engine.ends_free_collect(ef_handle)
                    if ef_handle is not None else [])
        with metrics.phase("cluster_consensus"):
            results = pool.map(
                finish_region_worker,
                [(params, work, dm.values, region_dens.get(si),
                  _precomputed(reassign_infos[si], dists, ef_d, pair_maxlen))
                 for si, ((work, _c, _s), dm) in enumerate(
                     zip(spans, matrices))])
        with metrics.phase("emit"):
            for (work, _c, _s), (clustmsg, alleles) in zip(spans, results):
                emit_region(params, work, clustmsg, alleles, out)
        return

    # cluster every region; the reassignment distances rode the batch's
    # distance launch and its ends-free launch (_dispatch_batch)
    region_jobs = []
    for si, ((work, coords, start), distmatrix) in enumerate(
            zip(spans, matrices)):
        with metrics.phase("cluster_consensus"), \
                metrics.phase("cluster_labels"):
            clustmsg, labels = cluster_labels(params, work, distmatrix,
                                              densities=region_dens.get(si))
        region_jobs.append((work, distmatrix, clustmsg, labels,
                            reassign_infos[si]))
    with metrics.phase("device_dispatch"):
        ef_d = (engine.ends_free_collect(ef_handle)
                if ef_handle is not None else [])

    staged_regions = []
    all_tasks = []
    for work, distmatrix, clustmsg, labels, info in region_jobs:
        pre = _precomputed(info, dists, ef_d, pair_maxlen)
        with metrics.phase("cluster_consensus"), \
                metrics.phase("cluster_finish"):
            alleles, tasks = cluster_finish(params, work, distmatrix,
                                            clustmsg, labels, pre)
        staged_regions.append((work, clustmsg, alleles))
        all_tasks.extend(tasks)
    # one affine cigar launch for every allele consensus in the batch
    with metrics.phase("cluster_consensus"), \
            metrics.phase("consensus_batch"):
        consensus_apply_batched(all_tasks, engine=engine)
    with metrics.phase("emit"):
        for work, clustmsg, alleles in staged_regions:
            emit_region(params, work, clustmsg, alleles, out)


def _assemble_batched(params: OtterOpts, bed_regions: List[BED],
                      bam: BamReader, faidx: Optional[Faidx],
                      reads_only: bool, dist_backend, pool,
                      out: TextIO) -> None:
    """Two-stage pipeline: batch k's kernels run on the card while the host
    finishes batch k - 1. Region preparation stays on this thread whatever
    -t is (it is GIL-bound Python: a thread pool made it slower on the
    card, PERF.md). Output order stays the BED order."""
    pending: List[RegionWork] = []
    in_flight = None
    for c0 in range(0, len(bed_regions), DEFAULT_REGION_BATCH):
        with metrics.phase("host_io"):
            results = []
            for local_bed in bed_regions[c0 : c0 + DEFAULT_REGION_BATCH]:
                buf = io.StringIO()
                results.append((prepare_region(params, local_bed, bam, faidx,
                                               reads_only, buf),
                                buf.getvalue()))
        for work, text in results:
            if text:
                out.write(text)
            metrics.add("regions")
            if work is not None:
                pending.append(work)
        if len(pending) >= DEFAULT_REGION_BATCH:
            staged = _dispatch_batch(params, pending, dist_backend)
            if in_flight is not None:
                _finish_batch(params, in_flight, dist_backend, out, pool)
            in_flight = staged
            pending = []
    if pending:
        staged = _dispatch_batch(params, pending, dist_backend)
        if in_flight is not None:
            _finish_batch(params, in_flight, dist_backend, out, pool)
        in_flight = staged
    if in_flight is not None:
        _finish_batch(params, in_flight, dist_backend, out, pool)


def assemble_region(params: OtterOpts, local_bed: BED, bam: BamReader,
                    faidx: Optional[Faidx], reads_only: bool,
                    out: TextIO) -> None:
    """One region on the host path (``device="host"``): the numpy pair DP
    of ``fill_dist_matrix``, then ``finish_region``."""
    work = prepare_region(params, local_bed, bam, faidx, reads_only, out)
    if work is None:
        return
    distmatrix = DistMatrix(len(work.valid_indeces))
    if params.max_alleles != 1:
        fill_dist_matrix(work.ignore_haps, work.reads, work.valid_indeces,
                         distmatrix)
    finish_region(params, work, distmatrix, out)


def _make_dist_backend(params: OtterOpts,
                       process_index: int = 0) -> TorchDistBackend:
    """The engine for ``params.device`` (for ``cuda``, the card this
    process binds to, ``parallel/distributed.py::bind_device``; for
    ``mesh``, the mesh engine over the process's visible cards); raises if
    that device is absent, and for ``host``, which has no engine."""
    from ..parallel.distributed import bind_device

    engines = tuple(d for d in DEVICES if d != "host")
    if params.device not in engines:
        raise ValueError(f"an engine's device is one of {engines}, "
                         f"not {params.device!r}")
    with metrics.phase("open"):
        return TorchDistBackend(bind_device(params.device, process_index))


def _finish_pool(params: OtterOpts):
    """The opt-in finish pool (OTTER_TPU_FINISH_POOL=1 at -t > 1, as the
    JAX package makes it), or None: -t spawned workers for each region's
    hclust, reassignment and consensus on the host. At -t 1 there is no
    pool. This process keeps its engine, on any device."""
    if os.environ.get("OTTER_TPU_FINISH_POOL") != "1" or params.threads <= 1:
        return None
    import multiprocessing as mp

    return mp.get_context("spawn").Pool(params.threads)


def assemble_process(params: OtterOpts, bam_path: str, bed_regions: List[BED],
                     reference: str, reads_only: bool, out: TextIO,
                     dist_backend=None) -> None:
    """Assemble ``bed_regions`` into ``out``. ``dist_backend`` defaults to
    the engine for ``params.device``; any object with an ``engine`` of the
    same surface runs the same pipeline. With -t > 1 and
    OTTER_TPU_FINISH_POOL=1 the host half of every region runs in a pool of
    -t spawned worker processes (``_finish_pool``). ``device="host"`` takes
    no engine and no pool: ``assemble_region`` a region, in BED order,
    whatever -t is."""
    host = params.device == "host"
    if host and dist_backend is not None:
        raise ValueError('device "host" runs no engine')
    sys.stderr.write(
        f"({antimestamp()}): Processing {bam_path} ({params.read_group})\n")
    if dist_backend is None and not host:
        dist_backend = _make_dist_backend(params)
    with metrics.phase("open"):
        bam = BamReader(bam_path, load_index=True)
        faidx = Faidx(reference) if reference else None
    pool = None if host else _finish_pool(params)
    try:
        if host:
            for local_bed in bed_regions:
                assemble_region(params, local_bed, bam, faidx, reads_only,
                                out)
                metrics.add("regions")
        else:
            _assemble_batched(params, bed_regions, bam, faidx, reads_only,
                              dist_backend, pool, out)
    finally:
        if pool is not None:
            pool.close()
            pool.join()
        bam.close()
        if faidx is not None:
            faidx.close()


def completed_regions(partial_output_path: str) -> set:
    """Region ids (chr:start-end) already present in a partial assemble
    output (SAM ta: tags or FASTA headers) — the restart unit is a region,
    matching the reference's implicit recovery model (SURVEY.md §5)."""
    done = set()
    try:
        with open(partial_output_path) as fh:
            for line in fh:
                if line.startswith("@"):
                    continue
                if line.startswith(">"):
                    parts = line[1:].split("#")
                    if len(parts) >= 2:
                        done.add(parts[1])
                else:
                    for field in line.rstrip("\n").split("\t")[11:]:
                        if field.startswith("ta:Z:"):
                            done.add(field[5:])
                            break
    except OSError:
        pass
    return done


def _record_region(line: str) -> Optional[str]:
    """Region id (chr:start-end) of one output record line, or None for
    headers and unparseable lines."""
    if line.startswith(">"):
        parts = line[1:].split("#")
        return parts[1] if len(parts) >= 2 else None
    for field in line.rstrip("\n").split("\t")[11:]:
        if field.startswith("ta:Z:"):
            return field[5:]
    return None


def trim_partial_output(path: str) -> set:
    """Make a partial (possibly torn) assemble output safe to resume from.

    A killed worker (SIGKILL, OOM, node loss) can leave (a) a truncated
    final line and (b) a final region whose allele set is incomplete.
    Records of one region are emitted contiguously, so dropping every
    trailing record of the LAST region id (plus any torn tail) leaves only
    whole regions. The file is rewritten in place; the surviving region ids
    (what ``completed_regions`` will report) are returned. Recovery then
    runs the worker's shard again with ``resume_from`` pointing here: the
    region is the recovery unit (SURVEY.md §5)."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError:
        return set()
    complete, sep, _torn = raw.rpartition(b"\n")
    if not sep:
        complete = b""
    lines = complete.decode("utf-8", "replace").split("\n") if complete \
        else []
    # region id per line; a FASTA sequence line (no id of its own) takes the
    # preceding header's, since a record is header + sequence and both go
    # if the record's region is trimmed
    regions_per_line: List[Optional[str]] = []
    cur: Optional[str] = None
    for line in lines:
        if line.startswith("@"):
            regions_per_line.append(None)  # SAM header: never trimmed
            cur = None
        elif line.startswith(">"):
            cur = _record_region(line)
            regions_per_line.append(cur)
        elif line and not line[0].isspace() and "\t" in line:
            cur = _record_region(line)  # SAM record line
            regions_per_line.append(cur)
        else:
            regions_per_line.append(cur)  # FASTA sequence continuation
    last_region = None
    for rid in reversed(regions_per_line):
        if rid is not None:
            last_region = rid
            break
    keep = len(lines)
    if last_region is not None:
        while keep > 0 and not lines[keep - 1].startswith("@") \
                and regions_per_line[keep - 1] == last_region:
            keep -= 1
    kept_lines = lines[:keep]
    with open(path, "w") as fh:
        for line in kept_lines:
            fh.write(line + "\n")
    done = set()
    for line in kept_lines:
        if not line.startswith("@"):
            rid = _record_region(line)
            if rid:
                done.add(rid)
    return done


def _write_sam_header(params: OtterOpts, bam_path: str, out: TextIO) -> None:
    """The SAM header: an @SQ line for each of the BAM's references, then
    @RG and @PG."""
    with metrics.phase("open"):
        hdr = BamReader(bam_path, load_index=True)
        for name, ln in zip(hdr.ref_names, hdr.ref_lens):
            out.write(f"@SQ\tSN:{name}\tLN:{ln}\n")
        out.write(f"@RG\tID:{params.read_group}\n")
        out.write(f"@PG\tID:otter\tOF:{params.offset_l},{params.offset_r}\n")
        hdr.close()


def assemble(bam_path: str, bed: str, reference: str, reads_only: bool,
             params: OtterOpts, out: Optional[TextIO] = None,
             resume_from: str = "", dist_backend=None) -> None:
    """Top level (assemble.cpp:160-179): SAM header, then the regions.

    Under a coordinator (``parallel/distributed.py``) each process handles
    its contiguous block of regions on its own card (or the shared one),
    and only process 0 writes the header, so the per-process outputs
    concatenated in process order are the one-process stream; with
    OTTER_TPU_GATHER=1 process 0 writes that whole stream and the others
    nothing. ``device="host"`` joins no coordinator: every process writes
    the whole stream, header included, as the JAX package's host mode
    does."""
    from ..parallel.distributed import (gather_enabled, gather_text_to_writer,
                                        process_group, shard_regions)

    if params.device not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, "
                         f"not {params.device!r}")
    with metrics.phase("assemble"):
        if out is None:
            out = sys.stdout
        with metrics.phase("open"):
            bed_regions = parse_bed_file(bed)
        if resume_from:
            done = completed_regions(resume_from)
            before = len(bed_regions)
            bed_regions = [b for b in bed_regions
                           if b.to_sc_string() not in done]
            sys.stderr.write(
                f"({antimestamp()}): resume: skipping "
                f"{before - len(bed_regions)} completed regions\n")
        if params.device == "host":
            if not params.is_fa:
                _write_sam_header(params, bam_path, out)
            assemble_process(params, bam_path, bed_regions, reference,
                             reads_only, out, dist_backend=dist_backend)
            return
        with process_group() as (pidx, pcount):
            if pcount > 1:
                bed_regions = shard_regions(bed_regions, pidx, pcount)
                sys.stderr.write(
                    f"({antimestamp()}): process {pidx}/{pcount} handling "
                    f"{len(bed_regions)} regions\n")
            if dist_backend is None:
                dist_backend = _make_dist_backend(params, pidx)
            gather = gather_enabled(pcount)
            body_out: TextIO = io.StringIO() if gather else out
            if not params.is_fa and pidx == 0:
                _write_sam_header(params, bam_path, body_out)
            assemble_process(params, bam_path, bed_regions, reference,
                             reads_only, body_out, dist_backend=dist_backend)
            if gather:
                full = gather_text_to_writer(body_out.getvalue(), pidx, pcount)
                if full is not None:
                    out.write(full)
