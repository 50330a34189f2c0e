"""Read-pair distances, reassignment, SE, and rapid consensus.

Exact-parity port of src/analignments.cpp: align_anreads (:62-101),
get_dist_anreads haplotag shortcut (:103-115), fill_dist_matrix (:117-124),
invalid_reassignment (:126-177), compute_se (:179-190), rapid_consensus
(:192-298), and local_realignment (:11-60).

The O(n^2) fill_dist_matrix is the pipeline's hottest loop; the assemble
pipeline computes the same distances with the batched CUDA kernels
(kernels/edit_engine.py) and injects them via the ``pair_dist_fn`` hook.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Callable, List, Optional, Tuple

import numpy as np

from .. import native
from ..seqs.model import AnAllele, AnRead
from ..utils.timestamp import antimestamp
from .align_np import (
    edit_distance,
    edit_distance_ends_free,
)
from .distmat import DistMatrix
from .poa import Ppoa


def align_anreads(read_x: AnRead, read_y: AnRead) -> float:
    """Normalized pairwise distance (analignments.cpp:62-101)."""
    if read_x.seq == read_y.seq:
        return 0.0
    if (read_x.is_spanning() and read_y.is_spanning()) or (
        read_y.is_spanning() and len(read_x.seq) >= len(read_y.seq)
    ):
        largest = float(max(len(read_x.seq), len(read_y.seq)))
        dist = edit_distance(read_x.seq, read_y.seq)
        return dist / largest
    if read_y.is_spanning():
        length_diff = len(read_y.seq) - len(read_x.seq)
        if length_diff < 0:
            length_diff = -length_diff
            if read_x.is_spanning_l:
                score = edit_distance_ends_free(read_x.seq, read_y.seq, 0, 0, 0, length_diff)
            elif read_x.is_spanning_r:
                score = edit_distance_ends_free(read_x.seq, read_y.seq, 0, 0, length_diff, 0)
            else:
                score = edit_distance_ends_free(
                    read_x.seq, read_y.seq, 0, 0, length_diff // 2, length_diff // 2)
            return score / float(len(read_x.seq))
        else:
            if read_x.is_spanning_l:
                score = edit_distance_ends_free(read_y.seq, read_x.seq, 0, length_diff, 0, 0)
            elif read_x.is_spanning_r:
                score = edit_distance_ends_free(read_y.seq, read_x.seq, length_diff, 0, 0, 0)
            else:
                score = edit_distance_ends_free(
                    read_y.seq, read_x.seq, length_diff // 2, length_diff // 2, 0, 0)
            return score / float(len(read_x.seq))
    return -1.0


def get_dist_anreads(ignore_haps: bool, read_x: AnRead, read_y: AnRead) -> float:
    """Haplotag shortcut 0/1 when haplotags are used (analignments.cpp:103-115)."""
    if ignore_haps:
        return align_anreads(read_x, read_y)
    if read_x.hpt.is_defined() and read_y.hpt.is_defined():
        return 0.0 if read_x.hpt == read_y.hpt else 1.0
    return 1.0


PairDistFn = Callable[[AnRead, AnRead], float]


def fill_dist_matrix(ignore_haps: bool, reads: List[AnRead], indeces: List[int],
                     distmatrix: DistMatrix,
                     pair_dist_fn: Optional[PairDistFn] = None) -> None:
    """O(n^2) pairwise fill (analignments.cpp:117-124). ``pair_dist_fn`` lets
    the TPU batch path substitute device-computed distances."""
    fn = pair_dist_fn
    for i in range(len(indeces)):
        for j in range(i + 1, len(indeces)):
            rx, ry = reads[indeces[i]], reads[indeces[j]]
            if fn is not None and ignore_haps:
                d = fn(rx, ry)
            else:
                d = get_dist_anreads(ignore_haps, rx, ry)
            distmatrix.set_dist(i, j, d)


def reassignment_jobs(reads: List[AnRead], labels: List[int]):
    """Collect the batchable align_anreads jobs for (unassigned i, initially
    labeled spanning j) pairs. Returns (pre, e2e_pairs, e2e_keys, ef_jobs,
    ef_keys, ef_norm); equal-sequence pairs land directly in ``pre``."""
    e2e_pairs = []
    e2e_keys = []
    ef_jobs = []
    ef_keys = []
    ef_norm = []
    pre: dict = {}
    for i in range(len(labels)):
        if labels[i] >= 0:
            continue
        read_x = reads[i]
        for j in range(len(labels)):
            read_y = reads[j]
            if i == j or labels[j] < 0 or not read_y.is_spanning():
                continue
            if read_x.seq == read_y.seq:
                pre[(i, j)] = 0.0
            elif (read_x.is_spanning() and read_y.is_spanning()) or (
                read_y.is_spanning() and len(read_x.seq) >= len(read_y.seq)
            ):
                e2e_pairs.append((read_x.seq, read_y.seq))
                e2e_keys.append((i, j))
            else:
                length_diff = len(read_y.seq) - len(read_x.seq)
                # read_x shorter here (analignments.cpp:83-99 else-branch)
                if read_x.is_spanning_l:
                    job = (read_y.seq, read_x.seq, 0, length_diff, 0, 0)
                elif read_x.is_spanning_r:
                    job = (read_y.seq, read_x.seq, length_diff, 0, 0, 0)
                else:
                    job = (read_y.seq, read_x.seq, length_diff // 2,
                           length_diff // 2, 0, 0)
                ef_jobs.append(job)
                ef_keys.append((i, j))
                ef_norm.append(float(len(read_x.seq)))
    return pre, e2e_pairs, e2e_keys, ef_jobs, ef_keys, ef_norm


def reassignment_distances_batched(reads: List[AnRead], labels: List[int],
                                   engine=None) -> dict:
    """Precompute align_anreads distances for (unassigned i, initially
    labeled spanning j) pairs in batch. End2End cases go through the batched
    edit engine (device kernels when available); ends-free cases through the
    striped Myers device path or the vectorized host DP. Reads labeled
    *during* the sequential reassignment loop are handled on demand there,
    preserving the reference's in-loop dependency (analignments.cpp:129-176)."""
    from .align_batch import edit_ends_free_batch

    pre, e2e_pairs, e2e_keys, ef_jobs, ef_keys, ef_norm = reassignment_jobs(
        reads, labels)
    if e2e_pairs:
        if engine is not None:
            dists = engine.distances(e2e_pairs)
        else:
            dists = edit_ends_free_batch(
                [(x, y, 0, 0, 0, 0) for x, y in e2e_pairs])
        for key, d, (x, y) in zip(e2e_keys, dists, e2e_pairs):
            pre[key] = d / float(max(len(x), len(y)))
    if ef_jobs:
        if engine is not None and hasattr(engine, "ends_free"):
            dists = engine.ends_free(ef_jobs)
        else:
            dists = edit_ends_free_batch(ef_jobs)
        for key, d, nrm in zip(ef_keys, dists, ef_norm):
            pre[key] = d / nrm
    return pre


def invalid_reassignment(ignore_haps: bool, min_sim: float, max_error: float,
                         total_alleles: int, reads: List[AnRead],
                         labels: List[int],
                         pair_dist_fn: Optional[PairDistFn] = None,
                         precomputed: Optional[dict] = None) -> None:
    """Assign non-spanning reads to the allele with max similarity, requiring
    min_sim and a margin >= max_error over the runner-up
    (analignments.cpp:126-177)."""
    fn = pair_dist_fn or (lambda a, b: get_dist_anreads(True, a, b))
    pre = precomputed or {}
    for i in range(len(labels)):
        if labels[i] < 0:
            max_sim = [0.0] * total_alleles
            read_i = reads[i]
            for j in range(len(labels)):
                read_j = reads[j]
                if i != j and labels[j] >= 0 and read_j.is_spanning():
                    dist = pre.get((i, j))
                    if dist is None:
                        dist = fn(read_i, read_j)
                    if dist < 0:
                        sys.stderr.write(
                            "ERROR: unexpected distance for the following alignment:\n"
                            f"{read_i.name}\t{int(read_i.is_spanning())}\n{read_i.seq}\n"
                            f"{read_j.name}\t{int(read_j.is_spanning())}\n{read_j.seq}\n")
                        raise SystemExit(1)
                    sim = 1 - dist
                    if sim > max_sim[labels[j]]:
                        max_sim[labels[j]] = sim
            max_sim_label = 0
            for j in range(1, total_alleles):
                if max_sim[j] > max_sim[max_sim_label]:
                    max_sim_label = j
            same_max_sim = sum(1 for s in max_sim if s == max_sim[max_sim_label])
            if same_max_sim == 1 and max_sim[max_sim_label] >= min_sim:
                min_diff = 1.0
                for j in range(total_alleles):
                    if max_sim_label != j:
                        diff = max_sim[max_sim_label] - max_sim[j]
                        if diff < min_diff:
                            min_diff = diff
                if min_diff >= max_error:
                    labels[i] = max_sim_label


def compute_se(values: List[float]) -> float:
    """Standard error of the mean (analignments.cpp:179-190)."""
    if not values:
        return -1.0
    u = sum(values) / len(values)
    n = sum((v - u) ** 2 for v in values)
    return math.sqrt(n / (len(values) - 1)) / math.sqrt(len(values))


class PoaTask:
    """One allele's deferred consensus: backbone + per-member alignment jobs
    (a None job reproduces the reference's stale-aligner cigar reuse)."""

    def __init__(self, allele: AnAllele, rep_read: AnRead,
                 member_reads: List[AnRead], jobs: List[Optional[tuple]]):
        self.allele = allele
        self.rep_read = rep_read
        self.member_reads = member_reads
        self.jobs = jobs

    def flat_jobs(self) -> List[tuple]:
        return [(self.rep_read.seq,) + j for j in self.jobs if j is not None]

    def resolved_members(self, cigars: List[str]) -> List[tuple]:
        """Per-member (seq, cigar, span_l, span_r) with the reference's
        stale-aligner cigar reuse applied (a None job keeps the previous
        member's cigar, analignments.cpp:266-282)."""
        out = []
        cigar = ""
        ci = 0
        for read, job in zip(self.member_reads, self.jobs):
            if job is not None:
                cigar = cigars[ci]
                ci += 1
            out.append((read.seq, cigar, read.is_spanning_l,
                        read.is_spanning_r))
        return out

    def prune_c(self) -> float:
        n_members = len(self.member_reads) + 1
        c = np.float32(n_members * 0.4)
        if n_members < 4:
            c = np.float32(1.0)
        return float(c)

    def apply(self, cigars: List[str]) -> None:
        poa = Ppoa(self.rep_read.seq)
        for seq, cigar, sl, sr in self.resolved_members(cigars):
            poa.insert_alignment(seq, cigar, sl, sr)
        poa.adjust_weights(self.prune_c(), float(np.float32(0.3)))
        self.allele.seq = poa.consensus()
        if not self.allele.seq:
            self.allele.seq = "N"


def _route(flat: List[tuple], engine) -> tuple:
    """(K5 or not, the jobs to seed with a band hint) for the consensus
    jobs ``flat``, by the JAX package's rules for an accelerator engine
    (otter_tpu/ops/consensus.py:294-378), K5 in the place of its kernel:
    K5 unless OTTER_TPU_AFFINE_DEVICE=0; hints for every job with K5, none
    without, unless OTTER_TPU_AFFINE_HINTS=1 (every job) or =0 (none);
    without K5 and with neither, the long jobs (a side >= 512 bp) when
    their texts reach 50,000 bp. No kernel engine: the ladder, no hints.
    The JAX package's round-trip probe that picks its default is not
    ported: with nothing set, K5 with every job seeded."""
    if not flat or getattr(engine, "device", None) is None:
        return False, []
    use_k5 = os.environ.get("OTTER_TPU_AFFINE_DEVICE", "") != "0"
    env_hints = os.environ.get("OTTER_TPU_AFFINE_HINTS", "")
    if env_hints == "1" or (env_hints == "" and use_k5):
        return use_k5, list(range(len(flat)))
    if env_hints == "":
        long_idx = [i for i, j in enumerate(flat)
                    if max(len(j[0]), len(j[1])) >= 512]
        if sum(len(flat[i][1]) for i in long_idx) >= 50_000:
            return use_k5, long_idx
    return use_k5, []


def consensus_apply_batched(tasks: List["PoaTask"], engine=None) -> None:
    """Align every task's members to their representative in one batch,
    then build each POA.

    With a kernel engine (``engine.device`` set) the cigars come from the
    affine traceback kernel (kernels/affine_tb.py, K5), each member's band
    seeded by its exact ends-free distance (one engine dispatch), and the
    members it cannot prove optimal take the native band ladder
    (ops/align_batch.py), which computes the same cigar. Without one, every
    member takes the ladder. The JAX package's settings route as there,
    with K5 in the place of its accelerator kernel (``_route``):
    OTTER_TPU_AFFINE_DEVICE=0 sends every member to the ladder, and
    OTTER_TPU_AFFINE_HINTS=0 / =1 turn the band seeds off / on for every
    job. The cigars are the same either way. The POAs then take the native
    C++ PPOA, or with OTTER_TPU_POA_DEVICE=1 the Python graph build and
    K12's heaviest-path DP on the engine's device."""
    from .align_batch import affine_cigars_multi

    flat: List[tuple] = []
    spans: List[tuple] = []
    for task in tasks:
        jobs = task.flat_jobs()
        spans.append((task, len(flat), len(jobs)))
        flat.extend(jobs)
    from ..utils import metrics

    use_k5, hint_idx = _route(flat, engine)
    hints = None
    if hint_idx:
        with metrics.phase("consensus_hints"):
            hints = [None] * len(flat)
            for i, d in zip(hint_idx,
                            engine.ends_free([flat[i] for i in hint_idx])):
                hints[i] = int(d)
    with metrics.phase("consensus_affine"):
        if use_k5:
            from ..kernels.affine_tb import affine_cigars_tb

            with metrics.phase("affine_tb"):
                cigars, failed = affine_cigars_tb(flat, engine.device, hints)
        else:
            cigars, failed = [""] * len(flat), list(range(len(flat)))
        if getattr(engine, "device", None) is not None:
            engine.jobs_k5 += len(flat) - len(failed)
            engine.jobs_affine_host += len(failed)
        # the native band ladder redoes what K5 could not prove (span opened
        # with none to redo)
        with metrics.phase("affine_ladder"):
            if failed:
                redo = affine_cigars_multi(
                    [flat[i] for i in failed],
                    dist_hints=None if hints is None else [hints[i]
                                                           for i in failed])
                for i, cig in zip(failed, redo):
                    cigars[i] = cig
    # device heaviest-path DP (ops/poa_device.py, K12): graphs build on the
    # host, the consensus DP of the whole allele batch runs as one launch a
    # device (the engine's card or mesh; K12's plain version on the CPU).
    # Opt-in (OTTER_TPU_POA_DEVICE=1), as in the JAX package: the native C++
    # batch PPOA below builds the graphs far faster than Python does. Output
    # is byte-identical either way (parity-tested); a failure raises.
    if tasks and os.environ.get("OTTER_TPU_POA_DEVICE", "") == "1":
        from .poa_device import poa_consensus_device_batch

        with metrics.phase("consensus_poa"):
            poas = []
            for task, s, n in spans:
                poa = Ppoa(task.rep_read.seq)
                for seq, cigar, sl, sr in task.resolved_members(
                        cigars[s : s + n]):
                    poa.insert_alignment(seq, cigar, sl, sr)
                poa.adjust_weights(task.prune_c(), float(np.float32(0.3)))
                poas.append(poa)
            devices = (getattr(engine, "mesh", None)
                       or getattr(engine, "device", None) or "cpu")
            seqs = poa_consensus_device_batch(poas, devices)
        for (task, _s, _n), seq in zip(spans, seqs):
            task.allele.seq = seq if seq else "N"
        return
    # native C++ PPOA (byte-identical to the python Ppoa oracle) on the
    # device paths; python remains the host-mode parity oracle
    if engine is not None and tasks and native.enabled("POA"):
        with metrics.phase("consensus_poa"):
            ndata = [(t.rep_read.seq,
                      t.resolved_members(cigars[s : s + n]))
                     for t, s, n in spans]
            cvals = [t.prune_c() for t, _s, _n in spans]
            seqs = native.poa_consensus_batch(ndata, cvals,
                                              float(np.float32(0.3)))
        for (task, _s, _n), seq in zip(spans, seqs):
            task.allele.seq = seq if seq else "N"
        return
    for task, start, count in spans:
        task.apply(cigars[start : start + count])


def rapid_consensus(ignore_haps: bool, reads: List[AnRead], labels: List[int],
                    valid_indeces: List[int], total_alleles: int,
                    valid_distmatrix: DistMatrix,
                    alleles: List[AnAllele]) -> None:
    """Per-allele medoid backbone + POA consensus (analignments.cpp:192-298)."""
    tasks = consensus_prepare(ignore_haps, reads, labels, valid_indeces,
                              total_alleles, valid_distmatrix, alleles)
    consensus_apply_batched(tasks)


def consensus_prepare(ignore_haps: bool, reads: List[AnRead],
                      labels: List[int], valid_indeces: List[int],
                      total_alleles: int, valid_distmatrix: DistMatrix,
                      alleles: List[AnAllele]) -> List[PoaTask]:
    """Everything in rapid_consensus up to (but excluding) the alignments:
    coverage bookkeeping, SE, haplotag checks, small-cluster shortcut.
    Returns the deferred POA tasks for batched alignment."""
    if not valid_indeces:
        sys.stderr.write("ERROR: empty vector of valid read-indeces\n")
        raise SystemExit(1)
    tasks: List[PoaTask] = []
    for label in range(total_alleles):
        label_indeces_valid_reads = []
        label_indeces_valid_indeces = []
        for i in range(len(valid_indeces)):
            if label == labels[valid_indeces[i]]:
                label_indeces_valid_reads.append(valid_indeces[i])
                label_indeces_valid_indeces.append(i)
        if not label_indeces_valid_reads:
            sys.stderr.write(
                f"ERROR: empty vector of valid read-indeces for allele cluster {label}\n")
            raise SystemExit(1)
        rep_index_valid_indeces = valid_distmatrix.get_medoid(label_indeces_valid_indeces)
        rep = valid_indeces[rep_index_valid_indeces]
        label_indeces_all_reads = [
            i for i in range(len(reads)) if i != rep and labels[i] == label
        ]

        local_allele = alleles[label]
        local_allele.tcov = len(reads)
        local_allele.acov = len(label_indeces_all_reads) + 1
        local_allele.scov = len(label_indeces_valid_reads)
        if len(label_indeces_valid_indeces) == 1:
            local_allele.se = 0.0
        elif len(label_indeces_valid_indeces) == 2:
            local_allele.se = valid_distmatrix.get_dist(
                label_indeces_valid_indeces[0], label_indeces_valid_indeces[1])
        else:
            valid_dists = [
                valid_distmatrix.get_dist(i, rep_index_valid_indeces)
                for i in label_indeces_valid_indeces
                if i != rep_index_valid_indeces
            ]
            local_allele.se = compute_se(valid_dists)

        ps = -1
        hp = -1
        conflicting = False
        if not ignore_haps:
            for i in label_indeces_valid_reads:
                if ps < 0:
                    ps = reads[i].hpt.ps
                elif ps != reads[i].hpt.ps:
                    conflicting = True
                if hp < 0:
                    hp = reads[i].hpt.hp
                elif hp != reads[i].hpt.hp:
                    conflicting = True
        if conflicting:
            sys.stderr.write("ERROR: conflicting haplotag information:\n")
            for i in label_indeces_valid_reads:
                sys.stderr.write(f"{reads[i].name}\t{reads[i].hpt.ps}\t{reads[i].hpt.hp}\n")
            raise SystemExit(1)

        rep_read = reads[rep]
        if not ignore_haps:
            local_allele.hpt = rep_read.hpt

        if len(label_indeces_all_reads) + 1 <= 2:
            local_allele.seq = reads[label_indeces_valid_reads[0]].seq
        else:
            # collect per-member alignment jobs (analignments.cpp:266-279);
            # alignments run later as one batched banded DP across all
            # alleles (and regions). A job of None reproduces the
            # reference's stale-aligner state (previous cigar reused).
            jobs: List[Optional[tuple]] = []
            member_reads: List[AnRead] = []
            for i in label_indeces_all_reads:
                read = reads[i]
                member_reads.append(read)
                length_diff = len(rep_read.seq) - len(read.seq)
                if read.is_spanning() or length_diff < 0:
                    if length_diff >= 0:
                        jobs.append((read.seq, 0, 0, 0, 0))
                    elif read.is_spanning_l:
                        jobs.append((read.seq, 0, 0, 0, -length_diff))
                    elif read.is_spanning_r:
                        jobs.append((read.seq, 0, 0, -length_diff, 0))
                    else:
                        jobs.append(None)
                else:
                    if read.is_spanning_l:
                        jobs.append((read.seq, 0, length_diff, 0, 0))
                    elif read.is_spanning_r:
                        jobs.append((read.seq, length_diff, 0, 0, 0))
                    else:
                        jobs.append((read.seq, length_diff // 2,
                                     length_diff // 2, 0, 0))
            tasks.append(PoaTask(local_allele, rep_read, member_reads, jobs))
    return tasks


def local_realignment(chr: str, start: int, end: int, flank: int, min_sim: float,
                      faidx, reads: List[AnRead]) -> None:
    """Rescue partially-spanning reads by re-aligning their clipped tail to
    flanking reference sequence (analignments.cpp:11-60).

    All flank alignments of the region are gathered first and run as ONE
    batched gap-affine dispatch (ops/align_batch.py::affine_cigars_multi —
    native C++ ladder / device kernel with exact scalar parity) instead of
    the reference's per-read WFAlignerGapAffine call; the +1/-1 max-prefix
    rescue scan (:35-51) is then applied per read, so the mutation order
    over ``reads`` is unchanged."""
    from .align_batch import affine_cigars_multi

    ref_left = ""
    ref_right = ""
    pending: List[Tuple[AnRead, bool, str]] = []
    jobs: List[Tuple[str, str, int, int, int, int]] = []
    for local_read in reads:
        if not local_read.is_spanning() and (
            local_read.is_spanning_l or local_read.is_spanning_r
        ):
            left_realignment = local_read.is_spanning_r and local_read.ccoords[0] >= flank
            right_realignment = local_read.is_spanning_l and (
                len(local_read.seq) - local_read.ccoords[1] >= flank)
            if left_realignment:
                if not ref_left:
                    ref_left = faidx.fetch(chr, start - flank, start)
                subseq = local_read.seq[: local_read.ccoords[0]]
                if subseq:
                    pending.append((local_read, True, subseq))
                    jobs.append((subseq, ref_left, 0, 0, 0, 0))
            elif right_realignment:
                if not ref_right:
                    ref_right = faidx.fetch(chr, end, end + flank)
                subseq = local_read.seq[local_read.ccoords[1]:]
                if subseq:
                    pending.append((local_read, False, subseq))
                    jobs.append((subseq, ref_right, 0, 0, 0, 0))
    if not jobs:
        return
    cigars = affine_cigars_multi(jobs)
    for (local_read, left_realignment, subseq), cigar in zip(pending, cigars):
        # +1/-1 max-prefix score scan over non-I cigar ops (:35-51)
        scores = [0] * len(subseq)
        j = 0
        for op in cigar:
            if op != "I":
                penalty = 1 if op == "M" else -1
                if penalty > 0:
                    scores[j] = penalty if j == 0 else scores[j - 1] + penalty
                elif j > 0 and scores[j - 1] > 0:
                    scores[j] = scores[j - 1] + penalty
                j += 1
        max_sum_i = 0
        for j in range(len(scores)):
            if scores[j] > scores[max_sum_i]:
                max_sum_i = j
        start_i = max_sum_i
        while start_i > 0 and scores[start_i] > 0:
            start_i -= 1
        if scores[max_sum_i] / float(flank) >= min_sim:
            if left_realignment:
                local_read.seq = local_read.seq[max_sum_i:]
            else:
                local_read.seq = local_read.seq[: local_read.ccoords[1] + start_i]
            local_read.set_is_spanning()
