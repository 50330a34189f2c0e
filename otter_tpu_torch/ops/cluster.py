"""Clustering heuristics (exact-parity port of src/otterclust.cpp).

Covers: KDE decision boundary with peak merge/tie-break rules
(otterclust.cpp:20-116), ``otter_hclust`` with special cases, bandwidth
switching, coverage-based seed/outlier reassignment (:118-320), length and
k-mer-usage allele clustering, and the joint ``anallele_cluster``
(:322-527).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .. import native
from ..seqs.kmer import Kusage, kusage_batch, seq2kcounts
from ..seqs.model import AnAllele, AnRead
from ..utils import metrics
from .distmat import DistMatrix, triu_pair_indices
from .hclust import cutree_cdist, cutree_k, hclust_average
from .kde import kde_densities, kde_grid, kde_maximas


# GEMM-vs-scalar-dot accumulation differences are a few ulps of a value
# <= 1000 (~1e-13 absolute); 1e-9 leaves ~4 orders of magnitude of margin
# while flagging only ~4e-9 of uniformly-distributed pairs for the scalar
# recompute
_ROUND_GUARD = 1e-9


@dataclass
class ClusteringStatus:
    ic: int = 0
    fc: int = 0
    labels: List[int] = field(default_factory=list)

    def set_global_label(self, l: int) -> None:
        for i in range(len(self.labels)):
            self.labels[i] = l


@dataclass
class Genotype:
    gt: int = -1
    gt_l: int = -1
    gt_k: int = -1
    hsd: float = -1.0


@dataclass
class DecisionBound:
    dist0: float
    dist1: float
    cut0: float


def _insertion_sort(a: List[int], less) -> None:
    """libstdc++ __insertion_sort (what std::sort runs for <16 elements)."""
    for i in range(1, len(a)):
        val = a[i]
        if less(val, a[0]):
            for j in range(i, 0, -1):
                a[j] = a[j - 1]
            a[0] = val
        else:
            j = i
            while less(val, a[j - 1]):
                a[j] = a[j - 1]
                j -= 1
            a[j] = val


def otter_find_clustering_dist(radius: int, dinterval: float, bandwidth: float,
                               distmatrix: DistMatrix,
                               densities: Optional[np.ndarray] = None
                               ) -> DecisionBound:
    """KDE over the distance distribution -> (first peak, second peak, valley)
    with the reference's peak-merging and tie-break rules
    (otterclust.cpp:20-116). ``densities`` may be precomputed (device path)."""
    if densities is None:
        xs = kde_grid(dinterval)
        densities = kde_densities(distmatrix.values, bandwidth, xs)
    maximas, minimas = kde_maximas(radius, densities)
    if not maximas:
        sys.stderr.write("ERROR: failed to obtain maximas\n")
        raise SystemExit(1)
    if len(maximas) == 1:
        return DecisionBound(maximas[0][0] * dinterval, maximas[0][0] * dinterval, -1.0)
    if not minimas:
        sys.stderr.write("ERROR: failed to obtain minimas\n")
        raise SystemExit(1)
    if len(maximas) == 2:
        return DecisionBound(maximas[0][0] * dinterval, maximas[1][0] * dinterval,
                             minimas[0][0] * dinterval)
    # >2 peaks: sort by density (desc) with near-tie (<=0.01) broken by
    # position, then delete adjacent-index near-equal peaks (:59-87).
    # The reference comparator (otterclust.cpp:61-66) is not a strict weak
    # ordering, so the result depends on the sort algorithm; std::sort uses
    # plain insertion sort for ranges < 16 elements (the practical case), and
    # we replicate that insertion sort exactly.
    sorted_maximas = list(range(len(maximas)))

    def cmp_less(a: int, b: int) -> bool:
        diff = maximas[a][1] - maximas[b][1]
        diff = diff if diff > 0 else -diff
        if diff <= 0.01:
            return maximas[a][0] < maximas[b][0]
        return maximas[a][1] > maximas[b][1]

    _insertion_sort(sorted_maximas, cmp_less)
    last_i = 0
    acc_i = 1
    while acc_i < len(sorted_maximas):
        index_diff = abs(acc_i - last_i)
        f_diff = abs(maximas[sorted_maximas[acc_i]][1] - maximas[sorted_maximas[last_i]][1])
        if index_diff == 1 and f_diff <= 0.01:
            del sorted_maximas[acc_i]
            last_i = acc_i
        acc_i += 1
    if len(sorted_maximas) < 2:
        return DecisionBound(maximas[0][0] * dinterval, maximas[1][0] * dinterval,
                             minimas[0][0] * dinterval)
    m_first_i = sorted_maximas[0]
    m_second_i = sorted_maximas[1]
    if m_first_i > m_second_i:
        m_first_i, m_second_i = m_second_i, m_first_i
    boundary_i = m_second_i - 1
    if boundary_i < 0 or boundary_i >= len(minimas):
        sys.stderr.write(f"ERROR: unexpected index for minimas: {boundary_i}\n")
        raise SystemExit(1)
    if (m_second_i - m_first_i > 1 and m_second_i - 2 >= 0
            and (maximas[m_second_i][0] * dinterval - minimas[boundary_i][0] * dinterval
                 <= 0.01)):
        boundary_i = m_second_i - 2
        if boundary_i < 0 or boundary_i >= len(minimas):
            sys.stderr.write(
                f"ERROR: unexpected index for minimas after correction: {boundary_i}\n")
            raise SystemExit(1)
    return DecisionBound(
        maximas[m_first_i][0] * dinterval,
        maximas[m_second_i][0] * dinterval,
        minimas[m_first_i + (m_second_i - m_first_i) // 2][0] * dinterval,
    )


def otter_hclust(ignore_haps: bool, max_alleles: int, bandwidth_short: float,
                 bandwidth_length: int, bandwidth_long: float,
                 max_tolerable_diff: float, min_cov_fraction: float,
                 min_cov_fraction2_l: int, min_cov_fraction2_f: float,
                 indeces: List[int], distmatrix: DistMatrix,
                 reads: List[AnRead], clustering: ClusteringStatus,
                 densities: Optional[np.ndarray] = None) -> None:
    """Read clustering into allele groups (otterclust.cpp:118-320)."""
    clustering.labels = [-1] * len(indeces)
    if len(indeces) == 1:
        clustering.labels[0] = 0
        clustering.ic = 1
        clustering.fc = 1
        return
    if len(indeces) == 2:
        clustering.labels[0] = 0
        clustering.labels[1] = 0
        if max_alleles == 1:
            clustering.ic = 1
            clustering.fc = 1
        else:
            dist = distmatrix.get_dist(0, 1)
            if dist <= max_tolerable_diff:
                clustering.ic = 1
                clustering.fc = 1
            else:
                clustering.labels[1] = 1
                clustering.ic = 2
                clustering.fc = 2
        return
    if max_alleles == 1:
        clustering.set_global_label(0)
        clustering.ic = 1
        clustering.fc = 1
        return

    error_intervals = 0.0025
    radius = int(max_tolerable_diff / error_intervals)
    if radius < 1:
        radius = 1
    bandwidth = bandwidth_short
    for i in indeces:
        if len(reads[i].seq) >= bandwidth_length:
            bandwidth = bandwidth_long
            break
    dists = otter_find_clustering_dist(radius, error_intervals, bandwidth,
                                       distmatrix, densities=densities)
    if dists.dist1 - dists.dist0 <= max_tolerable_diff:
        clustering.set_global_label(0)
        clustering.ic = 1
        clustering.fc = 1
        return

    n = len(indeces)
    merge, height = _hclust_fast(n, distmatrix.values)
    dist_final = dists.dist1 if dists.dist1 == bandwidth else dists.cut0 + 0.0025
    labels = cutree_cdist(n, merge, height, dist_final).tolist()
    total_alleles = 0
    for l in labels:
        if l > total_alleles:
            total_alleles = l
    total_alleles += 1
    clustering.ic = total_alleles
    min_cov1 = int(n * min_cov_fraction + 0.5)
    min_cov2 = int(n * min_cov_fraction2_f + 0.5)

    if max_alleles != 0:
        label_counts = [0] * total_alleles
        label_max_sizes = [0] * total_alleles
        label_required_covs = [0] * total_alleles
        for i in range(n):
            label_counts[labels[i]] += 1
            if len(reads[indeces[i]].seq) > label_max_sizes[labels[i]]:
                label_max_sizes[labels[i]] = len(reads[indeces[i]].seq)
        label_max_cov = 0
        for l in range(total_alleles):
            if label_counts[l] > label_max_cov:
                label_max_cov = label_counts[l]
            if label_max_sizes[l] < min_cov_fraction2_l:
                label_required_covs[l] = min_cov1
            else:
                label_required_covs[l] = min_cov2

        is_only_singletons = True
        for l in range(total_alleles):
            if label_counts[l] >= label_required_covs[l]:
                is_only_singletons = False
                break
        if is_only_singletons:
            labels = cutree_k(n, merge, max_alleles).tolist()
            clustering.fc = max_alleles
        else:
            outlier_clusters_n = 0
            seed_clusters_n = 0
            for l in range(total_alleles):
                if label_counts[l] < label_required_covs[l]:
                    outlier_clusters_n += 1
                else:
                    seed_clusters_n += 1
            if seed_clusters_n == 0 or seed_clusters_n > max_alleles:
                labels = cutree_k(n, merge, max_alleles).tolist()
                clustering.fc = max_alleles
            else:
                outlier_clusters = []
                seed_clusters = []
                for l in range(total_alleles):
                    if label_counts[l] < label_required_covs[l]:
                        outlier_clusters.append(l)
                    else:
                        seed_clusters.append(l)
                for i in range(n):
                    if labels[i] in outlier_clusters:
                        labels[i] = -1
                # relabel seed clusters to 0..k-1 (:277-286)
                for i in range(n):
                    for j, s in enumerate(seed_clusters):
                        if labels[i] == s:
                            labels[i] = j
                            break
                # reassign outliers to nearest labeled read (:289-304)
                for i in range(n):
                    if labels[i] == -1:
                        closest_j = None
                        min_dist = 100000.0
                        for j in range(n):
                            if i != j and labels[j] != -1:
                                j_dist = distmatrix.get_dist(i, j)
                                if j_dist < min_dist:
                                    closest_j = j
                                    min_dist = j_dist
                        labels[i] = labels[closest_j]
                clustering.fc = seed_clusters_n

    for i in range(n):
        clustering.labels[i] = labels[i]


def length_dist(x: int, y: int) -> float:
    """|x-y|/max(x,y) (otterclust.cpp:322-327)."""
    is_x_smallest = x < y
    dist = float(y - x) if is_x_smallest else float(x - y)
    return dist / y if is_x_smallest else dist / x


def _hclust_route(n: int, condensed: np.ndarray, cdist: float,
                  device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """Average linkage for the cohort paths: native C++ NN-chain by
    default (exact f64 parity with the python oracle — same algorithm,
    same scan order, -ffp-contract=off so rounding matches numpy; see
    native/otter_native.cpp::hclust_one and test_hclust.py's randomized
    tie-heavy parity sweep), K11 on ``device`` when provably safe.

    Real cohort matrices are full of ties (cosine distances round to 3
    decimals, length distances repeat), so the tie-free guard below
    almost always declines — the native path is what actually serves the
    n = 2*samples+1 cohort regime. OTTER_TPU_NATIVE_HCLUST=0 keeps the
    python NN-chain.

    The device formulation (ops/hclust_device.py, kernel K11) matches the
    host NN-chain only on tie-free matrices, and it runs in float32, so it
    is used only when the result is certain to be byte-identical to the
    host cut:

      * the condensed matrix has no duplicate values after float32 cast
        (any float64-distinct pair that collides in f32 is a device tie);
      * the realized merge heights come back strictly increasing (a
        duplicate realized height means a derived-average collision the
        input check cannot see);
      * no merge height lands within ``tol`` of the cut threshold, where
        tol covers worst-case f32 averaging drift (so the host's
        ``height >= cdist`` comparisons cannot flip).

    A matrix a guard declines takes the host NN-chain, so outputs are
    byte-identical either way (counted: ``hclust_device``,
    ``hclust_device_declined``). OTTER_TPU_HCLUST_DEVICE=0 disables, =1
    forces the attempt regardless of size and device (K11's plain version
    on the CPU); by default K11 is tried for n >= 64 when ``device`` is a
    card, as the JAX package tries its device whenever JAX is live."""
    import torch

    env = os.environ.get("OTTER_TPU_HCLUST_DEVICE", "")
    if n < 2 or env == "0":
        return _hclust_fast(n, condensed)
    if env != "1" and (n < 64 or torch.device(device).type != "cuda"):
        return _hclust_fast(n, condensed)
    v32 = np.asarray(condensed, dtype=np.float32)
    if np.unique(v32).size != v32.size:
        metrics.add("hclust_device_declined")
        return _hclust_fast(n, condensed)
    from .hclust_device import hclust_average_device

    merge, height = hclust_average_device(
        np.asarray(condensed, dtype=np.float64), n, device)
    h = np.asarray(height, dtype=np.float64)
    tol = max(1e-4, n * 1e-6) * max(1.0, abs(cdist))
    if h.size and (np.any(np.diff(h) <= 0.0)
                   or np.any(np.abs(h - cdist) <= tol)):
        metrics.add("hclust_device_declined")
        return _hclust_fast(n, condensed)
    metrics.add("hclust_device")
    return merge, h


def _hclust_fast(n: int, condensed: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Native C++ NN-chain (OTTER_TPU_NATIVE_HCLUST=0: python oracle)."""
    if n >= 2 and native.enabled("HCLUST"):
        return native.hclust_average_native(condensed, n)
    return hclust_average(n, condensed)


def cluter_to_e(max_error: float, total_alleles: int,
                distmatrix: DistMatrix,
                dendro=None, device="cpu") -> List[List[int]]:
    """hclust + cut at max_error -> clusters as index lists (:329-349).

    ``dendro``: optional precomputed (merge, height) — the batched cohort
    pipeline runs ONE threaded native NN-chain call for every region's
    matrices (native.hclust_average_native_batch) and hands each result
    in here; the native batch is parity-exact with the per-matrix route
    (same C++ core), so output is unchanged. ``device``: where
    ``_hclust_route`` may run K11."""
    if dendro is not None:
        merge, height = dendro
    else:
        merge, height = _hclust_route(total_alleles, distmatrix.values,
                                      max_error, device)
    labels = np.asarray(
        cutree_cdist(total_alleles, merge, height, max_error), dtype=np.int64)
    # grouped build via stable argsort: cluster l = indices with label l in
    # ascending order — exactly the scalar double loop's output
    total_clusters = int(labels.max()) + 1 if total_alleles else 1
    order = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=total_clusters)
    clusters: List[List[int]] = []
    pos = 0
    for c in counts:
        clusters.append(order[pos : pos + int(c)].tolist())
        pos += int(c)
    return clusters


def remap_cluster_indeces(distmatrix: DistMatrix, indeces: List[int],
                          input_clusters: List[List[int]]
                          ) -> Tuple[List[List[int]], List[int]]:
    """Reindex clusters to allele ids + medoid reps (:351-365)."""
    output_clusters: List[List[int]] = []
    medoids: List[int] = []
    for cluster in input_clusters:
        mapped = [indeces[i] for i in cluster]
        output_clusters.append(mapped)
        if len(mapped) <= 2:
            medoids.append(mapped[0])
        else:
            medoids.append(distmatrix.get_medoid(mapped))
    return output_clusters, medoids


def anallele_cluster_length(max_error: float, alleles: List[AnAllele],
                            indeces: List[int], distmatrix: DistMatrix,
                            device="cpu"
                            ) -> Tuple[List[List[int]], List[int]]:
    """Length-based allele clustering (:367-382). The pairwise fill is
    vectorized — |x-y|/max(x,y) elementwise float64, the same two ops as
    the scalar length_dist per pair. ``device``: the hclust route's."""
    n = len(indeces)
    lens = np.asarray([len(alleles[i].seq) for i in indeces],
                      dtype=np.float64)
    iu, ju = triu_pair_indices(n)
    li, lj = lens[iu], lens[ju]
    mx = np.maximum(li, lj)
    distmatrix.values = np.abs(li - lj) / np.maximum(mx, 1.0)
    clusters = cluter_to_e(max_error, n, distmatrix, device=device)
    return remap_cluster_indeces(distmatrix, indeces, clusters)


def generate_kusage(k: int, alleles: List[AnAllele],
                    indeces: List[int], device="cpu") -> List[Kusage]:
    """Batched counts + diversity (seqs/kmer.py::kusage_batch) —
    bit-identical to per-allele Kusage(seq2kcounts(...)) (parity-tested in
    tests/test_heuristics.py) at vector speed; seq2kcounts stays the
    scalar oracle. ``device``: where OTTER_TPU_KMER_DEVICE=1 counts."""
    return kusage_batch(k, [alleles[i].seq for i in indeces], device=device)


def anallele_cluster_kusage(max_error: float, k: int, alleles: List[AnAllele],
                            indeces: List[int], distmatrix: DistMatrix,
                            device="cpu"
                            ) -> Tuple[List[Kusage], List[List[int]], List[int]]:
    """3-mer-usage cosine-dissimilarity clustering (:402-420), with the
    reference's round-to-3-decimals and NaN->dist-1.0 handling.
    ``device``: the k-mer counts' and the hclust route's."""
    kusages = generate_kusage(k, alleles, indeces, device)
    # vectorized cosine-dissimilarity matrix: one GEMM over the usage
    # vectors instead of n^2/2 python dot calls, certified against the
    # scalar-dot oracle (kusage_cosine_condensed)
    n = len(kusages)
    V = np.stack([ku.vec for ku in kusages])  # (n, 4^k + 1)
    norms = np.asarray([ku.vnorm for ku in kusages])
    dots = V @ V.T
    with np.errstate(invalid="ignore", divide="ignore"):
        scaled = (dots / np.outer(norms, norms)) * 1000.0
    distmatrix.values = kusage_cosine_condensed(scaled, V, norms,
                                                _ROUND_GUARD)
    clusters = cluter_to_e(max_error, len(kusages), distmatrix,
                           device=device)
    out_clusters, reps = remap_cluster_indeces(distmatrix, indeces, clusters)
    return kusages, out_clusters, reps


def kusage_cosine_condensed(scaled: np.ndarray, V: np.ndarray,
                            norms: np.ndarray, guard: float) -> np.ndarray:
    """Condensed 1 - round3(cosine) distances from a PRE-ROUND scaled
    (n, n) similarity matrix computed by ANY backend (host f64 GEMM,
    cross-region batched einsum, device f32), certified against the
    scalar-dot oracle: entries within ``guard`` of a .5 round-to-3-decimals
    boundary are recomputed with the per-pair f64 np.dot, so every backend
    yields the byte-identical condensed matrix as long as its error is
    below the guard (f64 GEMM ~1e-13 vs guard 1e-9; device f32 einsum at
    Precision.HIGHEST ~4e-3 worst case vs guard 1e-2 — see
    models/genotype.py::_ROUND_GUARD_F32). NaN norms (total==0 alleles)
    round to similarity 0.0, the reference's handling."""
    n = V.shape[0]
    iu, ju = triu_pair_indices(n)
    sv = np.asarray(scaled, dtype=np.float64)[iu, ju].copy()
    finite = np.isfinite(sv)
    near = finite & (np.abs(np.abs(sv - np.floor(sv)) - 0.5) < guard)
    if np.any(near):
        for p in np.nonzero(near)[0]:
            i, j = int(iu[p]), int(ju[p])
            dot = float(np.dot(V[i], V[j]))
            sv[p] = (dot / (norms[i] * norms[j])) * 1000.0
    sims = np.where(sv >= 0, np.floor(sv + 0.5), np.ceil(sv - 0.5)) / 1000.0
    sims = np.where(np.isnan(norms[iu] * norms[ju]), 0.0, sims)
    return 1.0 - sims


def kusage_cosine_condensed_batch(scaled_list, V_list, norms_list,
                                  guard: float) -> List[np.ndarray]:
    """kusage_cosine_condensed over many regions at once: regions are
    grouped by allele count and the gather + boundary-certify + round ops
    run on stacked (G, n(n-1)/2) arrays — identical per-entry arithmetic,
    so each region's condensed matrix is byte-equal to the scalar call.
    Near-boundary entries still recompute with the per-pair f64 np.dot
    oracle."""
    out: List[Optional[np.ndarray]] = [None] * len(scaled_list)

    def _scaled_of(entry, norms):
        """Materialize a ("raw", S) entry — the raw GEMM dot matrix whose
        /(ni*nj)*1000 scaling the native pass applies inline — for the
        numpy fallback (same elementwise f64 ops, same result)."""
        if isinstance(entry, tuple) and entry[0] == "raw":
            with np.errstate(invalid="ignore", divide="ignore"):
                return (entry[1] / np.outer(norms, norms)) * 1000.0
        return np.asarray(entry, dtype=np.float64)

    groups: dict = {}
    for i, V in enumerate(V_list):
        groups.setdefault(V.shape[0], []).append(i)
    # native single-pass gather+round for big matrices (cohort scale): the
    # C++ kernel replicates the per-entry arithmetic below bit for bit and
    # returns the near-boundary positions for the np.dot oracle recompute
    # (otter_cosine_condensed; VERDICT r4 #5 — the numpy path's ~15
    # full-array passes dominated genotype500)
    if native.enabled("COSINE"):
        for n, members in list(groups.items()):
            if n < 256:
                continue
            done = []
            for i in members:
                entry = scaled_list[i]
                raw = isinstance(entry, tuple) and entry[0] == "raw"
                cond, near = native.cosine_condensed_native(
                    entry[1] if raw
                    else np.asarray(entry, dtype=np.float64),
                    norms_list[i], guard, prescaled=not raw)
                if cond is None:
                    # the near positions overflowed the native buffer: this
                    # matrix and the rest of its group take the numpy path
                    break
                if len(near):
                    V = V_list[i]
                    norms = norms_list[i]
                    iu, ju = triu_pair_indices(n)
                    for p in np.sort(near):
                        a, b = int(iu[p]), int(ju[p])
                        dot = float(np.dot(V[a], V[b]))
                        sv = (dot / (norms[a] * norms[b])) * 1000.0
                        sim = (np.floor(sv + 0.5) if sv >= 0
                               else np.ceil(sv - 0.5)) / 1000.0
                        if np.isnan(norms[a] * norms[b]):
                            sim = 0.0
                        cond[p] = 1.0 - sim
                out[i] = cond
                done.append(i)
            rest = [i for i in members if i not in done]
            if rest:
                groups[n] = rest
            else:
                del groups[n]
    for n, members in groups.items():
        iu, ju = triu_pair_indices(n)
        sv = np.stack([_scaled_of(scaled_list[i], norms_list[i])[iu, ju]
                       for i in members])
        finite = np.isfinite(sv)
        near = finite & (np.abs(np.abs(sv - np.floor(sv)) - 0.5) < guard)
        if np.any(near):
            for g, p in zip(*np.nonzero(near)):
                i = members[int(g)]
                a, b = int(iu[p]), int(ju[p])
                V = V_list[i]
                norms = norms_list[i]
                dot = float(np.dot(V[a], V[b]))
                sv[g, p] = (dot / (norms[a] * norms[b])) * 1000.0
        sims = np.where(sv >= 0, np.floor(sv + 0.5), np.ceil(sv - 0.5)) / 1000.0
        for g, i in enumerate(members):
            norms = norms_list[i]
            s = np.where(np.isnan(norms[iu] * norms[ju]), 0.0, sims[g])
            out[i] = 1.0 - s
    return out


def _cpp_round(x: float) -> float:
    """C++ std::round: halfway away from zero (Python round is banker's)."""
    import math
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def anallele_cluster(max_error_l: float, max_error_c: float,
                     alleles: List[AnAllele], genotypes: List[Genotype],
                     precomputed: Optional[dict] = None,
                     hsd_indices: Optional[List[int]] = None,
                     device="cpu") -> Tuple[int, List[int]]:
    """Joint (length x kusage) allele clustering (:463-527).

    Returns (total final clusters, representative allele per cluster).
    ``precomputed`` (the batched genotype pipeline) may carry
    ``length_values`` / ``kusage_values`` condensed distance matrices and
    ``kusages``; they must be byte-identical to what this function would
    compute (the device path certifies, models/genotype.py) — everything
    downstream (hclust, cutree, joint labels, medoids) is shared code.
    ``device``: the card (or the CPU) of the opt-in device routes, K10's
    k-mer counts and K11's linkage.
    """
    allele_indeces = list(range(len(alleles)))
    pre = precomputed or {}

    distmatrix_length = DistMatrix(len(allele_indeces))
    if "length_values" in pre:
        distmatrix_length.values = pre["length_values"]
        length_clusters = cluter_to_e(max_error_l, len(allele_indeces),
                                      distmatrix_length,
                                      dendro=pre.get("length_dendro"),
                                      device=device)
        length_clusters, length_reps = remap_cluster_indeces(
            distmatrix_length, allele_indeces, length_clusters)
    else:
        length_clusters, length_reps = anallele_cluster_length(
            max_error_l, alleles, allele_indeces, distmatrix_length,
            device)
    if len(length_reps) != len(length_clusters):
        sys.stderr.write(
            f"[ERROR] unexpected number of representative alleles "
            f"({len(length_reps)}) for {len(length_clusters)} length clusters\n")
        raise SystemExit(1)
    for i, cluster in enumerate(length_clusters):
        for j in cluster:
            genotypes[j].gt_l = i

    distmatrix_kusage = DistMatrix(len(allele_indeces))
    if "kusage_values" in pre:
        distmatrix_kusage.values = pre["kusage_values"]
        kusages = pre["kusages"]
        kusage_clusters = cluter_to_e(max_error_c, len(allele_indeces),
                                      distmatrix_kusage,
                                      dendro=pre.get("kusage_dendro"),
                                      device=device)
        kusage_clusters, kusage_reps = remap_cluster_indeces(
            distmatrix_kusage, allele_indeces, kusage_clusters)
    else:
        kusages, kusage_clusters, kusage_reps = anallele_cluster_kusage(
            max_error_c, 3, alleles, allele_indeces, distmatrix_kusage,
            device)
    if len(kusage_reps) != len(kusage_clusters):
        sys.stderr.write(
            f"[ERROR] unexpected representative alleles "
            f"({len(kusage_reps)}) for {len(kusage_clusters)} kusage clusters\n")
        raise SystemExit(1)
    for i, cluster in enumerate(kusage_clusters):
        for j in cluster:
            genotypes[j].gt_k = i

    # joint label = (gt_l, gt_k) intersection in first-seen order (:500-516).
    # Vectorized: key = (gt_l, gt_k); clusters ordered by first occurrence,
    # members in ascending index — exactly the scalar remaining-list scan.
    n_all = len(alleles)
    gl = np.fromiter((genotypes[j].gt_l for j in range(n_all)),
                     dtype=np.int64, count=n_all)
    gk = np.fromiter((genotypes[j].gt_k for j in range(n_all)),
                     dtype=np.int64, count=n_all)
    keys = gl * (np.int64(n_all) + 1) + gk  # gt_k in [0, n_all)
    uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    by_first = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[by_first] = np.arange(len(uniq))
    cluster_of = rank[inv]
    order = np.argsort(cluster_of, kind="stable")
    counts = np.bincount(cluster_of, minlength=len(uniq))
    final_clusters: List[List[int]] = []
    pos = 0
    for c in counts:
        final_clusters.append(order[pos : pos + int(c)].tolist())
        pos += int(c)
    gt_reps: List[int] = []
    for i, cluster in enumerate(final_clusters):
        for j in cluster:
            genotypes[j].gt = i
        gt_reps.append(int(distmatrix_length.get_medoid(cluster)))
    # HSD is only ever emitted for representative alleles (and the
    # reference allele, genotype.cpp:49-53 via the re-centered reps), so
    # compute the diversity just where it can be read; hsdiv() is
    # bit-identical scalar-on-demand when the batch precompute is off.
    # CONTRACT: non-representative Genotype.hsd stays at the -1.0
    # sentinel (the reference sets it for every member,
    # otterclust.cpp:496) — a consumer reading hsd of a non-rep must
    # compute it itself, never assume reference-equivalent internal state
    hsd_need = set(gt_reps)
    if hsd_indices is not None:
        hsd_need.update(j for j in hsd_indices
                        if 0 <= j < len(alleles))
    else:
        hsd_need.update(range(len(alleles)))
    for j in hsd_need:
        genotypes[j].hsd = kusages[j].hsdiv()
    return len(final_clusters), gt_reps
