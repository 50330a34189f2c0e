"""``otter compare`` (hidden) on the PyTorch port (parity with
src/compare.cpp).

Counterpart of ``otter_tpu/models/compare.py``: per region, all-vs-all
edit distances between a "truth" otter BAM and a query otter BAM, picking
the 2 best disjoint (i, j) edges and emitting a TSV (compare.cpp:50-147).
The distances of every region come from one pooled call to the port's
distance engine (kernels K1, K3, K2 and K7 by its routes), then one batched
composite DP gives the (edit, cols) values: byte-identical to the scalar
host path (``get_distances`` without hints).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, TextIO

from ..config import OtterOpts
from ..io.bam import BamReader
from ..io.bed import BED, parse_bed_file
from ..io.sample_index import SampleIndex
from ..kernels.dist_backend import TorchDistBackend
from ..ops.align_np import edit_align_cigar_len
from ..seqs.extract import parse_anallele, parse_analleles
from ..seqs.model import AnAllele
from ..utils.timestamp import antimestamp


@dataclass
class DistCompare:
    i: int
    j: int
    edit: float
    ops: float


def local_parse_analleles(bam: BamReader, bed: BED, sample2index: Dict[str, int]):
    """(compare.cpp:26-48): like parse_analleles but records the sp tag and
    keeps only reads whose name starts with the region's chromosome."""
    anallele_block: List[AnAllele] = []
    allele_sample_indeces: List[int] = []
    spannings: List[int] = []
    for rec in bam.fetch(bed.chr, bed.start, bed.end):
        name = rec.name
        if name[: len(bed.chr)] == bed.chr:
            spanning = rec.get_aux("sp")
            spanning = spanning if isinstance(spanning, str) else "u"
            before = len(anallele_block)
            parse_anallele(bed.to_sc_string(), sample2index, rec,
                           anallele_block, allele_sample_indeces)
            if len(anallele_block) > before:
                spannings.append({"u": -1, "b": 0, "l": 1, "r": 2, "n": 3}.get(spanning, -1))
    return anallele_block, allele_sample_indeces, spannings


def get_distances(subjs: List[AnAllele], querys: List[AnAllele],
                  hints: Optional[Dict] = None) -> List[DistCompare]:
    """(compare.cpp:50-66) including the N/NDNNN special cases.

    ``hints``: optional {(i, j): (edit, cols)} precomputed by the pooled
    engine path (pooled_compare_results); identical values to the scalar
    DP, so output is byte-identical with or without them."""
    distances: List[DistCompare] = []
    for i, subj_a in enumerate(subjs):
        subj = subj_a.seq
        for j, query_a in enumerate(querys):
            query = query_a.seq
            if subj == query or (subj == "N" and query == "NDNNN") or \
                    (query == "N" and subj == "NDNNN"):
                distances.append(DistCompare(i, j, 0, len(query)))
            elif subj in ("N", "NDNNN") or query in ("N", "NDNNN"):
                distances.append(DistCompare(i, j, len(query) - 1, len(query)))
            else:
                pre = None if hints is None else hints.get((i, j))
                if pre is not None:
                    edit, ops = pre
                elif len(subj) > len(query):
                    edit, ops = edit_align_cigar_len(subj, query)
                else:
                    edit, ops = edit_align_cigar_len(query, subj)
                distances.append(DistCompare(i, j, edit, ops))
    return distances


def pooled_compare_results(kept, dist_backend) -> List[Optional[Dict]]:
    """One pooled engine call for every region's all-vs-all truth x query
    pairs: the exact edit distances come back batched from the engine that
    serves assemble's distance matrices, then ONE batched composite DP
    (ops/align_batch.py::edit_cigar_cols_batch, band seeded at each pair's
    exact distance) produces the (edit, cols) values. Special-case pairs
    (equal seqs, N/NDNNN, compare.cpp:56-57) never reach the engine.
    Returns per-region {(i, j): (edit, cols)} or None (no engine pair). A
    failure of the engine raises."""
    from ..ops.align_batch import edit_cigar_cols_batch

    results: List[Optional[Dict]] = [None] * len(kept)
    flat_pairs = []
    owners = []
    for ridx, (_rs, subjs, _sp, querys) in enumerate(kept):
        for i, subj_a in enumerate(subjs):
            subj = subj_a.seq
            for j, query_a in enumerate(querys):
                query = query_a.seq
                if subj == query or subj in ("N", "NDNNN") or \
                        query in ("N", "NDNNN"):
                    continue
                # compare.cpp's pattern/text order: longer first, query
                # on ties (compare.cpp:58-61)
                if len(subj) > len(query):
                    flat_pairs.append((subj, query))
                else:
                    flat_pairs.append((query, subj))
                owners.append((ridx, i, j))
    if not flat_pairs:
        return results
    dists = dist_backend.engine.distances(flat_pairs)
    pair_results = edit_cigar_cols_batch(flat_pairs, dists)
    for (ridx, i, j), res in zip(owners, pair_results):
        if results[ridx] is None:
            results[ridx] = {}
        results[ridx][(i, j)] = res
    return results


def compare(params: OtterOpts, bed_file: str, reference: str, target: str,
            out: Optional[TextIO] = None, dist_backend=None,
            pooled: bool = True) -> None:
    """(compare.cpp:68-150). The pooled engine call takes the distances
    (``dist_backend`` defaults to the engine for ``params.device``);
    ``pooled=False``, or ``params.device == "host"``, runs the scalar host
    DP of every pair instead, with the python allele parser: the path the
    pooled one must equal byte for byte. Under ``host`` no engine is
    built."""
    if out is None:
        out = sys.stdout
    if params.device == "host":
        if dist_backend is not None:
            raise ValueError('device "host" runs no engine')
        pooled = False
    if pooled and dist_backend is None:
        dist_backend = TorchDistBackend(params.device)
    regions = parse_bed_file(bed_file)
    bam_ref = BamReader(reference, load_index=True)
    bam_target = BamReader(target, load_index=True)
    sample2index: Dict[str, int] = {}
    si = SampleIndex()
    si.init(reference)
    sample2index[si.index2sample[0]] = 0
    sit = SampleIndex()
    sit.init(target)
    sample2index[sit.index2sample[0]] = 1

    # pass 1: parse every region (warnings to stderr as in compare.cpp),
    # keeping the survivors for the pooled distance call
    kept = []
    for region in regions:
        region_str = region.to_sc_string()
        reference_alleles, _, reference_spannings = local_parse_analleles(
            bam_ref, region, sample2index)
        query_alleles, _ = parse_analleles(params, bam_target, region, sample2index)
        if len(query_alleles) == 1:
            query_alleles.append(query_alleles[0])
        if len(reference_alleles) > 2:
            sys.stderr.write(
                f"({antimestamp()}): WARNING: skipping region due to multiple "
                f"expected alignments (>2) for region: {region_str}\n")
        elif len(reference_alleles) == 1:
            sys.stderr.write(
                f"({antimestamp()}): WARNING: skipping region due to single "
                f"expected alignment for region: {region_str}\n")
        elif len(reference_alleles) == 0:
            sys.stderr.write(
                f"({antimestamp()}): WARNING: skipping region due no expected "
                f"alignments for region: {region_str}\n")
        elif len(query_alleles) == 0:
            sys.stderr.write(
                f"({antimestamp()}): WARNING: skipping region due no query "
                f"alleles for region: {region_str}\n")
        else:
            kept.append((region_str, reference_alleles, reference_spannings,
                         query_alleles))
    # pass 2: ONE pooled engine call across every region's pairs, then
    # per-region edge selection + TSV
    hints_by_region = (pooled_compare_results(kept, dist_backend) if pooled
                       else [None] * len(kept))
    for (region_str, reference_alleles, reference_spannings,
         query_alleles), hints in zip(kept, hints_by_region):
        dist_edges = get_distances(reference_alleles, query_alleles, hints)
        dist_edges.sort(key=lambda x: (x.edit, x.ops))
        edge_0 = dist_edges[0]
        edge_1_j = 1
        while edge_1_j < len(dist_edges):
            edge_1 = dist_edges[edge_1_j]
            if edge_1.i != edge_0.i and edge_1.j != edge_0.j:
                break
            edge_1_j += 1
        if edge_1_j >= len(dist_edges):
            edge_1_j = len(dist_edges) - 1
        for i in (0, edge_1_j):
            min_edge = dist_edges[i]
            out.write(
                f"{region_str}\t{len(reference_alleles[min_edge.i].seq)}\t"
                f"{len(query_alleles[min_edge.j].seq)}\t"
                f"{reference_spannings[min_edge.i]}\t"
                f"{_fmt_num(min_edge.edit)}\t{_fmt_num(min_edge.ops)}\n")
    bam_ref.close()
    bam_target.close()


def _fmt_num(x: float) -> str:
    """C++ streams doubles holding integers as integers."""
    return str(int(x)) if float(x).is_integer() else ("%g" % x)
