"""``otter wgat`` on the PyTorch port (parity with src/wgat.cpp).

Counterpart of ``otter_tpu/models/wgat.py``; host code. Whole-genome-
assembly genotyping: interval tree over offset BED regions
(wgat.cpp:19-29), per-contig scan of alignments (:148), CIGAR -> op-interval
projection, sorted op-overlap walk with DEL/clip edge cases (:61-99), and
ANALLELE emission with the sp tag (:104-114).
"""

from __future__ import annotations

import io
import sys
from typing import List, Optional, TextIO

import numpy as np

from ..config import OtterOpts
from ..io.bam import (
    BAM_CDEL,
    BAM_CHARD_CLIP,
    BAM_CSOFT_CLIP,
    BamReader,
)
from ..io.bed import BED, parse_bed_file
from ..seqs.model import AnAllele
from ..seqs.opinterval import get_op_intervals
from ..utils.interval_tree import Interval, IntervalTree
from ..utils.timestamp import antimestamp


def construct_bed_interval_tree(offset_l: int, offset_r: int,
                                bed_regions: List[BED]) -> IntervalTree:
    """(wgat.cpp:19-29)"""
    ivals = [
        Interval(bed_regions[i].start - offset_l, bed_regions[i].end + offset_r, i)
        for i in range(len(bed_regions))
    ]
    tree = IntervalTree(ivals)
    sys.stderr.write(
        f"({antimestamp()}): Constructed interval tree for {len(bed_regions)} "
        f"target regions\n")
    return tree


def wga_bam_genotyper_process(params: OtterOpts, bed_regions: List[BED],
                              bed_tree: IntervalTree, chrom_region: str,
                              chrom_name: str, bam: BamReader,
                              out: TextIO) -> None:
    """Per-contig alignment walk (wgat.cpp:31-124)."""
    chrom, coords = chrom_region.split(":")
    lo, hi = coords.split("-")
    alignment_index = 0
    for rec in bam.fetch(chrom, int(lo) - 1, int(hi)):
        if rec.l_qseq <= 0:
            continue
        ref_end_pos = rec.pos + rec.ref_len()
        bed_overlaps = [
            ov for ov in bed_tree.find_overlapping(rec.pos, ref_end_pos)
            if bed_regions[ov.value].chr == chrom_name
        ]
        if bed_overlaps:
            name = rec.name
            ref_positions, query_positions = get_op_intervals(rec)
            if len(ref_positions) != len(query_positions):
                sys.stderr.write(
                    f"{antimestamp()}): Unexpected number of ref and query "
                    f"OP-intervals: {len(ref_positions)} vs {len(query_positions)}\n")
                raise SystemExit(1)
            # op ref-intervals are monotone in cigar order (rpos only grows),
            # so the ops overlapping a closed range [s, e] form a contiguous
            # slice — two binary searches replace the reference's
            # per-alignment interval tree (wgat.cpp:57-60), and cigar order
            # equals the (start, stop) sort the reference applies (:65-68)
            op_starts = np.fromiter((r[0] for r in ref_positions),
                                    dtype=np.int64,
                                    count=len(ref_positions))
            op_stops = np.fromiter((r[1] for r in ref_positions),
                                   dtype=np.int64, count=len(ref_positions))
            for overlap in bed_overlaps:
                local_bed = bed_regions[overlap.value]
                lo = int(np.searchsorted(op_stops, overlap.start, side="left"))
                hi = int(np.searchsorted(op_starts, overlap.stop,
                                         side="right"))
                bed_op_overlaps = [
                    Interval(int(op_starts[i]), int(op_stops[i]), i)
                    for i in range(lo, hi)
                ]
                clipped_l = False
                clipped_r = False
                query_start = 0
                query_end = 0
                brk = False
                for i, op_ref in enumerate(bed_op_overlaps):
                    op_query = query_positions[op_ref.value]
                    if op_query.op in (BAM_CSOFT_CLIP, BAM_CHARD_CLIP):
                        if i == 0:
                            clipped_l = True
                            query_start = op_query.end
                        else:
                            clipped_r = True
                            query_end = op_query.start
                    else:
                        if i == 0:
                            if op_query.op == BAM_CDEL:
                                if op_ref.start <= overlap.start and op_ref.stop >= overlap.stop:
                                    brk = True
                                    break
                                query_start = op_query.start
                            else:
                                query_start = op_query.start + (overlap.start - op_ref.start)
                        if i + 1 == len(bed_op_overlaps):
                            if op_query.op == BAM_CDEL:
                                query_end = op_query.end
                            else:
                                query_end = op_query.end - (op_ref.stop - overlap.stop)
                if brk:
                    continue
                if clipped_l or clipped_r:
                    sys.stderr.write(
                        f"{antimestamp()}): [WARNING] skipping non-spanning "
                        f"whole-genome alignment at {local_bed.to_sc_string()} "
                        f"for: {name}\n")
                else:
                    seq = rec.seq[query_start:query_end]
                    if not seq:
                        seq = "N"
                    allele = AnAllele(seq=seq)
                    if params.is_fa:
                        out.write(allele.to_fa(
                            params.read_group,
                            f"{name}#{local_bed.to_sc_string()}#{alignment_index}",
                            True, not clipped_l, not clipped_r) + "\n")
                    else:
                        out.write(allele.to_sam(
                            f"{name}#{local_bed.to_sc_string()}_{alignment_index}",
                            local_bed.chr, local_bed.start, local_bed.end,
                            params.read_group, True, not clipped_l,
                            not clipped_r) + "\n")
        alignment_index += 1


def wga_bam_genotyper(params: OtterOpts, bam_path: str,
                      bed_regions: List[BED], out: TextIO) -> None:
    """(wgat.cpp:127-158)"""
    bed_tree = construct_bed_interval_tree(params.offset_l, params.offset_r,
                                           bed_regions)
    hdr = BamReader(bam_path, load_index=False)
    ref_chrms = [
        f"{name}:1-{ln}" for name, ln in zip(hdr.ref_names, hdr.ref_lens)
    ]
    chrom_names = list(hdr.ref_names)
    hdr.close()
    sys.stderr.write(
        f"({antimestamp()}): Parallelising across {len(ref_chrms)} contigs\n")
    n_threads = max(1, int(getattr(params, "threads", 1) or 1))
    if n_threads <= 1 or len(ref_chrms) <= 1:
        bam = BamReader(bam_path, load_index=True)
        if bam.index is None:
            sys.stderr.write(
                f"({antimestamp()}): [WARNING] index not found for "
                f"{bam_path}; using linear scan\n")
        for chrom_region, chrom_name in zip(ref_chrms, chrom_names):
            wga_bam_genotyper_process(params, bed_regions, bed_tree,
                                      chrom_region, chrom_name, bam, out)
        bam.close()
        return
    # contig thread pool with per-thread BamReader handles (the
    # reference's parallelize_loop over contigs + stdout mutex,
    # wgat.cpp:148; emission here is in CONTIG ORDER, so -t N output is
    # byte-identical to -t 1; exception-propagating pool in utils/pool.py)
    from ..utils.pool import ordered_thread_map

    def run_item(bam, i):
        buf = io.StringIO()
        wga_bam_genotyper_process(params, bed_regions, bed_tree,
                                  ref_chrms[i], chrom_names[i], bam, buf)
        return buf.getvalue()

    results = ordered_thread_map(
        len(ref_chrms), n_threads,
        lambda: BamReader(bam_path, load_index=True), run_item,
        lambda bam: bam.close())
    for text in results:
        if text:
            out.write(text)


def wgat(params: OtterOpts, input_path: str, bed_file: str,
         out: Optional[TextIO] = None) -> None:
    """(wgat.cpp:161-179): BAM-only input (extension check)."""
    if out is None:
        out = sys.stdout
    bed_regions = parse_bed_file(bed_file)
    if input_path.rsplit(".", 1)[-1] == "bam":
        if not params.is_fa:
            hdr = BamReader(input_path, load_index=True)
            for name, ln in zip(hdr.ref_names, hdr.ref_lens):
                out.write(f"@SQ\tSN:{name}\tLN:{ln}\n")
            out.write(f"@RG\tID:{params.read_group}\n")
            out.write(f"@PG\tID:otter\tOF:{params.offset_l},{params.offset_r}\n")
            hdr.close()
        wga_bam_genotyper(params, input_path, bed_regions, out)
    else:
        # the reference silently ignores non-.bam inputs (wgat.cpp:164-177
        # has no else-branch); we keep the no-op but say so — wgat needs an
        # ALIGNED assembly (CIGARs project ROIs onto contigs), so a FASTA
        # has nothing to genotype until it is aligned to the reference
        sys.stderr.write(
            f"({antimestamp()}): [WARNING] unsupported input (expected .bam "
            f"of aligned assembly contigs): {input_path}; nothing emitted. "
            f"Align the assembly first (e.g. minimap2 -a) and pass the "
            f"indexed BAM.\n")
