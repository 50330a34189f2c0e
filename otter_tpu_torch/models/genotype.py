"""``otter genotype`` on the PyTorch port (parity with src/genotype.cpp).

Counterpart of ``otter_tpu/models/genotype.py``: joint genotyping of
merged otter BAMs. Sample index from @RG/@PG header lines, internal
reference sample OTTER_INTREF appended (genotype.cpp:175-189); per region
allele re-parse, reference allele fetch, diploid (min, max) pairing, joint
length x 3-mer clustering, GT re-centering so the reference allele is GT 0,
and VCF emission (genotype.cpp:16-67, 80-164). Under a coordinator
(``parallel/distributed.py``) each process handles its block of regions.

With a reference and more than one region, the regions go through the
batched pipeline (``genotype_process_batched``), whose pooled cosine GEMM
runs as host float64 BLAS, or, with ``OTTER_TPU_GENOTYPE_DEVICE=1``, as one
f32 ``torch.bmm`` on ``device``; both are certified against the scalar f64
oracle, so the VCF is byte-identical to the sequential host path.

``device="host"`` is the JAX package's pure-host exact mode: the
sequential path (a region thread pool at -t > 1), the python allele
parser, no process sharding; a setting that routes to a device function
runs its plain version on the CPU.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
from typing import List, Optional, TextIO, Tuple

import numpy as np

from .. import native
from ..config import OtterOpts
from ..io.bam import BamReader
from ..io.bed import BED, parse_bed_file
from ..io.fasta import Faidx
from ..io.sample_index import SampleIndex
from ..ops.cluster import Genotype, anallele_cluster
from ..seqs.extract import parse_analleles
from ..seqs.model import AnAllele
from ..utils import metrics
from ..utils.fmt import fmt_double, fmt_float
from ..utils.timestamp import antimestamp

REFNAME = "OTTER_INTREF"
DEVICES = ("cuda", "cpu", "mesh", "host")


def output_vcf_header(bam_path: str, sample_index: List[str], ref_name: str,
                      out: TextIO) -> None:
    """(genotype.cpp:16-37)"""
    rd = BamReader(bam_path, load_index=True)
    out.write("##fileformat=VCFv4.2\n")
    for name, ln in zip(rd.ref_names, rd.ref_lens):
        out.write(f"##contig=<ID={name},length={ln}>\n")
    rd.close()
    out.write(
        '##INFO=<ID=HSD,Number=R,Type=Float,Description="Hill-Shannon Diversity Metric">\n'
        '##ALT=<ID=DEL,Description="Deletion">\n'
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase Set">\n'
        '##FORMAT=<ID=HP,Number=1,Type=Integer,Description="Haplotype Identifier">\n'
        '##FORMAT=<ID=TC,Number=1,Type=Integer,Description="Total Coverage of Region">\n'
        '##FORMAT=<ID=AC,Number=2,Type=Integer,Description="Total Coverage For Each Allele">\n'
        '##FORMAT=<ID=SC,Number=2,Type=Integer,Description="Total Coverage of Spanning Reads For Each Allele">\n'
        '##FORMAT=<ID=SE,Number=2,Type=Float,Description="Standard Mean Error of Spanning Reads For Each Allele">\n'
    )
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT")
    for sample in sample_index:
        if sample != ref_name:
            out.write("\t" + sample)
    out.write("\n")


def output_vcf_line(offset_l: int, offset_r: int, region: BED, si: SampleIndex,
                    ref_allele_index: int, alleles: List[AnAllele],
                    genotypes: List[Genotype], reps: List[int],
                    sample2localindeces: List[Optional[Tuple[int, int]]],
                    out: TextIO) -> None:
    """(genotype.cpp:39-67)"""
    parts = [f"{region.chr}\t{1 + region.start - offset_l}\t{region.to_sc_string()}\t"
             f"{alleles[ref_allele_index].seq}\t"]
    if len(reps) == 1:
        parts.append(".")
    else:
        for i in range(1, len(reps)):
            if i > 1:
                parts.append(",")
            parts.append("<DEL>" if alleles[reps[i]].seq == "N" else alleles[reps[i]].seq)
    parts.append("\t.\t.\tHSD=")
    for i in range(len(reps)):
        if i > 0:
            parts.append(",")
        parts.append(fmt_double(genotypes[reps[i]].hsd))
    parts.append("\tGT:PS:HP:TC:AC:SC:SE")
    for i in range(len(sample2localindeces) - 1):
        pair = sample2localindeces[i]
        if pair is None:
            parts.append("\t./.:.:.:.:.:.:.")
        else:
            a1 = alleles[pair[0]]
            a2 = alleles[pair[1]]
            if a1.hpt != a2.hpt:
                sys.stderr.write(
                    f"({antimestamp()}): [WARNING] mismatching phased information for "
                    f"{si.index2sample[i]}: allele1=PS:{a1.hpt.ps}:HP:{a1.hpt.hp} "
                    f"allele2=PS:{a1.hpt.ps}:HP:{a1.hpt.hp}\n")
            parts.append(
                f"\t{genotypes[pair[0]].gt}/{genotypes[pair[1]].gt}:{a1.hpt.ps}:"
                f"{a1.hpt.hp}:{a1.tcov}:{a1.acov},{a2.acov}:{a1.scov},{a2.scov}:"
                f"{fmt_float(a1.se)},{fmt_float(a2.se)}")
    parts.append("\n")
    out.write("".join(parts))


def _genotype_prep(params: OtterOpts, region: BED, bam: BamReader,
                   faidx: Optional[Faidx], si: SampleIndex, refindex: int,
                   out: TextIO):
    """Everything in genotype_region before clustering: allele parse, ref
    allele fetch, sample->local-allele mapping. Returns None when the
    region is fully handled here (warning, or the no-reference TSV mode);
    otherwise (anallele_block, allele_sample_indeces, ref_allele_index,
    sample2localindeces)."""
    anallele_block, allele_sample_indeces = parse_analleles(
        params, bam, region, si.sample2index)
    if len(anallele_block) != len(allele_sample_indeces):
        sys.stderr.write(
            f"({antimestamp()}): [ERROR] expected matching total number of alleles "
            f"and samples: {len(anallele_block)} vs {len(allele_sample_indeces)}\n")
        raise SystemExit(1)
    if not anallele_block:
        sys.stderr.write(
            f"({antimestamp()}): [WARNING] no alleles found for "
            f"{region.to_sc_string()}\n")
        return None
    ref_allele_index = -1
    if faidx is not None:
        refseq = faidx.fetch(region.chr, region.start - si.offset_l,
                             region.end + si.offset_r - 1)
        ref_allele_index = len(allele_sample_indeces)
        allele_sample_indeces.append(refindex)
        anallele_block.append(AnAllele(seq=refseq))
    # diploid pairing (genotype.cpp:103-111): the (min, max) allele index
    # per sample is its first and last occurrence in the ascending walk
    sample2localindeces: List[Optional[Tuple[int, int]]] = [None] * len(si.sample2index)
    if allele_sample_indeces:
        arr = np.asarray(allele_sample_indeces, dtype=np.int64)
        uniq, first = np.unique(arr, return_index=True)
        rev_last = arr.size - 1 - np.unique(arr[::-1], return_index=True)[1]
        for s, lo, hi in zip(uniq.tolist(), first.tolist(),
                             rev_last.tolist()):
            sample2localindeces[s] = (lo, hi)
    if faidx is None:
        for i in range(len(si.sample2index)):
            pair = sample2localindeces[i]
            if pair is not None and i != refindex:
                a1 = len(anallele_block[pair[0]].seq)
                a2 = len(anallele_block[pair[1]].seq)
                out.write(f"{region.to_sc_string()}\t{si.index2sample[i]}\t"
                          f"{min(a1, a2)}\t{max(a1, a2)}\n")
        return None
    return (anallele_block, allele_sample_indeces, ref_allele_index,
            sample2localindeces)


def genotype_card(params: OtterOpts, mesh=None):
    """The one device of genotype's opt-in K10 counts and K11 linkage:
    ``params.device``, in mesh mode the mesh's first card, and under
    ``host`` the CPU (the functions' plain versions)."""
    if mesh is not None:
        return mesh[0]
    if params.device == "mesh":
        from ..parallel.mesh import make_mesh

        return make_mesh()[0]
    if params.device == "host":
        return "cpu"
    return params.device


def genotype_region(params: OtterOpts, region: BED, bam: BamReader,
                    faidx: Optional[Faidx], si: SampleIndex, refindex: int,
                    out: TextIO, precomputed: Optional[dict] = None,
                    prep=None, device=None) -> None:
    """(genotype.cpp:80-165). ``device``: ``genotype_card``'s (by default
    from ``params``)."""
    if prep is None:
        prep = _genotype_prep(params, region, bam, faidx, si, refindex, out)
    if prep is None:
        return
    (anallele_block, allele_sample_indeces, ref_allele_index,
     sample2localindeces) = prep
    genotypes = [Genotype() for _ in range(len(anallele_block))]
    acc_gt, gt_reps = anallele_cluster(params.max_error, params.max_cosdis,
                                       anallele_block, genotypes,
                                       precomputed=precomputed,
                                       hsd_indices=[ref_allele_index],
                                       device=(genotype_card(params)
                                               if device is None
                                               else device))
    if acc_gt != len(gt_reps):
        sys.stderr.write(
            f"({antimestamp()}): ERROR unexpected representative alleles "
            f"({len(gt_reps)}) for {acc_gt} total alleles\n")
        raise SystemExit(1)
    ref_gt = genotypes[ref_allele_index].gt
    gt_reps_centered = list(gt_reps)
    for i in range(len(gt_reps_centered)):
        if i == 0:
            gt_reps_centered[0] = ref_allele_index
        elif i <= ref_gt:
            gt_reps_centered[i] = gt_reps[i - 1]
    for g in genotypes:
        if g.gt == ref_gt:
            g.gt = 0
        elif g.gt < ref_gt:
            g.gt += 1
    output_vcf_line(si.offset_l, si.offset_r, region, si, ref_allele_index,
                    anallele_block, genotypes, gt_reps_centered,
                    sample2localindeces, out)


def genotype_process(params: OtterOpts, bam_path: str, regions: List[BED],
                     reference: str, si: SampleIndex, refindex: int,
                     out: TextIO, batched: bool = True, mesh=None) -> None:
    """The batched pipeline with a reference and more than one region
    (unless ``batched`` is False; ``mesh``: its GEMM's devices); otherwise
    sequential at -t 1 and a region thread pool above (the reference
    parallelizes over regions with a stdout mutex, genotype.cpp:71-78;
    emission here is in REGION ORDER, so -t N output is byte-identical to
    -t 1)."""
    if batched and reference and len(regions) > 1:
        genotype_process_batched(params, bam_path, regions, reference, si,
                                 refindex, out, mesh=mesh)
        return
    n_threads = max(1, int(params.threads or 1))
    if n_threads <= 1 or len(regions) <= 1:
        bam = BamReader(bam_path, load_index=True)
        faidx = Faidx(reference) if reference else None
        for region in regions:
            genotype_region(params, region, bam, faidx, si, refindex, out)
        bam.close()
        if faidx is not None:
            faidx.close()
        return
    results = _pooled_regions(params, bam_path, regions, reference, si,
                              refindex, n_threads, prep_only=False)
    for text, _prep in results:
        if text:
            out.write(text)


def _pooled_regions(params: OtterOpts, bam_path: str, regions: List[BED],
                    reference: str, si: SampleIndex, refindex: int,
                    n_threads: int, prep_only: bool):
    """Region thread pool with per-thread BamReader/Faidx handles (the
    reference's BS_thread_pool pattern, genotype.cpp:71-78). Returns
    per-region (emitted_text, prep) in region order; with prep_only the
    workers stop before clustering (the batched pipeline takes over)."""
    from ..utils.pool import ordered_thread_map

    def make_ctx():
        return (BamReader(bam_path, load_index=True),
                Faidx(reference) if reference else None)

    def run_item(ctx, i):
        bam, faidx = ctx
        buf = io.StringIO()
        if prep_only:
            prep = _genotype_prep(params, regions[i], bam, faidx,
                                  si, refindex, buf)
            return (buf.getvalue(), prep)
        genotype_region(params, regions[i], bam, faidx, si, refindex, buf)
        return (buf.getvalue(), None)

    def close_ctx(ctx):
        bam, faidx = ctx
        bam.close()
        if faidx is not None:
            faidx.close()

    return ordered_thread_map(len(regions), n_threads, make_ctx, run_item,
                              close_ctx)


# f32 GEMM error bound: a 65-term f32 dot accumulates ~65*2^-24 relative
# error; scaled values reach 1000, so the absolute error stays under ~4e-3.
# The 1e-2 guard recomputes every pair the f32 GEMM could have mis-rounded
# (a few percent) with the scalar f64 oracle.
_ROUND_GUARD_F32 = 1e-2


@contextlib.contextmanager
def _full_f32_matmul():
    """cuBLAS float32 products in full float32 for the block, whatever the
    caller set: TF32's ~2^-11 relative error would void the guard's
    65 * 2^-24 error model. The caller's setting comes back afterwards."""
    import torch

    mm = torch.backends.cuda.matmul
    if hasattr(mm, "fp32_precision"):
        prev = mm.fp32_precision
        mm.fp32_precision = "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = prev
    else:
        prev = mm.allow_tf32
        mm.allow_tf32 = False
        try:
            yield
        finally:
            mm.allow_tf32 = prev


def cosine_gemm_f32(Vs: List[np.ndarray], devices) -> np.ndarray:
    """Every region's (n, n) usage-vector dot matrix as batched f32
    ``torch.bmm`` over the zero-padded (R, n_max, width) batch: ONE on a
    device, or one on each shard of a mesh (a sequence of devices) over
    its contiguous block of regions, every shard launched before any is
    copied back, as the JAX package shards the region axis. Returns the
    (R, n_max, n_max) products in float64."""
    import torch

    from ..parallel.mesh import as_mesh, shard_rows

    mesh = as_mesh(devices)
    n_max = max(V.shape[0] for V in Vs)
    Vp = np.zeros((len(Vs), n_max, Vs[0].shape[1]), dtype=np.float32)
    for bi, V in enumerate(Vs):
        Vp[bi, : V.shape[0]] = V
    parts = []
    with _full_f32_matmul():
        for dev, (lo, hi) in zip(mesh, shard_rows(len(Vs), mesh)):
            if lo < hi:
                X = torch.from_numpy(Vp[lo:hi]).to(dev)
                parts.append(torch.bmm(X, X.transpose(1, 2)))
    return np.concatenate([S.cpu().numpy() for S in parts]).astype(
        np.float64)


def _use_device_gemm() -> bool:
    """OTTER_TPU_GENOTYPE_DEVICE=1 takes the f32 GEMM on ``params.device``;
    by default (or =0) the host f64 BLAS takes it, on the card too: there
    the f32 route's 1e-2 guard sends thousands of entries to the scalar
    recompute, and it ties or loses to host BLAS on an H100 (PERF.md),
    as the JAX package routes off a TPU."""
    return os.environ.get("OTTER_TPU_GENOTYPE_DEVICE", "") == "1"


def genotype_process_batched(params: OtterOpts, bam_path: str,
                             regions: List[BED], reference: str,
                             si: SampleIndex, refindex: int,
                             out: TextIO, mesh=None) -> None:
    """Assemble-style pooled genotype pipeline (otterclust.cpp:367-420,
    463-527 semantics, batched across regions):

      1. threaded region prep (allele parse + ref fetch), per-thread
         handles;
      2. ONE vectorized k-mer usage pass over every allele of every
         region (seqs/kmer.py::kusage_batch_arrays; K10 on the card with
         OTTER_TPU_KMER_DEVICE=1, the mesh's first card in mesh mode);
      3. the per-region length distances vectorized on host (elementwise
         f64, exact) and ALL regions' cosine similarity matrices as ONE
         pooled GEMM: the host f64 BLAS, or f32 ``torch.bmm`` on the
         device (``cosine_gemm_f32``); both are certified pair-wise against the
         scalar-dot oracle (ops/cluster.py::kusage_cosine_condensed), so
         the VCF is byte-identical to the sequential host path either way.
         A mesh (``mesh=``, or ``params.device == "mesh"``: the visible
         cards) takes the f32 route whatever OTTER_TPU_GENOTYPE_DEVICE
         says, its region axis split over the shards, as the JAX
         package's mesh mode does;
      4. per-region hclust (native C++ NN-chain; with
         OTTER_TPU_NATIVE_HCLUST=0 the per-matrix route, which may take
         K11) + joint labels + VCF line, emitted in region order.
    """
    from ..ops.cluster import _ROUND_GUARD, kusage_cosine_condensed_batch
    from ..ops.distmat import triu_pair_indices
    from ..seqs.kmer import kusage_batch_arrays

    n_threads = max(1, int(params.threads or 1))
    if mesh is None and params.device == "mesh":
        from ..parallel.mesh import make_mesh

        mesh = make_mesh()
    card = genotype_card(params, mesh)
    with metrics.phase("genotype_prep"):
        results = _pooled_regions(params, bam_path, regions, reference, si,
                                  refindex, n_threads, prep_only=True)
    live = [i for i, (_t, prep) in enumerate(results) if prep is not None]
    with metrics.phase("genotype_kusage"):
        all_seqs: List[str] = []
        spans = {}
        for i in live:
            block = results[i][1][0]
            spans[i] = (len(all_seqs), len(block))
            all_seqs.extend(a.seq for a in block)
        kus_all, vecs_all, vnorms_all = kusage_batch_arrays(
            3, all_seqs, lazy=True, device=card)
    Vs = {}
    norms_by_region = {}
    for i in live:
        s0, cnt = spans[i]
        Vs[i] = vecs_all[s0 : s0 + cnt]
        norms_by_region[i] = vnorms_all[s0 : s0 + cnt]
    scaled_by_region = {}
    guard = _ROUND_GUARD
    if live and (mesh is not None or _use_device_gemm()):
        with metrics.phase("genotype_cosine_device"):
            S = cosine_gemm_f32([Vs[i] for i in live],
                                params.device if mesh is None else mesh)
            for bi, i in enumerate(live):
                n = Vs[i].shape[0]
                nr = norms_by_region[i]
                with np.errstate(invalid="ignore", divide="ignore"):
                    scaled_by_region[i] = (
                        S[bi, :n, :n] / np.outer(nr, nr)) * 1000.0
        guard = _ROUND_GUARD_F32
    else:
        with metrics.phase("genotype_cosine_host"):
            # raw GEMM only: the /(ni*nj)*1000 scaling happens inside the
            # native condensed pass (the numpy path applies the identical
            # elementwise ops)
            for i in live:
                V = Vs[i]
                scaled_by_region[i] = ("raw", V @ V.T)
    with metrics.phase("genotype_finish"):
        # condensed cosine rounding for every region in one stacked pass
        # (byte-equal per entry to the scalar kusage_cosine_condensed)
        kvals_all = kusage_cosine_condensed_batch(
            [scaled_by_region[i] for i in live], [Vs[i] for i in live],
            [norms_by_region[i] for i in live], guard)
        kvals_by_region = dict(zip(live, kvals_all))
        # length condensed matrices for every region (vector ops, f64 exact)
        lvals_by_region = {}
        for i in live:
            block = results[i][1][0]
            lens = np.asarray([len(a.seq) for a in block],
                              dtype=np.float64)
            iu, ju = triu_pair_indices(len(block))
            mx = np.maximum(lens[iu], lens[ju])
            lvals_by_region[i] = np.abs(lens[iu] - lens[ju]) \
                / np.maximum(mx, 1.0)
        # ONE threaded native NN-chain call for every region's two
        # matrices (the same C++ core as the per-matrix route, so the VCF
        # is unchanged); OTTER_TPU_NATIVE_HCLUST=0 clusters per region
        dendros_by_region = {}
        if native.enabled("HCLUST"):
            mats = []
            owners = []
            for i in live:
                n_all = len(results[i][1][0])
                if n_all >= 2:
                    mats.append((lvals_by_region[i], n_all))
                    owners.append((i, "length_dendro"))
                    mats.append((kvals_by_region[i], n_all))
                    owners.append((i, "kusage_dendro"))
            if mats:
                outs = native.hclust_average_native_batch(mats)
                for (i, key), mh in zip(owners, outs):
                    dendros_by_region.setdefault(i, {})[key] = mh

        def finish_region(i: int) -> str:
            text, prep = results[i]
            if prep is None:
                return text or ""
            s0, cnt = spans[i]
            pre = {"length_values": lvals_by_region[i],
                   "kusage_values": kvals_by_region[i],
                   "kusages": kus_all[s0 : s0 + cnt]}
            pre.update(dendros_by_region.get(i, {}))
            buf = io.StringIO()
            genotype_region(params, regions[i], None, None, si, refindex,
                            buf, precomputed=pre, prep=prep, device=card)
            return (text or "") + buf.getvalue()

        if n_threads > 1:
            # region finish pool (pure functions + GIL-releasing native
            # hclust/cutree); emission stays in region order, so -t N is
            # byte-identical to -t 1
            from ..utils.pool import ordered_thread_map

            texts = ordered_thread_map(
                len(regions), n_threads, lambda: None,
                lambda _ctx, i: finish_region(i), lambda _ctx: None)
            for t in texts:
                out.write(t)
        else:
            for i in range(len(regions)):
                out.write(finish_region(i))


def genotype(params: OtterOpts, bam_path: str, bed: str, reference: str,
             out: Optional[TextIO] = None, batched: bool = True,
             mesh=None) -> None:
    """(genotype.cpp:173-192). ``batched=False`` keeps every region on the
    sequential host path, the one the batched pipeline must equal byte for
    byte. ``mesh``: the devices of the batched pipeline's GEMM (a CPU mesh
    in the tests); ``params.device == "mesh"`` takes the visible cards.

    Under a coordinator each process handles its block of regions and only
    process 0 writes the VCF header (OTTER_TPU_GATHER=1: process 0 writes
    every row), as ``assemble`` does. ``cuda`` binds the process to its card
    and raises without one, whichever route the GEMM takes. ``host`` joins
    no coordinator and takes the sequential path: every process writes the
    whole VCF, as the JAX package's host mode does."""
    from ..parallel.distributed import (bind_device, gather_enabled,
                                        gather_text_to_writer, process_group,
                                        shard_regions)

    if params.device not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, "
                         f"not {params.device!r}")
    if out is None:
        out = sys.stdout
    regions = parse_bed_file(bed)
    if params.device == "host":
        if mesh is not None:
            raise ValueError('device "host" runs no mesh')
        _genotype_regions(params, bam_path, regions, reference, out, 0,
                          batched=False)
        return
    with process_group() as (pidx, pcount):
        bind_device(params.device, pidx)
        if pcount > 1:
            regions = shard_regions(regions, pidx, pcount)
            sys.stderr.write(
                f"({antimestamp()}): process {pidx}/{pcount} handling "
                f"{len(regions)} regions\n")
        gather = gather_enabled(pcount)
        body_out: TextIO = io.StringIO() if gather else out
        _genotype_regions(params, bam_path, regions, reference, body_out,
                          pidx, batched, mesh)
        if gather:
            full = gather_text_to_writer(body_out.getvalue(), pidx, pcount)
            if full is not None:
                out.write(full)


def _genotype_regions(params: OtterOpts, bam_path: str, regions: List[BED],
                      reference: str, out: TextIO, process_index: int,
                      batched: bool, mesh=None) -> None:
    """The sample index with OTTER_INTREF appended, the VCF header (from
    process 0, with a reference), then ``regions``' rows
    (genotype.cpp:175-189)."""
    si = SampleIndex()
    si.init(bam_path)
    sys.stderr.write(
        f"({antimestamp()}): Found {len(si.index2sample)} samples "
        "(read-group tags)\n")
    sys.stderr.write(
        f"({antimestamp()}): Using offset of {si.offset_l},{si.offset_r}\n")
    refindex = len(si.index2sample)
    si.index2sample.append(REFNAME)
    si.sample2index[REFNAME] = refindex
    if reference and process_index == 0:
        output_vcf_header(bam_path, si.index2sample, REFNAME, out)
    genotype_process(params, bam_path, regions, reference, si, refindex,
                     out, batched, mesh=mesh)
