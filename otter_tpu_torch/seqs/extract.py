"""Region read/allele extraction from BAM (parity with src/anseqs.cpp:439-524)."""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

from .. import native
from ..native import _ANREAD_AUX_ABSENT, _ANREAD_RQ_ABSENT
from ..config import OtterOpts
from ..io.bam import BamReader, BamRecord, FLAG_SECONDARY, FLAG_SUPPLEMENTARY
from ..io.bed import BED
from ..utils.timestamp import antimestamp
from .breakpoints import ParseMsg, parse_alignment
from .model import AnAllele, AnRead, Haplotag


def _parse_standard_auxs(rec: BamRecord, anread: AnRead) -> None:
    """HP/PS/rq tags (anseqs.cpp:244-252)."""
    v = rec.get_aux_int("HP")
    if v is not None:
        anread.hpt.hp = v
    v = rec.get_aux_int("PS")
    if v is not None:
        anread.hpt.ps = v
    f = rec.get_aux_float("rq")
    if f is not None:
        anread.rq = f


def parse_anreads(params: OtterOpts, bed: BED, bam: BamReader) -> List[AnRead]:
    """Query + filter + extract reads for a region (anseqs.cpp:439-460).

    Filters: mapq (:445), primary-only unless --non-primary (:445),
    parse success + optional omit-nonspanning (:451), read quality (:454).

    Device pipelines route through the native C++ extractor
    (otter_native.cpp::otter_anreads_parse — same breakpoints/filters,
    nibble expansion only for the extracted window); host mode keeps this
    python oracle. OTTER_TPU_NATIVE_ANREADS=0 selects the oracle.
    """
    if params.device != "host" and native.enabled("ANREADS"):
        got = _parse_anreads_native(params, bed, bam)
        if got is not None:
            return got
    out: List[AnRead] = []
    for rec in bam.fetch(bed.chr, bed.start, bed.end):
        if rec.mapq >= params.mapq and (
            params.nonprimary
            or not (rec.flag & FLAG_SECONDARY or rec.flag & FLAG_SUPPLEMENTARY)
        ):
            anread = AnRead(name=rec.name)
            msg = ParseMsg()
            anread.seq = parse_alignment(bed.start, bed.end, rec, msg)
            if msg.successful and (not params.omitnonspanning or msg.is_spanning()):
                msg.transfer_status(anread)
                _parse_standard_auxs(rec, anread)
                if anread.rq >= params.read_quality:
                    out.append(anread)
    return out


def _parse_anreads_native(params: OtterOpts, bed: BED,
                          bam: BamReader) -> "List[AnRead] | None":
    """Native extraction path; None when the BAM has no index, where the
    caller reads the region with fetch()."""
    got = bam.fetch_raw(bed.chr, bed.start, bed.end)
    if got is None:
        if bam.tid(bed.chr) < 0:
            # fetch() prints this warning and yields nothing; replicate
            sys.stderr.write(
                f"({antimestamp()}): WARNING: query failed at region "
                f"{bed.chr}:{bed.start}-{bed.end}\n")
            return []
        return None
    tid, raw = got
    d = native.anreads_parse(raw, tid, bed.start, bed.end, bed.start,
                             bed.end, params.mapq, params.nonprimary,
                             params.omitnonspanning, params.read_quality)
    out: List[AnRead] = []
    no, so = d["name_off"], d["seq_off"]
    for i in range(d["n"]):
        r = AnRead(
            seq=d["seqs"][so[i] : so[i + 1]].decode("latin-1"),
            name=d["names"][no[i] : no[i + 1]].decode(),
            is_spanning_l=bool(d["span_l"][i]),
            is_spanning_r=bool(d["span_r"][i]),
        )
        r.ccoords = (int(d["cc0"][i]), int(d["cc1"][i]))
        if d["rq"][i] != _ANREAD_RQ_ABSENT:
            r.rq = float(d["rq"][i])
        if d["hp"][i] != _ANREAD_AUX_ABSENT:
            r.hpt.hp = int(d["hp"][i])
        if d["ps"][i] != _ANREAD_AUX_ABSENT:
            r.hpt.ps = int(d["ps"][i])
        out.append(r)
    return out


def parse_anallele(target_region: str, sample2index: Dict[str, int],
                   rec: BamRecord, anallele_block: List[AnAllele],
                   allele_sample_indeces: List[int]) -> None:
    """Re-parse an assembled allele's ta/RG/tc/ac/sc/PS/HP/se/ic tags
    (anseqs.cpp:462-511)."""
    aux = rec.get_aux_map()  # one walk for all 9 tags

    def _i(tag):
        v = aux.get(tag)
        return int(v) if isinstance(v, (int, float)) else None

    parsed_region = aux.get("ta") if isinstance(aux.get("ta"), str) else ""
    if target_region != parsed_region:
        return
    sample = aux.get("RG") if isinstance(aux.get("RG"), str) else ""
    idx = sample2index.get(sample)
    if idx is None:
        sys.stderr.write(
            f"({antimestamp()}): ERROR unrecognized sample-name (read-group): {sample}\n"
        )
        raise SystemExit(1)
    tc = _i("tc")
    ac = _i("ac")
    sc = _i("sc")
    ps = _i("PS")
    hp = _i("HP")
    sev = aux.get("se")
    se = float(sev) if isinstance(sev, (int, float)) else None
    ic = _i("ic")
    seq = rec.seq if rec.seq else "N"
    allele_sample_indeces.append(idx)
    anallele_block.append(
        AnAllele(
            seq=seq,
            scov=1 if sc is None else sc,
            acov=1 if ac is None else ac,
            tcov=1 if tc is None else tc,
            se=0.0 if se is None else se,
            ic=1 if ic is None else ic,
            hpt=Haplotag(-1 if ps is None else ps, -1 if hp is None else hp),
        )
    )


def parse_analleles(params: OtterOpts, bam: BamReader, bed: BED,
                    sample2index: Dict[str, int]
                    ) -> Tuple[List[AnAllele], List[int]]:
    """All alleles of a region from a merged otter BAM (anseqs.cpp:513-524).

    Device pipelines route through the native C++ allele feeder
    (otter_native.cpp::otter_analleles_parse — same ta/RG/tag semantics in
    fetch order, no per-record python aux walk); host mode keeps this
    python oracle. OTTER_TPU_NATIVE_ANALLELES=0 selects the oracle."""
    if params.device != "host" and native.enabled("ANALLELES"):
        got = _parse_analleles_native(bam, bed, sample2index)
        if got is not None:
            return got
    anallele_block: List[AnAllele] = []
    allele_sample_indeces: List[int] = []
    for rec in bam.fetch(bed.chr, bed.start, bed.end):
        parse_anallele(bed.to_sc_string(), sample2index, rec,
                       anallele_block, allele_sample_indeces)
    return anallele_block, allele_sample_indeces


def _parse_analleles_native(bam: BamReader, bed: BED,
                            sample2index: Dict[str, int]):
    """Native allele-feeder path; None when the BAM has no index, where
    the caller reads the region with fetch()."""
    got = bam.fetch_raw(bed.chr, bed.start, bed.end)
    if got is None:
        if bam.tid(bed.chr) < 0:
            sys.stderr.write(
                f"({antimestamp()}): WARNING: query failed at region "
                f"{bed.chr}:{bed.start}-{bed.end}\n")
            return [], []
        return None
    tid, raw = got
    seqs, rgs, cols, se = native.analleles_parse(
        raw, tid, bed.start, bed.end, bed.to_sc_string())
    anallele_block: List[AnAllele] = []
    allele_sample_indeces: List[int] = []
    # bulk-convert the native columns once (numpy-scalar -> python int is
    # ~10x slower per element than one .tolist()); construct with
    # positional args — this loop is the cohort prep hot path
    sc_l = cols["sc"].tolist()
    ac_l = cols["ac"].tolist()
    tc_l = cols["tc"].tolist()
    ic_l = cols["ic"].tolist()
    ps_l = cols["ps"].tolist()
    hp_l = cols["hp"].tolist()
    se_l = se.tolist()
    get_idx = sample2index.get
    # Haplotags are value objects nothing mutates: intern per (ps, hp) so
    # cohort regions (thousands of untagged alleles) share one instance
    hpt_cache: Dict[tuple, Haplotag] = {}
    for i, (seq, rg) in enumerate(zip(seqs, rgs)):
        idx = get_idx(rg)
        if idx is None:
            sys.stderr.write(
                f"({antimestamp()}): ERROR unrecognized sample-name "
                f"(read-group): {rg}\n")
            raise SystemExit(1)
        allele_sample_indeces.append(idx)
        key = (ps_l[i], hp_l[i])
        hpt = hpt_cache.get(key)
        if hpt is None:
            hpt = hpt_cache[key] = Haplotag(key[0], key[1])
        anallele_block.append(AnAllele(
            seq, sc_l[i], ac_l[i], tc_l[i], se_l[i], ic_l[i], hpt))
    return anallele_block, allele_sample_indeces
