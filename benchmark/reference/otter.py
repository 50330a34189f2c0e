"""Plain reference of ``otter assemble``: the same operations on the same
BAM, BED and FASTA give the same SAM records.

The pipeline per region (otter's ``src/assemble.cpp:39-158``): reads from
the BAM through its index, each read's region subsequence by the CIGAR
walk, the coverage filter, local realignment of partly spanning reads
against the reference flanks, the valid / invalid partition, the
all-vs-all distance matrix (unit-cost edit distance over the longer
length), the KDE threshold and average-linkage clustering, reassignment of
the reads that do not span, and each allele's consensus (medoid backbone,
gap-affine member alignments, partial-order graph), emitted as SAM with
the ``tc/ac/sc/ic/se`` tags.

The host logic is a frozen copy of the program's pure-host mode
(``otter_tpu_torch`` at commit eda140f: ``seqs/breakpoints.py``,
``seqs/model.py``, ``ops/consensus.py``, ``ops/cluster.py``,
``ops/kde.py``, ``ops/distmat.py``, ``utils/fmt.py``), which the program's
own tests hold byte for byte against otter's C++ semantics; the two
dynamic programs run batched in torch (``dp.py``). ``fdt`` is the
precision of every floating-point quantity: float64 as otter computes
them, float32 for the control that shows the comparison fails a lower
precision. This module imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..fixtures.bam import (BAM_CDEL, BAM_CDIFF, BAM_CEQUAL, BAM_CHARD_CLIP,
                            BAM_CINS, BAM_CMATCH, BAM_CSOFT_CLIP,
                            FLAG_SECONDARY, FLAG_SUPPLEMENTARY, BamReader,
                            BamRecord)
from . import dp
from .hclust import cutree_cdist, cutree_k, hclust_average
from .poa import Ppoa

# -- options (otter's cxxopts defaults, command_assemble.cpp:34-45) ----------


@dataclass
class Opts:
    offset_l: int = 1
    offset_r: int = 0
    max_alleles: int = 2
    mapq: int = 0
    read_quality: float = 0.0
    max_cov: int = 200
    min_cov_fraction: float = 0.2
    min_cov_fraction2_l: int = 500
    min_cov_fraction2_f: float = 0.1
    max_error: float = 0.01
    bandwidth_short: float = 0.01
    bandwidth_long: float = 0.015
    bandwidth_length: int = 500
    flank: int = 100
    min_sim: float = 0.9
    nonprimary: bool = False
    omitnonspanning: bool = False
    ignore_haps: bool = True
    read_group: str = ""

    @classmethod
    def of(cls, settings: dict) -> "Opts":
        known = cls.__dataclass_fields__
        return cls(**{k: v for k, v in settings.items() if k in known})


# -- formatting (utils/fmt.py) -------------------------------------------------


def fmt_double(x) -> str:
    x = float(x)
    if x != x:
        return "nan"
    if x == float("inf"):
        return "inf"
    if x == float("-inf"):
        return "-inf"
    return "%g" % x


def fmt_float(x) -> str:
    """A C++ ``float`` as ``std::cout << x`` prints it."""
    return fmt_double(float(np.float32(float(x))))


# -- reads and alleles (seqs/model.py) -----------------------------------------


@dataclass(slots=True)
class Haplotag:
    ps: int = -1
    hp: int = -1

    def is_defined(self) -> bool:
        return self.ps >= 0 and self.hp >= 0


@dataclass(slots=True)
class AnRead:
    seq: str = ""
    name: str = ""
    rq: float = 0.0
    is_spanning_l: bool = False
    is_spanning_r: bool = False
    hpt: Haplotag = field(default_factory=Haplotag)
    ccoords: Tuple[int, int] = (-1, -1)

    def is_spanning(self) -> bool:
        return self.is_spanning_l and self.is_spanning_r

    def set_is_spanning(self) -> None:
        self.is_spanning_l = True
        self.is_spanning_r = True


@dataclass(slots=True)
class AnAllele:
    seq: str = ""
    scov: int = 1
    acov: int = 1
    tcov: int = 1
    se: float = 0.0
    ic: int = 1
    hpt: Haplotag = field(default_factory=Haplotag)

    def to_sam(self, name: str, chr: str, start: int, end: int,
               rg: str) -> str:
        out = [f"{name}\t0\t{chr}\t{start}\t0\t{len(self.seq)}M\t*\t0\t0\t"
               f"{self.seq}\t{'!' * len(self.seq)}"]
        if rg:
            out.append(f"\tRG:Z:{rg}")
        out.append(f"\tta:Z:{chr}:{start}-{end}\ttc:i:{self.tcov}"
                   f"\tac:i:{self.acov}\tsc:i:{self.scov}")
        out.append(f"\tic:i:{self.ic}")
        out.append(f"\tse:f:{fmt_float(self.se)}")
        if self.hpt.ps >= 0:
            out.append(f"\tPS:i:{self.hpt.ps}")
        if self.hpt.hp >= 0:
            out.append(f"\tHP:i:{self.hpt.hp}")
        return "".join(out)


# -- region subsequence of a read (seqs/breakpoints.py) ------------------------


@dataclass
class ParseMsg:
    successful: bool = True
    spanning_l: bool = True
    spanning_r: bool = True
    alignment_coords: Tuple[int, int] = (-1, -1)

    def is_spanning(self) -> bool:
        return self.spanning_l and self.spanning_r

    def transfer_status(self, anread: AnRead) -> None:
        if self.is_spanning():
            anread.set_is_spanning()
        elif self.spanning_l:
            anread.is_spanning_l = True
        elif self.spanning_r:
            anread.is_spanning_r = True
        anread.ccoords = self.alignment_coords


def get_breakpoints(start: int, end: int, rec: BamRecord,
                    msg: ParseMsg) -> Optional[Tuple[int, int]]:
    """Project region [start, end] onto the read (anseqs.cpp:286-408)."""
    clipped_l = False
    clipped_r = False
    qstart_dist = -1
    qend_dist = -1
    leftmost_q = -1
    rightmost_q = -1
    leftmost_r = -1
    rightmost_r = -1
    qstart_q = -1
    qend_q = -1
    qstart_cigar_i = 0
    qend_cigar_i = 0
    cigar = rec.cigar
    n_cigar = len(cigar)
    rpos = rec.pos
    qpos = 0
    for i in range(n_cigar):
        ol, op = cigar[i]
        if op in (BAM_CHARD_CLIP, BAM_CSOFT_CLIP):
            if i == 0:
                clipped_l = True
            if i == n_cigar - 1:
                clipped_r = True
            if op == BAM_CSOFT_CLIP:
                qpos += ol
        elif op in (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF):
            if leftmost_q == -1:
                leftmost_q = qpos
                leftmost_r = rpos
            last_r = rpos + ol - 1
            if rightmost_q == -1 or last_r > rightmost_r:
                rightmost_q = qpos + (last_r - rpos)
                rightmost_r = last_r
            if last_r >= start:
                cand_r = rpos if rpos >= start else start
                cstart_dist = cand_r - start
                if cstart_dist >= 0 and (qstart_dist < 0
                                         or cstart_dist < qstart_dist):
                    qstart_dist = cstart_dist
                    qstart_q = qpos + (cand_r - rpos)
                    qstart_cigar_i = i
            if rpos <= end:
                cand_r = last_r if last_r <= end else end
                cend_dist = end - cand_r
                if cend_dist >= 0 and (qend_dist < 0 or cend_dist < qend_dist):
                    qend_dist = cend_dist
                    qend_q = qpos + (cand_r - rpos)
                    qend_cigar_i = i
            rpos += ol
            qpos += ol
        elif op == BAM_CINS:
            qpos += ol
        elif op == BAM_CDEL:
            rpos += ol

    if rightmost_r < start or leftmost_r > end:
        msg.successful = False
        msg.spanning_l = False
        msg.spanning_r = False
        return None
    if qstart_q > -1 and qend_q > -1 and qstart_q > qend_q:
        qstart_q = -1
        qend_q = -1
        msg.successful = True
        msg.spanning_l = True
        msg.spanning_r = True
    else:
        msg.alignment_coords = (qstart_q, qend_q)
        if leftmost_r > start and clipped_l and qstart_cigar_i == 1:
            while qstart_q > 0 and qstart_cigar_i > 0:
                ol, op = cigar[qstart_cigar_i - 1]
                if op == BAM_CDEL:
                    qstart_cigar_i -= 1
                elif op in (BAM_CHARD_CLIP, BAM_CSOFT_CLIP, BAM_CINS):
                    qstart_q -= ol
                    qstart_cigar_i -= 1
                else:
                    break
        if rightmost_r < end and clipped_r and qend_cigar_i == n_cigar - 1:
            while qend_q < rec.l_qseq - 1 and qend_cigar_i < n_cigar:
                ol, op = cigar[qend_cigar_i - 1]
                if op == BAM_CDEL:
                    qend_cigar_i += 1
                elif op in (BAM_CHARD_CLIP, BAM_CSOFT_CLIP, BAM_CINS):
                    qend_q += ol
                    qend_cigar_i += 1
                else:
                    break
        msg.spanning_l = leftmost_q >= 0 and leftmost_r <= start
        msg.spanning_r = rightmost_q >= 0 and rightmost_r >= end
        msg.successful = True
    if msg.spanning_l and msg.spanning_r:
        return (qstart_q, qend_q)
    if msg.spanning_l:
        return (qstart_q, rec.l_qseq)
    if msg.spanning_r:
        return (0, qend_q)
    return (0, rec.l_qseq)


def parse_alignment(rstart: int, rend: int, rec: BamRecord,
                    msg: ParseMsg) -> str:
    """The region subsequence of a read (anseqs.cpp:412-435)."""
    query = get_breakpoints(rstart, rend, rec, msg)
    if not msg.successful:
        return ""
    qlo, qhi = query
    if (qlo == -1) != (qhi == -1):
        raise ValueError(f"unexpected query coordinates for read {rec.name}")
    if qlo == -1 or rec.l_qseq < (qhi - qlo):
        return "N"
    l_og = msg.alignment_coords[1] - msg.alignment_coords[0]
    new_first = msg.alignment_coords[0] - qlo
    msg.alignment_coords = (new_first, new_first + l_og)
    seq = rec.seq[qlo:qhi]
    return seq if seq else "N"


def parse_anreads(opts: Opts, chrom: str, start: int, end: int,
                  bam: BamReader) -> List[AnRead]:
    """Query, filter and extract a region's reads (anseqs.cpp:439-460)."""
    out: List[AnRead] = []
    for rec in bam.fetch(chrom, start, end):
        if rec.mapq >= opts.mapq and (
                opts.nonprimary
                or not (rec.flag & FLAG_SECONDARY
                        or rec.flag & FLAG_SUPPLEMENTARY)):
            anread = AnRead(name=rec.name)
            msg = ParseMsg()
            anread.seq = parse_alignment(start, end, rec, msg)
            if msg.successful and (not opts.omitnonspanning
                                   or msg.is_spanning()):
                msg.transfer_status(anread)
                v = rec.get_aux_int("HP")
                if v is not None:
                    anread.hpt.hp = v
                v = rec.get_aux_int("PS")
                if v is not None:
                    anread.hpt.ps = v
                f = rec.get_aux_float("rq")
                if f is not None:
                    anread.rq = f
                if anread.rq >= opts.read_quality:
                    out.append(anread)
    return out


class Fasta:
    """The reference FASTA in memory; ``fetch`` as faidx: 0-based
    inclusive [start, end], clamped, uppercased."""

    def __init__(self, path: str):
        self.seqs: Dict[str, str] = {}
        name, parts = None, []
        with open(path) as fh:
            for line in fh:
                line = line.rstrip("\r\n")
                if line.startswith(">"):
                    if name is not None:
                        self.seqs[name] = "".join(parts)
                    name, parts = line[1:].split()[0], []
                else:
                    parts.append(line)
        if name is not None:
            self.seqs[name] = "".join(parts)

    def fetch(self, chrom: str, start: int, end: int) -> str:
        s = self.seqs.get(chrom)
        if s is None:
            return ""
        start = max(start, 0)
        end = min(end, len(s) - 1)
        if end < start:
            return ""
        return s[start : end + 1].upper()


# -- distances (ops/consensus.py, ops/distmat.py) -------------------------------


class DistMatrix:
    """Condensed upper triangle, entry (i, j) at (2n-3-i) i / 2 + j - 1."""

    def __init__(self, n: int, fdt):
        self.n = int(n)
        self.fdt = fdt
        self.values = np.full((self.n * (self.n - 1)) // 2, 1.0, dtype=fdt)

    def _index(self, i: int, j: int) -> int:
        a, b = (i, j) if i < j else (j, i)
        return ((2 * self.n - 3 - a) * a >> 1) + b - 1

    def get_dist(self, i: int, j: int) -> float:
        return float(self.values[self._index(i, j)])

    def to_square(self) -> np.ndarray:
        sq = np.zeros((self.n, self.n), dtype=self.fdt)
        sq[np.triu_indices(self.n, k=1)] = self.values
        return sq + sq.T

    def get_medoid(self, indeces) -> int:
        """Min row sum, the first on ties (andistmat.cpp:36-50), summed
        left to right."""
        idx = list(indeces)
        if len(idx) <= 2:
            return idx[0]
        ia = np.asarray(idx, dtype=np.int64)
        sub = self.to_square()[np.ix_(ia, ia)]
        zero = np.zeros((len(idx), 1), dtype=self.fdt)
        sums = np.concatenate([zero, sub], axis=1).cumsum(axis=1)[:, -1]
        return idx[int(np.argmin(sums))]


def _pair_job(read_x: AnRead, read_y: AnRead):
    """What ``align_anreads`` (analignments.cpp:62-101) computes for a
    pair: ('same',), ('e2e', x, y, norm), ('ef', pattern, text, pb, pe,
    tb, te, norm) or ('none',)."""
    if read_x.seq == read_y.seq:
        return ("same",)
    if (read_x.is_spanning() and read_y.is_spanning()) or (
            read_y.is_spanning() and len(read_x.seq) >= len(read_y.seq)):
        return ("e2e", read_x.seq, read_y.seq,
                max(len(read_x.seq), len(read_y.seq)))
    if read_y.is_spanning():
        ld = len(read_y.seq) - len(read_x.seq)
        nrm = len(read_x.seq)
        if ld < 0:
            ld = -ld
            if read_x.is_spanning_l:
                return ("ef", read_x.seq, read_y.seq, 0, 0, 0, ld, nrm)
            if read_x.is_spanning_r:
                return ("ef", read_x.seq, read_y.seq, 0, 0, ld, 0, nrm)
            return ("ef", read_x.seq, read_y.seq, 0, 0, ld // 2, ld // 2,
                    nrm)
        if read_x.is_spanning_l:
            return ("ef", read_y.seq, read_x.seq, 0, ld, 0, 0, nrm)
        if read_x.is_spanning_r:
            return ("ef", read_y.seq, read_x.seq, ld, 0, 0, 0, nrm)
        return ("ef", read_y.seq, read_x.seq, ld // 2, ld // 2, 0, 0, nrm)
    return ("none",)


def _normalised(d: int, norm: int, fdt) -> float:
    return fdt(d) / fdt(norm)


def pair_distances(jobs: Sequence[tuple], device, fdt) -> List[float]:
    """Normalised distances of ``_pair_job`` jobs, the end-to-end ones in
    one batched call."""
    out: List[float] = [0.0] * len(jobs)
    e2e = [(i, j) for i, j in enumerate(jobs) if j[0] == "e2e"]
    dists = dp.edit_distances([(j[1], j[2]) for _i, j in e2e], device)
    for (i, j), d in zip(e2e, dists.tolist()):
        out[i] = _normalised(d, j[3], fdt)
    ef = [(i, j) for i, j in enumerate(jobs) if j[0] == "ef"]
    dists = dp.edit_distances_ends_free([j[1:7] for _i, j in ef], device)
    for (i, j), d in zip(ef, dists.tolist()):
        out[i] = _normalised(d, j[7], fdt)
    for i, j in enumerate(jobs):
        if j[0] == "none":
            out[i] = -1.0
    return out


# -- KDE and clustering (ops/kde.py, ops/cluster.py) ----------------------------


_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * 3.14159265358979323846)


def kde_grid(dinterval: float, fdt) -> np.ndarray:
    """``for (x = 0; x <= 1; x += dinterval)`` (otterclust.cpp:26),
    accumulated in ``fdt``."""
    xs = []
    x = fdt(0.0)
    step = fdt(dinterval)
    while x <= 1.0:
        xs.append(x)
        x = fdt(x + step)
    return np.asarray(xs, dtype=fdt)


def kde_densities(values: np.ndarray, bandwidth: float, xs: np.ndarray,
                  fdt) -> np.ndarray:
    """Gaussian KDE on the grid, normalised to sum 1
    (otterclust.cpp:25-34)."""
    values = np.asarray(values, dtype=fdt)
    h = fdt(bandwidth)
    z = (xs[:, None] - values[None, :]) / h
    dens = np.sum(fdt(_INV_SQRT_2PI) * np.exp(-(z * z) / fdt(2.0)),
                  axis=1) / (h * fdt(len(values)))
    return dens / np.sum(dens)


def _windowed_sums(d: np.ndarray, radius: int) -> np.ndarray:
    sums = d.copy()
    for j in range(1, radius):
        shifted = np.zeros_like(d)
        shifted[j:] = d[:-j]
        sums += shifted
    for j in range(1, radius):
        shifted = np.zeros_like(d)
        shifted[:-j] = d[j:]
        sums += shifted
    return sums


def kde_maximas(radius: int, densities: np.ndarray):
    """Alternating maxima and minima of the windowed density sums
    (ankde.cpp:25-62), the sequential scan."""
    maxs: List[Tuple[int, float]] = []
    mins: List[Tuple[int, float]] = []
    n = len(densities)
    sums = _windowed_sums(densities, radius)
    find_maxima = True
    last_sum = 0.0
    last_sum_i = 1
    for i in range(1, n - 1):
        s = float(sums[i])
        if find_maxima:
            if s < last_sum:
                find_maxima = False
                maxs.append((last_sum_i, last_sum))
        else:
            if s > last_sum:
                find_maxima = True
                mins.append((last_sum_i, last_sum))
        last_sum = s
        last_sum_i = i
    if find_maxima:
        maxs.append((last_sum_i, last_sum))
    return maxs, mins


@dataclass
class ClusteringStatus:
    ic: int = 0
    fc: int = 0
    labels: List[int] = field(default_factory=list)


@dataclass
class DecisionBound:
    dist0: float
    dist1: float
    cut0: float


def _insertion_sort(a: List[int], less) -> None:
    """libstdc++ __insertion_sort (std::sort under 16 elements)."""
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


def find_clustering_dist(radius: int, dinterval: float, bandwidth: float,
                         dm: DistMatrix) -> DecisionBound:
    """KDE peaks and valley of the distance distribution
    (otterclust.cpp:20-116)."""
    densities = kde_densities(dm.values, bandwidth,
                              kde_grid(dinterval, dm.fdt), dm.fdt)
    maximas, minimas = kde_maximas(radius, densities)
    if not maximas:
        raise ValueError("failed to obtain maximas")
    if len(maximas) == 1:
        return DecisionBound(maximas[0][0] * dinterval,
                             maximas[0][0] * dinterval, -1.0)
    if not minimas:
        raise ValueError("failed to obtain minimas")
    if len(maximas) == 2:
        return DecisionBound(maximas[0][0] * dinterval,
                             maximas[1][0] * dinterval,
                             minimas[0][0] * dinterval)
    order = list(range(len(maximas)))

    def cmp_less(a: int, b: int) -> bool:
        diff = maximas[a][1] - maximas[b][1]
        diff = diff if diff > 0 else -diff
        if diff <= 0.01:
            return maximas[a][0] < maximas[b][0]
        return maximas[a][1] > maximas[b][1]

    _insertion_sort(order, cmp_less)
    last_i = 0
    acc_i = 1
    while acc_i < len(order):
        index_diff = abs(acc_i - last_i)
        f_diff = abs(maximas[order[acc_i]][1] - maximas[order[last_i]][1])
        if index_diff == 1 and f_diff <= 0.01:
            del order[acc_i]
            last_i = acc_i
        acc_i += 1
    if len(order) < 2:
        return DecisionBound(maximas[0][0] * dinterval,
                             maximas[1][0] * dinterval,
                             minimas[0][0] * dinterval)
    m_first_i = order[0]
    m_second_i = order[1]
    if m_first_i > m_second_i:
        m_first_i, m_second_i = m_second_i, m_first_i
    boundary_i = m_second_i - 1
    if boundary_i < 0 or boundary_i >= len(minimas):
        raise ValueError(f"unexpected index for minimas: {boundary_i}")
    if (m_second_i - m_first_i > 1 and m_second_i - 2 >= 0
            and (maximas[m_second_i][0] * dinterval
                 - minimas[boundary_i][0] * dinterval <= 0.01)):
        boundary_i = m_second_i - 2
        if boundary_i < 0 or boundary_i >= len(minimas):
            raise ValueError(f"unexpected index for minimas: {boundary_i}")
    return DecisionBound(
        maximas[m_first_i][0] * dinterval,
        maximas[m_second_i][0] * dinterval,
        minimas[m_first_i + (m_second_i - m_first_i) // 2][0] * dinterval)


def otter_hclust(opts: Opts, ignore_haps: bool, indeces: List[int],
                 dm: DistMatrix, reads: List[AnRead],
                 clustering: ClusteringStatus) -> None:
    """Reads into allele groups (otterclust.cpp:118-320)."""
    max_alleles = opts.max_alleles
    max_tolerable_diff = opts.max_error
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
        elif dm.get_dist(0, 1) <= max_tolerable_diff:
            clustering.ic = 1
            clustering.fc = 1
        else:
            clustering.labels[1] = 1
            clustering.ic = 2
            clustering.fc = 2
        return
    if max_alleles == 1:
        clustering.labels = [0] * len(indeces)
        clustering.ic = 1
        clustering.fc = 1
        return
    error_intervals = 0.0025
    radius = max(1, int(max_tolerable_diff / error_intervals))
    bandwidth = opts.bandwidth_short
    for i in indeces:
        if len(reads[i].seq) >= opts.bandwidth_length:
            bandwidth = opts.bandwidth_long
            break
    dists = find_clustering_dist(radius, error_intervals, bandwidth, dm)
    if dists.dist1 - dists.dist0 <= max_tolerable_diff:
        clustering.labels = [0] * len(indeces)
        clustering.ic = 1
        clustering.fc = 1
        return
    n = len(indeces)
    merge, height = hclust_average(n, dm.values, dm.fdt)
    dist_final = (dists.dist1 if dists.dist1 == bandwidth
                  else dists.cut0 + 0.0025)
    labels = cutree_cdist(n, merge, height, dist_final).tolist()
    total_alleles = max(labels) + 1
    clustering.ic = total_alleles
    min_cov1 = int(n * opts.min_cov_fraction + 0.5)
    min_cov2 = int(n * opts.min_cov_fraction2_f + 0.5)
    if max_alleles != 0:
        label_counts = [0] * total_alleles
        label_max_sizes = [0] * total_alleles
        label_required_covs = [0] * total_alleles
        for i in range(n):
            label_counts[labels[i]] += 1
            if len(reads[indeces[i]].seq) > label_max_sizes[labels[i]]:
                label_max_sizes[labels[i]] = len(reads[indeces[i]].seq)
        for l in range(total_alleles):
            if label_max_sizes[l] < opts.min_cov_fraction2_l:
                label_required_covs[l] = min_cov1
            else:
                label_required_covs[l] = min_cov2
        is_only_singletons = all(label_counts[l] < label_required_covs[l]
                                 for l in range(total_alleles))
        if is_only_singletons:
            labels = cutree_k(n, merge, max_alleles).tolist()
            clustering.fc = max_alleles
        else:
            seed_clusters = [l for l in range(total_alleles)
                             if label_counts[l] >= label_required_covs[l]]
            outlier_clusters = [l for l in range(total_alleles)
                                if label_counts[l] < label_required_covs[l]]
            if not seed_clusters or len(seed_clusters) > max_alleles:
                labels = cutree_k(n, merge, max_alleles).tolist()
                clustering.fc = max_alleles
            else:
                for i in range(n):
                    if labels[i] in outlier_clusters:
                        labels[i] = -1
                for i in range(n):
                    for j, s in enumerate(seed_clusters):
                        if labels[i] == s:
                            labels[i] = j
                            break
                for i in range(n):
                    if labels[i] == -1:
                        closest_j = None
                        min_dist = 100000.0
                        for j in range(n):
                            if i != j and labels[j] != -1:
                                j_dist = dm.get_dist(i, j)
                                if j_dist < min_dist:
                                    closest_j = j
                                    min_dist = j_dist
                        labels[i] = labels[closest_j]
                clustering.fc = len(seed_clusters)
    clustering.labels = list(labels)


# -- reassignment and consensus (ops/consensus.py) ------------------------------


def invalid_reassignment(opts: Opts, total_alleles: int,
                         reads: List[AnRead], labels: List[int], pre: dict,
                         device, fdt) -> None:
    """Non-spanning reads to the allele of highest similarity, at least
    ``min_sim`` and ``max_error`` above the runner-up
    (analignments.cpp:126-177)."""
    for i in range(len(labels)):
        if labels[i] >= 0:
            continue
        max_sim = [0.0] * total_alleles
        for j in range(len(labels)):
            if i != j and labels[j] >= 0 and reads[j].is_spanning():
                dist = pre.get((i, j))
                if dist is None:
                    dist = pair_distances([_pair_job(reads[i], reads[j])],
                                          device, fdt)[0]
                if dist < 0:
                    raise ValueError("unexpected distance in reassignment")
                sim = float(fdt(1) - fdt(dist))
                if sim > max_sim[labels[j]]:
                    max_sim[labels[j]] = sim
        best = 0
        for j in range(1, total_alleles):
            if max_sim[j] > max_sim[best]:
                best = j
        same = sum(1 for s in max_sim if s == max_sim[best])
        if same == 1 and max_sim[best] >= opts.min_sim:
            min_diff = 1.0
            for j in range(total_alleles):
                if best != j:
                    diff = max_sim[best] - max_sim[j]
                    if diff < min_diff:
                        min_diff = diff
            if min_diff >= opts.max_error:
                labels[i] = best


def compute_se(values: List[float], fdt) -> float:
    """Standard error of the mean (analignments.cpp:179-190)."""
    if not values:
        return -1.0
    if fdt is np.float64:
        u = sum(values) / len(values)
        n = sum((v - u) ** 2 for v in values)
        return math.sqrt(n / (len(values) - 1)) / math.sqrt(len(values))
    v = np.asarray(values, dtype=fdt)
    u = fdt(0)
    for x in v:
        u = fdt(u + x)
    u = fdt(u / fdt(len(v)))
    n = fdt(0)
    for x in v:
        n = fdt(n + (x - u) * (x - u))
    return float(np.sqrt(fdt(n / fdt(len(v) - 1))) / np.sqrt(fdt(len(v))))


class PoaTask:
    """One allele's consensus: backbone and member alignment jobs (a None
    job reuses the previous member's cigar, as otter's stale aligner)."""

    def __init__(self, allele: AnAllele, rep_read: AnRead,
                 member_reads: List[AnRead], jobs: List[Optional[tuple]]):
        self.allele = allele
        self.rep_read = rep_read
        self.member_reads = member_reads
        self.jobs = jobs

    def flat_jobs(self) -> List[tuple]:
        return [(self.rep_read.seq,) + j for j in self.jobs if j is not None]

    def apply(self, cigars: List[str]) -> None:
        poa = Ppoa(self.rep_read.seq)
        cigar = ""
        ci = 0
        for read, job in zip(self.member_reads, self.jobs):
            if job is not None:
                cigar = cigars[ci]
                ci += 1
            poa.insert_alignment(read.seq, cigar, read.is_spanning_l,
                                 read.is_spanning_r)
        n_members = len(self.member_reads) + 1
        c = np.float32(n_members * 0.4) if n_members >= 4 else np.float32(1.0)
        poa.adjust_weights(float(c), float(np.float32(0.3)))
        self.allele.seq = poa.consensus() or "N"


def consensus_prepare(ignore_haps: bool, reads: List[AnRead],
                      labels: List[int], valid_indeces: List[int],
                      total_alleles: int, dm: DistMatrix,
                      alleles: List[AnAllele], fdt) -> List[PoaTask]:
    """Coverage bookkeeping, SE, medoid and member jobs of each allele
    (analignments.cpp:192-298, up to the alignments)."""
    tasks: List[PoaTask] = []
    for label in range(total_alleles):
        lab_reads = []
        lab_valid = []
        for i in range(len(valid_indeces)):
            if label == labels[valid_indeces[i]]:
                lab_reads.append(valid_indeces[i])
                lab_valid.append(i)
        if not lab_reads:
            raise ValueError(f"empty allele cluster {label}")
        rep_v = dm.get_medoid(lab_valid)
        rep = valid_indeces[rep_v]
        lab_all = [i for i in range(len(reads))
                   if i != rep and labels[i] == label]
        allele = alleles[label]
        allele.tcov = len(reads)
        allele.acov = len(lab_all) + 1
        allele.scov = len(lab_reads)
        if len(lab_valid) == 1:
            allele.se = 0.0
        elif len(lab_valid) == 2:
            allele.se = dm.get_dist(lab_valid[0], lab_valid[1])
        else:
            allele.se = compute_se([dm.get_dist(i, rep_v) for i in lab_valid
                                    if i != rep_v], fdt)
        if not ignore_haps:
            ps = hp = -1
            for i in lab_reads:
                if ps < 0:
                    ps = reads[i].hpt.ps
                elif ps != reads[i].hpt.ps:
                    raise ValueError("conflicting haplotag information")
                if hp < 0:
                    hp = reads[i].hpt.hp
                elif hp != reads[i].hpt.hp:
                    raise ValueError("conflicting haplotag information")
            allele.hpt = reads[rep].hpt
        rep_read = reads[rep]
        if len(lab_all) + 1 <= 2:
            allele.seq = reads[lab_reads[0]].seq
            continue
        jobs: List[Optional[tuple]] = []
        members: List[AnRead] = []
        for i in lab_all:
            read = reads[i]
            members.append(read)
            ld = len(rep_read.seq) - len(read.seq)
            if read.is_spanning() or ld < 0:
                if ld >= 0:
                    jobs.append((read.seq, 0, 0, 0, 0))
                elif read.is_spanning_l:
                    jobs.append((read.seq, 0, 0, 0, -ld))
                elif read.is_spanning_r:
                    jobs.append((read.seq, 0, 0, -ld, 0))
                else:
                    jobs.append(None)
            elif read.is_spanning_l:
                jobs.append((read.seq, 0, ld, 0, 0))
            elif read.is_spanning_r:
                jobs.append((read.seq, ld, 0, 0, 0))
            else:
                jobs.append((read.seq, ld // 2, ld // 2, 0, 0))
        tasks.append(PoaTask(allele, rep_read, members, jobs))
    return tasks


def local_realignment(chrom: str, start: int, end: int, flank: int,
                      min_sim: float, fasta: Fasta, reads: List[AnRead],
                      device) -> None:
    """Rescue partly spanning reads by aligning their clipped tail to the
    reference flank (analignments.cpp:11-60)."""
    ref_left = ""
    ref_right = ""
    pending = []
    jobs = []
    for read in reads:
        if not read.is_spanning() and (read.is_spanning_l
                                       or read.is_spanning_r):
            left = read.is_spanning_r and read.ccoords[0] >= flank
            right = read.is_spanning_l and (
                len(read.seq) - read.ccoords[1] >= flank)
            if left:
                if not ref_left:
                    ref_left = fasta.fetch(chrom, start - flank, start)
                subseq = read.seq[: read.ccoords[0]]
                if subseq:
                    pending.append((read, True, subseq))
                    jobs.append((subseq, ref_left, 0, 0, 0, 0))
            elif right:
                if not ref_right:
                    ref_right = fasta.fetch(chrom, end, end + flank)
                subseq = read.seq[read.ccoords[1]:]
                if subseq:
                    pending.append((read, False, subseq))
                    jobs.append((subseq, ref_right, 0, 0, 0, 0))
    if not jobs:
        return
    for (read, left, subseq), cigar in zip(pending,
                                           dp.affine_cigars(jobs, device)):
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
            if left:
                read.seq = read.seq[max_sum_i:]
            else:
                read.seq = read.seq[: read.ccoords[1] + start_i]
            read.set_is_spanning()


# -- the pipeline ----------------------------------------------------------------


@dataclass
class _Region:
    chrom: str
    start: int
    end: int
    reads: List[AnRead]
    ignore_haps: bool
    valid: List[int]
    invalid: List[int]


def _prepare(opts: Opts, chrom: str, start: int, end: int, bam: BamReader,
             fasta: Optional[Fasta], device) -> Optional[_Region]:
    """Reads, filters and realignment of one region (assemble.cpp:51-122);
    None where otter emits nothing for it."""
    mstart, mend = start - opts.offset_l, end + opts.offset_r
    reads = parse_anreads(opts, chrom, mstart, mend, bam)
    if len(reads) > opts.max_cov:
        return None
    if fasta is not None:
        local_realignment(chrom, mstart, mend, opts.flank, opts.min_sim,
                          fasta, reads, device)
    spanning = sum(1 for r in reads if r.is_spanning())
    if spanning == 0:
        return None

    def partition(ignore_haps):
        valid, invalid = [], []
        for i, r in enumerate(reads):
            if r.is_spanning() and (ignore_haps or r.hpt.is_defined()):
                valid.append(i)
            else:
                invalid.append(i)
        return valid, invalid

    ignore_haps = opts.ignore_haps
    valid, invalid = partition(ignore_haps)
    if len(valid) < 2:
        ignore_haps = True
        valid, invalid = partition(True)
    if not valid:
        return None
    return _Region(chrom, start, end, reads, ignore_haps, valid, invalid)


def assemble(opts: Opts, bam_path: str, fasta_path: Optional[str],
             regions: Sequence[Tuple[str, int, int]], device,
             fdt=np.float64, times: Optional[Dict[str, float]] = None
             ) -> Dict[Tuple[str, int, int], List[Tuple[str, float]]]:
    """(SAM record, its SE before printing) of each allele otter emits for
    each region, by (chrom, start, end); a region otter skips maps to [].
    Every region's distances run in one batched call, and every allele's
    member alignments in another. ``times`` gathers each stage's
    seconds."""
    clock = _Clock(times)
    out: Dict[Tuple[str, int, int], List[Tuple[str, float]]] = {
        r: [] for r in regions}
    fasta = Fasta(fasta_path) if fasta_path else None
    with BamReader(bam_path, load_index=True) as bam:
        work = [w for w in (_prepare(opts, c, s, e, bam, fasta, device)
                            for c, s, e in regions) if w is not None]
    clock("prepare")
    # the all-vs-all distance matrices
    mats: List[DistMatrix] = []
    jobs, spans = [], []
    for w in work:
        dm = DistMatrix(len(w.valid), fdt)
        mats.append(dm)
        if opts.max_alleles == 1:
            spans.append(None)
            continue
        if not w.ignore_haps:
            for a in range(len(w.valid)):
                for b in range(a + 1, len(w.valid)):
                    x, y = w.reads[w.valid[a]], w.reads[w.valid[b]]
                    dm.values[dm._index(a, b)] = (
                        0.0 if (x.hpt.is_defined() and y.hpt.is_defined()
                                and x.hpt == y.hpt) else 1.0)
            spans.append(None)
            continue
        spans.append(len(jobs))
        for a in range(len(w.valid)):
            for b in range(a + 1, len(w.valid)):
                jobs.append(_pair_job(w.reads[w.valid[a]],
                                      w.reads[w.valid[b]]))
    dists = pair_distances(jobs, device, fdt)
    clock("distances")
    for w, dm, s in zip(work, mats, spans):
        if s is not None:
            dm.values[:] = np.asarray(dists[s : s + len(dm.values)],
                                      dtype=fdt)
    # clustering, then every region's reassignment distances in one
    # batched call, then reassignment and consensus preparation
    clustered, pre_jobs, pre_keys = [], [], []
    for r, (w, dm) in enumerate(zip(work, mats)):
        cl = ClusteringStatus()
        otter_hclust(opts, w.ignore_haps, w.valid, dm, w.reads, cl)
        labels = [-1] * len(w.reads)
        for i, l in enumerate(cl.labels):
            labels[w.valid[i]] = l
        clustered.append((cl, labels))
        if not w.invalid:
            continue
        for i in range(len(labels)):
            if labels[i] >= 0:
                continue
            for j in range(len(labels)):
                if i != j and labels[j] >= 0 and w.reads[j].is_spanning():
                    pre_jobs.append(_pair_job(w.reads[i], w.reads[j]))
                    pre_keys.append((r, i, j))
    pre_all: Dict[int, dict] = {}
    for (r, i, j), d in zip(pre_keys, pair_distances(pre_jobs, device, fdt)):
        pre_all.setdefault(r, {})[(i, j)] = d
    staged, tasks = [], []
    for r, (w, dm) in enumerate(zip(work, mats)):
        cl, labels = clustered[r]
        if w.invalid:
            invalid_reassignment(opts, cl.fc, w.reads, labels,
                                 pre_all.get(r, {}), device, fdt)
        alleles = [AnAllele() for _ in range(cl.fc)]
        tasks.extend(consensus_prepare(w.ignore_haps, w.reads, labels,
                                       w.valid, cl.fc, dm, alleles, fdt))
        staged.append((w, cl, alleles))
    clock("clustering")
    flat, owners = [], []
    for t in tasks:
        jobs_t = t.flat_jobs()
        owners.append((len(flat), len(jobs_t)))
        flat.extend(jobs_t)
    cigars = dp.affine_cigars(flat, device)
    clock("alignments")
    for t, (s, n) in zip(tasks, owners):
        t.apply(cigars[s : s + n])
    clock("graphs")
    for w, cl, alleles in staged:
        key = (w.chrom, w.start, w.end)
        for l in range(cl.fc):
            alleles[l].ic = cl.ic
            out[key].append((alleles[l].to_sam(
                f"{w.chrom}:{w.start}-{w.end}_{l}", w.chrom, w.start, w.end,
                opts.read_group), float(alleles[l].se)))
    return out


class _Clock:
    """Seconds since the previous call, added to ``times[stage]``."""

    def __init__(self, times: Optional[Dict[str, float]]):
        import time

        self.times = times
        self.now = time.perf_counter
        self.last = self.now()

    def __call__(self, stage: str) -> None:
        t = self.now()
        if self.times is not None:
            self.times[stage] = self.times.get(stage, 0.0) + t - self.last
        self.last = t


def needed_pairs(opts: Opts, bam_path: str, fasta_path: Optional[str],
                 regions: Sequence[Tuple[str, int, int]], device):
    """(m, n, d) of every all-vs-all end-to-end pair otter aligns in these
    regions (m <= n the lengths, d their edit distance), and the bases of
    the distinct reads those pairs read: the work the inputs need."""
    fasta = Fasta(fasta_path) if fasta_path else None
    with BamReader(bam_path, load_index=True) as bam:
        work = [w for w in (_prepare(opts, c, s, e, bam, fasta, device)
                            for c, s, e in regions) if w is not None]
    pairs, bases = [], 0
    for w in work:
        if opts.max_alleles == 1 or not w.ignore_haps:
            continue
        seqs = [w.reads[v].seq for v in w.valid]
        bases += sum(len(s) for s in set(seqs))
        for a in range(len(seqs)):
            for b in range(a + 1, len(seqs)):
                if seqs[a] != seqs[b]:
                    pairs.append((seqs[a], seqs[b]))
    d = dp.edit_distances(pairs, device)
    m = np.array([min(len(x), len(y)) for x, y in pairs], dtype=np.int64)
    n = np.array([max(len(x), len(y)) for x, y in pairs], dtype=np.int64)
    return m, n, d, bases
