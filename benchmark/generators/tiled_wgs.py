"""Whole-genome layout: tandem-repeat loci spread along one contig, one
sample whose two haplotypes are each tiled end to end by layers of long
reads.

The mix (``traffic/<mix>.json``) gives the loci: ``spacing`` bases a
locus, a reference length from fixed quantiles of ``ref_len`` (spread
``ref_spread``), a motif of ``motif_len`` bases with ``impurity`` of its
bases substituted, and in a share ``het_share`` of the loci a second
allele that adds or removes ``alt_units`` motif units (fixed quantiles,
every other one a contraction, which keeps at least half of the repeat).
The deployment (``configs/<name>.json``) gives the reads: ``coverage``
(half a haplotype), lengths from fixed quantiles of a lognormal
(``read_len_mean``, ``read_len_sd``) in the haplotype's own bases, and
``error``. A read ends wherever its length takes it, inside a locus too,
at the rate the lengths give.
"""

from __future__ import annotations

import math
import statistics
from typing import List, Tuple

from .common import (Fixture, Haplotype, bases, quantiles, repeat, rng,
                     write_outputs)


def plan_loci(config: dict, traffic: dict, seed: int
              ) -> List[Tuple[str, str]]:
    """(reference allele, second allele) of every locus in contig order;
    the sizes are the same for every seed, the seed orders them and picks
    the bases."""
    n = config["loci"]
    fixed = rng(0, 100)
    ref_lens = [int(round(v)) for v in quantiles(
        *traffic["ref_len"], n, traffic.get("ref_spread", "uniform"))]
    motifs = [int(v) for v in fixed.integers(traffic["motif_len"][0],
                                             traffic["motif_len"][1] + 1, n)]
    n_het = int(round(traffic["het_share"] * n))
    units = [int(round(v)) for v in quantiles(*traffic["alt_units"], n_het)]
    units = [units[i] * (1 if i % 2 else -1) for i in fixed.permutation(n_het)]
    het = {int((j + 0.5) * n / n_het): units[j] for j in range(n_het)}
    r = rng(seed, 1)
    out = []
    for i in r.permutation(n).tolist():
        motif = bases(r, motifs[i])
        ref = repeat(r, motif, ref_lens[i], traffic["impurity"])
        du = het.get(i)
        if du is None:
            second = ref
        elif du > 0:
            second = ref + repeat(r, motif, du * len(motif),
                                  traffic["impurity"])
        else:
            second = ref[: max(len(ref) // 2, len(ref) + du * len(motif))]
        out.append((ref, second))
    return out


def make(tmpdir: str, seed: int, config: dict, traffic: dict) -> Fixture:
    alleles = plan_loci(config, traffic, seed)
    r = rng(seed, 2)
    nprng = rng(seed, 3)
    spacing, lead = traffic["spacing"], 5000
    contig = 2 * lead + spacing * len(alleles)
    background = bases(r, contig)
    loci, parts, at = [], [], 0
    for k, (ref_allele, _second) in enumerate(alleles):
        s = lead + k * spacing + (spacing - len(ref_allele)) // 2
        loci.append((s, s + len(ref_allele)))
        parts += [background[at:s], ref_allele]
        at = s + len(ref_allele)
    ref = "".join(parts) + background[at:]

    mean, sd = config["read_len_mean"], config["read_len_sd"]
    sigma = math.sqrt(math.log(1 + (sd / mean) ** 2))
    dist = statistics.NormalDist(math.log(mean) - sigma * sigma / 2, sigma)
    per_layer = int(math.ceil(contig / mean)) + 8
    lengths = [int(math.exp(dist.inv_cdf((i + 0.5) / per_layer)))
               for i in range(per_layer)]
    records = []
    for h in (0, 1):
        hap = Haplotype(ref, loci, [a[h] for a in alleles])
        for layer in range(config["coverage"] // 2):
            order = r.permutation(per_layer).tolist()
            at = -int(r.integers(0, lengths[order[0]]))
            for li in order:
                a, at = max(at, 0), min(at + lengths[li], len(hap.seq))
                if at - a >= 1000:
                    records.append(hap.read(f"h{h}l{layer}_{a}", a, at,
                                            config["error"], nprng))
                if at >= len(hap.seq):
                    break
    return write_outputs(tmpdir, ref, loci, [records],
                         [config["otter"]["read_group"]], [alleles])
