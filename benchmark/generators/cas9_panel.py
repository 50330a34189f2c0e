"""Targeted layout: a panel of repeat loci, each cut out by Cas9 at two
fixed sites, so every read of a target is the same fragment (its allele
between the two flanks) and spans it; several samples over one BED and
one reference.

The mix (``traffic/<mix>.json``) lists the panel's ``loci`` (gene, motif,
the published normal range in units; the reference genome holds the
range's middle) and the ``samples`` of a run: each haplotype's allele is
drawn from fixed quantiles of the locus's normal range unless the sample
names an expansion there (``expanded``: gene -> units of haplotype 0 and
1, null for a normal allele). The deployment gives ``coverage`` (reads a
sample a target, fixed quantiles, half a haplotype), ``flank`` (bases of
reference from each cut site to the repeat, fixed quantiles per target)
and ``error``.
"""

from __future__ import annotations

from .common import (Fixture, Haplotype, bases, quantiles, repeat, rng,
                     write_outputs)


def plan_alleles(config: dict, traffic: dict, seed: int):
    """(reference alleles, each sample's (haplotype 0, haplotype 1) a
    locus); the units of every allele are the same for every seed."""
    loci, samples = traffic["loci"], traffic["samples"]
    if len(samples) != config["samples"]:
        raise ValueError(f"the mix has {len(samples)} samples, the "
                         f"deployment {config['samples']}")
    fixed = rng(0, 200)
    units = []
    for L in loci:
        q = [int(round(v)) for v in quantiles(*L["normal"],
                                              2 * len(samples))]
        units.append([q[i] for i in fixed.permutation(len(q))])
    r = rng(seed, 1)
    imp = traffic["impurity"]
    ref_alleles, per_sample = [], [[] for _ in samples]
    for li, L in enumerate(loci):
        motif = L["motif"]
        mid = int(round(sum(L["normal"]) / 2))
        ref_alleles.append(repeat(r, motif, mid * len(motif), imp))
        for k, s in enumerate(samples):
            exp = s.get("expanded", {}).get(L["gene"], [None, None])
            pair = []
            for h in (0, 1):
                u = exp[h] if exp[h] is not None else units[li][2 * k + h]
                pair.append(repeat(r, motif, u * len(motif), imp))
            per_sample[k].append(tuple(pair))
    return ref_alleles, per_sample


def make(tmpdir: str, seed: int, config: dict, traffic: dict) -> Fixture:
    ref_alleles, per_sample = plan_alleles(config, traffic, seed)
    n = len(ref_alleles)
    fixed = rng(0, 201)
    fl = [int(round(v)) for v in quantiles(*config["flank"], 2 * n)]
    fl = [fl[i] for i in fixed.permutation(2 * n)]
    lo, hi = config["coverage"]
    n_s = len(per_sample)
    covs = [int(round(v)) for v in quantiles(lo, hi, n * n_s)]
    covs = [covs[i] for i in fixed.permutation(n * n_s)]
    r = rng(seed, 2)
    nprng = rng(seed, 3)
    spacing = 2 * config["flank"][1] + traffic.get("gap", 2000) + max(
        len(a) for a in ref_alleles)
    lead = 5000
    background = bases(r, 2 * lead + spacing * n)
    loci, parts, at = [], [], 0
    for k, allele in enumerate(ref_alleles):
        s = lead + k * spacing + (spacing - len(allele)) // 2
        loci.append((s, s + len(allele)))
        parts += [background[at:s], allele]
        at = s + len(allele)
    ref = "".join(parts) + background[at:]
    reads = []
    for k, alleles in enumerate(per_sample):
        haps = [Haplotype(ref, loci, [a[h] for a in alleles]) for h in (0, 1)]
        records = []
        for li, (s, e) in enumerate(loci):
            for c in range(covs[k * n + li]):
                hap = haps[c % 2]
                piece = 2 * li + 1     # the locus's piece of the haplotype
                h0 = hap.pieces[piece][2]
                h1 = h0 + len(alleles[li][c % 2])
                records.append(hap.read(f"s{k}t{li}_{c}", h0 - fl[2 * li],
                                        h1 + fl[2 * li + 1], config["error"],
                                        nprng))
        reads.append(records)
    names = [s["name"] for s in traffic["samples"]]
    return write_outputs(tmpdir, ref, loci, reads, names, per_sample)
