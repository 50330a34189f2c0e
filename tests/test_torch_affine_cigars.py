"""The cigar bytes of K5 / K6 (``kernels/affine_tb.py``) on the CPU: the
plain version's bytes against the host decode of its own walk codes
(``_decode_walk_ops(_unpack_codes(...))``), member by member, and
``affine_cigars_tb`` against a member-by-member escalation that decodes
on the host.

Every comparison is exact: cigars are compared byte for byte."""

import random

import numpy as np
import pytest
import torch

from otter_tpu_torch.kernels import affine_tb as K

IUPAC = "ACGTNRYSWKMBDHV"


def _seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(alphabet) for _ in range(n))


def _mutate(rng, s, rate, alphabet="ACGT"):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate * 0.4:
            out.append(rng.choice(alphabet))
        elif r < rate * 0.7:
            out.append(ch + rng.choice(alphabet))
        elif r >= rate:
            out.append(ch)
    return "".join(out) or "A"


def _iupac(rng):
    """Members and representatives with N and IUPAC bases (and a lowercase
    one): M against X is a byte compare."""
    jobs = []
    for _ in range(8):
        rep = _seq(rng, rng.randint(60, 220), IUPAC)
        jobs.append((_mutate(rng, rep, 0.05, IUPAC), rep, 0, 0, 0, 0))
    jobs.append(("acgtNNRY" * 9, "ACGTNNRY" * 9, 0, 0, 0, 0))
    return jobs, 63, 256


def _free_ends(rng):
    """A free end on each side in turn, on both sides, and the catalog's
    right-end members: the pattern longer by m - n, pb = m - n."""
    jobs = []
    for q in range(12):
        rep = _seq(rng, rng.randint(120, 240))
        mem = _mutate(rng, rep, 0.03)
        c = rng.randint(5, 40)
        jobs.append([(mem[c:], rep, 0, 0, c, 0), (mem[:-c], rep, 0, 0, 0, c),
                     (rep, mem[c:], c, 0, 0, 0), (rep, mem[:-c], 0, c, 0, 0),
                     (mem[c:-c], rep, 0, 0, c, c),
                     (rep, rep[:-c], c, 0, 0, 0)][q % 6])
    return jobs, 63, 256


def _band(k):
    def make(rng):
        """Members with a gap of up to k / 2 in the pattern or the text
        (runs across many lanes) and an unrelated one (not walked), at
        band k."""
        jobs = []
        for q in range(5):
            rep = _seq(rng, rng.randint(120, 240))
            mem = _mutate(rng, rep, 0.04)
            x, g = rng.randint(0, len(mem) - 1), rng.randint(4, k // 2)
            mem = [mem, mem[:x] + mem[x + g:] or "A",
                   mem[:x] + _seq(rng, g) + mem[x:], _seq(rng, len(rep)),
                   _mutate(rng, rep, 0.1)][q]
            jobs.append((mem, rep, 0, 0, 0, 0))
        return jobs, k, 512
    return make


def _ckpt(rng):
    """A bucket K6 takes (rows * W >= CKPT_CELLS): k = 511, 1,024 rows."""
    jobs = []
    for _ in range(2):
        rep = _seq(rng, rng.randint(700, 1000))
        jobs.append((_mutate(rng, rep, 0.02), rep, 0, 0, 0, 0))
    return jobs, 511, 1024


def _lp_max(rng):
    """A pattern of LP_MAX rows whose end is free past its first ~120
    bases: the longest rows and 'D' tail the buffer takes."""
    rep = _seq(rng, K.LP_MAX)
    p = (_mutate(rng, rep[:120], 0.02) + rep)[: K.LP_MAX]
    return [(p, rep[:100], 0, K.LP_MAX - 100, 0, 0)], 63, K.LP_MAX


def _lt_max(rng):
    """A text of LT_MAX whose end is free past its first ~100 bases: the
    longest 'I' tail the buffer takes (a launch of its own, so the plain
    version's DP runs ~120 rows, not LP_MAX)."""
    rep = _seq(rng, K.LT_MAX)
    head = _mutate(rng, rep[:120], 0.02)
    return [(head, rep, 0, 0, 0, K.LT_MAX - 100)], 63, K.LP_MAX


CASES = {"iupac": _iupac, "free_ends": _free_ends,
         **{f"band{k}": _band(k) for k in K.BANDS},
         "ckpt_bucket": _ckpt, "lp_max": _lp_max, "lt_max": _lt_max}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_cigar_bytes_equal_host_decode(case):
    """The plain version's cigar bytes equal the host decode of its walk
    codes for every member, walked or not (exact)."""
    jobs, k, rows = CASES[case](random.Random(case))
    a, bpad, mn = K.pack_affine_jobs(jobs, rows, k)
    tw = K._t_words(rows, k)
    run = K.affine_tb_ckpt if rows * 2 * (k + 1) >= K.CKPT_CELLS \
        else K.affine_tb
    args = [torch.from_numpy(x) for x in (a, bpad, mn)]
    cig = torch.empty((len(jobs), K.cigar_stride(jobs)), dtype=torch.uint8)
    ops, end = run(*args, k, tw, cig)
    codes = K._unpack_codes(ops.numpy(), tw)
    end = end.numpy()
    got = K.read_cigars(cig.numpy(), mn, np.arange(len(jobs)))
    for b, (p, t, *_frees) in enumerate(jobs):
        want = K._decode_walk_ops(codes[b][codes[b] != 0], p, t,
                                  int(end[b, 1]), int(end[b, 2]), len(p),
                                  len(t))
        assert got[b] == want, b
    assert end[:, 3].sum() >= max(1, len(jobs) // 2)


def _escalating_jobs(rng):
    """Members at 1-30% error against 150-300 bp representatives (some
    take a second band), an unrelated pair with a free text begin that only
    k = 511 admits and no band proves (failed after a launch), and a member
    outside every band (failed before any launch)."""
    jobs = []
    for q in range(6):
        rep = _seq(rng, rng.randint(150, 300))
        jobs.append((_mutate(rng, rep, [0.01, 0.12, 0.3][q % 3]), rep, 0, 0,
                     0, 0))
    jobs.append((_seq(rng, 800), _seq(rng, 800), 0, 0, 300, 0))
    jobs.append((_seq(rng, 700), _seq(rng, 90), 0, 0, 0, 0))
    return jobs


def _member_by_member(jobs):
    """affine_cigars_tb's rule, one member a launch, decoded on the host:
    each admissible band in turn until a walk reaches (0, 0) below the
    band's cap. Returns (cigars, failed, the number of bands each member
    tried)."""
    cigars, failed, tried = [""] * len(jobs), [], []
    for i, (p, t, pb, pe, tb, te) in enumerate(jobs):
        bands = K._admissible_bands(len(p), len(t), pb, pe, tb, te, None)
        tried.append(0)
        for k in bands:
            tried[-1] += 1
            rows = K._rows_bucket(len(p))
            tw = K._t_words(rows, k)
            a, bpad, mn = K.pack_affine_jobs([jobs[i]], rows, k)
            ops, end = K.affine_tb_torch(
                *(torch.from_numpy(x) for x in (a, bpad, mn)), k, tw)
            score, ei, ej, ok = (int(v) for v in end[0])
            if ok and score < mn[0, 6]:
                codes = K._unpack_codes(ops.numpy(), tw)[0]
                cigars[i] = K._decode_walk_ops(codes[codes != 0], p, t, ei,
                                               ej, len(p), len(t))
                break
        else:
            failed.append(i)
    return cigars, failed, tried


def test_affine_cigars_tb_equal_member_by_member_decode():
    """affine_cigars_tb on the CPU (bucketed launches, cigars read from the
    bytes) gives the cigars and failed members of a member-by-member
    escalation decoded on the host; the fixture holds members kept at
    their first band, members kept at a later band and failed ones (one
    refused by every band before any launch)."""
    jobs = _escalating_jobs(random.Random(23))
    cigs, failed = K.affine_cigars_tb(jobs, torch.device("cpu"))
    want_cigs, want_failed, tried = _member_by_member(jobs)
    assert sorted(failed) == want_failed
    assert cigs == want_cigs
    kept = [tried[i] for i in range(len(jobs)) if i not in want_failed]
    assert 1 in kept and max(kept) > 1
    assert [tried[i] for i in want_failed] == [1, 0]
