"""The port's BAI region walk (``io/bam.py::BamReader._walk``) on an indexed
BAM of long reads: ``fetch_raw`` and ``fetch`` give exactly the records of a
linear scan filtered by overlap, the walk ends at the first record past the
region, and a pass over the regions inflates each BGZF block about once.

Reads of 10-20 kb tiled at ~20x over 600 kb sit in the 16 kb, 128 kb and
1 Mb bins, so a region's BAI chunks reach far past it: the walk must stop
at the first record with ``ref_id != tid or pos >= end``, as htslib's
iterator does. The extractors on top (``parse_anreads``,
``parse_analleles``) are held to their Python oracles and to the JAX
package's, whose walk reads every chunk to its end."""

import random

import pytest

from otter_tpu.config import OtterOpts as JaxOpts
from otter_tpu.io.bam import BamReader as JaxReader
from otter_tpu.io.bed import BED as JaxBED
from otter_tpu.seqs import extract as jax_extract
from otter_tpu_torch.config import OtterOpts
from otter_tpu_torch.io.bam import FLAG_UNMAP, BamReader, _decode_record
from otter_tpu_torch.io.bed import BED
from otter_tpu_torch.io.bgzf import BgzfReader
from otter_tpu_torch.seqs import extract
from otter_tpu_torch.utils import metrics

from fixtures import make_bam, read_record

CHR1_LEN = 620_000     # reads end by 600 kb; the last 20 kb hold none
TILED = 600_000
CHR2_LEN = 40_000
SAMPLES = {"S1": 0, "S2": 1}
M, I, D, S = 0, 1, 2, 4


def _catalog():
    """A locus every 8 kb along the tiled span, 40-2,000 bp long."""
    rng = random.Random(11)
    return [("chr1", p, p + rng.randint(40, 2000))
            for p in range(3_000, TILED - 2_000, 8_000)]


CATALOG = _catalog()
NAMED = {
    "start": ("chr1", 0, 2_000),
    "middle": ("chr1", 300_000, 300_500),
    "leaf_boundary": ("chr1", 10 * 16_384 - 100, 10 * 16_384 + 100),
    "coarse_boundary": ("chr1", 2 * 131_072 - 50, 2 * 131_072 + 50),
    "end": ("chr1", TILED - 1_000, TILED),
    "past_last_read": ("chr1", TILED + 5_000, TILED + 6_000),
    "chr2": ("chr2", 15_000, 16_000),
    "unknown_contig": ("chrX", 1_000, 2_000),
}
REGIONS = list(NAMED.values()) + CATALOG


def _read(rng, k, tid, ref, pos, length, ta):
    """One read at pos of ~length reference bases: all M, or soft clips
    with an insertion and a deletion; flags, mapq and tags vary."""
    if rng.random() < 0.5:
        seq = ref[pos:pos + length]
        cigar = [(len(seq), M)]
    else:
        a, b = length // 3, length // 3
        c = length - a - b - 40
        clip = "".join(rng.choices("ACGT", k=60))
        ins = "".join(rng.choices("ACGT", k=30))
        seq = (clip + ref[pos:pos + a] + ins + ref[pos + a:pos + a + b]
               + ref[pos + a + b + 40:pos + length] + clip[:25])
        cigar = [(60, S), (a, M), (30, I), (b, M), (40, D), (c, M), (25, S)]
    r = rng.random()
    flag = (256 if r < 0.04 else 2048 if r < 0.08 else FLAG_UNMAP
            if r < 0.11 else 16 if r < 0.5 else 0)
    tags = [("RG", "Z", rng.choice(sorted(SAMPLES))),
            ("rq", "f", rng.choice((0.999, 0.995, 0.5)))]
    if rng.random() < 0.5:
        tags += [("HP", "i", rng.randint(1, 2)), ("PS", "i", 1000 + k)]
    if ta is not None:
        tags += [("ta", "Z", ta), ("tc", "i", rng.randint(1, 40)),
                 ("ac", "i", rng.randint(1, 20)), ("sc", "i", 3),
                 ("ic", "i", 2), ("se", "f", rng.random())]
    return read_record(f"r{k}", tid, pos, seq, cigar,
                       mapq=rng.choice((60, 60, 60, 3)), flag=flag, tags=tags)


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    rng = random.Random(2024)
    ref1 = "".join(rng.choices("ACGT", k=CHR1_LEN))
    ref2 = "".join(rng.choices("ACGT", k=CHR2_LEN))
    records = []
    n = TILED * 20 // 15_000
    for k in range(n):
        length = rng.randint(10_000, 20_000)
        pos = min(k * (TILED // n) + rng.randint(0, 600), TILED - length)
        # a read carries the locus tag of one locus it overlaps
        over = [f"{c}:{s}-{e}" for c, s, e in CATALOG
                if s < pos + length and e > pos]
        ta = rng.choice(over) if over and rng.random() < 0.6 else None
        records.append(_read(rng, k, 0, ref1, pos, length, ta))
    for k in range(n, n + 40):
        length = rng.randint(10_000, 20_000)
        pos = rng.randint(0, CHR2_LEN - length)
        records.append(_read(rng, k, 1, ref2, pos, length, None))
    path = str(tmp_path_factory.mktemp("bamq") / "reads.bam")
    make_bam(path, [("chr1", CHR1_LEN), ("chr2", CHR2_LEN)], records)
    return path


def _key(rec):
    return (rec.name, rec.flag, rec.ref_id, rec.pos, rec.mapq,
            list(rec.cigar), rec.seq, bytes(rec.aux))


def _split(raw):
    """The records of a raw stream, decoded."""
    out, off = [], 0
    while off < len(raw):
        bs = int.from_bytes(raw[off:off + 4], "little")
        out.append(_decode_record(raw[off + 4:off + 4 + bs]))
        off += 4 + bs
    return out


@pytest.fixture(scope="module")
def linear(bam):
    """Every record of the file, in file order, from a scan without index."""
    with BamReader(bam, load_index=False) as rd:
        return list(rd), list(rd.ref_names)


def _scan(linear, chrom, start, end):
    recs, names = linear
    if chrom not in names:
        return []
    tid = names.index(chrom)
    return [_key(r) for r in recs
            if r.ref_id == tid and r.pos < end and r.end_pos() > start
            and not r.flag & FLAG_UNMAP]


def _regions(name, linear):
    """The regions of a case: a named one, the catalog, or regions that end
    at, or start at, the first base of every 25th read on chr1."""
    if name == "catalog":
        return CATALOG
    if name == "read_starts":
        starts = [r.pos for r in linear[0] if r.ref_id == 0][::25]
        return ([("chr1", max(0, p - 300), p) for p in starts]
                + [("chr1", p, p + 1) for p in starts])
    return [NAMED[name]]


CASES = sorted(NAMED) + ["catalog", "read_starts"]


def test_fixture_reaches_the_coarse_bins(linear):
    from otter_tpu_torch.io.bai import reg2bin
    levels = {0: 0, 1: 0, 2: 0}
    for r in linear[0]:
        b = reg2bin(r.pos, r.end_pos())
        levels[0 if b >= 4681 else 1 if b >= 585 else 2] += 1
    assert min(levels.values()) > 0, levels


@pytest.mark.parametrize("native", ["native", "python"])
@pytest.mark.parametrize("name", CASES)
def test_fetch_equals_linear_scan(bam, linear, name, native, monkeypatch,
                                  capfd):
    if native == "python":
        monkeypatch.setenv("OTTER_TPU_NATIVE_IO", "0")
    regions = _regions(name, linear)
    with BamReader(bam) as rd:
        for chrom, start, end in regions:
            got = [_key(r) for r in rd.fetch(chrom, start, end)]
            assert got == _scan(linear, chrom, start, end), (chrom, start)
    err = capfd.readouterr().err
    assert ("WARNING: query failed at region chrX:1000-2000" in err) == \
        (name == "unknown_contig")


@pytest.mark.parametrize("name", CASES)
def test_fetch_raw_ends_at_the_region(bam, linear, name):
    """``fetch_raw``'s stream holds no record past the region, its overlap
    filter gives the linear scan's records, and it is a prefix of the
    stream of the JAX package's walk, which reads every chunk to its end."""
    regions = _regions(name, linear)
    with BamReader(bam) as rd, JaxReader(bam) as jrd:
        for chrom, start, end in regions:
            got = rd.fetch_raw(chrom, start, end)
            full = jrd.fetch_raw(chrom, start, end)
            if name == "unknown_contig":
                assert got is None and full is None
                continue
            tid, raw = got
            assert tid == full[0] == rd.tid(chrom)
            assert full[1].startswith(raw)
            recs = _split(raw)
            assert all(r.ref_id == tid and r.pos < end for r in recs)
            kept = [_key(r) for r in recs
                    if r.end_pos() > start and not r.flag & FLAG_UNMAP]
            assert kept == _scan(linear, chrom, start, end), (chrom, start)


def test_unindexed_reader(bam, linear):
    with BamReader(bam, load_index=False) as rd:
        for chrom, start, end in (NAMED["middle"], NAMED["chr2"]):
            assert rd.fetch_raw(chrom, start, end) is None
            assert [_key(r) for r in rd.fetch(chrom, start, end)] == \
                _scan(linear, chrom, start, end)


def _blocks(path):
    rd = BgzfReader(path)
    n, coffset = 0, 0
    while True:
        _, bsize = rd._read_block_at(coffset)
        if bsize == 0:
            break
        n, coffset = n + 1, coffset + bsize
    rd.close()
    return n


def test_a_pass_inflates_each_block_about_once(bam):
    """Over every region of the fixture in order, one reader inflates at
    most the file's blocks plus one a region; the JAX package's walk, which
    reads past each region, hands its parser several times the bytes."""
    blocks = _blocks(bam)
    metrics.reset()
    port_bytes = jax_bytes = 0
    with BamReader(bam) as rd, JaxReader(bam) as jrd:
        for chrom, start, end in REGIONS:
            got = rd.fetch_raw(chrom, start, end)
            full = jrd.fetch_raw(chrom, start, end)
            port_bytes += len(got[1]) if got else 0
            jax_bytes += len(full[1]) if full else 0
    inflates = metrics.snapshot()["count.bgzf_inflates"]
    assert 0 < inflates <= blocks + len(REGIONS), (inflates, blocks)
    assert 3 * port_bytes < jax_bytes, (port_bytes, jax_bytes)


def _anreads(reads):
    return [(r.name, r.seq, tuple(r.ccoords), r.is_spanning_l,
             r.is_spanning_r, r.rq, r.hpt.ps, r.hpt.hp) for r in reads]


def _alleles(got):
    block, idx = got
    return [(a.seq, a.scov, a.acov, a.tcov, a.se, a.ic, a.hpt.ps, a.hpt.hp)
            for a in block], list(idx)


def _port(kind, device, rd, region):
    params = OtterOpts()
    params.device = device
    bed = BED(*region)
    if kind == "anreads":
        if device != "host":
            got = extract._parse_anreads_native(params, bed, rd)
            assert got is not None
            return _anreads(got)
        return _anreads(extract.parse_anreads(params, bed, rd))
    if device != "host":
        got = extract._parse_analleles_native(rd, bed, SAMPLES)
        assert got is not None
        return _alleles(got)
    return _alleles(extract.parse_analleles(params, rd, bed, SAMPLES))


def _jax(kind, rd, region):
    params = JaxOpts()
    bed = JaxBED(*region)
    if kind == "anreads":
        return _anreads(jax_extract.parse_anreads(params, bed, rd))
    if kind == "analleles":
        return _alleles(jax_extract.parse_analleles(params, rd, bed, SAMPLES))
    return [_key(r) for r in rd.fetch(*region)]


@pytest.mark.parametrize("case", [
    "anreads_vs_oracle", "anreads_vs_jax", "analleles_vs_oracle",
    "analleles_vs_jax", "fetch_vs_jax"])
def test_extractors_region_by_region(bam, case, capfd):
    """The native extractors on the port's walk equal their Python oracles
    (``fetch``) and the JAX package's extractors, region by region."""
    kind, _, other = case.partition("_vs_")
    with BamReader(bam) as rd, JaxReader(bam) as jrd:
        nonempty = 0
        for region in REGIONS:
            if kind == "fetch":
                got = [_key(r) for r in rd.fetch(*region)]
            else:
                got = _port(kind, "cuda", rd, region)
            want = (_port(kind, "host", rd, region) if other == "oracle"
                    else _jax(kind, jrd, region))
            assert got == want, (case, region)
            nonempty += bool(got[0] if kind == "analleles" else got)
    assert nonempty >= len(CATALOG)
    capfd.readouterr()
