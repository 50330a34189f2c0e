"""ctypes binding to the native runtime library (csrc/otter_native.cpp).

Builds the shared library on demand with g++ (no external deps) into
``build/otter_tpu_torch/`` at the repository root. Provides the threaded
host halves of the pipeline: BAM parsing, the 2-bit pool packer, edit
distances for pairs no kernel takes, the affine cigar ladder, hclust and
the POA consensus.

Each stage with a native half has a Python oracle beside it, and one
switch chooses between them: ``enabled(name)``. With the switch on, the
stage calls this library, and a failure (a build that fails, a missing
symbol, an error inside a call) raises; nothing degrades to the oracle.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import List, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "csrc", "otter_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "otter_tpu_torch")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def enabled(name: str) -> bool:
    """Whether stage ``name`` takes its native half: OTTER_TPU_NATIVE_<name>,
    default "1"; "0" selects the stage's Python oracle. The stages: IO,
    ANREADS, ANALLELES, KMER, HCLUST, MEDOID, COSINE, AFFINE, POA."""
    return os.environ.get(f"OTTER_TPU_NATIVE_{name}", "1") == "1"


def _lib_path() -> str:
    """Source-hashed library path. dlopen caches by path within a process,
    so rebuilding in place would hand long-lived processes (persistent
    workers, daemons) the stale image; a content-addressed name forces a
    fresh load after every source change."""
    import hashlib

    with open(_SRC, "rb") as fh:
        h = hashlib.sha1(fh.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libotter_native.{h}.so")


def build_native(force: bool = False) -> str:
    lib = _lib_path()
    if not force and os.path.exists(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = lib + f".tmp{os.getpid()}"
    # -ffp-contract=off: float parity paths (hclust Lance-Williams, POA
    # weights) must round like numpy, which never fuses mul+add into FMA
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
           "-shared", "-fPIC", "-pthread", "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib)  # atomic vs concurrent builders
    return lib


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = build_native()
            lib = ctypes.CDLL(path)
            lib.otter_edit_distance.restype = ctypes.c_int32
            lib.otter_edit_distance.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.otter_edit_distance_batch.restype = None
            lib.otter_edit_distance_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.otter_bam_parse.restype = ctypes.c_void_p
            lib.otter_bam_parse.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
            lib.otter_bam_count.restype = ctypes.c_int64
            lib.otter_bam_count.argtypes = [ctypes.c_void_p]
            lib.otter_bam_columns.restype = None
            lib.otter_bam_columns.argtypes = [ctypes.c_void_p] + \
                [ctypes.POINTER(ctypes.c_int32)] * 5 + \
                [ctypes.POINTER(ctypes.c_int64)] * 4
            lib.otter_bam_blob_sizes.restype = ctypes.c_int64
            lib.otter_bam_blob_sizes.argtypes = [ctypes.c_void_p] + \
                [ctypes.POINTER(ctypes.c_int64)] * 4
            lib.otter_bam_blobs.restype = None
            lib.otter_bam_blobs.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint8)]
            lib.otter_bam_free.restype = None
            lib.otter_bam_free.argtypes = [ctypes.c_void_p]
            lib.otter_affine_banded_batch.restype = None
            lib.otter_affine_banded_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),      # seqs
                ctypes.POINTER(ctypes.c_int64),      # offsets
                ctypes.POINTER(ctypes.c_int32),      # pb
                ctypes.POINTER(ctypes.c_int32),      # pe
                ctypes.POINTER(ctypes.c_int32),      # tb
                ctypes.POINTER(ctypes.c_int32),      # te
                ctypes.POINTER(ctypes.c_int32),      # kv
                ctypes.c_int32, ctypes.c_int32,      # n_members, n_threads
                ctypes.c_char_p,                     # cigars
                ctypes.POINTER(ctypes.c_int64),      # cig_off
                ctypes.POINTER(ctypes.c_int32),      # cig_len
                ctypes.POINTER(ctypes.c_int32),      # score
            ]
            lib.otter_poa_consensus_batch.restype = None
            lib.otter_poa_consensus_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),      # bbs
                ctypes.POINTER(ctypes.c_int64),      # bb_off
                ctypes.POINTER(ctypes.c_uint8),      # seqs
                ctypes.POINTER(ctypes.c_int64),      # seq_off
                ctypes.POINTER(ctypes.c_uint8),      # cigs
                ctypes.POINTER(ctypes.c_int64),      # cig_off
                ctypes.POINTER(ctypes.c_uint8),      # span_l
                ctypes.POINTER(ctypes.c_uint8),      # span_r
                ctypes.POINTER(ctypes.c_int64),      # task_off
                ctypes.POINTER(ctypes.c_float),      # cvals
                ctypes.c_float,                      # tval
                ctypes.c_int64, ctypes.c_int32,      # n_tasks, n_threads
                ctypes.POINTER(ctypes.c_uint8),      # out
                ctypes.POINTER(ctypes.c_int64),      # out_off
                ctypes.POINTER(ctypes.c_int32),      # out_len
            ]
            lib.otter_hclust_average.restype = None
            lib.otter_hclust_average.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.otter_hclust_average_batch.restype = None
            lib.otter_hclust_average_batch.argtypes = [
                ctypes.POINTER(ctypes.c_double),     # condensed_all
                ctypes.POINTER(ctypes.c_int64),      # cond_off
                ctypes.POINTER(ctypes.c_int32),      # ns
                ctypes.c_int32,                      # n_mats
                ctypes.POINTER(ctypes.c_int64),      # merge_all
                ctypes.POINTER(ctypes.c_int64),      # merge_off
                ctypes.POINTER(ctypes.c_double),     # height_all
                ctypes.POINTER(ctypes.c_int64),      # height_off
                ctypes.c_int32,                      # n_threads
            ]
            lib.otter_pack_pool_2bit.restype = None
            lib.otter_pack_pool_2bit.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),      # buf
                ctypes.POINTER(ctypes.c_int64),      # offs
                ctypes.c_int32, ctypes.c_int32,      # n_seqs, n_words_pool
                ctypes.c_int32,                      # n_threads
                ctypes.POINTER(ctypes.c_uint32),     # out
            ]
            _lib = lib
        return _lib


def parse_bam_records(raw: bytes):
    """Decode a raw concatenated BAM record stream with the C++ feeder.

    Returns a dict of numpy columns + blob arrays (see otter_native.cpp).
    """
    lib = get_lib()
    buf = np.frombuffer(raw, dtype=np.uint8)
    h = lib.otter_bam_parse(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(raw))
    try:
        n = lib.otter_bam_count(h)
        cols = {k: np.zeros(n, dtype=np.int32)
                for k in ("ref_id", "pos", "flag", "mapq", "l_qseq")}
        offs = {k: np.zeros(n + 1, dtype=np.int64)
                for k in ("name_off", "cigar_off", "seq_off", "aux_off")}
        lib.otter_bam_columns(
            h, *[cols[k].ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
                 for k in ("ref_id", "pos", "flag", "mapq", "l_qseq")],
            *[offs[k].ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
              for k in ("name_off", "cigar_off", "seq_off", "aux_off")])
        sz = [ctypes.c_int64(0) for _ in range(4)]
        lib.otter_bam_blob_sizes(h, *[ctypes.byref(s) for s in sz])
        names = ctypes.create_string_buffer(max(1, sz[0].value))
        cigars = np.zeros(max(1, sz[1].value), dtype=np.uint32)
        seqs = ctypes.create_string_buffer(max(1, sz[2].value))
        auxs = np.zeros(max(1, sz[3].value), dtype=np.uint8)
        lib.otter_bam_blobs(
            h, names, cigars.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            seqs, auxs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return {
            **cols, **offs,
            "names": names.raw[: sz[0].value],
            "cigars": cigars[: sz[1].value],
            "seqs": seqs.raw[: sz[2].value],
            "auxs": auxs[: sz[3].value],
        }
    finally:
        lib.otter_bam_free(h)


def edit_distance_batch(pairs: List[Tuple[str, str]],
                        n_threads: int = 1) -> Tuple[np.ndarray, int]:
    """Exact edit distances via the native library; returns (dists, cells)."""
    lib = get_lib()
    blobs = []
    offsets = np.zeros(2 * len(pairs) + 1, dtype=np.int64)
    pos = 0
    for i, (a, b) in enumerate(pairs):
        ab = a.encode("latin-1")
        bb = b.encode("latin-1")
        blobs.append(ab)
        blobs.append(bb)
        offsets[2 * i + 1] = pos + len(ab)
        offsets[2 * i + 2] = pos + len(ab) + len(bb)
        pos += len(ab) + len(bb)
    seqs = np.frombuffer(b"".join(blobs) + b"\x00", dtype=np.uint8).copy()
    out = np.zeros(len(pairs), dtype=np.int32)
    cells = ctypes.c_int64(0)
    lib.otter_edit_distance_batch(
        seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(pairs), n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(cells))
    return out.astype(np.int64), int(cells.value)


# cap transient H/E/F footprint across affine worker threads
_AFFINE_MEM_BUDGET = 3 * 1024 * 1024 * 1024


def affine_banded_cigar_batch(jobs, ks, n_threads: int = 0):
    """Native banded gap-affine cigars with traceback.

    jobs: (pattern, text, pb, pe, tb, te) tuples; ks: per-job band
    half-width (k >= max(m, n) covers the full matrix -> unconditionally
    exact). Returns (cigars, scores); the caller applies the band-validity
    check / escalation exactly as for the numpy path.
    """
    lib = get_lib()
    B = len(jobs)
    blobs = []
    offsets = np.zeros(2 * B + 1, dtype=np.int64)
    cig_off = np.zeros(B + 1, dtype=np.int64)
    pos = 0
    for i, (a, b, _pb, _pe, _tb, _te) in enumerate(jobs):
        ab = a.encode("latin-1")
        bb = b.encode("latin-1")
        blobs.append(ab)
        blobs.append(bb)
        offsets[2 * i + 1] = pos + len(ab)
        offsets[2 * i + 2] = pos + len(ab) + len(bb)
        pos += len(ab) + len(bb)
        cig_off[i + 1] = cig_off[i] + len(ab) + len(bb) + 1
    seqs = np.frombuffer(b"".join(blobs) + b"\x00", dtype=np.uint8).copy()
    pb = np.array([j[2] for j in jobs], dtype=np.int32)
    pe = np.array([j[3] for j in jobs], dtype=np.int32)
    tb = np.array([j[4] for j in jobs], dtype=np.int32)
    te = np.array([j[5] for j in jobs], dtype=np.int32)
    kv = np.asarray(ks, dtype=np.int32)
    cigars = ctypes.create_string_buffer(int(cig_off[-1]) + 1)
    cig_len = np.zeros(B, dtype=np.int32)
    score = np.zeros(B, dtype=np.int32)
    if n_threads <= 0:
        n_threads = min(32, os.cpu_count() or 1)
    per_member = max(
        3 * 4 * (len(j[0]) + 1) * 2 * (int(k) + 1)
        for j, k in zip(jobs, kv))
    n_threads = max(1, min(n_threads, B,
                           _AFFINE_MEM_BUDGET // max(1, per_member)))
    lib.otter_affine_banded_batch(
        seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pe.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        te.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        kv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        B, n_threads, cigars,
        cig_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cig_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        score.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    out = []
    for i in range(B):
        s = int(cig_off[i])
        out.append(cigars.raw[s : s + int(cig_len[i])].decode("ascii"))
    return out, score


def poa_consensus_batch(tasks, cvals, tval: float,
                        n_threads: int = 0) -> List[str]:
    """Batched native PPOA consensus (reference src/anppoa.hpp semantics;
    byte-identical to ops/poa.py::Ppoa — the host parity oracle).

    tasks: list of (backbone, members) where members is a list of
    (sequence, cigar, span_l, span_r) with cigars already resolved (the
    stale-cigar reuse applied by the caller). cvals: per-task prune
    constant c; tval: prune fraction t.
    """
    lib = get_lib()
    n_tasks = len(tasks)
    bb_blobs: List[bytes] = []
    seq_blobs: List[bytes] = []
    cig_blobs: List[bytes] = []
    span_l: List[int] = []
    span_r: List[int] = []
    bb_off = np.zeros(n_tasks + 1, dtype=np.int64)
    task_off = np.zeros(n_tasks + 1, dtype=np.int64)
    out_off = np.zeros(n_tasks + 1, dtype=np.int64)
    n_members = sum(len(members) for _bb, members in tasks)
    seq_off = np.zeros(n_members + 1, dtype=np.int64)
    cig_off = np.zeros(n_members + 1, dtype=np.int64)
    mi = 0
    for t, (bb, members) in enumerate(tasks):
        bbb = bb.encode("latin-1")
        bb_blobs.append(bbb)
        bb_off[t + 1] = bb_off[t] + len(bbb)
        cap = len(bbb) + 1
        for seq, cig, sl, sr in members:
            sb = seq.encode("latin-1")
            cb = cig.encode("latin-1")
            seq_blobs.append(sb)
            cig_blobs.append(cb)
            seq_off[mi + 1] = seq_off[mi] + len(sb)
            cig_off[mi + 1] = cig_off[mi] + len(cb)
            span_l.append(1 if sl else 0)
            span_r.append(1 if sr else 0)
            cap += len(sb)
            mi += 1
        task_off[t + 1] = mi
        out_off[t + 1] = out_off[t] + cap
    bbs = np.frombuffer(b"".join(bb_blobs) + b"\x00", dtype=np.uint8).copy()
    seqs = np.frombuffer(b"".join(seq_blobs) + b"\x00", dtype=np.uint8).copy()
    cigs = np.frombuffer(b"".join(cig_blobs) + b"\x00", dtype=np.uint8).copy()
    sl_arr = np.asarray(span_l, dtype=np.uint8)
    sr_arr = np.asarray(span_r, dtype=np.uint8)
    cv = np.asarray(cvals, dtype=np.float32)
    out = np.zeros(int(out_off[-1]) + 1, dtype=np.uint8)
    out_len = np.zeros(n_tasks, dtype=np.int32)
    if n_threads <= 0:
        n_threads = min(32, os.cpu_count() or 1)
    n_threads = max(1, min(n_threads, n_tasks))

    def p8(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    lib.otter_poa_consensus_batch(
        p8(bbs), p64(bb_off), p8(seqs), p64(seq_off), p8(cigs), p64(cig_off),
        p8(sl_arr), p8(sr_arr), p64(task_off),
        cv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(tval), n_tasks, n_threads,
        p8(out), p64(out_off),
        out_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    res = []
    for t in range(n_tasks):
        o = int(out_off[t])
        res.append(out[o : o + int(out_len[t])].tobytes().decode("latin-1"))
    return res


_ANREAD_RQ_ABSENT = -1e300
_ANREAD_AUX_ABSENT = -(2 ** 31)


def anreads_parse(raw: bytes, tid: int, qstart: int, qend: int,
                  bstart: int, bend: int, mapq_min: int, nonprimary: bool,
                  omitnonspanning: bool, read_quality: float):
    """Native region read extraction (anseqs.cpp:286-460 semantics; the
    python oracle is seqs/breakpoints.py + seqs/extract.py). Returns a dict
    of columns, or raises SystemExit on the reference's inconsistent-coords
    error."""
    lib = get_lib()
    if not hasattr(lib, "_anreads_ready"):
        lib.otter_anreads_parse.restype = ctypes.c_void_p
        lib.otter_anreads_parse.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_double]
        lib.otter_anreads_count.restype = ctypes.c_int64
        lib.otter_anreads_count.argtypes = [ctypes.c_void_p]
        lib.otter_anreads_blob_sizes.restype = ctypes.c_int64
        lib.otter_anreads_blob_sizes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.otter_anreads_export.restype = None
        lib.otter_anreads_export.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.otter_anreads_error_name.restype = None
        lib.otter_anreads_error_name.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.otter_anreads_free.restype = None
        lib.otter_anreads_free.argtypes = [ctypes.c_void_p]
        lib._anreads_ready = True
    buf = np.frombuffer(raw, dtype=np.uint8)
    h = lib.otter_anreads_parse(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(raw),
        tid, qstart, qend, bstart, bend, mapq_min,
        1 if nonprimary else 0, 1 if omitnonspanning else 0, read_quality)
    try:
        n = lib.otter_anreads_count(h)
        if n < 0:
            name = ctypes.create_string_buffer(512)
            lib.otter_anreads_error_name(h, name, 512)
            import sys as _sys

            from .utils.timestamp import antimestamp
            _sys.stderr.write(
                f"({antimestamp()}): ERROR: unexpected querty start/end "
                f"coords found for read {name.value.decode()}\n")
            raise SystemExit(1)
        sizes = [ctypes.c_int64(0), ctypes.c_int64(0)]
        lib.otter_anreads_blob_sizes(h, *[ctypes.byref(s) for s in sizes])
        names = ctypes.create_string_buffer(max(1, sizes[0].value))
        seqs = ctypes.create_string_buffer(max(1, sizes[1].value))
        name_off = np.zeros(n + 1, dtype=np.int64)
        seq_off = np.zeros(n + 1, dtype=np.int64)
        span_l = np.zeros(n, dtype=np.uint8)
        span_r = np.zeros(n, dtype=np.uint8)
        cc0 = np.zeros(n, dtype=np.int32)
        cc1 = np.zeros(n, dtype=np.int32)
        rq = np.zeros(n, dtype=np.float64)
        hp = np.zeros(n, dtype=np.int32)
        ps = np.zeros(n, dtype=np.int32)

        def p(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        lib.otter_anreads_export(
            h, names, p(name_off, ctypes.c_int64), seqs,
            p(seq_off, ctypes.c_int64), p(span_l, ctypes.c_uint8),
            p(span_r, ctypes.c_uint8), p(cc0, ctypes.c_int32),
            p(cc1, ctypes.c_int32), p(rq, ctypes.c_double),
            p(hp, ctypes.c_int32), p(ps, ctypes.c_int32))
        return {
            "n": int(n), "names": names.raw[: sizes[0].value],
            "name_off": name_off, "seqs": seqs.raw[: sizes[1].value],
            "seq_off": seq_off, "span_l": span_l, "span_r": span_r,
            "cc0": cc0, "cc1": cc1, "rq": rq, "hp": hp, "ps": ps,
        }
    finally:
        lib.otter_anreads_free(h)


def hclust_average_native(condensed: np.ndarray, n: int):
    """Average-linkage NN-chain via the native library; exact f64 parity
    with ops/hclust.py::hclust_average (ties included — same scan order,
    same non-contracted Lance-Williams rounding). Returns (merge, height)."""
    lib = get_lib()
    cond = np.ascontiguousarray(condensed, dtype=np.float64)
    merge = np.zeros((max(0, n - 1), 2), dtype=np.int64)
    height = np.zeros(max(0, n - 1), dtype=np.float64)
    if n >= 2:
        lib.otter_hclust_average(
            cond.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            merge.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            height.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return merge, height


def hclust_average_native_batch(mats, n_threads: int = 0):
    """Batched native hclust: ``mats`` is a list of (condensed, n); returns
    a list of (merge, height). Threaded across matrices (the cohort
    genotype path runs one matrix per region)."""
    lib = get_lib()
    if not mats:
        return []
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    conds = [np.ascontiguousarray(c, dtype=np.float64) for c, _n in mats]
    ns = np.array([n for _c, n in mats], dtype=np.int32)
    cond_off = np.zeros(len(mats) + 1, dtype=np.int64)
    np.cumsum([c.size for c in conds], out=cond_off[1:])
    blob = (np.concatenate(conds) if conds else
            np.zeros(0, dtype=np.float64))
    nm = np.maximum(ns - 1, 0).astype(np.int64)
    height_off = np.zeros(len(mats) + 1, dtype=np.int64)
    np.cumsum(nm, out=height_off[1:])
    merge_off = height_off * 2
    merge_all = np.zeros(int(merge_off[-1]), dtype=np.int64)
    height_all = np.zeros(int(height_off[-1]), dtype=np.float64)
    lib.otter_hclust_average_batch(
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cond_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ns.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(mats), merge_all.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        merge_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        height_all.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        height_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_threads)
    out = []
    for i in range(len(mats)):
        h0, h1 = int(height_off[i]), int(height_off[i + 1])
        out.append((merge_all[2 * h0 : 2 * h1].reshape(-1, 2),
                    height_all[h0:h1]))
    return out


def analleles_parse(raw: bytes, tid: int, qstart: int, qend: int,
                    target: str):
    """Genotype allele feeder (otter_native.cpp::otter_analleles_parse):
    raw BAM record stream -> (seqs, rgs, tc, ac, sc, ps, hp, ic, se)
    with parse_anallele's exact filter/tag semantics, in fetch order."""
    lib = get_lib()
    lib.otter_analleles_parse.restype = ctypes.c_void_p
    buf = np.frombuffer(raw, dtype=np.uint8)
    tgt = target.encode()
    h = lib.otter_analleles_parse(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(raw)), tid,
        ctypes.c_int64(qstart), ctypes.c_int64(qend),
        ctypes.c_char_p(tgt), ctypes.c_int64(len(tgt)))
    try:
        lib.otter_analleles_count.restype = ctypes.c_int64
        n = lib.otter_analleles_count(ctypes.c_void_p(h))
        seq_total = ctypes.c_int64()
        rg_total = ctypes.c_int64()
        lib.otter_analleles_blob_sizes(ctypes.c_void_p(h),
                                       ctypes.byref(seq_total),
                                       ctypes.byref(rg_total))
        cols = {k: np.zeros(n, dtype=np.int32)
                for k in ("tc", "ac", "sc", "ps", "hp", "ic")}
        se = np.zeros(n, dtype=np.float64)
        seq_off = np.zeros(n + 1, dtype=np.int64)
        rg_off = np.zeros(n + 1, dtype=np.int64)
        seqs = ctypes.create_string_buffer(max(1, seq_total.value))
        rgs = ctypes.create_string_buffer(max(1, rg_total.value))
        lib.otter_analleles_columns(
            ctypes.c_void_p(h),
            *[cols[k].ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
              for k in ("tc", "ac", "sc", "ps", "hp", "ic")],
            se.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            rg_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            seqs, rgs)
        seq_blob = seqs.raw[: seq_total.value].decode("ascii")
        rg_blob = rgs.raw[: rg_total.value].decode("ascii")
        out_seqs = [seq_blob[seq_off[i] : seq_off[i + 1]] for i in range(n)]
        out_rgs = [rg_blob[rg_off[i] : rg_off[i + 1]] for i in range(n)]
        return out_seqs, out_rgs, cols, se
    finally:
        lib.otter_analleles_free(ctypes.c_void_p(h))


def pack_pool_2bit_native(seqs: List[str], n_words_pool: int,
                          n_threads: int = 0) -> np.ndarray:
    """(S, n_words_pool) int32 2-bit packed pool rows, bit-identical to
    myers_pallas.pack_pool_2bit (the numpy oracle)."""
    lib = get_lib()
    S = len(seqs)
    offs = np.zeros(S + 1, dtype=np.int64)
    pos = 0
    blobs = []
    for i, s in enumerate(seqs):
        b = s.encode("latin-1")
        blobs.append(b)
        pos += len(b)
        offs[i + 1] = pos
    buf = np.frombuffer(b"".join(blobs) + b"\x00", dtype=np.uint8)
    out = np.zeros((S, n_words_pool), dtype=np.uint32)
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    lib.otter_pack_pool_2bit(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        S, n_words_pool, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out.view(np.int32)


def cutree_k_native(n: int, merge: np.ndarray, nclust: int) -> np.ndarray:
    """cutree_k via the native library (otter_native.cpp::otter_cutree_k);
    integer-exact port of ops/hclust.py::cutree_k."""
    lib = get_lib()
    m = np.ascontiguousarray(merge, dtype=np.int64)
    labels = np.zeros(n, dtype=np.int64)
    lib.otter_cutree_k(
        ctypes.c_int32(n),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(nclust),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return labels


def kcounts_native(k: int, seqs) -> np.ndarray:
    """Batched k-mer counts via the native library — bit-identical to
    seqs/kmer.py::seq2kcounts_np (integer counts in f64)."""
    lib = get_lib()
    n = len(seqs)
    width = int(4 ** k) + 1
    out = np.zeros((n, width), dtype=np.float64)
    if n == 0:
        return out
    # latin-1: every accepted char is exactly one byte, so the len(s)
    # character offsets below stay valid byte offsets (UTF-8 would shift
    # every subsequent row's window on a non-ASCII char); chars > U+00FF
    # raise instead of silently corrupting counts
    blob = "".join(seqs).encode("latin-1")
    buf = np.frombuffer(blob, dtype=np.uint8)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offs[1:])
    n_threads = min(8, os.cpu_count() or 1)
    lib.otter_kcounts(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if len(blob)
        else ctypes.cast(0, ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(n), ctypes.c_int32(k), ctypes.c_int32(n_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def medoid_sums_native(condensed: np.ndarray, n: int,
                       idx: np.ndarray) -> np.ndarray:
    """Cluster row sums straight from the condensed matrix (C++,
    otter_medoid_sums) — the accumulation order matches DistMatrix.
    get_medoid's cumsum path exactly; caller argmins (numpy semantics)."""
    lib = get_lib()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    vals = np.ascontiguousarray(condensed, dtype=np.float64)
    m = len(idx)
    out = np.zeros(m, dtype=np.float64)
    n_threads = min(8, os.cpu_count() or 1)
    lib.otter_medoid_sums(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(m), ctypes.c_int32(n_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def cosine_condensed_native(scaled: np.ndarray, norms: np.ndarray,
                            guard: float, prescaled: bool = True):
    """Condensed 1 - round3(cos) from the scaled (n, n) matrix (C++,
    otter_cosine_condensed). ``prescaled=False`` passes the RAW dot-product
    matrix and applies /(ni*nj)*1000 inside the C pass (same elementwise
    f64 ops the python pre-scaling would). Returns (out, near_pos): entries
    listed in near_pos sit within ``guard`` of a .5 rounding boundary and
    MUST be recomputed by the caller with the np.dot oracle
    (kusage_cosine_condensed semantics)."""
    lib = get_lib()
    scaled = np.ascontiguousarray(scaled, dtype=np.float64)
    norms = np.ascontiguousarray(norms, dtype=np.float64)
    n = scaled.shape[0]
    total = n * (n - 1) // 2
    out = np.zeros(total, dtype=np.float64)
    near_cap = max(1024, total // 64)
    near_pos = np.zeros(near_cap, dtype=np.int64)
    n_threads = min(8, os.cpu_count() or 1)
    lib.otter_cosine_condensed.restype = ctypes.c_int64
    count = lib.otter_cosine_condensed(
        scaled.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        norms.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n), ctypes.c_double(float(guard)),
        ctypes.c_int32(n_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        near_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(near_cap), ctypes.c_int32(1 if prescaled else 0))
    if count > near_cap:
        # overflow (pathological): caller falls back to the numpy path
        return None, None
    return out, near_pos[:count]
