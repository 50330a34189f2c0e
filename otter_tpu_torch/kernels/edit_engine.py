"""Batched exact edit distances for the assemble pipeline, on PyTorch.

Counterpart of ``EditDistanceEngine`` and ``IndexedPairs`` in
``otter_tpu/kernels/edit_pallas.py``, cut to the surface the assemble path
calls. ``mode`` is ``"cuda"`` (kernels on the card) or ``"torch-cpu"`` (the
kernels' plain versions, for CPU tensors).

Distance routing (after the equal-object and empty-side shortcuts), as on
the TPU:

* ACGT pairs, shorter side <= 2048, longer side <= 32 kb -> K1
  (``myers_pallas``), one launch per n_words bucket {4, 8, 16, 32, 64};
* ACGT pairs, shorter side > 2048, longer side <= 32 kb -> the K3 ladder
  (``myers_banded``) over bands k whose window stays under a quarter of
  the matrix, then K2 (``myers_striped``, full matrix) for the rest; a
  pair a rung k did not resolve skips to the first rung >= min(its banded
  score, 8 k) (rung-jumping, also on the K4 ladder);
* everything else (a non-ACGT char, or a side over 32 kb) -> the K7 ladder
  (``edit_banded``), doubling k until every pair resolves.

Ends-free routing: jobs without frees take the distance path; one-sided
ACGT jobs (both sides non-empty, <= 32 kb) -> K2, or the K4 ladder
(``myers_banded_ef``) first when the free-less side is over 2048; the rest
(frees on both sides, non-ACGT) -> the host DP
``ops.align_batch.edit_ends_free_batch``, as the JAX package does; over a
mesh (``MeshEngine``) that DP's fixed-k passes run on kernel K9
(``edit_banded.edit_banded_ends_free``), as the JAX package's mesh mode
runs them in jnp. Every route is exact.

The ``*_async`` calls launch K1 and the short K2 jobs on the current stream
and return; the ``*_collect`` calls copy those results back and run the
ladders, which read each rung's results before launching the next.
Plain-integer counters record where each pair and job went.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .edit_banded import edit_banded, pack_banded
from .myers_banded import myers_banded, myers_banded_ef
from .myers_pallas import (int32_tensor, myers_pool, pack_pool,
                           pool_width)
from .myers_striped import (dedup_oriented, myers_striped,
                            myers_striped_ends_free_async,
                            myers_striped_ends_free_collect, oriented_inputs,
                            striped_n_words)

# shorter-side thresholds of the K1 n_words buckets 4, 8, 16, 32 (64 above)
_NW_THRESHOLDS = np.asarray([128, 256, 512, 1024], dtype=np.int64)

COUNTERS = ("pairs_k1", "pairs_k3", "pairs_k2", "pairs_k7", "jobs_k2",
            "jobs_k4", "jobs_host", "jobs_k9", "jobs_k5", "jobs_affine_host",
            "cells")


class IndexedPairs:
    """Lazy (x, y) pair container over a unique-sequence pool: pair p is
    (seqs[xi[p]], seqs[yi[p]]). Supports len, [] indexing and iteration;
    only pairs that are touched materialize."""

    __slots__ = ("seqs", "xi", "yi", "lens")

    def __init__(self, seqs: List[str], xi, yi):
        self.seqs = seqs
        self.xi = np.asarray(xi, dtype=np.int64)
        self.yi = np.asarray(yi, dtype=np.int64)
        self.lens = np.fromiter((len(s) for s in seqs), np.int64,
                                len(seqs))

    def __len__(self) -> int:
        return len(self.xi)

    def __getitem__(self, i):
        return (self.seqs[self.xi[i]], self.seqs[self.yi[i]])

    def __iter__(self):
        seqs = self.seqs
        for a, b in zip(self.xi, self.yi):
            yield (seqs[a], seqs[b])

    def maxlens(self) -> np.ndarray:
        return np.maximum(self.lens[self.xi], self.lens[self.yi])


def acgt_flags(seqs: Sequence[str]) -> np.ndarray:
    """(S,) bool: sequence is pure ACGT (one pass over the joined bytes)."""
    if not seqs:
        return np.zeros(0, dtype=bool)
    # one byte per char: a char past latin-1 becomes '?', which is not ACGT
    blob = "".join(seqs).encode("latin-1", "replace")
    bad = np.ones(256, dtype=np.int64)
    bad[list(b"ACGT")] = 0
    csum = np.zeros(len(blob) + 1, dtype=np.int64)
    np.cumsum(bad[np.frombuffer(blob, dtype=np.uint8)], out=csum[1:])
    offs = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offs[1:])
    return (csum[offs[1:]] - csum[offs[:-1]]) == 0


def collect_kde(pv: IndexedPairs, pending: list, out: np.ndarray, device,
                rid: np.ndarray, slot: np.ndarray, ex_entries,
                nvals: np.ndarray, bw: np.ndarray, n_rows: int,
                n_pad: int):
    """The fused collect of K1 results ``pending`` ((pair indices, result
    tensor) on any devices), gathered on ``device``: the distances and the
    batch's scaled KDE (``parallel/mesh.py::kde_fused_from_pairs``, K8)
    in one device-to-host copy. ``rid`` / ``slot``: each pair's KDE row
    (``n_rows`` for a pair of no KDE region) and its slot in the row;
    ``ex_entries``: (row, slot, value) of the host-known values, to which
    the KDE regions' pairs that no kernel took (equal sequences, an empty
    side) are added with their normalised distances. Fills ``out`` and
    returns (out, m, s), m and s (n_rows, G)."""
    from ..ops.kde import kde_grid
    from ..parallel.mesh import kde_fused_from_pairs

    members = np.concatenate([np.asarray(m, dtype=np.int64)
                              for m, _dev in pending])
    flat = torch.cat([dev.to(device) for _m, dev in pending])
    maxlen = pv.maxlens().astype(np.float64)
    on_dev = np.zeros(len(pv), dtype=bool)
    on_dev[members] = True
    host_idx = np.nonzero(~on_dev & (rid < n_rows))[0]
    ex_row = [int(r) for r, _s, _v in ex_entries] + rid[host_idx].tolist()
    ex_slot = [int(s) for _r, s, _v in ex_entries] + slot[host_idx].tolist()
    ex_val = np.concatenate([
        np.asarray([v for _r, _s, v in ex_entries], dtype=np.float32),
        (out[host_idx] / maxlen[host_idx]).astype(np.float32)])
    xs = kde_grid(0.0025)
    G = len(xs)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)
                                ).to(device)

    fused = kde_fused_from_pairs(
        flat, f32(maxlen[members]), int32_tensor(rid[members], device),
        int32_tensor(slot[members], device), int32_tensor(ex_row, device),
        int32_tensor(ex_slot, device), f32(ex_val),
        int32_tensor(nvals, device), f32(bw), f32(xs), n_pad, n_rows,
        n_max=int(nvals.max())).cpu().numpy()
    P = len(members)
    out[members] = fused[:P].astype(np.int64)
    m = fused[P : P + n_rows * G].reshape(n_rows, G)
    s = fused[P + n_rows * G :].reshape(n_rows, G)
    return out, m, s


class EditDistanceEngine:
    """Exact batched Levenshtein and ends-free distances on one device."""

    MYERS_MAX_WORDS = 64          # K1: shorter side <= 2048 bp
    MYERS_TEXT_CAP = 1 << 15      # K1-K4: longer side <= 32 kb
    K_LONG = (63, 127, 255, 511, 1023, 2047)   # K3 / K4 bands
    BANDED_FRAC = 0.25            # a band past this share of m: K2 instead
    K_LADDER = (63, 127, 255, 511, 1023, 2047, 4095, 8191, 16383, 32767)
    K7_CHUNK = 1024               # pairs per K7 launch

    def __init__(self, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device 'cuda' requested but "
                                   "torch.cuda.is_available() is false")
            self.mode = "cuda"
        elif device.type == "cpu":
            self.mode = "torch-cpu"
        else:
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self.cells = 0        # m * n DP cells of the Myers pairs and jobs
        self.pairs_k1 = 0
        self.pairs_k3 = 0     # resolved by a K3 rung
        self.pairs_k2 = 0
        self.pairs_k7 = 0
        self.jobs_k2 = 0
        self.jobs_k4 = 0      # resolved by a K4 rung
        self.jobs_host = 0
        self.jobs_k9 = 0      # resolved by a K9 pass (mesh mode only)
        self.jobs_k5 = 0      # consensus cigars from K5
        self.jobs_affine_host = 0   # consensus cigars K5 left to the ladder
        # one entry a K3 / K4 ladder call: (kernel, [(k, launched,
        # resolved) a rung run], left to K2)
        self.ladders: list = []

    def _int32(self, a) -> torch.Tensor:
        return int32_tensor(a, self.device)

    def counters(self) -> dict:
        return {k: getattr(self, k) for k in COUNTERS}

    # -- distances -----------------------------------------------------------

    def distances(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        return self.distances_collect(self.distances_async(pairs))

    def distances_indexed(self, seqs: List[str], xi, yi) -> np.ndarray:
        return self.distances_collect(
            self.distances_async_indexed(seqs, xi, yi))

    def distances_async(self, pairs: Sequence[Tuple[str, str]]):
        seqs, xi, yi = dedup_oriented(pairs)
        return self.distances_async_indexed(seqs, xi, yi)

    def _pool_inputs(self, pv: IndexedPairs, idx: np.ndarray):
        """Pairs ``idx`` oriented pattern = shorter side, over one pool of
        the sequences they read: (pool, ip, it, m, n), the lengths numpy."""
        lx = pv.lens[pv.xi[idx]]
        ly = pv.lens[pv.yi[idx]]
        swap = lx > ly
        pat = np.where(swap, pv.yi[idx], pv.xi[idx])
        txt = np.where(swap, pv.xi[idx], pv.yi[idx])
        uniq, inv = np.unique(np.concatenate([pat, txt]), return_inverse=True)
        m = np.minimum(lx, ly)
        n = np.maximum(lx, ly)
        width = pool_width(max(self.MYERS_MAX_WORDS,
                               striped_n_words(int(m.max()))), int(n.max()))
        pool = self._int32(pack_pool([pv.seqs[s] for s in uniq], width))
        return pool, inv[: len(idx)], inv[len(idx):], m, n

    def route_pairs(self, pv: IndexedPairs):
        """(out, k1, long, rest): the results of the pairs no kernel needs
        (equal objects, an empty side) filled in ``out``, and the indices of
        the K1 pairs, the long ACGT pairs (K3 ladder, then K2) and the rest
        (K7 ladder)."""
        lx = pv.lens[pv.xi]
        ly = pv.lens[pv.yi]
        mn = np.minimum(lx, ly)
        mx = np.maximum(lx, ly)
        out = np.zeros(len(pv), dtype=np.int64)
        empty = (lx == 0) | (ly == 0)
        out[empty] = mx[empty]
        todo = ~((pv.xi == pv.yi) | empty)
        acgt = acgt_flags(pv.seqs)
        elig = todo & acgt[pv.xi] & acgt[pv.yi] & (mx <= self.MYERS_TEXT_CAP)
        base = elig & (mn <= self.MYERS_MAX_WORDS * 32)
        return (out, np.nonzero(base)[0], np.nonzero(elig & ~base)[0],
                np.nonzero(todo & ~elig)[0])

    @staticmethod
    def k1_buckets(pv: IndexedPairs, idx: np.ndarray) -> np.ndarray:
        """The K1 n_words bucket (0-4: 4, 8, 16, 32, 64 words) of pairs
        ``idx``, by their shorter side."""
        m = np.minimum(pv.lens[pv.xi[idx]], pv.lens[pv.yi[idx]])
        return np.searchsorted(_NW_THRESHOLDS, m, side="left")

    def launch_k1(self, pv: IndexedPairs, bidx: np.ndarray) -> list:
        """One K1 launch per n_words bucket of pairs ``bidx``; returns the
        pending (pair indices, device result) list."""
        pending = []
        if len(bidx):
            pool, ip, it, m, n = self._pool_inputs(pv, bidx)
            nwi = self.k1_buckets(pv, bidx)
            for g in np.unique(nwi):
                sel = nwi == g
                dev = myers_pool(pool, self._int32(ip[sel]),
                                 self._int32(it[sel]), self._int32(n[sel]),
                                 self._int32(m[sel]), int(4 << g),
                                 int(n[sel].max()))
                pending.append((bidx[sel], dev))
                self.pairs_k1 += int(sel.sum())
                self.cells += int((m[sel] * n[sel]).sum())
        return pending

    def distances_async_indexed(self, seqs: List[str], xi, yi):
        """Route pair p = (seqs[xi[p]], seqs[yi[p]]) and launch its K1
        buckets; returns a handle for ``distances_collect``."""
        pv = IndexedPairs(seqs, xi, yi)
        out, bidx, long_idx, rest = self.route_pairs(pv)
        return pv, self.launch_k1(pv, bidx), long_idx, rest, out

    @staticmethod
    def collect_k1(pending: list, out: np.ndarray) -> None:
        """One device-to-host copy of a ``launch_k1`` list into ``out``."""
        if pending:
            flat = torch.cat([dev for _m, dev in pending]).cpu().numpy()
            offset = 0
            for members, _dev in pending:
                out[members] = flat[offset : offset + len(members)]
                offset += len(members)

    def collect_ladders(self, pv: IndexedPairs, long_idx: np.ndarray,
                        rest: np.ndarray, out: np.ndarray) -> None:
        """The K3/K2 and K7 ladders of ``long_idx`` and ``rest``."""
        if len(long_idx):
            self._long_pair_route(pv, long_idx, out)
        if len(rest):
            self._banded_ladder(pv, rest, out)

    def distances_collect(self, handle) -> np.ndarray:
        """Finish a ``distances_async*`` handle: one device-to-host copy of
        the K1 results, then the K3/K2 and K7 ladders."""
        pv, pending, long_idx, rest, out = handle
        self.collect_k1(pending, out)
        self.collect_ladders(pv, long_idx, rest, out)
        return out

    def distances_collect_kde(self, handle, rid: np.ndarray,
                              slot: np.ndarray, ex_entries,
                              nvals: np.ndarray, bw: np.ndarray, n_rows: int,
                              n_pad: int):
        """``distances_collect`` with the batch's scaled KDE in the same
        device-to-host copy (``collect_kde``): (out, m, s), or None when a
        pair went to a ladder or none to K1 (the caller then collects and
        runs the KDE in two steps, with the same results)."""
        pv, pending, long_idx, rest, out = handle
        if len(long_idx) or len(rest) or not pending:
            return None
        return collect_kde(pv, pending, out, self.device, rid, slot,
                           ex_entries, nvals, bw, n_rows, n_pad)

    def _long_pair_route(self, pv: IndexedPairs, idx: np.ndarray,
                         out: np.ndarray) -> None:
        """ACGT pairs past K1's 2048: K3 rungs k with n - m <= k <=
        BANDED_FRAC * m and k < n (a band near the full matrix costs as
        much as K2) and k >= the pair's ``need`` (``_jump``), one launch
        per rung; what no rung resolves -> K2."""
        pool, ip, it, m, n = self._pool_inputs(pv, idx)
        nw = striped_n_words(int(m.max()))
        left = np.ones(len(idx), dtype=bool)
        need = np.zeros(len(idx), dtype=np.int64)
        rungs = []
        for k in self.K_LONG:
            now = (left & (need <= k) & (n - m <= k)
                   & (k <= m * self.BANDED_FRAC) & (k < n))
            if not now.any():
                continue
            sel = np.nonzero(now)[0]
            d = myers_banded(pool, self._int32(ip[sel]), self._int32(it[sel]),
                             self._int32(n[sel]), self._int32(m[sel]), k, nw,
                             int(n[sel].max())).cpu().numpy()
            self.cells += int((n[sel] * np.minimum(m[sel],
                                                   2 * (k + 1))).sum())
            ok = self._jump(d, k, sel, need)
            out[idx[sel[ok]]] = d[ok]
            left[sel[ok]] = False
            self.pairs_k3 += int(ok.sum())
            rungs.append((k, len(sel), int(ok.sum())))
        self.ladders.append(("K3", rungs, int(left.sum())))
        if left.any():
            sel = np.nonzero(left)[0]
            zero = self._int32(np.zeros(len(sel)))
            d = myers_striped(pool, self._int32(ip[sel]), self._int32(it[sel]),
                              self._int32(n[sel]), self._int32(m[sel]), zero,
                              zero, nw, int(n[sel].max())).cpu().numpy()
            out[idx[sel]] = d
            self.pairs_k2 += len(sel)
            self.cells += int((m[sel] * n[sel]).sum())

    @staticmethod
    def _jump(d: np.ndarray, k: int, sel: np.ndarray,
              need: np.ndarray) -> np.ndarray:
        """Rung-jumping, as the JAX engine's ladders do: rung k's results
        ``d`` of jobs ``sel``; returns the resolved ones (d <= k, exact).
        A job it did not resolve has d > k, and its banded score bounds d
        from above (2^30 where row m left the band), so it next runs at the
        first rung >= min(score, 8 k): the cap bounds the overshoot when a
        band's boundary inflates the score far past d. Any later rung, and
        K2, is exact, so the results do not depend on it."""
        ok = d <= k
        need[sel[~ok]] = np.minimum(d[~ok], 8 * k)
        return ok

    def _banded_ladder(self, pv: IndexedPairs, idx: np.ndarray,
                       out: np.ndarray) -> None:
        """K7 rungs from k = 63, doubling, over the pairs whose length
        difference fits the band; the last rung covers the longest side,
        so every pair resolves."""
        lx = pv.lens[pv.xi[idx]]
        ly = pv.lens[pv.yi[idx]]
        maxlen = int(np.maximum(lx, ly).max())
        ladder = [kk for kk in self.K_LADDER if kk < 2 * maxlen]
        if not ladder or ladder[-1] < maxlen:
            ladder.append(((maxlen + 127) // 128) * 128 - 1)
        left = np.ones(len(idx), dtype=bool)
        for k in [kk for kk in ladder if kk >= self.K_LADDER[0]] \
                or [ladder[-1]]:
            sel = np.nonzero(left & (np.abs(lx - ly) <= k))[0]
            for c0 in range(0, len(sel), self.K7_CHUNK):
                chunk = sel[c0 : c0 + self.K7_CHUNK]
                a, bpad, mn = pack_banded([pv[int(i)] for i in idx[chunk]], k)
                d = edit_banded(*(self._int32(x) for x in (a, bpad, mn)),
                                k).cpu().numpy()
                ok = d <= k
                out[idx[chunk[ok]]] = d[ok]
                left[chunk[ok]] = False
                self.pairs_k7 += int(ok.sum())
            if not left.any():
                return
        raise AssertionError("banded DP failed to converge")

    # -- ends-free -----------------------------------------------------------

    def ends_free(self, jobs) -> np.ndarray:
        return self.ends_free_collect(self.ends_free_async(jobs))

    def route_ends_free(self, jobs):
        """(k2, k4, host, zero): the indices of the ends-free jobs for K2,
        for the K4 ladder, for the host DP and with no frees (the distance
        path); jobs whose sides are equal need nothing (0)."""
        acgt: dict = {}

        def is_acgt(s: str) -> bool:
            v = acgt.get(id(s))
            if v is None:
                v = acgt[id(s)] = bool(acgt_flags([s])[0])
            return v

        k2: List[int] = []
        k4: List[int] = []
        host: List[int] = []
        zero_idx: List[int] = []
        for idx, (p, t, pb, pe, tb, te) in enumerate(jobs):
            if p == t:
                continue
            if not (pb or pe or tb or te):
                zero_idx.append(idx)
            elif (not ((pb or pe) and (tb or te))
                  and min(len(p), len(t)) > 0
                  and max(len(p), len(t)) <= self.MYERS_TEXT_CAP
                  and is_acgt(p) and is_acgt(t)):
                free_less = t if (pb or pe) else p
                if len(free_less) > self.MYERS_MAX_WORDS * 32:
                    k4.append(idx)
                else:
                    k2.append(idx)
            else:
                host.append(idx)
        return k2, k4, host, zero_idx

    def launch_k2_ends_free(self, jobs, k2: List[int]):
        """Launch the K2 jobs ``k2``; the handle, or None for none."""
        if not k2:
            return None
        sub = [jobs[i] for i in k2]
        self.jobs_k2 += len(k2)
        self.cells += sum(len(j[0]) * len(j[1]) for j in sub)
        return myers_striped_ends_free_async(sub, self.device)

    def ends_free_async(self, jobs):
        """Route ends-free jobs (pattern, text, pb, pe, tb, te) and launch
        the short K2 ones; returns a handle for ``ends_free_collect``."""
        out = np.zeros(len(jobs), dtype=np.int64)
        k2, k4, host, zero_idx = self.route_ends_free(jobs)
        k2h = self.launch_k2_ends_free(jobs, k2)
        self.jobs_host += len(host)
        zh = (self.distances_async([jobs[i][:2] for i in zero_idx])
              if zero_idx else None)
        return jobs, out, k2, k2h, k4, host, zero_idx, zh

    def ends_free_collect(self, handle) -> np.ndarray:
        jobs, out, k2, k2h, k4, host, zero_idx, zh = handle
        if k2h is not None:
            out[k2] = myers_striped_ends_free_collect(k2h)
        if k4:
            self._ends_free_banded_route(jobs, np.asarray(k4), out)
        if zh is not None:
            out[zero_idx] = self.distances_collect(zh)
        if host:
            from ..ops.align_batch import edit_ends_free_batch

            out[host] = edit_ends_free_batch([jobs[i] for i in host])
        return out

    def _ends_free_banded_route(self, jobs, idx: np.ndarray,
                                out: np.ndarray) -> None:
        """One-sided ACGT jobs whose free-less side (the Myers pattern) is
        past 2048: K4 rungs k with klo + 2k <= BANDED_FRAC * m and k < n
        (klo: the free begin rounded up to a power of two >= 64) and k >=
        the job's ``need`` (``_jump``), one launch per rung; what no rung
        resolves -> K2."""
        oriented, tbs, tes = [], [], []
        for i in idx:
            p, t, pb, pe, tb, te = jobs[i]
            if pb or pe:
                oriented.append((t, p))
                tbs.append(pb)
                tes.append(pe)
            else:
                oriented.append((p, t))
                tbs.append(tb)
                tes.append(te)
        pool, ip, it, nl, ml, tbt, tet, nw, _tl = oriented_inputs(
            oriented, tbs, tes, self.device)
        m = np.fromiter((len(p) for p, _t in oriented), np.int64, len(idx))
        n = np.fromiter((len(t) for _p, t in oriented), np.int64, len(idx))
        klo = np.asarray([1 << max(6, (max(b, 1) - 1).bit_length())
                          for b in tbs], dtype=np.int64)
        left = np.ones(len(idx), dtype=bool)
        need = np.zeros(len(idx), dtype=np.int64)
        rungs = []
        for k in self.K_LONG:
            now = (left & (need <= k)
                   & (klo + 2 * k <= m * self.BANDED_FRAC) & (k < n))
            if not now.any():
                continue
            sel = torch.from_numpy(np.nonzero(now)[0]).to(self.device)
            seln = np.nonzero(now)[0]
            d = myers_banded_ef(pool, ip[sel], it[sel], nl[sel], ml[sel],
                                tbt[sel], tet[sel], k, nw,
                                int(n[seln].max()),
                                tb_max=max(tbs[i] for i in seln)).cpu().numpy()
            ok = self._jump(d, k, seln, need)
            out[idx[seln[ok]]] = d[ok]
            left[seln[ok]] = False
            self.jobs_k4 += int(ok.sum())
            rungs.append((k, len(seln), int(ok.sum())))
        self.ladders.append(("K4", rungs, int(left.sum())))
        if left.any():
            seln = np.nonzero(left)[0]
            sel = torch.from_numpy(seln).to(self.device)
            d = myers_striped(pool, ip[sel], it[sel], nl[sel], ml[sel],
                              tbt[sel], tet[sel], nw,
                              int(n[seln].max())).cpu().numpy()
            out[idx[seln]] = d
            self.jobs_k2 += len(seln)
            self.cells += int((m[seln] * n[seln]).sum())


class MeshEngine:
    """The engine's surface over a mesh (``parallel/mesh.py``): one
    ``EditDistanceEngine`` a shard, the counterpart of the JAX package's
    ``EditDistanceEngine(mode="jnp", mesh=...)`` (``device="mesh"``).

    Pairs and jobs are routed once, as on one device; then each route's
    batch is split over the shards in contiguous blocks (each K1 n_words
    bucket, the long pairs, the K7 pairs, the K2 and K4 jobs), so every
    shard runs the same kernels as ``device="cuda"`` on its share. The JAX
    mesh mode sends every pair through ``edit_banded_jnp`` instead, a
    constraint of sharding under pjit; the distances are the same
    integers either way. Every shard's K1 and K2 launches are made before
    any result is read; each shard's ladders then read their own rungs.
    The host bucket of the ends-free jobs (frees on both sides, or a
    non-ACGT character) goes to ``edit_ends_free_batch`` with a runner that
    splits each fixed-k pass over the shards and runs kernel K9 on each
    (the JAX package's ``_ends_free_mesh_runner``); a job whose band reaches
    its text stays on the host DP there, as in both packages.

    ``device`` is the mesh's first device, where the consensus cigars (K5,
    K6) run: the JAX mesh mode shards no cigar work either. ``counters()``
    sums the shards'; ``shard_counters()`` gives each shard's."""

    def __init__(self, mesh):
        from ..parallel.mesh import make_mesh

        self.mesh = make_mesh(devices=mesh)
        self.engines = [EditDistanceEngine(d) for d in self.mesh]
        self.device = self.mesh[0]
        self.mode = self.engines[0].mode
        self.jobs_host = 0
        self.jobs_k5 = 0
        self.jobs_affine_host = 0

    def counters(self) -> dict:
        out = dict.fromkeys(COUNTERS, 0)
        for eng in self.engines:
            for k, v in eng.counters().items():
                out[k] += v
        for k in ("jobs_host", "jobs_k5", "jobs_affine_host"):
            out[k] += getattr(self, k)
        return out

    def shard_counters(self) -> list:
        return [eng.counters() for eng in self.engines]

    def _split(self, idx) -> list:
        """``idx`` cut into one contiguous block a shard."""
        from ..parallel.mesh import shard_rows

        return [idx[lo:hi] for lo, hi in shard_rows(len(idx), self.mesh)]

    # -- distances -----------------------------------------------------------

    def distances(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        return self.distances_collect(self.distances_async(pairs))

    def distances_async(self, pairs: Sequence[Tuple[str, str]]):
        seqs, xi, yi = dedup_oriented(pairs)
        return self.distances_async_indexed(seqs, xi, yi)

    def distances_async_indexed(self, seqs: List[str], xi, yi):
        """Route the pairs, split each K1 bucket, the long pairs and the
        K7 pairs over the shards, and launch every shard's K1."""
        pv = IndexedPairs(seqs, xi, yi)
        out, bidx, long_idx, rest = self.engines[0].route_pairs(pv)
        nwi = EditDistanceEngine.k1_buckets(pv, bidx)
        k1 = [[] for _ in self.engines]
        for g in np.unique(nwi):
            for s, part in enumerate(self._split(bidx[nwi == g])):
                k1[s].append(part)
        shards = []
        for eng, parts, lp, rp in zip(self.engines, k1,
                                      self._split(long_idx),
                                      self._split(rest)):
            idx = (np.concatenate(parts) if parts
                   else np.zeros(0, dtype=np.int64))
            shards.append((eng, eng.launch_k1(pv, idx), lp, rp))
        return pv, shards, out

    def distances_collect(self, handle) -> np.ndarray:
        """Every shard's K1 results (one copy a shard), then each shard's
        ladders."""
        pv, shards, out = handle
        for eng, pending, _lp, _rp in shards:
            eng.collect_k1(pending, out)
        for eng, _pending, lp, rp in shards:
            eng.collect_ladders(pv, lp, rp, out)
        return out

    def distances_collect_kde(self, handle, rid: np.ndarray,
                              slot: np.ndarray, ex_entries,
                              nvals: np.ndarray, bw: np.ndarray, n_rows: int,
                              n_pad: int):
        """Every shard's K1 results gathered on the mesh's first device,
        then ``collect_kde`` there: (out, m, s), or None when a pair went to
        a ladder on any shard or none to K1."""
        pv, shards, out = handle
        if any(len(lp) or len(rp) for _e, _p, lp, rp in shards):
            return None
        pending = [item for _e, pend, _lp, _rp in shards for item in pend]
        if not pending:
            return None
        return collect_kde(pv, pending, out, self.device, rid, slot,
                           ex_entries, nvals, bw, n_rows, n_pad)

    # -- ends-free -----------------------------------------------------------

    def ends_free(self, jobs) -> np.ndarray:
        return self.ends_free_collect(self.ends_free_async(jobs))

    def ends_free_async(self, jobs):
        """Route the jobs once, split the K2 and K4 jobs over the shards
        and launch every shard's K2."""
        out = np.zeros(len(jobs), dtype=np.int64)
        k2, k4, host, zero_idx = self.engines[0].route_ends_free(jobs)
        shards = [(eng, k2s, eng.launch_k2_ends_free(jobs, k2s), k4s)
                  for eng, k2s, k4s in zip(self.engines, self._split(k2),
                                           self._split(k4))]
        zh = (self.distances_async([jobs[i][:2] for i in zero_idx])
              if zero_idx else None)
        return jobs, out, shards, host, zero_idx, zh

    def ends_free_collect(self, handle) -> np.ndarray:
        from ..ops.align_batch import edit_ends_free_batch

        jobs, out, shards, host, zero_idx, zh = handle
        for _eng, k2s, k2h, _k4s in shards:
            if k2h is not None:
                out[k2s] = myers_striped_ends_free_collect(k2h)
        for eng, _k2s, _k2h, k4s in shards:
            if k4s:
                eng._ends_free_banded_route(jobs, np.asarray(k4s), out)
        if zh is not None:
            out[zero_idx] = self.distances_collect(zh)
        if host:
            self.jobs_host += len(host)  # less the jobs K9 resolves
            out[host] = edit_ends_free_batch([jobs[i] for i in host],
                                             banded_runner=self._k9_runner)
        return out

    def _k9_runner(self, jobs, members, k: int) -> np.ndarray:
        """``edit_ends_free_batch``'s fixed-k pass: ``members`` split over
        the shards, K9 launched on each before any result is read. Each
        shard counts the jobs its pass resolves (best <= k - reach, the
        check the caller makes) as K9's, not the host DP's."""
        from .edit_banded import edit_banded_ends_free, pack_ends_free

        launched = []
        for eng, part in zip(self.engines, self._split(list(members))):
            if part:
                ax, bxp, meta = (eng._int32(x)
                                 for x in pack_ends_free(jobs, part, k))
                launched.append((eng, part,
                                 edit_banded_ends_free(ax, bxp, meta, k)))
        best = []
        for eng, part, dev in launched:
            got = dev.cpu().numpy().astype(np.int64)
            reach = np.fromiter(
                (max(abs(len(jobs[i][1]) - len(jobs[i][0])), *jobs[i][2:6])
                 for i in part), np.int64, len(part))
            resolved = int((got <= k - reach).sum())
            eng.jobs_k9 += resolved
            self.jobs_host -= resolved
            best.append(got)
        return np.concatenate(best)


class NativeEngine:
    """The engine's surface on the host, the counterpart of the JAX
    package's ``EditDistanceEngine(mode="native")`` (its ``--device cpu``
    engine): threaded native C++ edit distances
    (``native.py::edit_distance_batch``) and the host ends-free DP
    (``ops/align_batch.py::edit_ends_free_batch``). It has no ``device``,
    so the consensus takes the native affine ladder. Exact on every pair,
    it launches no kernel: the baseline and the oracle of the card's
    engine on cells too large for the host mode's numpy DP. ``cells``
    counts the native library's band cells."""

    mode = "native"
    device = None

    def __init__(self):
        import os

        self.threads = min(32, os.cpu_count() or 1)
        self.cells = 0

    def distances_async_indexed(self, seqs, xi, yi):
        return [(seqs[a], seqs[b]) for a, b in zip(xi, yi)]

    def distances_async(self, pairs):
        return list(pairs)

    def distances_collect(self, pairs) -> np.ndarray:
        from ..native import edit_distance_batch

        out = np.zeros(len(pairs), dtype=np.int64)
        todo = []
        for i, (x, y) in enumerate(pairs):
            if not x or not y:
                out[i] = max(len(x), len(y))
            elif x != y:
                todo.append(i)
        if todo:
            d, cells = edit_distance_batch([pairs[i] for i in todo],
                                           self.threads)
            out[todo] = d
            self.cells += cells
        return out

    def distances(self, pairs) -> np.ndarray:
        return self.distances_collect(pairs)

    def ends_free_async(self, jobs):
        return jobs

    def ends_free_collect(self, jobs) -> np.ndarray:
        from ..ops.align_batch import edit_ends_free_batch

        return edit_ends_free_batch(jobs)

    def ends_free(self, jobs) -> np.ndarray:
        return self.ends_free_collect(jobs)
