"""Kernels K7 and K9: banded Levenshtein row DPs over any byte alphabet.

Counterpart of ``edit_banded_pallas`` / ``_edit_kernel`` in
``otter_tpu/kernels/edit_pallas.py``, with the inputs that launch takes:
``a`` (B, L) int32 codes of each pair's longer side, ``bpad``
(B, L + 2 (k + 1) + 2) int32 codes of the shorter side shifted right by
k + 1, and ``mn`` (B, 2) int32 lengths, as ``pack_banded`` (the JAX
package's ``_pack_bucket``) builds them. The result is (B,) int32: the
exact distance when it is <= k, INF = 2^24 when |m - n| > k, and the
banded DP's value otherwise (see ``csrc/edit_banded.cu``).

``edit_banded_cuda`` launches the hand-written kernel, ``edit_banded_torch``
is the plain PyTorch version of the same recurrence (the JAX package's
``edit_banded_numpy``), and ``edit_banded`` picks one by device.

K9 is the two-sided ends-free pass, the counterpart of
``edit_banded_ends_free_jnp`` in ``otter_tpu/kernels/edit_pallas.py``: one
fixed-k pass of ``ops/align_batch.py::edit_ends_free_batch``'s doubling
ladder, over ``ax`` (B, Lp) int32 pattern codes (padding -2), ``bxp``
(B, k + 2 + Np + W + 2) int32 text codes after k + 2 sentinel -1 columns,
and ``meta`` (B, 6) int32 = (m, n, pb, pe, tb, te), as
``pack_ends_free`` (the JAX package's ``_ends_free_mesh_runner``) builds
them. The result is (B,) int32: each job's best end cell (INF when none),
whose band validity (best <= k - reach) is the caller's check.
``edit_banded_ends_free_cuda`` launches the kernel (``ends_free_shape``
names the kernel and instance a band takes), ``_torch`` is the plain
version, and ``edit_banded_ends_free`` picks one by device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .myers_pallas import data_ptr

INF = 1 << 24
SMEM_LANES = 1 << 15   # k > 511: the row in shared memory up to W lanes


def pack_banded(pairs: Sequence[Tuple[str, str]], k: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(a, bpad, mn) of ``pairs`` at band k: rows = the longer side, band
    columns = the shorter (latin-1 byte codes; padding 0 never meets a
    valid cell)."""
    pats: List[bytes] = []
    txts: List[bytes] = []
    for p, t in pairs:
        x, y = (p, t) if len(p) >= len(t) else (t, p)
        pats.append(x.encode("latin-1"))
        txts.append(y.encode("latin-1"))
    W = 2 * (k + 1)
    L = max([len(p) for p in pats] + [1])
    a = np.zeros((len(pairs), L), dtype=np.int32)
    bp = np.zeros((len(pairs), L + W + 2), dtype=np.int32)
    mn = np.zeros((len(pairs), 2), dtype=np.int32)
    for i, (pc, tc) in enumerate(zip(pats, txts)):
        a[i, : len(pc)] = np.frombuffer(pc, dtype=np.uint8)
        bp[i, k + 1 : k + 1 + len(tc)] = np.frombuffer(tc, dtype=np.uint8)
        mn[i] = (len(pc), len(tc))
    return a, bp, mn


def pack_bucket(pairs: Sequence[Tuple[str, str]], k: int, tile_b: int = 32
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(a, bpad, mn, L): ``pack_banded``'s layout padded as the JAX
    package's ``_pack_bucket`` pads it (a power of two >= 128 rows, a batch
    of ``tile_b`` times a power of two, padding pairs m = n = 0), the
    layout of its sharded forward step."""
    a0, b0, mn0 = pack_banded(pairs, k)
    L = 128
    while L < a0.shape[1]:
        L *= 2
    B = tile_b
    while B < len(pairs):
        B *= 2
    W = 2 * (k + 1)
    a = np.zeros((B, L), dtype=np.int32)
    bp = np.zeros((B, L + W + 2), dtype=np.int32)
    mn = np.zeros((B, 2), dtype=np.int32)
    a[: len(pairs), : a0.shape[1]] = a0
    bp[: len(pairs), : b0.shape[1]] = b0
    mn[: len(pairs)] = mn0
    return a, bp, mn, L


def _check(a, bpad, mn, k: int) -> None:
    B, L = a.shape
    if a.dtype != torch.int32 or bpad.dtype != torch.int32 \
            or mn.dtype != torch.int32:
        raise ValueError("a, bpad and mn must be int32")
    if bpad.shape != (B, L + 2 * (k + 1) + 2) or mn.shape != (B, 2):
        raise ValueError("bpad must be (B, L + 2 (k + 1) + 2), mn (B, 2)")
    if not (a.device == bpad.device == mn.device):
        raise ValueError("all inputs must be on one device")


def edit_banded_torch(a: torch.Tensor, bpad: torch.Tensor, mn: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Plain PyTorch K7, vectorised over pairs: one row update per pattern
    row, the left term as a running minimum (cummin). Returns (B,) int32."""
    _check(a, bpad, mn, k)
    B, L = a.shape
    W = 2 * (k + 1)
    dev = a.device
    w_idx = torch.arange(W, device=dev, dtype=torch.int64).unsqueeze(0)
    m = mn[:, 0].to(torch.int64).clamp(max=L).unsqueeze(1)
    n = mn[:, 1].to(torch.int64).unsqueeze(1)
    j0 = w_idx - (k + 1)
    prev = torch.where((j0 >= 0) & (j0 <= n), j0, INF).expand(B, W).clone()
    inf_col = torch.full((B, 1), INF, device=dev, dtype=torch.int64)
    rows = int(m.max()) if B else 0
    for i in range(1, rows + 1):
        a_col = a[:, i - 1 : i]
        window = bpad[:, i - 1 : i - 1 + W]
        j = i + j0
        sub = (window != a_col).to(torch.int64)
        up = torch.cat([prev[:, 1:], inf_col], dim=1) + 1
        v = torch.minimum(up, prev + sub)
        v = torch.where(j == 0, i, v)
        invalid = (j < 0) | (j > n)
        v = torch.where(invalid, INF, v)
        cur = torch.cummin(v - w_idx, dim=1).values + w_idx
        cur = torch.where(invalid, INF, cur)
        prev = torch.where(i <= m, cur, prev)
    target = (n - m + (k + 1)).clamp(0, W - 1)
    res = prev.gather(1, target).squeeze(1)
    valid = (n - m).abs().squeeze(1) <= k
    return torch.where(valid, res, INF).to(torch.int32)


def edit_banded_cuda(a: torch.Tensor, bpad: torch.Tensor, mn: torch.Tensor,
                     k: int) -> torch.Tensor:
    """K7 on the card (``csrc/edit_banded.cu``): one launch on the current
    stream, no synchronisation; a warp per pair for k <= 511, a block per
    pair above, with the row in device-memory scratch (allocated here) once
    it outgrows shared memory. Raises on bad inputs or a refused launch."""
    from . import _build

    _check(a, bpad, mn, k)
    if not a.is_cuda:
        raise ValueError("edit_banded_cuda takes CUDA tensors")
    B, L = a.shape
    out = torch.empty(B, dtype=torch.int32, device=a.device)
    if B == 0:
        return out
    W = 2 * (k + 1)
    scratch = torch.empty(W * B if W > SMEM_LANES else 0, dtype=torch.int32,
                          device=a.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.otter_edit_banded(data_ptr(a), data_ptr(bpad), data_ptr(mn),
                                    L, k, data_ptr(out), B, data_ptr(scratch),
                                    stream)
    _build.check(lib, err, "edit_banded_cuda")
    edit_banded_cuda.launches += 1
    return out


edit_banded_cuda.launches = 0


def edit_banded(a: torch.Tensor, bpad: torch.Tensor, mn: torch.Tensor,
                k: int) -> torch.Tensor:
    """K7 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if a.is_cuda:
        return edit_banded_cuda(a, bpad, mn, k)
    if a.device.type == "cpu":
        return edit_banded_torch(a, bpad, mn, k)
    raise ValueError(f"no K7 version for device {a.device}")


def _job_codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8)


def pack_ends_free(jobs, members: Sequence[int], k: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ax, bxp, meta) of ``jobs[members]`` (pattern, text, pb, pe, tb, te)
    at band k: Lp and Np the powers of two >= 128 that hold the longest
    pattern and text, the text after k + 2 sentinel columns."""
    W = 2 * (k + 1)
    pats = [_job_codes(jobs[i][0]) for i in members]
    txts = [_job_codes(jobs[i][1]) for i in members]
    Lp = 128
    while Lp < max([len(p) for p in pats] + [1]):
        Lp *= 2
    Np = 128
    while Np < max([len(t) for t in txts] + [1]):
        Np *= 2
    ax = np.full((len(pats), Lp), -2, dtype=np.int32)
    bxp = np.full((len(pats), k + 2 + Np + W + 2), -1, dtype=np.int32)
    meta = np.zeros((len(pats), 6), dtype=np.int32)
    for bi, i in enumerate(members):
        ax[bi, : len(pats[bi])] = pats[bi]
        bxp[bi, k + 2 : k + 2 + len(txts[bi])] = txts[bi]
        meta[bi] = (len(pats[bi]), len(txts[bi]), *jobs[i][2:6])
    return ax, bxp, meta


def _check_ends_free(ax, bxp, meta, k: int) -> None:
    B = ax.shape[0]
    if ax.dtype != torch.int32 or bxp.dtype != torch.int32 \
            or meta.dtype != torch.int32:
        raise ValueError("ax, bxp and meta must be int32")
    if ax.dim() != 2 or bxp.dim() != 2 or bxp.shape[0] != B \
            or bxp.shape[1] < 1 or meta.shape != (B, 6) or k < 0:
        raise ValueError("ax must be (B, Lp), bxp (B, Lb), meta (B, 6), "
                         "k >= 0")
    if not (ax.device == bxp.device == meta.device):
        raise ValueError("all inputs must be on one device")


def edit_banded_ends_free_torch(ax: torch.Tensor, bxp: torch.Tensor,
                                meta: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch K9, vectorised over jobs: the recurrence of
    ``edit_banded_ends_free_jnp`` row by row, the left term as a running
    minimum (cummin). Rows past a job's m keep its row. Returns (B,)
    int32."""
    _check_ends_free(ax, bxp, meta, k)
    B, Lp = ax.shape
    W = 2 * (k + 1)
    dev = ax.device
    m, n, pb, pe, tb, te = (meta[:, c].to(torch.int64).unsqueeze(1)
                            for c in range(6))
    rows = min(Lp, int(m.max())) if B else 0
    if bxp.shape[1] < rows + W:  # windows past the row read sentinels
        bxp = torch.cat([bxp, torch.full((B, rows + W - bxp.shape[1]), -1,
                                         dtype=bxp.dtype, device=dev)], 1)
    w_idx = torch.arange(W, device=dev, dtype=torch.int64).unsqueeze(0)
    j0 = w_idx - (k + 1)
    prev = torch.where((j0 >= 0) & (j0 <= n), (j0 - tb).clamp(min=0), INF)
    col0 = n + (k + 1)
    best = torch.where((pe >= m) & (col0 < W),
                       prev.gather(1, col0.clamp(0, W - 1)), INF)
    inf_col = torch.full((B, 1), INF, device=dev, dtype=torch.int64)
    for i in range(1, rows + 1):
        a_col = ax[:, i - 1 : i]
        window = bxp[:, i : i + W]
        j = i + j0
        sub = (window != a_col).to(torch.int64)
        up = torch.cat([prev[:, 1:], inf_col], dim=1) + 1
        v = torch.minimum(up, prev + sub)
        v = torch.where(j == 0, (i - pb).clamp(min=0), v)
        invalid = (j < 0) | (j > n)
        v = torch.where(invalid, INF, v)
        cur = torch.cummin(v - w_idx, dim=1).values + w_idx
        cur = torch.where(invalid, INF, cur)
        keep = i <= m
        prev = torch.where(keep, cur, prev)
        wcol = n - i + (k + 1)
        active = keep & (m - i <= pe) & (wcol >= 0) & (wcol < W)
        best = torch.minimum(best, torch.where(
            active, cur.gather(1, wcol.clamp(0, W - 1)), INF))
    jmap = m + j0
    rowvals = torch.where((jmap >= (n - te).clamp(min=0)) & (jmap <= n),
                          prev, INF)
    best = torch.minimum(best, rowvals.min(dim=1, keepdim=True).values)
    return best.squeeze(1).to(torch.int32)


def edit_banded_ends_free_cuda(ax: torch.Tensor, bxp: torch.Tensor,
                               meta: torch.Tensor, k: int) -> torch.Tensor:
    """K9 on the card (``csrc/edit_banded.cu``): one launch on the current
    stream, no synchronisation; a warp per job for k <= 511 (K7's warp
    kernel with the ends-free rules), a block of P warps with the row in
    registers to k = 8447, K7's block kernel beyond (the row in
    device-memory scratch, allocated here, past 32,768 lanes). Raises on
    bad inputs or a refused launch."""
    from . import _build

    _check_ends_free(ax, bxp, meta, k)
    if not ax.is_cuda:
        raise ValueError("edit_banded_ends_free_cuda takes CUDA tensors")
    B, Lp = ax.shape
    out = torch.empty(B, dtype=torch.int32, device=ax.device)
    if B == 0:
        return out
    W = 2 * (k + 1)
    scratch = torch.empty(W * B if W > SMEM_LANES else 0, dtype=torch.int32,
                          device=ax.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(ax.device).cuda_stream
    with torch.cuda.device(ax.device):
        err = lib.otter_edit_banded_ends_free(
            data_ptr(ax), data_ptr(bxp), data_ptr(meta), Lp, bxp.shape[1],
            k, data_ptr(out), B, data_ptr(scratch), stream)
    _build.check(lib, err, "edit_banded_ends_free_cuda")
    edit_banded_ends_free_cuda.launches += 1
    return out


edit_banded_ends_free_cuda.launches = 0


def ends_free_shape(k: int) -> Tuple[str, int, int]:
    """The kernel and instance K9 takes at band k, from the built library:
    ("warp", 1, L) a warp per job of L lanes a thread, ("warps", P, L) P
    warps of L, or ("block", threads, lanes a thread)."""
    from . import _build

    shape = np.zeros(3, dtype=np.int32)
    lib = _build.load()
    _build.check(lib, lib.otter_edit_banded_ends_free_shape(
        k, shape.ctypes.data), "ends_free_shape")
    return ("warp", "warps", "block")[shape[0]], int(shape[1]), int(shape[2])


def edit_banded_ends_free(ax: torch.Tensor, bxp: torch.Tensor,
                          meta: torch.Tensor, k: int) -> torch.Tensor:
    """K9 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if ax.is_cuda:
        return edit_banded_ends_free_cuda(ax, bxp, meta, k)
    if ax.device.type == "cpu":
        return edit_banded_ends_free_torch(ax, bxp, meta, k)
    raise ValueError(f"no K9 version for device {ax.device}")
