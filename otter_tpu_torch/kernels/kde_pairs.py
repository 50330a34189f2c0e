"""Kernel K14: per-region KDE densities of a cross-region pair batch.

Counterpart of the KDE half of ``region_batch_step`` in
``otter_tpu/parallel/mesh.py`` (jnp, not Pallas): for pair p with distance
``d`` (its K7 result), lengths ``m``, ``n``, region ``region_id`` and
``pair_valid``, and region bandwidths ``bw`` (R,), over the grid ``xs``
(``linspace_grid``, the JAX linspace's values), the (R, G) f32 densities

    norm = f32(d) / max(f32(max(m, n)), 1)
    raw  = sum over the region's valid pairs of
           (INV_SQRT_2PI / h) exp(-(z z) / 2),  z = (x - norm) / h
    dens = raw / max(count, 1), then / max(row total, 1e-30).

XLA leaves the order of the segment sum open; here it is fixed and
independent of the card: a region's valid pairs in input order
(``group_pairs``) cut into consecutive chunks of ``CHUNK`` pairs, each
chunk's sum a grid point in pair order, the region's raw sum its chunk sums
added in chunk order (a region of at most ``CHUNK`` pairs: one sequential
sum), the row total the halving tree of ``kde_scaled.normalize_rows_torch``.
So the densities are deterministic and the same bits at every mesh size.

``kde_pairs_cuda`` launches the hand-written kernel (``csrc/kde_pairs.cu``),
``kde_pairs_torch`` is the plain PyTorch version of the same arithmetic in
the same order, and ``kde_pairs`` picks one by device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .kde_scaled import INV_SQRT_2PI, normalize_rows_torch, row_lanes
from .myers_pallas import data_ptr

# pairs a chunk of a region's sum (csrc/kde_pairs.cu kChunk)
CHUNK = 256


def linspace_grid(grid_pts: int) -> np.ndarray:
    """``jnp.linspace(0, 1, grid_pts, dtype=float32)`` as XLA computes it:
    i times the f32 reciprocal of grid_pts - 1, then 1 at the end
    (``torch.linspace`` and numpy's give other values at many points)."""
    if grid_pts <= 1:
        return np.zeros(grid_pts, dtype=np.float32)
    xs = np.arange(grid_pts, dtype=np.float32) * (
        np.float32(1.0) / np.float32(grid_pts - 1))
    xs[-1] = 1.0
    return xs


def _check(d, m, n, region_id, pair_valid, bw, xs) -> None:
    B = d.shape[0]
    if any(t.dtype != torch.int32 for t in (d, m, n, region_id)) \
            or pair_valid.dtype != torch.bool or bw.dtype != torch.float32 \
            or xs.dtype != torch.float32:
        raise ValueError("d, m, n and region_id must be int32, pair_valid "
                         "bool, bw and xs float32")
    if any(t.shape != (B,) for t in (m, n, region_id, pair_valid)) \
            or bw.dim() != 1 or xs.dim() != 1:
        raise ValueError("d, m, n, region_id and pair_valid must be (B,), "
                         "bw (R,), xs (G,)")
    if len({t.device for t in (d, m, n, region_id, pair_valid, bw,
                               xs)}) != 1:
        raise ValueError("all inputs must be on one device")
    row_lanes(xs.shape[0])


def group_pairs(region_id: torch.Tensor, pair_valid: torch.Tensor,
                n_regions: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, starts): the pairs sorted by region, each region's in input
    order (a stable sort; the invalid pairs last), and each region's
    offset into ``order`` (R + 1,), both int32, computed where the inputs
    lie without a copy to the host (a binary search of the sorted keys
    gives the offsets, so nothing waits on the card). A pair whose region
    is outside [0, R) counts nowhere, as in a segment sum."""
    rid = region_id.to(torch.int32)
    key = torch.where(pair_valid & (rid >= 0) & (rid < n_regions), rid,
                      n_regions)
    keys, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        keys, torch.arange(n_regions + 1, dtype=torch.int32,
                           device=key.device), out_int32=True)
    return order.to(torch.int32), starts


def kde_pairs_torch(d: torch.Tensor, m: torch.Tensor, n: torch.Tensor,
                    region_id: torch.Tensor, pair_valid: torch.Tensor,
                    bw: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K14: the kernel's sums in its order, vectorised over
    the chunks of every region (step i adds each chunk's i-th pair; a chunk
    that has no i-th pair keeps its sum), then each region's chunk sums
    added in chunk order. Returns (R, G) f32."""
    _check(d, m, n, region_id, pair_valid, bw, xs)
    R = bw.shape[0]
    dev = bw.device
    order, starts = group_pairs(region_id, pair_valid, R)
    order = order.to(torch.int64)
    starts = starts.to(torch.int64)
    counts = starts[1:] - starts[:-1]
    # a region's chunks (an empty region has one, empty), numbered region
    # after region
    n_chunks = torch.clamp((counts + CHUNK - 1) // CHUNK, min=1)
    first = torch.cumsum(n_chunks, 0) - n_chunks
    total = int(n_chunks.sum())
    region = torch.repeat_interleave(torch.arange(R, device=dev), n_chunks,
                                     output_size=total)
    j = torch.arange(total, device=dev) - first[region]
    lo = starts[region] + j * CHUNK
    size = torch.clamp(counts[region] - j * CHUNK, 0, CHUNK)
    length = torch.clamp(torch.maximum(m, n).to(torch.float32), min=1.0)
    norm = (d.to(torch.float32) / length)[order]
    h = bw[region][:, None]
    c = torch.tensor(INV_SQRT_2PI, device=dev) / h
    part = torch.zeros((total, xs.shape[0]), dtype=torch.float32, device=dev)
    last = max(0, order.shape[0] - 1)
    for i in range(int(size.max()) if total else 0):
        v = norm[torch.clamp(lo + i, max=last)]
        z = (xs[None, :] - v[:, None]) / h
        term = c * torch.exp((z * z) * -0.5)
        part = torch.where((size > i)[:, None], part + term, part)
    raw = part[first]
    for q in range(1, int(n_chunks.max()) if R else 1):
        nxt = part[torch.clamp(first + q, max=total - 1)]
        raw = torch.where((n_chunks > q)[:, None], raw + nxt, raw)
    div = torch.clamp(counts.to(torch.float32), min=1.0)
    return normalize_rows_torch(raw, div)


def _tickets(device: torch.device, stream: int, n_regions: int
             ) -> torch.Tensor:
    """The zero ticket array of ``stream`` on ``device``, at least
    ``n_regions`` long: every launch leaves it zero, and the launches of
    one stream take it in turn."""
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.shape[0] < n_regions:
        t = torch.zeros(max(n_regions, 64), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


_TICKETS: dict = {}


def kde_pairs_cuda(d: torch.Tensor, m: torch.Tensor, n: torch.Tensor,
                   region_id: torch.Tensor, pair_valid: torch.Tensor,
                   bw: torch.Tensor, xs: torch.Tensor, grouped=None
                   ) -> torch.Tensor:
    """K14 on the card (``csrc/kde_pairs.cu``): the pairs grouped on the
    card (``group_pairs``, or ``grouped``, its result for these inputs),
    then one launch on the current stream, no synchronisation. Raises on
    bad inputs or a refused launch."""
    from . import _build

    _check(d, m, n, region_id, pair_valid, bw, xs)
    if not d.is_cuda:
        raise ValueError("kde_pairs_cuda takes CUDA tensors")
    R, G = bw.shape[0], xs.shape[0]
    out = torch.empty((R, G), dtype=torch.float32, device=d.device)
    if R == 0 or G == 0:
        return out
    order, starts = grouped or group_pairs(region_id, pair_valid, R)
    n_pairs = order.shape[0]
    partial = torch.empty((n_pairs // CHUNK + R, G), dtype=torch.float32,
                          device=d.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(d.device).cuda_stream
    with torch.cuda.device(d.device):
        tickets = _tickets(d.device, stream, R)
        err = lib.otter_kde_pairs(
            data_ptr(d), data_ptr(m), data_ptr(n), data_ptr(order),
            data_ptr(starts), data_ptr(bw), data_ptr(xs), G, R, n_pairs,
            data_ptr(partial), data_ptr(tickets), data_ptr(out), stream)
    _build.check(lib, err, "kde_pairs_cuda")
    kde_pairs_cuda.launches += 1
    return out


kde_pairs_cuda.launches = 0


def kde_pairs(d: torch.Tensor, m: torch.Tensor, n: torch.Tensor,
              region_id: torch.Tensor, pair_valid: torch.Tensor,
              bw: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """K14 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if d.is_cuda:
        return kde_pairs_cuda(d, m, n, region_id, pair_valid, bw, xs)
    if d.device.type == "cpu":
        return kde_pairs_torch(d, m, n, region_id, pair_valid, bw, xs)
    raise ValueError(f"no K14 version for device {d.device}")
