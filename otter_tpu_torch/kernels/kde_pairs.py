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

XLA leaves the order of the segment sum open; here it is fixed: a region's
valid pairs in input order (``group_pairs``), one sum a grid point, the row
total the halving tree of ``kde_scaled.normalize_rows_torch``. So the
densities are deterministic and the same bits at every mesh size.

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
    lie without a copy to the host. A pair whose region is outside [0, R)
    counts nowhere, as in a segment sum."""
    rid = region_id.to(torch.int64)
    key = torch.where(pair_valid & (rid >= 0) & (rid < n_regions), rid,
                      n_regions)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n_regions + 1)[:n_regions]
    starts = torch.zeros(n_regions + 1, dtype=torch.int64,
                         device=key.device)
    starts[1:] = torch.cumsum(counts, 0)
    return order.to(torch.int32), starts.to(torch.int32)


def kde_pairs_torch(d: torch.Tensor, m: torch.Tensor, n: torch.Tensor,
                    region_id: torch.Tensor, pair_valid: torch.Tensor,
                    bw: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K14: the kernel's sums in its order, vectorised over
    regions (step j adds each region's j-th pair; a region that has no
    j-th pair keeps its sum). Returns (R, G) f32."""
    _check(d, m, n, region_id, pair_valid, bw, xs)
    R = bw.shape[0]
    order, starts = group_pairs(region_id, pair_valid, R)
    order = order.to(torch.int64)
    starts = starts.to(torch.int64)
    counts = starts[1:] - starts[:-1]
    length = torch.clamp(torch.maximum(m, n).to(torch.float32), min=1.0)
    norm = (d.to(torch.float32) / length)[order]
    h = bw[:, None]
    c = torch.tensor(INV_SQRT_2PI, device=bw.device) / h
    raw = torch.zeros((R, xs.shape[0]), dtype=torch.float32,
                      device=bw.device)
    last = max(0, int(starts[-1]) - 1)
    for j in range(int(counts.max()) if R else 0):
        v = norm[torch.clamp(starts[:-1] + j, max=last)]
        z = (xs[None, :] - v[:, None]) / h
        term = c * torch.exp((z * z) * -0.5)
        raw = torch.where((counts > j)[:, None], raw + term, raw)
    div = torch.clamp(counts.to(torch.float32), min=1.0)
    return normalize_rows_torch(raw, div)


def kde_pairs_cuda(d: torch.Tensor, m: torch.Tensor, n: torch.Tensor,
                   region_id: torch.Tensor, pair_valid: torch.Tensor,
                   bw: torch.Tensor, xs: torch.Tensor, grouped=None
                   ) -> torch.Tensor:
    """K14 on the card (``csrc/kde_pairs.cu``): the pairs grouped on the
    card (``group_pairs``, or ``grouped``, its result for these inputs),
    then one launch of the sums and one of the row normalisation on the
    current stream, no synchronisation. Raises on bad inputs or a refused
    launch."""
    from . import _build

    _check(d, m, n, region_id, pair_valid, bw, xs)
    if not d.is_cuda:
        raise ValueError("kde_pairs_cuda takes CUDA tensors")
    R, G = bw.shape[0], xs.shape[0]
    out = torch.empty((R, G), dtype=torch.float32, device=d.device)
    if R == 0 or G == 0:
        return out
    order, starts = grouped or group_pairs(region_id, pair_valid, R)
    raw = torch.empty_like(out)
    div = torch.empty(R, dtype=torch.float32, device=d.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(d.device).cuda_stream
    with torch.cuda.device(d.device):
        err = lib.otter_kde_pairs(
            data_ptr(d), data_ptr(m), data_ptr(n), data_ptr(order),
            data_ptr(starts), data_ptr(bw), data_ptr(xs), G, R,
            data_ptr(raw), data_ptr(div), data_ptr(out), stream)
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
