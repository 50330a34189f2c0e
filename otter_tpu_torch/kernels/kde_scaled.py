"""Kernel K8: scaled Gaussian KDE over the clustering grid.

Counterpart of ``kde_tree_step_scaled`` in ``otter_tpu/parallel/mesh.py``
(jnp, not Pallas). Inputs as that function takes them: ``vals`` (R, n_pad)
f32 per-region pair distances (n_pad a power of two >= nvals), ``nvals``
(R,) int32 real counts (>= 1), ``bw`` (R,) f32 bandwidths, ``xs`` (G,) f32
grid. The result is ``(m, s)``, each (R, G) f32: per cell the largest
exponent m = max -(z z) / 2 over the real values (z = (x - v) / h) and
s = sum exp(e - m), summed in the halving order the host certification
models (``ops/kde.py::kde_decision_certified_scaled``).

``kde_scaled_cuda`` launches the hand-written kernel
(``csrc/kde_scaled.cu``), ``kde_scaled_torch`` is the plain PyTorch version
of the same arithmetic (the halving loop as in the JAX function), and
``kde_scaled`` picks one by device.

Kernel K13 is the unscaled KDE, the counterpart of ``kde_tree_step`` in the
same JAX module: the same inputs, each term (INV_SQRT_2PI / h) exp(-(z z) /
2) summed in the same halving order, each row divided by h nvals and then
by its total (at least 1e-30), the total a fixed halving tree over the row
padded to ``ROW_LANES`` (``normalize_rows_torch``; XLA leaves that order
open). ``kde_tree_cuda`` launches K8's kernel in its unscaled instance and
the row normalisation (``csrc/kde_rows.cuh``), ``kde_tree_torch`` is the
plain version, ``kde_tree`` picks one by device.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .myers_pallas import data_ptr

# elements of one (regions, G, n_pad) slab of the plain version
_PLAIN_SLAB = 1 << 24
# the warps W that may share a grid cell's values (kWarps = 16 a block)
# and the grid cells C a thread may hold
WARPS = (1, 2, 4, 8, 16)
CELLS = (4, 8)
# f32 of 1 / sqrt(2 pi), as jnp takes the Python constant
INV_SQRT_2PI = np.float32(1.0 / math.sqrt(2.0 * 3.14159265358979323846))
# a density row's padded lanes for its total, at least (at most 1024)
ROW_LANES = 512


def row_lanes(n_cells: int) -> int:
    """The lanes a row of ``n_cells`` is padded to for its total."""
    lanes = ROW_LANES
    while lanes < n_cells:
        lanes *= 2
    if lanes > 1024:
        raise ValueError("a density row holds at most 1024 cells")
    return lanes


def normalize_rows_torch(raw: torch.Tensor, div: torch.Tensor
                         ) -> torch.Tensor:
    """The plain version of K13's and K14's last step
    (``csrc/kde_rows.cuh``): d = raw / div[r], then d / max(total,
    1e-30), the total a halving tree over the row padded with zeros to
    ``row_lanes``."""
    R, G = raw.shape
    d = raw / div[:, None]
    t = torch.zeros((R, row_lanes(G)), dtype=torch.float32,
                    device=raw.device)
    t[:, :G] = d
    w = t.shape[1]
    while w > 1:
        t = t[:, : w // 2] + t[:, w // 2 : w]
        w //= 2
    return d / torch.clamp(t, min=1e-30)


def _check(vals, nvals, bw, xs) -> None:
    R, n_pad = vals.shape
    if vals.dtype != torch.float32 or bw.dtype != torch.float32 \
            or xs.dtype != torch.float32 or nvals.dtype != torch.int32:
        raise ValueError("vals, bw and xs must be float32, nvals int32")
    if n_pad & (n_pad - 1) or nvals.shape != (R,) or bw.shape != (R,) \
            or xs.dim() != 1:
        raise ValueError("vals must be (R, n_pad) with n_pad a power of two, "
                         "nvals and bw (R,), xs (G,)")
    if not (vals.device == nvals.device == bw.device == xs.device):
        raise ValueError("all inputs must be on one device")


def kde_scaled_torch(vals: torch.Tensor, nvals: torch.Tensor,
                     bw: torch.Tensor, xs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K8: the JAX function's ops on (R, G, n_pad) slabs of
    a few regions at a time, the sum as its halving loop."""
    _check(vals, nvals, bw, xs)
    R, n_pad = vals.shape
    G = xs.shape[0]
    lane = torch.arange(n_pad, device=vals.device)
    m_out = torch.empty((R, G), dtype=torch.float32, device=vals.device)
    s_out = torch.empty_like(m_out)
    step = max(1, _PLAIN_SLAB // (G * n_pad))
    for r0 in range(0, R, step):
        sl = slice(r0, min(R, r0 + step))
        h = bw[sl, None, None]
        mask = lane[None, None, :] < nvals[sl, None, None]
        z = (xs[None, :, None] - vals[sl, None, :]) / h
        e = -(z * z) / 2.0
        e = torch.where(mask, e, float("-inf"))
        m = e.max(dim=2).values
        t = torch.exp(e - m[:, :, None])
        t = torch.where(mask, t, 0.0)
        w = n_pad
        while w > 1:
            t = t[..., : w // 2] + t[..., w // 2 : w]
            w //= 2
        m_out[sl] = m
        s_out[sl] = t[..., 0]
    return m_out, s_out


def kde_scaled_cuda(vals: torch.Tensor, nvals: torch.Tensor,
                    bw: torch.Tensor, xs: torch.Tensor,
                    n_max: Optional[int] = None, *, warps: int = 0,
                    cells: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 on the card (``csrc/kde_scaled.cu``): one launch on the current
    stream, no synchronisation. ``n_max``: the largest nvals, which the
    caller knows on the host (default n_pad); it sizes the kernel's
    shared-memory stage. ``warps`` and ``cells``: the warps W that share a
    grid cell's values (one of ``WARPS``) and the grid cells C a thread
    holds (one of ``CELLS``), for the tests and the A/B tool; 0 takes the
    launcher's rule (``kde_scaled_geometry``), as every caller of the
    package does. Every W and C give the same bits. Raises on bad inputs
    or a refused launch."""
    from . import _build

    _check(vals, nvals, bw, xs)
    if not vals.is_cuda:
        raise ValueError("kde_scaled_cuda takes CUDA tensors")
    R, n_pad = vals.shape
    G = xs.shape[0]
    m = torch.empty((R, G), dtype=torch.float32, device=vals.device)
    s = torch.empty_like(m)
    if R == 0 or G == 0:
        return m, s
    lib = _build.load()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        err = lib.otter_kde_scaled_launch(
            data_ptr(vals), n_pad, data_ptr(nvals), data_ptr(bw),
            data_ptr(xs), G, R, n_pad if n_max is None else n_max, cells,
            warps, data_ptr(m), data_ptr(s), stream)
    _build.check(lib, err, "kde_scaled_cuda")
    kde_scaled_cuda.launches += 1
    return m, s


kde_scaled_cuda.launches = 0


def kde_scaled_geometry(regions: int, n_pad: int, n_max: int,
                        grid: int) -> Tuple[int, int, int, int]:
    """(W, cells a thread, blocks, threads a block): the launch
    ``kde_scaled_cuda`` makes by its rule for ``regions`` rows of ``n_pad``
    lanes, the largest ``n_max`` values, over ``grid`` grid cells (needs
    the built library, so a CUDA toolchain)."""
    from . import _build

    lib = _build.load()
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.otter_kde_scaled_geometry(
        n_pad, n_max, grid, regions, ctypes.addressof(out)),
        "kde_scaled_geometry")
    return tuple(out)


def kde_scaled(vals: torch.Tensor, nvals: torch.Tensor, bw: torch.Tensor,
               xs: torch.Tensor, n_max: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if vals.is_cuda:
        return kde_scaled_cuda(vals, nvals, bw, xs, n_max)
    if vals.device.type == "cpu":
        return kde_scaled_torch(vals, nvals, bw, xs)
    raise ValueError(f"no K8 version for device {vals.device}")


def kde_tree_torch(vals: torch.Tensor, nvals: torch.Tensor, bw: torch.Tensor,
                   xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K13: kde_tree_step's ops on (R, G, n_pad) slabs of a
    few regions at a time, the sum as its halving loop, then
    ``normalize_rows_torch``. Returns (R, G) f32 densities."""
    _check(vals, nvals, bw, xs)
    R, n_pad = vals.shape
    G = xs.shape[0]
    row_lanes(G)
    lane = torch.arange(n_pad, device=vals.device)
    raw = torch.empty((R, G), dtype=torch.float32, device=vals.device)
    inv = torch.tensor(INV_SQRT_2PI, device=vals.device)
    step = max(1, _PLAIN_SLAB // (G * n_pad))
    for r0 in range(0, R, step):
        sl = slice(r0, min(R, r0 + step))
        h = bw[sl, None, None]
        mask = lane[None, None, :] < nvals[sl, None, None]
        z = (xs[None, :, None] - vals[sl, None, :]) / h
        kern = (inv / h) * torch.exp(-(z * z) / 2.0)
        t = torch.where(mask, kern, 0.0)
        w = n_pad
        while w > 1:
            t = t[..., : w // 2] + t[..., w // 2 : w]
            w //= 2
        raw[sl] = t[..., 0]
    return normalize_rows_torch(raw, bw * nvals.to(torch.float32))


def kde_tree_cuda(vals: torch.Tensor, nvals: torch.Tensor, bw: torch.Tensor,
                  xs: torch.Tensor, n_max: Optional[int] = None, *,
                  warps: int = 0, cells: int = 0) -> torch.Tensor:
    """K13 on the card: K8's kernel in its unscaled instance (the launch
    K8's rule picks, or ``warps`` / ``cells`` as ``kde_scaled_cuda``
    takes them), then the row normalisation; on the current stream, no
    synchronisation. Raises on bad inputs or a refused launch."""
    from . import _build

    _check(vals, nvals, bw, xs)
    if not vals.is_cuda:
        raise ValueError("kde_tree_cuda takes CUDA tensors")
    R, n_pad = vals.shape
    G = xs.shape[0]
    row_lanes(G)
    out = torch.empty((R, G), dtype=torch.float32, device=vals.device)
    if R == 0 or G == 0:
        return out
    raw = torch.empty_like(out)
    div = torch.empty(R, dtype=torch.float32, device=vals.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        err = lib.otter_kde_tree(
            data_ptr(vals), n_pad, data_ptr(nvals), data_ptr(bw),
            data_ptr(xs), G, R, n_pad if n_max is None else n_max, cells,
            warps, data_ptr(raw), data_ptr(div), data_ptr(out), stream)
    _build.check(lib, err, "kde_tree_cuda")
    kde_tree_cuda.launches += 1
    return out


kde_tree_cuda.launches = 0


def kde_tree(vals: torch.Tensor, nvals: torch.Tensor, bw: torch.Tensor,
             xs: torch.Tensor, n_max: Optional[int] = None) -> torch.Tensor:
    """K13 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if vals.is_cuda:
        return kde_tree_cuda(vals, nvals, bw, xs, n_max)
    if vals.device.type == "cpu":
        return kde_tree_torch(vals, nvals, bw, xs)
    raise ValueError(f"no K13 version for device {vals.device}")
