"""The in-process device mesh, and the pooled device KDE over it.

Counterpart of the JAX package's ``otter_tpu/parallel/mesh.py``
(``make_mesh``, ``shard_pair_batch``, ``pooled_kde_scaled``, the sharded
forward step ``region_batch_step`` / ``run_sharded_region_step`` with
kernels K7 and K14, and the fused collect's ``kde_fused_from_pairs``; the
unscaled KDE ``kde_tree_step`` is ``kernels/kde_scaled.py::kde_tree``,
K13). A mesh here
is an ordered tuple of ``torch.device``s: ``make_mesh`` gives the visible
cards, capped by ``OTTER_TPU_MESH_DEVICES`` as the JAX package caps its
local devices, and a caller may pass any devices instead (the tests' CPU
meshes ``(cpu,) * N``, whose shards run the kernels' plain versions in
turn; one card split in two shards, ``(cuda:0, cuda:0)``). Work is split
into contiguous row blocks, one a shard (``shard_rows``); torch has no
sharding constraint, so nothing is padded and an empty shard launches
nothing. Each shard's kernels launch on its own device, every shard is
launched before any result is read back, and results come back in the
input order.

Several processes on one host split the cards with
``CUDA_VISIBLE_DEVICES``: each process's mesh is the cards it sees.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.edit_banded import edit_banded
from ..kernels.kde_pairs import kde_pairs, linspace_grid
from ..kernels.kde_scaled import kde_scaled
from ..ops.kde import kde_grid
from ..utils.metrics import to_host

Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of ``devices`` (as given), or of the first ``n_devices``
    visible cards (default ``OTTER_TPU_MESH_DEVICES``; 0 or unset means
    all). Raises when no card is visible and no devices are given: a mesh
    never becomes a CPU run unless the caller asks for one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device 'mesh' requested but "
                               "torch.cuda.is_available() is false")
        if n_devices is None:
            n_devices = int(os.environ.get("OTTER_TPU_MESH_DEVICES", "0")
                            or 0)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if n_devices:
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def as_mesh(devices) -> Mesh:
    """``devices`` as a mesh: one device (a name or a ``torch.device``) is
    a mesh of one."""
    if isinstance(devices, (str, torch.device)):
        return (torch.device(devices),)
    return tuple(torch.device(d) for d in devices)


def shard_rows(n: int, mesh: Sequence) -> List[Tuple[int, int]]:
    """Contiguous row blocks [lo, hi) of ``n`` rows, one a shard of
    ``mesh`` in order, sizes differing by at most one (the first shards
    take the remainder); a shard past ``n`` gets an empty block."""
    shards = len(mesh)
    base, extra = divmod(n, shards)
    out = []
    lo = 0
    for s in range(shards):
        hi = lo + base + (1 if s < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def pooled_kde_scaled(value_lists, bandwidths, devices,
                      dinterval: float = 0.0025) -> list:
    """Scaled tree-reduction KDE (kernel K8 on CUDA devices, its plain
    version on the CPU) over many regions, bucketed by padded value count
    (n_pad, a power of two >= max(8, n)) as the JAX function does. Each
    bucket's regions are split over ``devices`` (a mesh, or one device),
    every shard launched before any is read, then ONE device-to-host copy
    a device. Returns per-region (m, s) float32 array pairs."""
    mesh = as_mesh(devices)
    xs32 = torch.from_numpy(kde_grid(dinterval).astype(np.float32))
    G = xs32.shape[0]
    xs = {d: xs32.to(d) for d in set(mesh)}
    out = [None] * len(value_lists)
    buckets: dict = {}
    for i, v in enumerate(value_lists):
        n_pad = 8
        while n_pad < len(v):
            n_pad *= 2
        buckets.setdefault(n_pad, []).append(i)
    chunks: dict = {d: [] for d in mesh}  # device (R, 2G) blocks
    spans: dict = {d: [] for d in mesh}   # their regions, in block order
    for n_pad, idxs in sorted(buckets.items()):
        for dev, (lo, hi) in zip(mesh, shard_rows(len(idxs), mesh)):
            if lo == hi:
                continue
            part = idxs[lo:hi]
            V = np.zeros((len(part), n_pad), dtype=np.float32)
            nv = np.ones(len(part), dtype=np.int32)
            bwv = np.full(len(part), 0.01, dtype=np.float32)
            for r, i in enumerate(part):
                v = np.asarray(value_lists[i], dtype=np.float32)
                V[r, : len(v)] = v
                nv[r] = len(v)
                bwv[r] = bandwidths[i]
            m, s = kde_scaled(torch.from_numpy(V).to(dev),
                              torch.from_numpy(nv).to(dev),
                              torch.from_numpy(bwv).to(dev), xs[dev],
                              n_max=int(nv.max()))
            chunks[dev].append(torch.cat([m, s], dim=1))
            spans[dev].extend(part)
    for dev, blocks in chunks.items():
        if not blocks:
            continue
        flat = to_host(torch.cat(blocks))
        for row, i in enumerate(spans[dev]):
            out[i] = (flat[row, :G], flat[row, G:])
    return out


def shard_pair_batch(mesh, arrays) -> list:
    """Each shard's contiguous row block of every array (numpy or torch,
    rows on the first axis) on the shard's device, one list a shard of
    ``mesh`` (``shard_rows``)."""
    mesh = as_mesh(mesh)
    tensors = [torch.as_tensor(a) for a in arrays]
    return [[t[lo:hi].to(dev) for t in tensors]
            for dev, (lo, hi) in zip(mesh, shard_rows(len(tensors[0]),
                                                      mesh))]


def region_batch_step(a, bpad, m, n, region_id, pair_valid, bandwidth,
                      k: int, max_rows: int, n_regions: int,
                      grid_pts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward step of the assemble math on the device the tensors lie
    on, as the JAX function: the banded edit distances of a cross-region
    pair batch (K7; INF = 2^24 where the band is too narrow), then the
    per-region KDE densities over ``linspace(0, 1, grid_pts)`` (K14). a
    (B, L) and bpad (B, L + W + 2) int32 codes in the JAX package's
    ``_pack_bucket`` layout (``max_rows`` = L), m, n, region_id (B,)
    int32, pair_valid (B,) bool, bandwidth (n_regions,) f32. Returns
    (dists (B,) int32, densities (n_regions, grid_pts) f32)."""
    return run_sharded_region_step((a.device,), a, bpad, m, n, region_id,
                                   pair_valid, bandwidth, k, max_rows,
                                   n_regions, grid_pts)


def run_sharded_region_step(mesh, a, bpad, m, n, region_id, pair_valid,
                            bandwidth, k: int, max_rows: int, n_regions: int,
                            grid_pts: int = 401
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``region_batch_step`` with the pair axis split over ``mesh`` (a
    mesh, or one device): each shard's K7 launch on its own device, every
    shard launched before any is read; then the distances gathered on the
    mesh's first device and K14 launched once there, so the densities are
    the same bits at every mesh size. Inputs numpy or torch; returns
    (dists, densities) on the first device."""
    mesh = as_mesh(mesh)
    if max_rows != np.shape(a)[1] or np.shape(bandwidth) != (n_regions,):
        raise ValueError("max_rows must be the width of a, bandwidth "
                         "(n_regions,)")
    launched = [edit_banded(a_s, b_s, torch.stack([m_s, n_s], 1).contiguous(),
                            k)
                for a_s, b_s, m_s, n_s in shard_pair_batch(mesh,
                                                           [a, bpad, m, n])]
    head = mesh[0]
    dists = torch.cat([d.to(head) for d in launched])
    m0, n0, rid0, pv0, bw0 = (torch.as_tensor(x).to(head) for x in (
        m, n, region_id, pair_valid, bandwidth))
    xs = torch.from_numpy(linspace_grid(grid_pts)).to(head)
    return dists, kde_pairs(dists, m0, n0, rid0, pv0, bw0, xs)


def kde_fused_from_pairs(flat, mlen, rid_m, slot_m, ex_row, ex_slot, ex_val,
                         nvals, bw, xs, n_pad: int, n_rows: int,
                         n_max: Optional[int] = None) -> torch.Tensor:
    """The scaled per-region KDE (K8) computed from pair distances where
    they lie (the fused collect's tail, as the JAX function): the f32
    divide of each distance by its pair's longer length, a scatter into
    the (n_rows + 1, n_pad) value grid (the host-known exceptional entries
    first, then the pairs; the last row takes the excluded pairs), then K8
    on the first n_rows rows. flat (P,) int32, mlen (P,) f32, rid_m /
    slot_m (P,) int32, ex_* (E,) int32 / f32, nvals (n_rows,) int32, bw
    (n_rows,) f32, xs (G,) f32, all on one device; ``n_max`` the largest
    nvals (K8 sizes its stage with it). Returns (P + 2 n_rows G,) f32:
    [distances, m.ravel(), s.ravel()]."""
    f = flat.to(torch.float32)
    vals = torch.zeros((n_rows + 1, n_pad), dtype=torch.float32,
                       device=f.device)
    vals[ex_row.long(), ex_slot.long()] = ex_val
    vals[rid_m.long(), slot_m.long()] = f / mlen
    m, s = kde_scaled(vals[:-1], nvals, bw, xs, n_max)
    return torch.cat([f, m.reshape(-1), s.reshape(-1)])
