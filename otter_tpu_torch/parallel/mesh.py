"""Pooled device KDE of many regions (counterpart of the JAX package's
``otter_tpu/parallel/mesh.py::pooled_kde_scaled``).

One process, one device: the mesh, the pair-batch sharding and the sharded
region step of the JAX module are not ported (ROADMAP queue 1 items 12 and
14).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.kde_scaled import kde_scaled
from ..ops.kde import kde_grid


def pooled_kde_scaled(value_lists, bandwidths, device,
                      dinterval: float = 0.0025) -> list:
    """Scaled tree-reduction KDE (kernel K8 on a CUDA ``device``, its plain
    version on the CPU) over many regions, bucketed by padded value count
    (n_pad, a power of two >= max(8, n)) as the JAX function does, with ONE
    device-to-host copy for every bucket. Returns per-region (m, s) float32
    array pairs."""
    dev = torch.device(device)
    xs = torch.from_numpy(kde_grid(dinterval).astype(np.float32)).to(dev)
    G = xs.shape[0]
    out = [None] * len(value_lists)
    buckets: dict = {}
    for i, v in enumerate(value_lists):
        n_pad = 8
        while n_pad < len(v):
            n_pad *= 2
        buckets.setdefault(n_pad, []).append(i)
    chunks = []  # device (R, 2G) blocks, one per bucket
    spans = []
    for n_pad, idxs in sorted(buckets.items()):
        V = np.zeros((len(idxs), n_pad), dtype=np.float32)
        nv = np.ones(len(idxs), dtype=np.int32)
        bwv = np.full(len(idxs), 0.01, dtype=np.float32)
        for r, i in enumerate(idxs):
            v = np.asarray(value_lists[i], dtype=np.float32)
            V[r, : len(v)] = v
            nv[r] = len(v)
            bwv[r] = bandwidths[i]
        m, s = kde_scaled(torch.from_numpy(V).to(dev),
                          torch.from_numpy(nv).to(dev),
                          torch.from_numpy(bwv).to(dev), xs,
                          n_max=int(nv.max()))
        chunks.append(torch.cat([m, s], dim=1))
        spans.append(idxs)
    flat = torch.cat(chunks).cpu().numpy() if chunks else None
    row = 0
    for idxs in spans:
        for i in idxs:
            out[i] = (flat[row, :G], flat[row, G:])
            row += 1
    return out
