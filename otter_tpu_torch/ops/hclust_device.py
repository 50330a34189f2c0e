"""Average-linkage clustering on a device (kernel K11).

The port of the JAX package's ``ops/hclust_device.py``: a global-minimum
formulation of average linkage in float32 (``kernels/linkage.py``), a block
per matrix on the card and its plain version on the CPU. Each step merges
the least pair (i < j, the lowest (i, j) on ties) and folds j into i with
size-weighted averaging.

For distance matrices without ties this gives the same dendrogram heights
and partitions as the host NN-chain (global-minimum merge order is a valid
NN-chain order); with exact ties the chain order may differ, which is why
the cohort route (``ops/cluster.py::_hclust_route``) takes it only where it
is certain to agree. Results are in R convention (singletons -(i+1),
clusters 1..n-1) so host cutree_k / cutree_cdist apply directly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels.linkage import linkage


def average_linkage_device(sq: np.ndarray, device="cuda"
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """sq: (n, n) symmetric float32 distances (diagonal ignored). Returns
    (merge_pairs (n-1, 2) int32 slot ids, heights (n-1,) float32): the
    JAX function's first n - 1 records, computed by K11 on ``device``."""
    D = torch.from_numpy(np.ascontiguousarray(sq, dtype=np.float32))
    recs, hs = linkage(D[None].to(device))
    return recs[0].cpu().numpy(), hs[0].cpu().numpy()


def to_r_convention(recs: np.ndarray, hs: np.ndarray, n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Convert slot-id merges to R merge/height arrays (host post-process).

    The device algorithm merges in nondecreasing height order, so no sort is
    needed; slot ids map to cluster ids via a running table."""
    merge = np.zeros((n - 1, 2), dtype=np.int64)
    height = np.zeros(n - 1, dtype=np.float64)
    cluster_of_slot = {i: -(i + 1) for i in range(len(recs) + 1)}
    for k in range(n - 1):
        i, j = int(recs[k][0]), int(recs[k][1])
        a = cluster_of_slot[i]
        b = cluster_of_slot[j]
        lo, hi = (a, b) if a < b else (b, a)
        # R convention orders (node1, node2) by the generate_R_dendrogram
        # rule: numerically ascending after sign mapping
        merge[k, 0] = lo
        merge[k, 1] = hi
        height[k] = float(hs[k])
        cluster_of_slot[i] = k + 1
    return merge, height


def hclust_average_device(condensed: np.ndarray, n: int, device="cuda"
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop-in (merge, height) like ops.hclust.hclust_average, computed by
    K11 on ``device`` from the condensed distances cast to float32."""
    if n < 2:
        return np.zeros((0, 2), dtype=np.int64), np.zeros(0)
    sq = np.zeros((n, n), dtype=np.float32)
    iu = np.triu_indices(n, 1)
    sq[iu] = condensed
    sq += sq.T
    recs, hs = average_linkage_device(sq, device)
    return to_r_convention(recs, hs, n)
