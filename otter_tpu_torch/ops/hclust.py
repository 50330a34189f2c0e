"""Average-linkage hierarchical clustering with hclust-cpp-compatible output.

The reference clusters with Müllner's nearest-neighbor-chain algorithm
(include/hclust-cpp, ``hclust_fast(..., HCLUST_METHOD_AVERAGE, ...)``) and
cuts the dendrogram with ``cutree_cdist``/``cutree_k``
(src/otterclust.cpp:182-185,227,242,336-337). Cluster labels — and therefore
medoids, consensus backbones, and final alleles — depend on the exact merge
order and the R-convention relabeling, so this module implements the same
published algorithm (Murtagh 1985 NN-chain; Müllner 2011) with identical
tie-breaking:

  * NN search scans the active-node doubly-linked list in index order and
    updates only on strictly smaller distances, so the lowest-index nearest
    neighbor wins ties.
  * Merges are recorded in discovery order, then stable-sorted by height, so
    equal-height merges keep chain order.
  * R output convention: singletons are -(i+1); internal nodes are numbered
    1..n-1 in sorted order via union-find.
  * ``cutree_cdist`` stops at the first height >= cdist; ``cutree_k`` labels
    clusters by first-member order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import native


def nn_chain_average(n: int, condensed: np.ndarray
                     ) -> List[Tuple[int, int, float]]:
    """NN-chain average linkage (vectorized over a square matrix; identical
    merges/ties to nn_chain_average_ref — the scan-order semantics map to
    numpy first-of-min argmin, and the Lance-Williams update is the same
    per-element float64 expression)."""
    S = np.zeros((n, n), dtype=np.float64)
    iu = np.triu_indices(n, k=1)
    S[iu] = condensed
    S.T[iu] = condensed
    members = np.ones(n, dtype=np.float64)
    active = np.ones(n, dtype=bool)
    merges: List[Tuple[int, int, float]] = []
    chain = [0] * n
    tip = 0
    idx1 = idx2 = 0
    mind = 0.0
    for _ in range(n - 1):
        if tip <= 3:
            # restart: idx1 = smallest active; idx2 = first-of-min among the
            # remaining actives in ascending order (strict-< scan semantics)
            cands = np.nonzero(active)[0]
            idx1 = int(cands[0])
            rest = cands[1:]
            vals = S[idx1, rest]
            idx2 = int(rest[int(np.argmin(vals))])
            mind = float(S[idx1, idx2])
            chain[0] = idx1
            tip = 1
        else:
            tip -= 3
            idx1 = chain[tip - 1]
            idx2 = chain[tip]
            mind = float(S[idx1, idx2])
        while True:
            chain[tip] = idx2
            # strict-< scan over actives != idx2 ascending: a new winner
            # needs a strictly smaller distance; equal keeps idx1
            cands = np.nonzero(active)[0]
            cands = cands[cands != idx2]
            vals = S[cands, idx2]
            ai = int(np.argmin(vals))
            if float(vals[ai]) < mind:
                mind = float(vals[ai])
                idx1 = int(cands[ai])
            idx2 = idx1
            idx1 = chain[tip]
            tip += 1
            if idx2 == chain[tip - 2]:
                break
        merges.append((idx1, idx2, float(mind)))
        if idx1 > idx2:
            idx1, idx2 = idx2, idx1
        size1 = members[idx1]
        size2 = members[idx2]
        members[idx2] += members[idx1]
        active[idx1] = False
        s = size1 / (size1 + size2)
        t = size2 / (size1 + size2)
        upd = s * S[idx1] + t * S[idx2]  # f_average, same expression
        S[idx2, active] = upd[active]
        S[active, idx2] = upd[active]
        S[idx2, idx2] = 0.0
    return merges


def nn_chain_average_ref(n: int, condensed: np.ndarray
                         ) -> List[Tuple[int, int, float]]:
    """Scalar NN-chain average linkage over a condensed distance matrix
    (tie-semantics oracle for the vectorized version above).

    Returns merges [(node1, node2, dist)] in discovery order, where node ids
    are original point indices standing for their current clusters (the
    surviving id after a merge is the larger index, as in hclust-cpp's
    NN_chain_core which removes the smaller index from the active list).
    """
    D = condensed.astype(np.float64).copy()
    members = np.ones(n, dtype=np.float64)

    def didx(a: int, b: int) -> int:
        if a > b:
            a, b = b, a
        return ((2 * n - 3 - a) * a >> 1) + b - 1

    # doubly linked active list
    succ = list(range(1, n + 1))
    pred = list(range(-1, n - 1))
    start = 0

    def remove(idx: int) -> None:
        nonlocal start
        p, s = pred[idx], succ[idx]
        if p < 0:
            start = s
        else:
            succ[p] = s
        if s < n:
            pred[s] = p

    merges: List[Tuple[int, int, float]] = []
    chain = [0] * n
    tip = 0
    idx1 = idx2 = 0
    mind = 0.0
    for _ in range(n - 1):
        if tip <= 3:
            idx1 = start
            chain[0] = idx1
            tip = 1
            idx2 = succ[idx1]
            mind = D[didx(idx1, idx2)]
            i = succ[idx2]
            while i < n:
                d = D[didx(idx1, i)]
                if d < mind:
                    mind = d
                    idx2 = i
                i = succ[i]
        else:
            tip -= 3
            idx1 = chain[tip - 1]
            idx2 = chain[tip]
            mind = D[didx(idx1, idx2)]
        while True:
            chain[tip] = idx2
            i = start
            while i < idx2:
                d = D[didx(i, idx2)]
                if d < mind:
                    mind = d
                    idx1 = i
                i = succ[i]
            i = succ[idx2]
            while i < n:
                d = D[didx(idx2, i)]
                if d < mind:
                    mind = d
                    idx1 = i
                i = succ[i]
            idx2 = idx1
            idx1 = chain[tip]
            tip += 1
            if idx2 == chain[tip - 2]:
                break
        merges.append((idx1, idx2, float(mind)))
        if idx1 > idx2:
            idx1, idx2 = idx2, idx1
        size1 = members[idx1]
        size2 = members[idx2]
        members[idx2] += members[idx1]
        remove(idx1)
        # average-linkage distance update (f_average)
        s = size1 / (size1 + size2)
        t = size2 / (size1 + size2)
        i = start
        while i < idx1:
            k = didx(i, idx2)
            D[k] = s * D[didx(i, idx1)] + t * D[k]
            i = succ[i]
        while i < idx2:
            k = didx(i, idx2)
            D[k] = s * D[didx(idx1, i)] + t * D[k]
            i = succ[i]
        i = succ[idx2]
        while i < n:
            k = didx(idx2, i)
            D[k] = s * D[didx(idx1, i)] + t * D[k]
            i = succ[i]
    return merges


def to_r_dendrogram(merges: List[Tuple[int, int, float]], n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Stable-sort merges by height and relabel to R convention
    (generate_R_dendrogram<false>): returns (merge[(n-1),2], height[n-1])
    with singletons negative (-i-1) and compound nodes 1..n-1."""
    order = sorted(range(len(merges)), key=lambda i: merges[i][2])
    # union-find over 2n-1 slots
    parent = list(range(2 * n - 1))

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    merge = np.zeros((n - 1, 2), dtype=np.int64)
    height = np.zeros(n - 1, dtype=np.float64)
    next_cluster = n
    for out_i, mi in enumerate(order):
        a, b, d = merges[mi]
        node1 = find(a)
        node2 = find(b)
        parent[node1] = next_cluster
        parent[node2] = next_cluster
        next_cluster += 1
        if node1 > node2:
            node1, node2 = node2, node1
        merge[out_i, 0] = -(node1 + 1) if node1 < n else node1 - n + 1
        merge[out_i, 1] = -(node2 + 1) if node2 < n else node2 - n + 1
        height[out_i] = d
    return merge, height


def hclust_average(n: int, condensed: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """hclust_fast(HCLUST_METHOD_AVERAGE) equivalent: (merge, height)."""
    if n < 2:
        return np.zeros((0, 2), dtype=np.int64), np.zeros(0, dtype=np.float64)
    merges = nn_chain_average(n, condensed)
    return to_r_dendrogram(merges, n)


def cutree_k(n: int, merge: np.ndarray, nclust: int) -> np.ndarray:
    """Labels 0..nclust-1 (fastcluster.cpp cutree_k semantics incl. the
    all-zero result when nclust > n or nclust < 2). The per-merge
    last_merge relabel scans are numpy boolean assignments — identical
    relabeling, O(n) vector ops instead of python loops. Routed to the
    native C++ port (otter_native.cpp::otter_cutree_k, integer-exact by
    construction) under the same gating as the native NN-chain."""
    labels = np.zeros(n, dtype=np.int64)
    if nclust > n or nclust < 2:
        return labels
    if native.enabled("HCLUST"):
        return native.cutree_k_native(n, merge, nclust)
    last_merge = np.zeros(n, dtype=np.int64)
    for k in range(1, n - nclust + 1):
        m1 = int(merge[k - 1, 0])
        m2 = int(merge[k - 1, 1])
        if m1 < 0 and m2 < 0:
            last_merge[-m1 - 1] = k
            last_merge[-m2 - 1] = k
        elif m1 < 0 or m2 < 0:
            if m1 < 0:
                j = -m1
                m1 = m2
            else:
                j = -m2
            last_merge[last_merge == m1] = k
            last_merge[j - 1] = k
        else:
            last_merge[(last_merge == m1) | (last_merge == m2)] = k
    label = 0
    z = [-1] * n
    for j in range(n):
        lm = int(last_merge[j])
        if lm == 0:
            labels[j] = label
            label += 1
        else:
            if z[lm] < 0:
                z[lm] = label
                label += 1
            labels[j] = z[lm]
    return labels


def cutree_cdist(n: int, merge: np.ndarray, height: np.ndarray,
                 cdist: float) -> np.ndarray:
    """Stop merging at the first height >= cdist (fastcluster.cpp)."""
    k = 0
    while k < n - 1:
        if height[k] >= cdist:
            break
        k += 1
    return cutree_k(n, merge, n - k)
