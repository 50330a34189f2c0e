"""Batched heaviest-path DP of built POA graphs on a device (kernel K12).

The port of the JAX package's ``ops/poa_device.py``. The reference's
consensus DP (src/anppoa.hpp:254-344) walks each allele's DAG one node at a
time on the CPU. Here the graph *build* (sequential, cigar-driven —
anppoa.hpp:112-241) stays on the host (``ops/poa.py::Ppoa``), and the
heaviest-path DP of MANY alleles runs as one launch of K12 a device
(``kernels/poa_heaviest.py``): per node the heaviest float32 path weight
and the least edge id achieving it (edge ids in the oracle's incoming-list
build order: ascending src, then out-list position). The oracle's tie
rules hold exactly: candidate = f32(h[src] + w) like set_heaviest
(anppoa.hpp:258-277; ops/poa.py:239); among equal candidates the FIRST
incoming edge wins; the best ending node is the smallest node id among
maxima (anppoa.hpp:356-367 iterates ascending).

Backtracking (O(path length), sequential) and the node-string concat stay
on the host; one device-to-host copy a device.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from ..kernels.poa_heaviest import pack_graphs, poa_heaviest, split_by_graph
from .poa import Ppoa


def graph_arrays(poa: Ppoa):
    """Flatten a built (weight-adjusted) Ppoa into DP arrays.

    Returns (src, sink, w, has_in, ending, depth) with edges in id order
    and depth each node's Kahn level (its longest path from a source; the
    JAX function returns only the largest, its sweep count), or None when
    the graph has no edges (degenerate: the caller takes the oracle) or a
    cycle (invalid cigars: the oracle's bail-out path).
    """
    n = len(poa.nodes)
    src: List[int] = []
    sink: List[int] = []
    w: List[np.float32] = []
    for s in range(n):
        for t, wt in poa.edges[s]:
            src.append(s)
            sink.append(t)
            w.append(np.float32(wt))
    if not src:
        return None
    src_a = np.asarray(src, dtype=np.int32)
    sink_a = np.asarray(sink, dtype=np.int32)
    has_in = np.zeros(n, dtype=bool)
    has_in[sink_a] = True
    # longest-path depth via Kahn levels
    indeg = np.zeros(n, dtype=np.int64)
    np.add.at(indeg, sink_a, 1)
    depth = np.zeros(n, dtype=np.int64)
    out_edges: List[List[int]] = [[] for _ in range(n)]
    for e in range(len(src)):
        out_edges[src[e]].append(e)
    queue = deque(int(v) for v in np.nonzero(indeg == 0)[0])
    drained = 0
    while queue:
        u = queue.popleft()
        drained += 1
        for e in out_edges[u]:
            v = sink[e]
            if depth[u] + 1 > depth[v]:
                depth[v] = depth[u] + 1
            indeg[v] -= 1
            if indeg[v] == 0:
                queue.append(v)
    if drained < n:
        return None
    ending = np.zeros(n, dtype=bool)
    for v in poa.ending_nodes:
        if v < n:
            ending[v] = True
    return (src_a, sink_a, np.asarray(w, dtype=np.float32), has_in, ending,
            depth)


def _backtrack(poa: Ppoa, src: np.ndarray, has_in: np.ndarray,
               ending: np.ndarray, h: np.ndarray, min_eid: np.ndarray) -> str:
    """The consensus string from the DP's (h, min_eid): the best ending
    node by strict > over ascending node ids (anppoa.hpp:356-367; node 0
    without ending nodes), then first-incoming-edge pointers back to a
    source."""
    h_node = 0
    if ending.any():
        ev = np.where(ending, h, -np.inf)
        h_node = int(np.nonzero(ev == ev.max())[0][0])
    path = []
    node = h_node
    while node != -1:
        path.append(node)
        if not has_in[node]:
            node = -1
        else:
            e = int(min_eid[node])
            node = int(src[e]) if e < len(src) else -1
    path.reverse()
    return "".join(poa.nodes[p] for p in path)


def poa_consensus_device_batch(poas: List[Ppoa], devices="cpu") -> List[str]:
    """Consensus strings for a batch of BUILT, weight-adjusted Ppoa graphs
    with the heaviest-path DP on ``devices`` (one device, or a mesh: the
    graph axis split over its shards in contiguous blocks, every shard
    launched before any is read, as the JAX package shards it over its
    mesh)."""
    from ..parallel.mesh import as_mesh, shard_rows

    out: List[Optional[str]] = [None] * len(poas)
    flat: List[Tuple[int, tuple]] = []
    for i, poa in enumerate(poas):
        arrs = graph_arrays(poa)
        if arrs is None:
            out[i] = poa.consensus()  # degenerate single-node graph
        else:
            flat.append((i, arrs))
    mesh = as_mesh(devices)
    launched = []
    for dev, (lo, hi) in zip(mesh, shard_rows(len(flat), mesh)):
        if lo == hi:
            continue
        part = flat[lo:hi]
        batch = pack_graphs([(a[0], a[1], a[2], a[5]) for _i, a in part])
        launched.append((part, batch, *poa_heaviest(batch.to(dev))))
    for part, batch, h, min_eid in launched:
        per_graph = split_by_graph(batch, h.cpu().numpy(),
                                   min_eid.cpu().numpy())
        for (i, (src, _t, _w, has_in, ending, _d)), (hv, mv) in zip(
                part, per_graph):
            out[i] = _backtrack(poas[i], src, has_in, ending, hv, mv)
    return out
