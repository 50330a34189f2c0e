"""Kernel K12: the heaviest-path DP of a batch of POA graphs.

Counterpart of ``_heaviest_step`` in ``otter_tpu/ops/poa_device.py`` (jnp,
not Pallas). Per node: h = 0 without in-edges, else the largest float32
``h[src] + w`` over its in-edges; min_eid = the least edge id (edges
numbered by ascending source, then out-list position) whose candidate
equals h, or the graph's edge count without in-edges.

The batch is packed on the host (``pack_graphs``) in the kernel's layout:
every graph's nodes in Kahn-level order, their in-edges by node in
ascending edge id, each as one record (the source's graph-local position
in that order, the weight's bits, the edge id), all graphs' nodes numbered
globally. ``poa_heaviest_cuda`` launches the
hand-written kernel (``csrc/poa_heaviest.cu``): the streamed kernel (a
block a graph, the level-ordered graph streamed into shared memory ahead
of the lane that walks it node by node) where the graph fits its shared
memory and every node's in-edges its ring, else the device-memory kernel
(a warp a graph, level by level).
``poa_heaviest_torch`` is the plain PyTorch version (the JAX function's
Jacobi sweeps over every edge, then its tie pass), and ``poa_heaviest``
picks one by device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.metrics import to_host
from .myers_pallas import data_ptr

# the streamed kernel's limit on nodes a graph (h and min_eid in shared
# memory) and its default rings: 2^lg_slots chunks of 2^lg elements for the
# in-edge bounds and for the edge records
STREAM_NODES = 24576
# the device-memory kernel's limit on nodes a graph with h in shared memory
SMEM_NODES = 49152
RING = (2, 8, 8)  # lg_slots, lg_pos, lg_edge
ROUTES = ("stream", "global")


class PoaBatch(NamedTuple):
    """A packed batch (see the module note); ``max_nodes`` is the most
    nodes of one graph, ``max_depth`` the most levels less one and
    ``max_in_edges`` the most in-edges of a node."""

    node_of: torch.Tensor  # (N,) int32 global node ids in level order
    lvl_ptr: torch.Tensor  # per graph, its levels + 1 position bounds
    in_ptr: torch.Tensor   # (N + 1,) int32 in-edge bounds of each position
    e_rec: torch.Tensor    # (E, 3) int32 source's graph-local position,
    #                        weight bits, graph-local edge id
    meta: torch.Tensor     # (B, 5) int32 node offset, nodes, level offset,
    #                        levels, edges
    max_nodes: int
    max_depth: int
    max_in_edges: int

    def to(self, device) -> "PoaBatch":
        return self._replace(**{f: getattr(self, f).to(device)
                                for f in self._fields[:5]})


def pack_graphs(graphs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray]]) -> PoaBatch:
    """Pack graphs given as (src, sink, w, depth) (edges in id order, depth
    each node's Kahn level) into a CPU ``PoaBatch``."""
    node_of, lvl_ptr, in_cnt, meta, e_rec = ([] for _ in range(5))
    node_off = edge_off = lvl_off = 0
    max_nodes = max_depth = max_in_edges = 0
    for src, sink, w, depth in graphs:
        n = len(depth)
        levels = int(depth.max()) + 1
        order = np.lexsort((np.arange(n), depth))
        pos_of = np.empty(n, dtype=np.int64)
        pos_of[order] = np.arange(n)
        sink_pos = pos_of[sink]
        eorder = np.argsort(sink_pos, kind="stable")
        node_of.append(order + node_off)
        lvl = np.zeros(levels + 1, dtype=np.int64)
        np.cumsum(np.bincount(depth, minlength=levels), out=lvl[1:])
        lvl_ptr.append(lvl + node_off)
        cnt = np.bincount(sink_pos, minlength=n)
        in_cnt.append(cnt)
        e_rec.append(np.stack([pos_of[src[eorder]],
                               np.asarray(w[eorder], dtype=np.float32
                                          ).view(np.int32), eorder], axis=1))
        max_in_edges = max(max_in_edges, int(cnt.max()))
        meta.append((node_off, n, lvl_off, levels, len(src)))
        node_off += n
        edge_off += len(src)
        lvl_off += levels + 1
        max_nodes = max(max_nodes, n)
        max_depth = max(max_depth, levels - 1)
    in_ptr = np.zeros(node_off + 1, dtype=np.int64)
    if in_cnt:
        np.cumsum(np.concatenate(in_cnt), out=in_ptr[1:])
    if max(node_off, edge_off, lvl_off) >= 2 ** 31:
        raise ValueError("POA batch too large for int32 indices")

    def i32(parts):
        return torch.from_numpy(np.concatenate(parts).astype(np.int32)
                                if parts else np.zeros(0, dtype=np.int32))

    return PoaBatch(
        i32(node_of), i32(lvl_ptr), torch.from_numpy(in_ptr.astype(np.int32)),
        i32(e_rec).reshape(-1, 3),
        torch.from_numpy(np.asarray(meta, dtype=np.int32).reshape(-1, 5)),
        max_nodes, max_depth, max_in_edges)


def _check(batch: PoaBatch) -> None:
    for f in batch._fields[:5]:
        if getattr(batch, f).dtype != torch.int32:
            raise ValueError(f"{f} must be int32")
    devs = {getattr(batch, f).device for f in batch._fields[:5]}
    if len(devs) != 1:
        raise ValueError("a POA batch must lie on one device")


def poa_heaviest_torch(batch: PoaBatch
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K12: ``max_depth`` Jacobi sweeps (a gather and a
    scatter-max over every edge), sources pinned to 0, then the tie pass
    (a scatter-min of the ids of the edges whose candidate equals h)."""
    _check(batch)
    dev = batch.node_of.device
    total = batch.node_of.shape[0]
    meta = batch.meta.long()
    counts = (batch.in_ptr[1:] - batch.in_ptr[:-1]).long()
    node_of = batch.node_of.long()
    sink = node_of[torch.repeat_interleave(
        torch.arange(total, device=dev), counts)]
    n_edges = batch.e_rec.shape[0]
    src = node_of[torch.repeat_interleave(meta[:, 0], meta[:, 4],
                                          output_size=n_edges)
                  + batch.e_rec[:, 0].long()]
    e_w = batch.e_rec[:, 1].view(torch.float32)
    e_id = batch.e_rec[:, 2]
    has_in = torch.zeros(total, dtype=torch.bool, device=dev)
    has_in[sink] = True
    h = torch.zeros(total, dtype=torch.float32, device=dev)
    for _ in range(batch.max_depth):
        cand = h[src] + e_w
        relaxed = torch.full((total,), float("-inf"), device=dev
                             ).scatter_reduce(0, sink, cand, "amax")
        h = torch.where(has_in, relaxed, 0.0)
    hit = h[src] + e_w == h[sink]
    big = torch.iinfo(torch.int32).max
    min_eid = torch.full((total,), big, dtype=torch.int32,
                         device=dev).scatter_reduce(
        0, sink, torch.where(hit, e_id, big), "amin")
    edges_of_node = torch.repeat_interleave(meta[:, 4], meta[:, 1],
                                            output_size=total)
    return h, torch.where(has_in, min_eid, edges_of_node.to(torch.int32))


def _chunks(width: int, lg: int) -> int:
    """The most chunks of 2^lg elements a run of ``width`` may touch."""
    return ((max(width, 1) + (1 << lg) - 2) >> lg) + 1


def stream_fits(batch: PoaBatch, ring=RING) -> bool:
    """Whether the streamed kernel takes the batch: every graph within
    STREAM_NODES nodes, and every node's in-edges within the edge ring's
    chunks (a node's two in-edge bounds always fit two chunks)."""
    lg_slots, _lg_pos, lg_edge = ring
    return (batch.max_nodes <= STREAM_NODES
            and _chunks(batch.max_in_edges, lg_edge) <= 1 << lg_slots)


def poa_heaviest_cuda(batch: PoaBatch, route: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12 on the card (``csrc/poa_heaviest.cu``): one launch on the
    current stream, no synchronisation; the streamed kernel where
    ``stream_fits``, else the device-memory kernel (``route`` forces one,
    to hold the two against each other; "stream" raises where the batch
    does not fit), counted in ``poa_heaviest_cuda.routes``. Raises on bad
    inputs or a refused launch."""
    from . import _build

    _check(batch)
    dev = batch.node_of.device
    if dev.type != "cuda":
        raise ValueError("poa_heaviest_cuda takes CUDA tensors")
    total = batch.node_of.shape[0]
    h = torch.empty(total, dtype=torch.float32, device=dev)
    min_eid = torch.empty(total, dtype=torch.int32, device=dev)
    n_graphs = batch.meta.shape[0]
    if n_graphs == 0:
        return h, min_eid
    fits = stream_fits(batch)
    if route is None:
        route = "stream" if fits else "global"
    elif route not in ROUTES or (route == "stream" and not fits):
        raise ValueError(f"K12 cannot take route {route!r} here")
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if route == "stream":
            arrays = (batch.in_ptr, batch.e_rec, batch.node_of, batch.meta)
            if any(a.data_ptr() % 16 for a in arrays):
                raise ValueError("the streamed kernel takes 16-byte "
                                 "aligned arrays")
            err = lib.otter_poa_heaviest_stream(
                *(data_ptr(a) for a in arrays), n_graphs, batch.max_nodes,
                batch.in_ptr.shape[0], batch.e_rec.shape[0], *RING,
                data_ptr(h), data_ptr(min_eid), stream)
        else:
            # h by position, where a graph is past the kernel's shared
            # memory
            h_pos = (torch.empty_like(h) if batch.max_nodes > SMEM_NODES
                     else h)
            err = lib.otter_poa_heaviest(
                *(data_ptr(a) for a in batch[:5]), n_graphs,
                batch.max_nodes, data_ptr(h_pos), data_ptr(h),
                data_ptr(min_eid), stream)
    _build.check(lib, err, f"poa_heaviest_cuda ({route} route)")
    poa_heaviest_cuda.launches += 1
    poa_heaviest_cuda.routes[route] += 1
    return h, min_eid


poa_heaviest_cuda.launches = 0
poa_heaviest_cuda.routes = dict.fromkeys(ROUTES, 0)


def poa_heaviest(batch: PoaBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    dev = batch.node_of.device
    if dev.type == "cuda":
        return poa_heaviest_cuda(batch)
    if dev.type == "cpu":
        return poa_heaviest_torch(batch)
    raise ValueError(f"no K12 version for device {dev}")


def split_by_graph(batch: PoaBatch, h: np.ndarray,
                   min_eid: np.ndarray) -> List[Tuple[np.ndarray,
                                                      np.ndarray]]:
    """Per graph, its nodes' (h, min_eid), by graph-local node id."""
    meta = to_host(batch.meta)
    return [(h[o : o + n], min_eid[o : o + n]) for o, n, *_r in meta]
