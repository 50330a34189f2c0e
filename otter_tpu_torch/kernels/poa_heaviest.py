"""Kernel K12: the heaviest-path DP of a batch of POA graphs.

Counterpart of ``_heaviest_step`` in ``otter_tpu/ops/poa_device.py`` (jnp,
not Pallas). Per node: h = 0 without in-edges, else the largest float32
``h[src] + w`` over its in-edges; min_eid = the least edge id (edges
numbered by ascending source, then out-list position) whose candidate
equals h, or the graph's edge count without in-edges.

The batch is packed on the host (``pack_graphs``) in the kernel's layout:
every graph's nodes in Kahn-level order, their in-edges by node in
ascending edge id, all graphs' nodes numbered globally. ``poa_heaviest_cuda``
launches the hand-written kernel (``csrc/poa_heaviest.cu``; a warp a graph,
level by level), ``poa_heaviest_torch`` is the plain PyTorch version (the
JAX function's Jacobi sweeps over every edge, then its tie pass), and
``poa_heaviest`` picks one by device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .myers_pallas import data_ptr


class PoaBatch(NamedTuple):
    """A packed batch (see the module note); ``max_nodes`` is the most
    nodes of one graph and ``max_depth`` the most levels less one."""

    node_of: torch.Tensor  # (N,) int32 global node ids in level order
    lvl_ptr: torch.Tensor  # per graph, its levels + 1 position bounds
    in_ptr: torch.Tensor   # (N + 1,) int32 in-edge bounds of each position
    e_src: torch.Tensor    # (E,) int32 global source node ids
    e_w: torch.Tensor      # (E,) float32 weights
    e_id: torch.Tensor     # (E,) int32 graph-local edge ids
    meta: torch.Tensor     # (B, 5) int32 node offset, nodes, level offset,
    #                        levels, edges
    max_nodes: int
    max_depth: int

    def to(self, device) -> "PoaBatch":
        return self._replace(**{f: getattr(self, f).to(device)
                                for f in self._fields[:7]})


def pack_graphs(graphs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray]]) -> PoaBatch:
    """Pack graphs given as (src, sink, w, depth) (edges in id order, depth
    each node's Kahn level) into a CPU ``PoaBatch``."""
    node_of, lvl_ptr, in_cnt, e_src, e_w, e_id, meta = ([] for _ in range(7))
    node_off = edge_off = lvl_off = 0
    max_nodes = max_depth = 0
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
        in_cnt.append(np.bincount(sink_pos, minlength=n))
        e_src.append(src[eorder] + node_off)
        e_w.append(w[eorder])
        e_id.append(eorder)
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
        i32(e_src),
        torch.from_numpy(np.concatenate(e_w).astype(np.float32) if e_w
                         else np.zeros(0, dtype=np.float32)),
        i32(e_id),
        torch.from_numpy(np.asarray(meta, dtype=np.int32).reshape(-1, 5)),
        max_nodes, max_depth)


def _check(batch: PoaBatch) -> None:
    for f in ("node_of", "lvl_ptr", "in_ptr", "e_src", "e_id", "meta"):
        if getattr(batch, f).dtype != torch.int32:
            raise ValueError(f"{f} must be int32")
    if batch.e_w.dtype != torch.float32:
        raise ValueError("e_w must be float32")
    devs = {getattr(batch, f).device for f in batch._fields[:7]}
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
    counts = (batch.in_ptr[1:] - batch.in_ptr[:-1]).long()
    sink = batch.node_of.long()[torch.repeat_interleave(
        torch.arange(total, device=dev), counts)]
    src = batch.e_src.long()
    has_in = torch.zeros(total, dtype=torch.bool, device=dev)
    has_in[sink] = True
    h = torch.zeros(total, dtype=torch.float32, device=dev)
    for _ in range(batch.max_depth):
        cand = h[src] + batch.e_w
        relaxed = torch.full((total,), float("-inf"), device=dev
                             ).scatter_reduce(0, sink, cand, "amax")
        h = torch.where(has_in, relaxed, 0.0)
    hit = h[src] + batch.e_w == h[sink]
    big = torch.iinfo(torch.int32).max
    min_eid = torch.full((total,), big, dtype=torch.int32,
                         device=dev).scatter_reduce(
        0, sink, torch.where(hit, batch.e_id, big), "amin")
    meta = batch.meta.long()
    edges_of_node = torch.repeat_interleave(meta[:, 4], meta[:, 1],
                                            output_size=total)
    return h, torch.where(has_in, min_eid, edges_of_node.to(torch.int32))


def poa_heaviest_cuda(batch: PoaBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12 on the card (``csrc/poa_heaviest.cu``): one launch on the
    current stream, a warp a graph, no synchronisation. Raises on bad
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
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.otter_poa_heaviest(
            data_ptr(batch.node_of), data_ptr(batch.lvl_ptr),
            data_ptr(batch.in_ptr), data_ptr(batch.e_src),
            data_ptr(batch.e_w), data_ptr(batch.e_id), data_ptr(batch.meta),
            n_graphs, batch.max_nodes, data_ptr(h), data_ptr(min_eid),
            stream)
    _build.check(lib, err, "poa_heaviest_cuda")
    poa_heaviest_cuda.launches += 1
    return h, min_eid


poa_heaviest_cuda.launches = 0


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
    meta = batch.meta.cpu().numpy()
    return [(h[o : o + n], min_eid[o : o + n]) for o, n, *_r in meta]
