"""Distance backend for the assemble pipeline on PyTorch.

Counterpart of ``DeviceDistBackend`` in ``otter_tpu/kernels/dist_backend.py``:
it holds the engine that the batched pipeline calls (``.engine``). A device
that is not there raises; nothing degrades to another backend.
``NativeDistBackend`` holds the host engine of the JAX package's
``DeviceDistBackend("cpu")`` (``mode="native"``).
"""

from __future__ import annotations

from typing import List

from ..ops.consensus import get_dist_anreads
from ..ops.distmat import DistMatrix
from ..seqs.model import AnRead
from .edit_engine import EditDistanceEngine, MeshEngine, NativeEngine


class TorchDistBackend:
    """Batched exact edit distances on ``device`` ("cuda" or "cpu"), or
    over a mesh: ``device="mesh"`` takes the visible cards
    (``parallel/mesh.py::make_mesh``, capped by ``OTTER_TPU_MESH_DEVICES``;
    raises without a card), and ``mesh=`` takes the devices given, such as
    a CPU mesh ``(cpu,) * N`` or one card in two shards."""

    def __init__(self, device="cuda", mesh=None):
        if mesh is None and device == "mesh":
            from ..parallel.mesh import make_mesh

            mesh = make_mesh()
        self.engine = (MeshEngine(mesh) if mesh is not None
                       else EditDistanceEngine(device))

    def fill_matrix(self, ignore_haps: bool, reads: List[AnRead],
                    indeces: List[int], distmatrix: DistMatrix) -> None:
        """``ops.consensus.fill_dist_matrix`` for the reads ``indeces``,
        batched: without ``ignore_haps`` the haplotag shortcut's host loop;
        with it one engine call for every pair, each exact distance
        divided on the host in float64 by the longer side."""
        n = len(indeces)
        if not ignore_haps:
            for i in range(n):
                for j in range(i + 1, n):
                    distmatrix.set_dist(i, j, get_dist_anreads(
                        False, reads[indeces[i]], reads[indeces[j]]))
            return
        coords = [(i, j) for i in range(n) for j in range(i + 1, n)]
        if not coords:
            return
        pairs = [(reads[indeces[i]].seq, reads[indeces[j]].seq)
                 for i, j in coords]
        dists = self.engine.distances(pairs)
        for (i, j), d, (x, y) in zip(coords, dists, pairs):
            distmatrix.set_dist(i, j, d / float(max(len(x), len(y))))

    def pair_dist_fn(self, reads: List[AnRead]):
        """The per-pair distance of the reassignment's host fallback
        (``fill_dist_matrix``'s ``pair_dist_fn``): ``get_dist_anreads``
        with the haplotags ignored; the batched matrix is ``fill_matrix``."""
        return lambda a, b: get_dist_anreads(True, a, b)


class NativeDistBackend:
    """Exact distances on the host (``edit_engine.NativeEngine``: threaded
    native C++ distances, the host ends-free DP, the native affine ladder):
    ``assemble(..., dist_backend=NativeDistBackend())`` is the JAX
    package's native-CPU engine, the refscale bench leg's baseline."""

    def __init__(self):
        self.engine = NativeEngine()
