"""Distance backend for the assemble pipeline on PyTorch.

Counterpart of ``DeviceDistBackend`` in ``otter_tpu/kernels/dist_backend.py``:
it holds the engine that the batched pipeline calls (``.engine``). A device
that is not there raises; nothing degrades to another backend.
"""

from __future__ import annotations

from .edit_engine import EditDistanceEngine, MeshEngine


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
