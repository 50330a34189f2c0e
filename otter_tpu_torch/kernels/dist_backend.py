"""Distance backend for the assemble pipeline on PyTorch.

Counterpart of ``DeviceDistBackend`` in ``otter_tpu/kernels/dist_backend.py``:
it holds the engine that the batched pipeline calls (``.engine``). A device
that is not there raises; nothing degrades to another backend.
"""

from __future__ import annotations

from .edit_engine import EditDistanceEngine


class TorchDistBackend:
    """Batched exact edit distances on ``device`` ("cuda" or "cpu")."""

    def __init__(self, device="cuda"):
        self.engine = EditDistanceEngine(device)
