"""The port's options: its library entry point runs on the card by
default and has no silent way to the CPU."""

import pytest
import torch

from otter_tpu_torch.config import OtterOpts
from otter_tpu_torch.models.assemble import _make_dist_backend


def test_default_device_is_cuda():
    assert OtterOpts().device == "cuda"


def test_default_backend_without_card_raises():
    """Where there is no card, the default options raise the engine's
    RuntimeError; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _make_dist_backend(OtterOpts())


def test_cpu_backend_is_asked_for():
    """The CPU runs the kernels' plain versions only when asked for."""
    p = OtterOpts()
    p.device = "cpu"
    assert _make_dist_backend(p).engine.mode == "torch-cpu"
