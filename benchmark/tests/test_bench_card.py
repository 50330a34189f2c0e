"""The harness end to end on the card, at the small sizes."""

import pytest

from benchmark.harness import run_cell

from conftest import TINY


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(TINY))
def test_small_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    r = run_cell(workload, 11, 0.5, True, "cuda", overrides=TINY[workload])
    assert r["correct"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert "device_idle_pct" in r["metrics"]
