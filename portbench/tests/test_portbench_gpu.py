"""On the card: a tiny cell through the whole harness.  Skips without a
CUDA card; on the chip: ``python -m pytest portbench/tests -m gpu -o
addopts="" -q``."""

import pytest
import torch

from portbench import harness

from ._fixtures import DATA


@pytest.mark.gpu
def test_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res, _ = harness.run_cell("md.cu_tiny", 7, 0.5, True, device="cuda",
                              workload_dirs=(DATA,), config_dirs=(DATA,))
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0
    assert "launches_per_step" in res["metrics"]
