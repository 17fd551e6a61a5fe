"""The control (the reference one precision lower, in the port's place)
fails the cell's limits; at a small size on the CPU.  On the card:
``python3 -m portbench.control --workload <cell> --seeds 1 2 3``."""

import pytest
import torch

from portbench import control

from ._fixtures import CPU, DATA


@pytest.mark.parametrize("cell", ["md.cu_tiny", "md.lgps4_tiny"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(cell, seed):
    torch.set_num_threads(1)
    nums, correct = control.readings(cell, seed, CPU, workload_dirs=(DATA,),
                                     config_dirs=(DATA,))
    assert correct is False
    assert nums["gram_err"] > 1e-8
