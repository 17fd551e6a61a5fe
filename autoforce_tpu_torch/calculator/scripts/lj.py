"""Oracle script: Lennard-Jones (numpy, on the host whatever ``device``)."""
from autoforce_tpu_torch.calculator.oracles import LennardJones


def make_calc(device="cuda"):
    return LennardJones()
