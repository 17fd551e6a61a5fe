"""Oracle script: EMT (role of theforce/calculator/emt.py), computing on
``device``."""
from autoforce_tpu_torch.calculator.emt import EMT


def make_calc(device="cuda"):
    return EMT(device=device)
