"""Oracle script: zeros ('Only for quick tests!', theforce/calculator/zero.py)."""
from autoforce_tpu_torch.calculator.oracles import ZeroCalculator


def make_calc(device="cuda"):
    return ZeroCalculator()
