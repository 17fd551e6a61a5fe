from .bcm import BCMActiveCalculator
from .oracles import LennardJones, ZeroCalculator

__all__ = ["BCMActiveCalculator", "LennardJones", "ZeroCalculator"]
