from .bcm import BCMActiveCalculator
from .multitask import MultiTaskCalculator
from .oracles import LennardJones, ZeroCalculator

__all__ = ["BCMActiveCalculator", "LennardJones", "MultiTaskCalculator",
           "ZeroCalculator"]
