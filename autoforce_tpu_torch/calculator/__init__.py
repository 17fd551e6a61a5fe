from .oracles import LennardJones, ZeroCalculator

__all__ = ["LennardJones", "ZeroCalculator"]
