"""Analysis helpers of the port (numpy copies of the JAX package's)."""

from .kde import GaussianKDE
from .rdf import rdf
from .trajectory import TrajAnalyser

__all__ = ["GaussianKDE", "rdf", "TrajAnalyser"]
