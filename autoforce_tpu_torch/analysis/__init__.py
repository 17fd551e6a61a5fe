"""Analysis helpers of the port (numpy copies of the JAX package's)."""

from .kde import GaussianKDE

__all__ = ["GaussianKDE"]
