"""Model folders and conversion from the JAX package's arrays."""
