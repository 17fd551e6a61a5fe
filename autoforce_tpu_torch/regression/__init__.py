"""Sparse-GP regression (serving subset)."""
