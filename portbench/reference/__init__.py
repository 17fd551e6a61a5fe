"""The plain reference of the port's benchmark: float64 PyTorch, in blocks.

Everything here is written from the definitions (the SeSoap power
spectrum, the dot-product kernel, a Lennard-Jones mixture, a sparse-GP
fit) and imports nothing of ``autoforce_tpu_torch`` or the JAX package:
it builds the crystals, the models and the labels of a cell from its seed,
and judges what the port produced.
"""
