"""Crystal-symmetry helpers (counterpart of theforce/analysis/symmetry.py).

Gated on spglib, an optional dependency imported at first use; raises
ImportError when it is missing.

A copy of ``autoforce_tpu/analysis/symmetry.py`` (numpy only): the port keeps
its own host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np


def _spglib():
    try:
        import spglib
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "symmetry analysis requires spglib (not installed)"
        ) from e
    return spglib


def get_spacegroup(system, symprec=1e-5):
    spglib = _spglib()
    cell = (system.cell, system.scaled_positions(), system.numbers)
    return spglib.get_spacegroup(cell, symprec=symprec)


def standardize(system, symprec=1e-5, to_primitive=False):
    spglib = _spglib()
    cell = (system.cell, system.scaled_positions(), system.numbers)
    lattice, scaled, numbers = spglib.standardize_cell(
        cell, to_primitive=to_primitive, symprec=symprec
    )
    from ..system import System

    return System(numbers=numbers, positions=scaled @ lattice, cell=lattice,
                  pbc=True)
