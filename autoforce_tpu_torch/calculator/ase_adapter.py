"""Optional ASE interoperability (gated on ase being installed).

The framework is ASE-free, but real ASE users can plug the learned
potential into ASE dynamics: ``AseCalculatorAdapter`` wraps any of our
calculators as an ``ase.calculators.calculator.Calculator``; conversion
helpers map ase.Atoms <-> System.

A copy of ``autoforce_tpu/calculator/ase_adapter.py`` (numpy only): the port keeps
its own host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..system import System

try:
    import ase
    from ase.calculators.calculator import Calculator, all_changes

    HAVE_ASE = True
except ImportError:  # pragma: no cover - ase is optional
    HAVE_ASE = False
    Calculator = object
    all_changes = None


def system_from_ase(atoms) -> System:
    s = System(
        numbers=atoms.numbers,
        positions=atoms.positions,
        cell=np.asarray(atoms.cell),
        pbc=atoms.pbc,
    )
    try:
        s.set_velocities(atoms.get_velocities())
    except Exception:
        pass
    return s


def system_to_ase(system):
    if not HAVE_ASE:
        raise ImportError("ase is not installed")
    atoms = ase.Atoms(
        numbers=system.numbers,
        positions=system.positions,
        cell=system.cell,
        pbc=system.pbc,
    )
    return atoms


def host_results(res):
    """A calculator's results as ASE reads them: device tensors become
    host numpy arrays, 0-d ones floats."""
    import torch

    out = {}
    for k, v in res.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
            v = float(v) if v.ndim == 0 else v
        out[k] = v
    return out


class AseCalculatorAdapter(Calculator):
    """Wraps a calculator of the port for use with ASE dynamics; the
    results reach ASE as host arrays (:func:`host_results`)."""

    implemented_properties = ["energy", "forces", "stress", "free_energy"]

    def __init__(self, calc, **kwargs):
        if not HAVE_ASE:
            raise ImportError("ase is not installed")
        Calculator.__init__(self, **kwargs)
        self._calc = calc

    def calculate(self, atoms=None, properties=("energy",),
                  system_changes=all_changes):
        Calculator.calculate(self, atoms, properties, system_changes)
        res = host_results(self._calc.calculate(system_from_ase(self.atoms)))
        self.results.update(res)
        self.results["free_energy"] = res["energy"]
