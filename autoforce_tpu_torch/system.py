"""Atomic configuration data model (ASE-free).

``System`` plays the role of the reference's ``ase.Atoms`` /
``TorchAtoms`` (reference: theforce/descriptor/atoms.py:262-614) but is a
plain numpy container designed to feed padded torch tensors.  It implements
the calculator protocol (``get_potential_energy`` / ``get_forces`` /
``get_stress``) so MD / relaxation / NEB drivers work with any calculator
that defines ``calculate(system) -> dict``.

A copy of ``autoforce_tpu/system.py``: the port keeps its own host
modules so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from .data import atomic_masses, atomic_numbers, chemical_symbols
from . import units


class System:
    def __init__(
        self,
        numbers=None,
        positions=None,
        cell=None,
        pbc=False,
        symbols=None,
        velocities=None,
        masses=None,
        info=None,
    ):
        if symbols is not None and numbers is None:
            numbers = [atomic_numbers[s] for s in symbols]
        self.numbers = np.asarray(numbers, dtype=np.int32).reshape(-1)
        n = len(self.numbers)
        if positions is None:
            positions = np.zeros((n, 3))
        self.positions = np.array(positions, dtype=np.float64).reshape(n, 3)
        if cell is None:
            cell = np.zeros((3, 3))
        cell = np.asarray(cell, dtype=np.float64)
        if cell.shape == (3,):
            cell = np.diag(cell)
        elif cell.shape == ():
            cell = np.eye(3) * float(cell)
        self.cell = cell.reshape(3, 3)
        if isinstance(pbc, (bool, np.bool_, int)):
            pbc = 3 * [bool(pbc)]
        self.pbc = np.asarray(pbc, dtype=bool).reshape(3)
        self._velocities = (
            np.array(velocities, dtype=np.float64).reshape(n, 3)
            if velocities is not None
            else None
        )
        self._masses = (
            np.array(masses, dtype=np.float64).reshape(n)
            if masses is not None
            else None
        )
        self.info = dict(info) if info else {}
        self.calc = None
        self._calc_cache = None

    # ------------------------------------------------------------------ basic
    def __len__(self):
        return len(self.numbers)

    @property
    def natoms(self):
        return len(self.numbers)

    @property
    def symbols(self):
        return [chemical_symbols[z] for z in self.numbers]

    def get_masses(self):
        if self._masses is not None:
            return self._masses
        return atomic_masses[self.numbers]

    def set_masses(self, masses):
        self._masses = np.array(masses, dtype=np.float64).reshape(len(self))

    def get_velocities(self):
        if self._velocities is None:
            return np.zeros((len(self), 3))
        return self._velocities

    def set_velocities(self, v):
        self._velocities = np.array(v, dtype=np.float64).reshape(len(self), 3)

    @property
    def volume(self):
        v = abs(np.linalg.det(self.cell))
        if v == 0.0:
            raise ValueError("zero cell volume")
        return v

    def get_volume(self):
        return self.volume

    def counts(self):
        """{atomic number: count} (reference: atoms.py `counts`)."""
        z, c = np.unique(self.numbers, return_counts=True)
        return {int(a): int(b) for a, b in zip(z, c)}

    def numbers_set(self):
        return sorted(set(int(z) for z in self.numbers))

    def copy(self):
        s = System(
            numbers=self.numbers.copy(),
            positions=self.positions.copy(),
            cell=self.cell.copy(),
            pbc=self.pbc.copy(),
            info=self.info,
        )
        if self._velocities is not None:
            s._velocities = self._velocities.copy()
        if self._masses is not None:
            s._masses = self._masses.copy()
        return s

    def __add__(self, other):
        s = System(
            numbers=np.concatenate([self.numbers, other.numbers]),
            positions=np.concatenate([self.positions, other.positions]),
            cell=self.cell.copy(),
            pbc=self.pbc.copy(),
        )
        return s

    # ------------------------------------------------------- geometry helpers
    def scaled_positions(self):
        return np.linalg.solve(self.cell.T, self.positions.T).T

    def wrap(self):
        """Wrap atoms into the cell along periodic directions."""
        if not self.pbc.any():
            return
        f = self.scaled_positions()
        for k in range(3):
            if self.pbc[k]:
                f[:, k] %= 1.0
        self.positions = f @ self.cell

    def rattle(self, stdev=0.001, seed=None):
        rng = np.random.default_rng(seed)
        self.positions = self.positions + rng.normal(0.0, stdev, self.positions.shape)

    def repeat(self, reps):
        if isinstance(reps, int):
            reps = (reps, reps, reps)
        r1, r2, r3 = reps
        offsets = np.array(
            [[i, j, k] for i in range(r1) for j in range(r2) for k in range(r3)],
            dtype=np.float64,
        )
        shift = offsets @ self.cell
        pos = (self.positions[None] + shift[:, None]).reshape(-1, 3)
        num = np.tile(self.numbers, len(offsets))
        out = System(
            numbers=num,
            positions=pos,
            cell=self.cell * np.asarray(reps, dtype=np.float64)[:, None],
            pbc=self.pbc.copy(),
        )
        return out

    def spatial_permutation(self, cell_size=5.0):
        """Morton (Z-curve) ordering of atoms by spatial bin.

        Atoms in construction order scatter neighbor-table gathers across
        HBM at scale (a 100k-atom table holds ~23M slots whose row
        indices span the whole position array).  Sorting atoms along a
        Z-curve of ~``cell_size``-sized bins makes neighbor indices
        near-diagonal, so gather rows land in nearby HBM lines.  Returns
        the permutation ``perm`` such that ``positions[perm]`` is
        spatially ordered (stable for ties).
        """
        pos = self.positions
        if abs(np.linalg.det(self.cell)) > 1e-12:
            frac = self.scaled_positions()
            for k in range(3):
                if self.pbc[k]:
                    frac[:, k] %= 1.0
            extent = np.linalg.norm(self.cell, axis=1)
        else:
            lo = pos.min(axis=0)
            extent = np.maximum(pos.max(axis=0) - lo, 1e-9)
            frac = (pos - lo) / extent
        nbin = np.clip((extent / cell_size).astype(int), 1, 1024)
        idx3 = np.clip((frac * nbin).astype(np.int64), 0, nbin - 1)
        code = np.zeros(len(self), dtype=np.int64)
        for bit in range(10):  # 1024 bins/axis max
            for ax in range(3):
                code |= ((idx3[:, ax] >> bit) & 1) << (3 * bit + ax)
        return np.argsort(code, kind="stable")

    def permuted(self, perm):
        """A copy with atoms reordered by ``perm`` (positions, numbers,
        velocities, masses)."""
        perm = np.asarray(perm, dtype=int)
        out = System(
            numbers=self.numbers[perm],
            positions=self.positions[perm],
            cell=self.cell.copy(),
            pbc=self.pbc.copy(),
            velocities=(
                self._velocities[perm] if self._velocities is not None else None
            ),
            masses=self._masses[perm] if self._masses is not None else None,
            info=self.info,
        )
        return out

    def spatially_ordered(self, cell_size=5.0):
        """(ordered copy, perm): see :meth:`spatial_permutation`.  Undo a
        quantity q computed in the new order with ``q[argsort(perm)]``."""
        perm = self.spatial_permutation(cell_size)
        return self.permuted(perm), perm

    # ------------------------------------------------------------ calculator
    def _invalidate(self):
        self._calc_cache = None

    def set_positions(self, positions):
        self.positions = np.array(positions, dtype=np.float64).reshape(len(self), 3)
        self._invalidate()

    def set_cell(self, cell, scale_atoms=False):
        cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
        if scale_atoms:
            f = self.scaled_positions()
            self.cell = cell
            self.positions = f @ cell
        else:
            self.cell = cell
        self._invalidate()

    def get_positions(self):
        return self.positions.copy()

    def get_cell(self):
        return self.cell.copy()

    def _results(self):
        if self.calc is None:
            raise RuntimeError("no calculator attached")
        key = (self.positions.tobytes(), self.cell.tobytes(), self.numbers.tobytes())
        if self._calc_cache is None or self._calc_cache[0] != key:
            res = self.calc.calculate(self)
            self._calc_cache = (key, res)
        return self._calc_cache[1]

    def get_potential_energy(self):
        return float(self._results()["energy"])

    def get_forces(self):
        return np.asarray(self._results()["forces"], dtype=np.float64)

    def get_stress(self):
        """Voigt stress [xx, yy, zz, yz, xz, xy] in eV/Ang^3."""
        return np.asarray(self._results()["stress"], dtype=np.float64)

    # ------------------------------------------------------------- dynamics
    def get_kinetic_energy(self):
        v = self.get_velocities()
        m = self.get_masses()
        return 0.5 * float((m[:, None] * v * v).sum())

    def get_temperature(self):
        """Instantaneous temperature in K (no constraint DOF accounting)."""
        dof = 3 * len(self)
        if dof == 0:
            return 0.0
        return 2 * self.get_kinetic_energy() / (dof * units.kB)

    def get_momenta(self):
        return self.get_masses()[:, None] * self.get_velocities()

    def set_momenta(self, p):
        self.set_velocities(np.asarray(p) / self.get_masses()[:, None])


class SinglePointCalculator:
    """Stores precomputed results (reference: ase SinglePointCalculator)."""

    def __init__(self, system=None, energy=None, forces=None, stress=None, **kw):
        self.results = {}
        if energy is not None:
            self.results["energy"] = float(energy)
        if forces is not None:
            self.results["forces"] = np.asarray(forces, dtype=np.float64)
        if stress is not None:
            self.results["stress"] = np.asarray(stress, dtype=np.float64)
        self.results.update(kw)

    def calculate(self, system):
        return self.results


def bulk_fcc(symbol, a, cubic=True):
    """Minimal fcc crystal builder (conventional cubic cell)."""
    z = atomic_numbers[symbol]
    pos = np.array(
        [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], dtype=np.float64
    ) * a
    return System(numbers=[z] * 4, positions=pos, cell=np.eye(3) * a, pbc=True)


def maxwell_boltzmann_velocities(system, temperature_K, seed=None, zero_momentum=True):
    """Draw velocities from the Maxwell-Boltzmann distribution."""
    rng = np.random.default_rng(seed)
    m = system.get_masses()
    sigma = np.sqrt(units.kB * temperature_K / m)[:, None]
    v = rng.normal(size=(len(system), 3)) * sigma
    if zero_momentum and len(system) > 1:
        p = (m[:, None] * v).sum(axis=0) / m.sum()
        v = v - p[None]
    system.set_velocities(v)
    return v
