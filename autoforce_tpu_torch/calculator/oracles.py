"""Cheap 'ab initio' oracle calculators for tests and examples.

A copy of ``autoforce_tpu/calculator/oracles.py`` (numpy only).

Counterparts of the reference's fake/cheap backends used to exercise the
active-learning machinery without DFT (theforce/calculator/zero.py,
theforce/calculator/emt.py): a Lennard-Jones potential and a zero
calculator.  An EMT implementation lives in emt.py.
"""

from __future__ import annotations

import numpy as np

from ..neighbors import displacements, neighbor_table


class ZeroCalculator:
    """Returns zeros; 'Only for quick tests!' (reference zero.py:5-24)."""

    def calculate(self, system):
        n = len(system)
        return {
            "energy": 0.0,
            "forces": np.zeros((n, 3)),
            "stress": np.zeros(6),
        }


class LennardJones:
    """Pairwise 12-6 potential with energy-shifted cutoff."""

    def __init__(self, epsilon=1.0, sigma=1.0, rc=None):
        self.epsilon = float(epsilon)
        self.sigma = float(sigma)
        self.rc = float(rc) if rc is not None else 3.0 * self.sigma
        s6 = (self.sigma / self.rc) ** 6
        self.shift = 4.0 * self.epsilon * (s6 * s6 - s6)

    def calculate(self, system):
        n = len(system)
        t = neighbor_table(system.positions, system.cell, system.pbc, self.rc)
        r = displacements(system.positions, system.cell, t)  # (n, k, 3)
        d = np.linalg.norm(r, axis=-1)
        d = np.where(t.mask, d, 1.0)
        s6 = (self.sigma / d) ** 6
        phi = 4.0 * self.epsilon * (s6 * s6 - s6) - self.shift
        dphi = 4.0 * self.epsilon * (-12.0 * s6 * s6 + 6.0 * s6) / d  # dphi/dd
        phi = np.where(t.mask, phi, 0.0)
        dphi = np.where(t.mask, dphi, 0.0)
        energy = 0.5 * phi.sum()
        rhat = r / d[..., None]
        forces = (dphi[..., None] * rhat).sum(axis=1)
        vir = 0.5 * np.einsum("nk,nka,nkb->ab", dphi / d, r, r)
        try:
            volume = system.volume
            stress = vir[[0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]] / volume
        except ValueError:
            stress = np.zeros(6)
        return {"energy": energy, "forces": forces, "stress": stress}


class MixtureLennardJones:
    """Per-pair 12-6 LJ with a smooth ``(1 - d/rc)^2`` cutoff factor —
    the multi-species oracle for on-the-fly learning tests/benchmarks
    (the role theforce's cheap calculators play for its multi-species
    examples, e.g. pair.py / the LGPS-like flagship workloads).

    ``eps``/``sig`` map species pairs ``(a, b)`` to parameters; missing
    pairs are auto-filled by Lorentz-Berthelot mixing from the diagonal
    entries (sigma arithmetic / epsilon geometric mean).  Energies are
    smooth at rc, so forces are exact gradients (NVE-safe)."""

    def __init__(self, eps, sig, rc=4.5):
        self.rc = float(rc)
        self.eps = dict(eps)
        self.sig = dict(sig)
        species = sorted({z for pair in self.eps for z in pair})
        for i, a in enumerate(species):
            for b in species[i:]:
                if (a, b) in self.eps or (b, a) in self.eps:
                    continue
                ea, eb = self.eps[(a, a)], self.eps[(b, b)]
                sa, sb = self.sig[(a, a)], self.sig[(b, b)]
                self.eps[(a, b)] = float(np.sqrt(ea * eb))
                self.sig[(a, b)] = 0.5 * (sa + sb)

    def calculate(self, system):
        t = neighbor_table(system.positions, system.cell, system.pbc, self.rc)
        r = displacements(system.positions, system.cell, t)
        d = np.where(t.mask, np.linalg.norm(r, axis=-1), 1.0)
        zi = system.numbers[:, None] * np.ones_like(t.idx)
        zj = system.numbers[t.idx]
        eps = np.zeros_like(d)
        sig = np.ones_like(d)
        for (a, b), e in self.eps.items():
            m = ((zi == a) & (zj == b)) | ((zi == b) & (zj == a))
            eps = np.where(m, e, eps)
            sig = np.where(m, self.sig[(a, b)], sig)
        s6 = (sig / d) ** 6
        cutv = (1 - d / self.rc) ** 2
        phi = 4 * eps * (s6 * s6 - s6) * np.where(d < self.rc, cutv, 0.0)
        dphi_dd = (
            4 * eps * (-12 * s6 * s6 + 6 * s6) / d
            * np.where(d < self.rc, cutv, 0)
            + 4 * eps * (s6 * s6 - s6)
            * np.where(d < self.rc, -2 * (1 - d / self.rc) / self.rc, 0.0)
        )
        phi = np.where(t.mask, phi, 0.0)
        dphi_dd = np.where(t.mask, dphi_dd, 0.0)
        energy = 0.5 * phi.sum()
        rhat = r / d[..., None]
        forces = (dphi_dd[..., None] * rhat).sum(axis=1)
        vir = 0.5 * np.einsum("nk,nka,nkb->ab", dphi_dd / d, r, r)
        try:
            volume = system.volume
            stress = vir[[0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]] / volume
        except ValueError:
            stress = np.zeros(6)
        return {"energy": energy, "forces": forces, "stress": stress}
