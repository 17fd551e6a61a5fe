"""Nose-Hoover-chain thermostat and MTK (Martyna-Tobias-Klein) barostat.

Fills the role of the reference's canonical-ensemble MD drivers
(theforce/cl/md.py:8,82-107, which pairs ase.md.npt.NPT — Nose-Hoover /
Parrinello-Rahman — with a cell ``mask``): unlike Berendsen weak coupling
(md/npt.py), these sample the correct NVT / NPT ensembles, including
canonical temperature fluctuations Var(T)/<T>^2 = 2/dof.

Host-side drivers (like the reference's ASE dynamics); the forces come
from the device predict.  The cell is evolved with a symmetric
strain rate ``vg`` (flexible cell a la Parrinello-Rahman), restricted by
an anisotropy ``mask`` (3-vector for the diagonal or full 3x3);
``isotropic=True`` couples only to the mean pressure.  A general cell is
fine here (our System/neighbor stack has no upper-triangular requirement;
use `autoforce_tpu_torch.utils.make_cell_upper_triangular` for LAMMPS interop).

Integrator: Trotter splitting following Martyna, Tuckerman, Tobias &
Klein (Mol. Phys. 87, 1117 (1996)) with Suzuki-Yoshida NHC sub-cycling.

A copy of ``autoforce_tpu/md/nose_hoover.py`` (numpy only): the port keeps its own
host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from .. import units
from .base import Dynamics

# 3-term Suzuki-Yoshida weights
_W3 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
SY3 = np.array([_W3, 1.0 - 2.0 * _W3, _W3])


class NHChain:
    """Nose-Hoover thermostat chain acting on a kinetic energy with
    ``dof`` degrees of freedom at temperature kT."""

    def __init__(self, kT, dof, tdamp, length=3, nc=2):
        self.kT = float(kT)
        self.dof = float(dof)
        # the half_step recursion needs at least two links (vxi[M-2] with
        # M=1 would wrap around); a single-link "chain" is plain NH, which
        # is not ergodic anyway — clamp up
        self.M = max(2, int(length))
        self.nc = int(nc)
        self._tdamp2 = float(tdamp) ** 2
        self.Q = np.full(self.M, kT * self._tdamp2)
        self.Q[0] *= self.dof
        self.vxi = np.zeros(self.M)
        self.xi = np.zeros(self.M)

    def set_kT(self, kT):
        self.kT = float(kT)
        self.Q = np.full(self.M, self.kT * self._tdamp2)
        self.Q[0] *= self.dof

    def energy(self):
        """Thermostat contribution to the conserved quantity."""
        e = 0.5 * (self.Q * self.vxi**2).sum()
        e += self.dof * self.kT * self.xi[0] + self.kT * self.xi[1:].sum()
        return e

    def half_step(self, KE2, dt):
        """Propagate the chain for dt/2 given twice the coupled kinetic
        energy; returns the velocity scale factor to apply."""
        M, Q, kT = self.M, self.Q, self.kT
        vxi, xi = self.vxi, self.xi
        scale = 1.0
        for _ in range(self.nc):
            for w in SY3:
                # segment length: the 1/4 (chain), 1/8 (coupling), 1/2
                # (scale) coefficients below already realize HALF a
                # segment of chain time wdt, so two half_step calls per
                # MD step propagate the chain for the full dt
                wdt = w * dt / self.nc
                # update chain tail -> head
                vxi[M - 1] += 0.25 * wdt * (
                    (Q[M - 2] * vxi[M - 2] ** 2 - kT) / Q[M - 1]
                )
                for j in range(M - 2, -1, -1):
                    ef = np.exp(-0.125 * wdt * vxi[j + 1])
                    G = (
                        (KE2 - self.dof * kT) / Q[0]
                        if j == 0
                        else (Q[j - 1] * vxi[j - 1] ** 2 - kT) / Q[j]
                    )
                    vxi[j] = (vxi[j] * ef + 0.25 * wdt * G) * ef
                # scale the coupled velocities
                sc = np.exp(-0.5 * wdt * vxi[0])
                scale *= sc
                KE2 *= sc * sc
                xi += 0.5 * wdt * vxi
                # update chain head -> tail
                for j in range(M - 1):
                    ef = np.exp(-0.125 * wdt * vxi[j + 1])
                    G = (
                        (KE2 - self.dof * kT) / Q[0]
                        if j == 0
                        else (Q[j - 1] * vxi[j - 1] ** 2 - kT) / Q[j]
                    )
                    vxi[j] = (vxi[j] * ef + 0.25 * wdt * G) * ef
                vxi[M - 1] += 0.25 * wdt * (
                    (Q[M - 2] * vxi[M - 2] ** 2 - kT) / Q[M - 1]
                )
        return scale


class NoseHooverNVT(Dynamics):
    """NHC-thermostatted velocity Verlet (canonical NVT)."""

    def __init__(self, system, dt, temperature_K, tdamp=None, tchain=3):
        super().__init__(system, dt)
        self.kT = units.kB * float(temperature_K)
        tdamp = float(tdamp) if tdamp else 100.0 * dt
        dof = 3 * len(system)
        self.chain = NHChain(self.kT, dof, tdamp, length=tchain)
        self._f = None

    def set_temperature(self, temperature_K):
        self.kT = units.kB * float(temperature_K)
        self.chain.set_kT(self.kT)

    def conserved(self):
        return (
            self.system.get_potential_energy()
            + self.system.get_kinetic_energy()
            + self.chain.energy()
        )

    def step(self):
        s = self.system
        m = self.masses()
        dt = self.dt
        v = s.get_velocities()
        v = v * self.chain.half_step((m * v * v).sum(), dt)
        f = self._f if self._f is not None else self.forces()
        v = v + 0.5 * dt * f / m
        s.set_positions(s.positions + dt * v)
        f = self.forces()
        v = v + 0.5 * dt * f / m
        v = v * self.chain.half_step((m * v * v).sum(), dt)
        s.set_velocities(v)
        self._f = f


def _expm_sym(A):
    """exp(A) of a symmetric 3x3 via eigendecomposition."""
    w, V = np.linalg.eigh(A)
    return (V * np.exp(w)) @ V.T


def _as_mask(mask):
    if mask is None:
        return np.ones((3, 3))
    mask = np.asarray(mask, dtype=float)
    if mask.shape == (3,):
        return np.diag(mask)
    mask = mask.reshape(3, 3)
    # the strain rate vg must stay symmetric (cell propagation uses a
    # symmetric eigendecomposition): symmetrize a lopsided user mask
    return ((mask + mask.T) > 0).astype(float)


class MTKNPT(Dynamics):
    """Flexible-cell NPT with Nose-Hoover chains on particles and cell
    (Martyna-Tobias-Klein); the canonical-ensemble counterpart of the
    reference's ase.md.npt.NPT driver (theforce/cl/md.py:82-107).

    Args:
        pressure_GPa: external pressure (scalar, GPa).
        mask: which strain components may move — 3-vector (diagonal) or
            3x3 (like the reference's NPT mask); default all.
        isotropic: couple only the mean pressure (cell shape fixed).
        tdamp/pdamp: thermostat/barostat time constants (internal units).
    """

    def __init__(self, system, dt, temperature_K, pressure_GPa=0.0,
                 tdamp=None, pdamp=None, mask=None, isotropic=False,
                 tchain=3, bulk_modulus_GPa=None):
        super().__init__(system, dt)
        self.kT = units.kB * float(temperature_K)
        self.p_ext = float(pressure_GPa) * units.GPa
        tdamp = float(tdamp) if tdamp else 100.0 * dt
        pdamp = float(pdamp) if pdamp else 1000.0 * dt
        self.mask = _as_mask(mask)
        self.isotropic = bool(isotropic)
        n = len(system)
        self.dof = 3 * n
        if bulk_modulus_GPa:
            # ASE-NPT-style inertia (cl/md.py pfactor = ptime^2 * B): cell
            # oscillation period ~ pdamp independent of temperature
            self.W = pdamp**2 * float(bulk_modulus_GPa) * units.GPa * system.volume
        else:
            # MTK canonical choice: W = (dof + 3) kT pdamp^2 / 3
            self.W = (self.dof + 3.0) * self.kT * pdamp**2 / 3.0
        self.chain = NHChain(self.kT, self.dof, tdamp, length=tchain)
        ncell = int(np.count_nonzero(self.mask)) if not self.isotropic else 1
        self.bchain = NHChain(self.kT, max(ncell, 1), pdamp, length=tchain)
        self.vg = np.zeros((3, 3))
        self._f = None

    def set_temperature(self, temperature_K):
        self.kT = units.kB * float(temperature_K)
        self.chain.set_kT(self.kT)
        self.bchain.set_kT(self.kT)

    # ------------------------------------------------------------ internals
    def _pressure_tensor(self, v, m):
        """Full internal pressure tensor (kinetic + virial)."""
        s = self.system
        vol = s.volume
        stress = s.get_stress()  # Voigt, potential part, eV/A^3
        P = -np.array(
            [
                [stress[0], stress[5], stress[4]],
                [stress[5], stress[1], stress[3]],
                [stress[4], stress[3], stress[2]],
            ]
        )
        P = P + (m * v).T @ v / vol
        return P

    def _vg_half(self, v, m, dt):
        vol = self.system.volume
        KE2 = (m * v * v).sum()
        P = self._pressure_tensor(v, m)
        if self.isotropic:
            p = np.trace(P) / 3.0
            G = (3.0 * vol * (p - self.p_ext) + KE2 / self.dof * 3.0) / self.W
            self.vg += 0.5 * dt * (G / 3.0) * np.eye(3)
            self.vg = np.trace(self.vg) / 3.0 * np.eye(3)
        else:
            G = (
                vol * (P - self.p_ext * np.eye(3))
                + KE2 / self.dof * np.eye(3)
            ) / self.W
            G = 0.5 * (G + G.T) * self.mask
            self.vg += 0.5 * dt * G
            self.vg *= self.mask

    def conserved(self):
        s = self.system
        return (
            s.get_potential_energy()
            + s.get_kinetic_energy()
            + self.chain.energy()
            + self.bchain.energy()
            + 0.5 * self.W * (self.vg**2).sum()
            + self.p_ext * s.volume
        )

    def step(self):
        s = self.system
        m = self.masses()
        dt = self.dt
        v = s.get_velocities()

        # thermostats (particles + cell) half-step
        v = v * self.chain.half_step((m * v * v).sum(), dt)
        self.vg = self.vg * self.bchain.half_step(
            self.W * (self.vg**2).sum(), dt
        )
        # barostat velocity half-step
        self._vg_half(v, m, dt)
        # particle velocity half-step with box coupling
        A = self.vg + (np.trace(self.vg) / self.dof) * np.eye(3)
        Em = _expm_sym(-0.5 * dt * A)
        v = v @ Em.T
        f = self._f if self._f is not None else self.forces()
        v = v + 0.5 * dt * f / m

        # position + cell drift (full step)
        E = _expm_sym(dt * self.vg)
        E2 = _expm_sym(0.5 * dt * self.vg)
        pos = s.positions @ E.T + dt * (v @ E2.T)
        # cell rows are lattice vectors: h'_row = h_row @ E^T
        s.set_cell(np.asarray(s.cell) @ E.T)
        s.set_positions(pos)

        # second half
        f = self.forces()
        v = v + 0.5 * dt * f / m
        v = v @ Em.T
        self._vg_half(v, m, dt)
        self.vg = self.vg * self.bchain.half_step(
            self.W * (self.vg**2).sum(), dt
        )
        v = v * self.chain.half_step((m * v * v).sum(), dt)
        s.set_velocities(v)
        self._f = f
