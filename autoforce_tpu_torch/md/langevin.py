"""Langevin thermostat (BAOAB splitting, Leimkuhler-Matthews).

Role of the reference's ASE ``Langevin`` driver in MLMD runs
(theforce/cl/md.py:81-107).  friction in 1/time (internal units; e.g.
0.01/units.fs).
"""

import numpy as np

from .. import units
from .base import Dynamics


class Langevin(Dynamics):
    def __init__(self, system, dt, temperature_K, friction=0.01, seed=None):
        super().__init__(system, dt)
        self.kT = units.kB * float(temperature_K)
        self.friction = float(friction)
        self.rng = np.random.default_rng(seed)

    def set_temperature(self, temperature_K):
        self.kT = units.kB * float(temperature_K)

    def step(self):
        s = self.system
        m = self.masses()
        dt = self.dt
        c1 = np.exp(-self.friction * dt)
        c2 = np.sqrt(self.kT * (1.0 - c1 * c1) / m)
        v = s.get_velocities()
        v = v + 0.5 * dt * self.forces() / m  # B
        s.set_positions(s.positions + 0.5 * dt * v)  # A
        v = c1 * v + c2 * self.rng.standard_normal(v.shape)  # O
        s.set_positions(s.positions + 0.5 * dt * v)  # A
        v = v + 0.5 * dt * self.forces() / m  # B
        s.set_velocities(v)
