"""Berendsen thermostat / barostat drivers.

Fill the role of the reference's NPT driver (theforce/cl/md.py:81-107,
which uses ase.md.npt.NPT): constant-temperature and constant-pressure
MLMD.  Berendsen weak coupling is used for robustness; the cell is
rescaled isotropically (or per-axis) from the trace of the stress.

A copy of ``autoforce_tpu/md/npt.py`` (numpy only): the port keeps its own
host modules so that it never imports the JAX package.
"""

import numpy as np

from .. import units
from .base import Dynamics


class BerendsenNVT(Dynamics):
    def __init__(self, system, dt, temperature_K, taut=None):
        super().__init__(system, dt)
        self.temperature_K = float(temperature_K)
        self.taut = float(taut) if taut else 100.0 * dt

    def step(self):
        s = self.system
        m = self.masses()
        f = self.forces()
        v = s.get_velocities()
        # Berendsen velocity scaling
        T = s.get_temperature()
        if T > 1e-12:
            lam = np.sqrt(
                1.0 + (self.dt / self.taut) * (self.temperature_K / T - 1.0)
            )
            lam = np.clip(lam, 0.9, 1.1)
            v = v * lam
        v = v + 0.5 * self.dt * f / m
        s.set_positions(s.positions + self.dt * v)
        f = self.forces()
        v = v + 0.5 * self.dt * f / m
        s.set_velocities(v)


class BerendsenNPT(BerendsenNVT):
    def __init__(
        self,
        system,
        dt,
        temperature_K,
        pressure_GPa=0.0,
        taut=None,
        taup=None,
        compressibility=4.57e-5,  # in 1/bar (ASE NPTBerendsen convention);
        # water's value — pass ~1/(B[GPa] * 1e4) for a solid of bulk
        # modulus B.  Converted to internal 1/(eV/A^3) below: the barostat
        # strength is beta * (dt/taup) * (P - P0) with P in eV/A^3.
        isotropic=True,
    ):
        super().__init__(system, dt, temperature_K, taut)
        self.pressure = float(pressure_GPa) * units.GPa
        self.taup = float(taup) if taup else 1000.0 * dt
        self.compressibility = float(compressibility) / units.bar
        self.isotropic = isotropic

    def step(self):
        super().step()
        s = self.system
        stress = s.get_stress()
        p = -(stress[0] + stress[1] + stress[2]) / 3.0
        scale = (
            1.0 - self.compressibility * (self.dt / self.taup) * (self.pressure - p)
        ) ** (1.0 / 3.0)
        scale = float(np.clip(scale, 0.98, 1.02))
        s.set_cell(s.cell * scale, scale_atoms=True)
