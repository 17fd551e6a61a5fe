"""Velocity Verlet integrator."""

from .base import Dynamics


class VelocityVerlet(Dynamics):
    def step(self):
        s = self.system
        m = self.masses()
        f = self.forces()
        v = s.get_velocities()
        v = v + 0.5 * self.dt * f / m
        s.set_positions(s.positions + self.dt * v)
        f = self.forces()
        v = v + 0.5 * self.dt * f / m
        s.set_velocities(v)
