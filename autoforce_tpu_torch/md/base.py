"""Common MD driver machinery (ASE-free).

Drivers operate on a :class:`autoforce_tpu_torch.system.System` (or any object
with the same protocol) and support ``attach(fn, interval)`` observers like
the reference's ASE dynamics.
"""

from __future__ import annotations

import numpy as np


class Dynamics:
    def __init__(self, system, dt):
        self.system = system
        self.dt = float(dt)
        self.nsteps = 0
        self._observers = []

    def attach(self, fn, interval=1):
        self._observers.append((fn, int(interval)))

    def call_observers(self):
        for fn, interval in self._observers:
            if self.nsteps % interval == 0:
                fn()

    def run(self, steps):
        if self.nsteps == 0:
            self.call_observers()
        for _ in range(int(steps)):
            self.step()
            self.nsteps += 1
            self.call_observers()
        return True

    def step(self):
        raise NotImplementedError

    # helpers
    def forces(self):
        return self.system.get_forces()

    def masses(self):
        return self.system.get_masses()[:, None]
