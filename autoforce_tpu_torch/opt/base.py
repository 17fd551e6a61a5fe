"""Structure-relaxation driver base (role of ASE optimizers in
theforce/cl/relax.py).

A copy of ``autoforce_tpu/opt/base.py`` (numpy only): the port keeps its own
host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np


class Optimizer:
    def __init__(self, target, logfile=None):
        """target: a System or a filter exposing get_positions/set_positions/
        get_forces/get_potential_energy."""
        self.target = target
        self.logfile = logfile
        self.nsteps = 0
        self._observers = []

    def attach(self, fn, interval=1):
        self._observers.append((fn, int(interval)))

    def log(self, fmax, e):
        if self.logfile:
            with open(self.logfile, "a") as f:
                f.write(f"{self.__class__.__name__} step {self.nsteps} "
                        f"E={e:.6f} fmax={fmax:.4f}\n")

    def converged(self, fmax_target):
        f = self.target.get_forces()
        return float(np.sqrt((f * f).sum(axis=1).max())) < fmax_target

    def run(self, fmax=0.05, steps=1000):
        for _ in range(int(steps)):
            f = self.target.get_forces()
            cur = float(np.sqrt((f * f).sum(axis=1).max()))
            self.log(cur, self.target.get_potential_energy())
            for fn, interval in self._observers:
                if self.nsteps % interval == 0:
                    fn()
            if cur < fmax:
                return True
            self.step(f)
            self.nsteps += 1
        return self.converged(fmax)

    def step(self, forces):
        raise NotImplementedError
