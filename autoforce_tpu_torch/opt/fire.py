"""FIRE optimizer (Bitzek et al., PRL 97, 170201 (2006)).

A copy of ``autoforce_tpu/opt/fire.py`` (numpy only): the port keeps its own
host modules so that it never imports the JAX package.
"""

import numpy as np

from .base import Optimizer


class FIRE(Optimizer):
    def __init__(self, target, dt=0.1, maxstep=0.2, dtmax=1.0, nmin=5,
                 finc=1.1, fdec=0.5, astart=0.1, fa=0.99, logfile=None):
        super().__init__(target, logfile)
        self.dt = dt
        self.maxstep = maxstep
        self.dtmax = dtmax
        self.nmin = nmin
        self.finc = finc
        self.fdec = fdec
        self.astart = astart
        self.fa = fa
        self.a = astart
        self.v = None
        self.n_uphill = 0

    def step(self, f):
        if self.v is None:
            self.v = np.zeros_like(f)
        vf = float((f * self.v).sum())
        if vf > 0:
            fn = np.linalg.norm(f)
            vn = np.linalg.norm(self.v)
            self.v = (1.0 - self.a) * self.v + self.a * (f / (fn + 1e-30)) * vn
            if self.n_uphill > self.nmin:
                self.dt = min(self.dt * self.finc, self.dtmax)
                self.a *= self.fa
            self.n_uphill += 1
        else:
            self.v[:] = 0.0
            self.a = self.astart
            self.dt *= self.fdec
            self.n_uphill = 0
        self.v = self.v + self.dt * f
        dr = self.dt * self.v
        norm = np.sqrt((dr * dr).sum(axis=1).max())
        if norm > self.maxstep:
            dr = dr * (self.maxstep / norm)
        self.target.set_positions(self.target.get_positions() + dr)
