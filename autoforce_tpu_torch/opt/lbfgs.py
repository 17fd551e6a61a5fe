"""Limited-memory BFGS optimizer (two-loop recursion, damped step).

A copy of ``autoforce_tpu/opt/lbfgs.py`` (numpy only): the port keeps its own
host modules so that it never imports the JAX package.
"""

import numpy as np

from .base import Optimizer


class LBFGS(Optimizer):
    def __init__(self, target, maxstep=0.2, memory=25, damping=1.0,
                 alpha=70.0, logfile=None):
        super().__init__(target, logfile)
        self.maxstep = maxstep
        self.memory = memory
        self.damping = damping
        self.H0 = 1.0 / alpha
        self.s = []
        self.y = []
        self.rho = []
        self._r0 = None
        self._f0 = None

    def step(self, forces):
        r = self.target.get_positions().reshape(-1)
        f = forces.reshape(-1)
        if self._r0 is not None:
            s0 = r - self._r0
            y0 = self._f0 - f
            ys = float(y0 @ s0)
            if ys > 1e-10:
                self.s.append(s0)
                self.y.append(y0)
                self.rho.append(1.0 / ys)
                if len(self.s) > self.memory:
                    self.s.pop(0)
                    self.y.pop(0)
                    self.rho.pop(0)
        q = -f.copy()
        alphas = []
        for s0, y0, rho in zip(reversed(self.s), reversed(self.y),
                               reversed(self.rho)):
            a = rho * (s0 @ q)
            alphas.append(a)
            q -= a * y0
        z = self.H0 * q
        for (s0, y0, rho), a in zip(
            zip(self.s, self.y, self.rho), reversed(alphas)
        ):
            b = rho * (y0 @ z)
            z += s0 * (a - b)
        dr = (-z).reshape(-1, 3) * self.damping
        norm = np.sqrt((dr * dr).sum(axis=1).max())
        if norm > self.maxstep:
            dr = dr * (self.maxstep / norm)
        self._r0 = r
        self._f0 = f
        self.target.set_positions(r.reshape(-1, 3) + dr)
