"""Simple per-atom environment similarity (counterpart of
theforce/analysis/simplesim.py): species-resolved RBF over neighbor
distances with PolyCut weights — a cheap structural fingerprint.

A copy of ``autoforce_tpu/analysis/simplesim.py`` (numpy only): the port keeps
its own host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..neighbors import displacements, neighbor_table


class SimpleSim:
    def __init__(self, system, cutoff=5.0, alpha=0.2):
        t = neighbor_table(system.positions, system.cell, system.pbc, cutoff)
        r = displacements(system.positions, system.cell, t)
        d = np.linalg.norm(r, axis=-1)
        self.data = []
        for i in range(len(system)):
            m = t.mask[i]
            self.data.append((system.numbers[t.idx[i][m]], d[i][m]))
        self.numbers = system.numbers
        self.rc = cutoff
        self.alpha = alpha

    def kern(self, i, j):
        z1, d1 = self.data[i]
        z2, d2 = self.data[j]
        value = 0.0
        for s in set(z1) | set(z2):
            a = d1[z1 == s]
            b = d2[z2 == s]
            if a.size == 0 or b.size == 0:
                continue
            f = np.exp(-(((a[:, None] - b[None]) / self.alpha) ** 2))
            c = ((1 - a / self.rc) ** 2)[:, None] * ((1 - b / self.rc) ** 2)[None]
            value += (f * c).sum()
        return value

    def __call__(self, i, j):
        """Normalized similarity in [0, 1]."""
        return self.kern(i, j) / np.sqrt(self.kern(i, i) * self.kern(j, j))
