"""Sparse-grid Gaussian kernel density estimate.

A copy of ``autoforce_tpu/analysis/kde.py`` (numpy only), the
counterpart of the reference's Gaussian_kde (theforce/analysis/kde.py):
observations are binned on a sigma-grid inside super-grid blocks so that
evaluation only visits neighboring blocks; used by metadynamics to
accumulate the bias potential.
"""

from __future__ import annotations

import itertools
import math
from collections import Counter

import numpy as np

SQ_2PI = math.sqrt(2.0 * math.pi)


def _discrete(val, sigma):
    return tuple(np.floor(np.asarray(val).reshape(-1) / sigma).astype(int).tolist())


class GaussianKDE:
    def __init__(self, sigma, super_grid=5):
        self.sigma = float(sigma)
        self.super_grid = int(super_grid)
        self.data = {}
        self.total = 0

    def count(self, x):
        block = _discrete(x, self.super_grid * self.sigma)
        if block not in self.data:
            self.data[block] = Counter()
        self.data[block][_discrete(x, self.sigma)] += 1.0
        self.total += 1

    def centers_near(self, x):
        """(points, weights) of all Gaussians near x (neighbor blocks)."""
        block = _discrete(x, self.super_grid * self.sigma)
        pts, ws = [], []
        for nb in itertools.product(*(len(block) * [[-1, 0, 1]])):
            key = tuple(a + b for a, b in zip(block, nb))
            if key in self.data:
                for p, w in self.data[key].items():
                    pts.append(p)
                    ws.append(w)
        if not pts:
            dim = np.asarray(x).reshape(-1).shape[0]
            return np.zeros((0, dim)), np.zeros(0)
        return (np.asarray(pts, dtype=float) + 0.5) * self.sigma, np.asarray(ws)

    def __call__(self, x, density=False):
        X, w = self.centers_near(x)
        xv = np.asarray(x, dtype=float).reshape(-1)
        if len(w):
            d2 = (((xv - X) / self.sigma) ** 2).sum(axis=-1)
            y = (np.exp(-0.5 * d2) * w).sum()
        else:
            y = 0.0
        dim = xv.shape[0]
        if density:
            norm = (SQ_2PI * self.sigma) ** dim * max(self.total, 1)
        else:
            norm = SQ_2PI**dim
        return y / norm

    def histogram(self):
        pts, ws = [], []
        for block in self.data.values():
            for p, w in block.items():
                pts.append(p)
                ws.append(w)
        return (np.asarray(pts, dtype=float) + 0.5) * self.sigma, np.asarray(ws)
