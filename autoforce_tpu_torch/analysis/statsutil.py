"""Statistics utilities (counterpart of theforce/analysis/statsutil.py).

A copy of ``autoforce_tpu/analysis/statsutil.py`` (numpy only): the port keeps
its own host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np


def moving_average(x, w, axis=0):
    a = np.cumsum(np.asarray(x, dtype=float), axis=axis)
    a[w:] = a[w:] - a[:-w]
    return a[w - 1:] / w


class OnlineCov:
    """On-the-fly covariance matrix of streamed observations
    (reference Cov_otf)."""

    def __init__(self):
        self.k = 0
        self.s1 = 0.0
        self.s2 = 0.0

    def __call__(self, y):
        y = np.asarray(y, dtype=float).reshape(-1, 1)
        self.k += 1
        self.s1 = self.s1 + y
        self.s2 = self.s2 + y @ y.T

    @property
    def mat(self):
        return self.s2 / self.k - (self.s1 @ self.s1.T) / self.k**2

    @property
    def eig(self):
        w, v = np.linalg.eigh(self.mat)
        return w, v


def block_error(x, nblocks=10):
    """Standard error of the mean via block averaging (correlated series)."""
    x = np.asarray(x, dtype=float)
    n = (len(x) // nblocks) * nblocks
    blocks = x[:n].reshape(nblocks, -1).mean(axis=1)
    return float(blocks.std(ddof=1) / np.sqrt(nblocks))


def autocorrelation(x, maxlag=None):
    x = np.asarray(x, dtype=float)
    x = x - x.mean()
    n = len(x)
    maxlag = maxlag or n // 2
    var = (x * x).mean()
    return np.array(
        [1.0] + [
            (x[:-k] * x[k:]).mean() / var if var > 0 else 0.0
            for k in range(1, maxlag)
        ]
    )
