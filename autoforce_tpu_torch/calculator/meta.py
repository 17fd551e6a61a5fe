"""Metadynamics (port of ``autoforce_tpu/calculator/meta.py``: the
counterparts of theforce/calculator/meta.py and of the kernel-space
Meta/ActiveMeta of calculator/active.py:1152-1186).

``Meta`` deposits Gaussians on collective variables (CVs) accumulated in a
sparse-grid KDE; the bias energy and its exact forces come from torch
autograd through the CV functions, in float64 on the calculator's device.
CVs: ``Posvar`` (position), ``Qlvar`` (Steinhardt bond order), ``Catvar``
(concatenation).

``SoapMeta``/``ActiveMeta`` bias directly in kernel space using the
calculator's covariance row block; both evaluate through the engine, so
they launch the SOAP kernels.  ``DeviceMD`` fuses ``ActiveMeta`` into its
step (``md.device_md._sgpr_forces``); the other biases run under the host
drivers, which call ``update`` after each step.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import units
from ..analysis.kde import GaussianKDE
from ..descriptor.ql import steinhardt_ql
from ..engine import device_fetch


class Meta:
    def __init__(self, colvar, sigma=0.1, w=0.01, tem=None, hist="meta.hist"):
        """colvar(numbers, positions, cell, pbc, nl) -> tensor of CVs.
        sigma: Gaussian width; w: height*dt (eV); tem: well-tempered T (K)."""
        self.colvar = colvar
        self.kde = GaussianKDE(sigma)
        self.w = w
        self.tem = tem
        self.hist = hist
        if hist:
            with open(hist, "w") as f:
                f.write(f"# {sigma}\n")
        self._cv = None

    def __call__(self, calc):
        system = calc.system
        dev = calc.engine.device

        def t(a, dtype=torch.float64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        numbers = t(system.numbers, torch.int64)
        cell = t(system.cell)
        if self._cv is not None:
            centers, weights = self.kde.centers_near(self._cv)
        else:
            centers, weights = np.zeros((0, 1)), np.zeros(0)
        sigma = self.kde.sigma
        with torch.enable_grad():
            pos = t(system.positions).requires_grad_(True)
            cv = self.colvar(numbers, pos, cell, system.pbc, calc._nl)
            cv = torch.atleast_1d(cv)
            if len(weights) == 0:
                e = (pos * 0.0).sum()
            else:
                d2 = (((cv[None] - t(centers)) / sigma) ** 2).sum(-1)
                kde = (torch.exp(-0.5 * d2) * t(weights)).sum() / (
                    np.sqrt(2 * np.pi) ** cv.shape[0])
                e = self.w * kde
                if self.tem is not None:
                    gamma = 1.0 / (units.kB * self.tem)
                    e = torch.log(1.0 + e * gamma) / gamma
            (g,) = torch.autograd.grad(e, pos)
        e, g, cv = device_fetch(e, g, cv)
        self._cv = cv
        return {"energy": float(e), "forces": -g}

    def update(self):
        """Deposit the current CV (called by the MD driver each step)."""
        if self._cv is not None:
            self.kde.count(self._cv)
            if self.hist:
                with open(self.hist, "a") as f:
                    f.write(" ".join(f"{float(v)}" for v in self._cv) + "\n")


class Posvar:
    """Relative position of one atom w.r.t. the (selected) centroid
    (meta.py:63-78)."""

    def __init__(self, index, select=None):
        self.index = index
        self.select = select

    def __call__(self, numbers, positions, cell, pbc, nl):
        keep = torch.ones(len(numbers), dtype=torch.bool,
                          device=positions.device)
        keep[self.index] = False
        if self.select is not None:
            keep = keep & (numbers == self.select)
        w = keep.to(positions.dtype)
        centroid = (w[:, None] * positions).sum(0) / w.sum()
        return positions[self.index] - centroid


class Qlvar:
    """Steinhardt Q_l of one atom's environment (meta.py:81-108)."""

    def __init__(self, i, j, index=None, cutoff=4.0, l=(6,)):
        self.i = i
        self.j = j
        self.index = index
        self.cutoff = cutoff
        self.l = list(l)
        self.lmax = max(self.l)

    def __call__(self, numbers, positions, cell, pbc, nl):
        numbers_h = numbers.cpu().numpy()
        if self.index is None:
            self.index = int(np.flatnonzero(numbers_h == self.i)[0])
        i = self.index
        mask = nl.mask[i]
        j = nl.idx[i][mask]
        jj = j[numbers_h[j] == self.j]
        off = torch.as_tensor(nl.off[i][mask][numbers_h[j] == self.j],
                              dtype=positions.dtype, device=positions.device)
        jj = torch.as_tensor(jj, device=positions.device)
        r = positions[jj] - positions[i] + off @ cell
        ql = steinhardt_ql(r, self.lmax, self.cutoff)
        return ql[self.l]


class Catvar:
    def __init__(self, *var):
        self.var = var

    def __call__(self, *args):
        return torch.cat([torch.atleast_1d(v(*args)).reshape(-1)
                          for v in self.var])


class SoapMeta:
    """Kernel-space metadynamics (reference active.py:1152-1167): the bias
    potential lives on the inducing set and grows along the visited
    covariance directions."""

    def __init__(self, scale=1e-2):
        self.scale = scale
        self.pot = None

    def __call__(self, calc):
        model = calc.model
        cov = calc._cov  # (n, m) host
        m = model.m
        if self.pot is None:
            self.pot = np.zeros(m)
        elif len(self.pot) < m:
            self.pot = np.concatenate([self.pot, np.zeros(m - len(self.pot))])
        Mi = model.choli.T @ model.choli
        nu = Mi @ cov.T
        norm = float(np.sqrt((cov @ nu).sum()))
        mu = nu.sum(axis=1) / max(norm, 1e-30)
        self.pot = self.pot + self.scale * mu
        # energy + forces from one engine pass with mu := pot / norm
        ma = model.full_model_arrays()
        mu_bias = np.zeros(ma.mu.shape[0])
        mu_bias[:m] = self.pot / max(norm, 1e-30)
        ma2 = ma._replace(mu=torch.as_tensor(mu_bias, dtype=ma.mu.dtype,
                                             device=ma.mu.device))
        vs = model.vscale_for(calc.cfg.numbers.cpu().numpy())
        e, f, *_ = calc.engine.predict(calc.cfg, ma2, vs)
        e, f = device_fetch(e, f)
        return {"energy": float(e),
                "forces": f[: len(calc.system)].astype(np.float64)}

    def update(self):
        pass


class ActiveMeta:
    """Uncertainty-seeking bias (reference active.py:1170-1186):
    E = -scale * sum_i beta_i sqrt(vscale)."""

    def __init__(self, scale=1e-2):
        self.scale = scale

    def __call__(self, calc):
        from ..engine import meta_covloss_fn

        model = calc.model
        cfg = calc.cfg
        vs = model.vscale_for(cfg.numbers.cpu().numpy())
        e, g = meta_covloss_fn(
            cfg, model.full_model_arrays(), calc.engine.radii_table(),
            torch.as_tensor(vs, dtype=cfg.positions.dtype,
                            device=cfg.positions.device),
            calc.engine.params, calc.engine.exponent, self.scale,
        )
        e, g = device_fetch(e, g)
        return {"energy": float(e),
                "forces": -g[: len(calc.system)].astype(np.float64)}

    def update(self):
        pass
