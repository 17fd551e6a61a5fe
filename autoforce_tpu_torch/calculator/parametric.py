"""Closed-form parametric pair potentials as a calculator (port of
``autoforce_tpu/calculator/parametric.py``).

Counterpart of theforce/calculator/parametric.py: per-species-pair radial
terms built from the Func algebra (LJ, Coulomb, repulsive cores, ...),
served through the calculator protocol with torch-autograd forces and
stress, and fittable to reference data by least squares over the Func
parameters (scipy, with the gradient from autograd).  The tensors live on
``device`` (the card unless the caller asks for the CPU) in float64; no
SOAP kernel is involved.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..descriptor.func import CutFunc, Param, RepulsiveCore
from ..neighbors import neighbor_table


class PairPot:
    """One radial term g(d) applied to species pair (a, b)."""

    def __init__(self, a, b, radial):
        self.a = int(a)
        self.b = int(b)
        self.radial = radial

    def params(self):
        return self.radial.params()


def get_lj_terms(pairs, epsilon=1.0, sigma=1.0, rc=6.0, trainable=True):
    """4 eps ((sig/d)^12 - (sig/d)^6), smoothly cut (parametric.py LJ)."""
    terms = []
    for (a, b) in pairs:
        eps = Param(epsilon, name=f"lj_eps_{a}_{b}") if trainable else epsilon
        s6 = sigma**6
        g = (
            4.0 * eps * (s6 * s6 * RepulsiveCore(12) + (-1.0) * s6 * RepulsiveCore(6))
        ) * CutFunc(rc)
        terms.append(PairPot(a, b, g))
    return terms


def get_coulomb_terms(charges, rc=6.0, trainable=True):
    """q_a q_b / d with smooth cutoff (parametric.py Coulomb)."""
    terms = []
    ke = 14.399645  # e^2/(4 pi eps0) in eV*A
    zs = sorted(charges.keys())
    qparams = {
        z: Param(abs(charges[z]), name=f"q_{z}") if trainable else abs(charges[z])
        for z in zs
    }
    for i, a in enumerate(zs):
        for b in zs[i:]:
            sign = np.sign(charges[a] * charges[b])
            g = (sign * ke) * qparams[a] * qparams[b] * RepulsiveCore(1) * CutFunc(rc)
            terms.append(PairPot(a, b, g))
    return terms


class ParametricCalculator:
    def __init__(self, terms, rc=6.0, device="cuda"):
        self.terms = list(terms)
        self.rc = float(rc)
        self.device = resolve_device(device)
        self.param_values = {}
        for t in self.terms:
            self.param_values.update(t.params())

    def params(self):
        return dict(self.param_values)

    def _energy(self, pos, eps, cell, nbr_idx, nbr_off, masks, params):
        one = torch.eye(3, dtype=pos.dtype, device=pos.device) + eps
        posd = pos @ one
        celld = cell @ one
        r = posd[nbr_idx] - posd[:, None, :] + nbr_off @ celld
        d = torch.sqrt((r * r).sum(-1) + 1e-30)
        e = 0.0
        for t, m in zip(self.terms, masks):
            g = t.radial(d, params)
            e = e + 0.5 * torch.where(m, g, torch.zeros_like(g)).sum()
        return e

    def _prepare(self, system):
        """(positions, cell, neighbor indices, image shifts, one pair mask
        per term) on the device."""
        t = neighbor_table(system.positions, system.cell, system.pbc, self.rc)
        zi = system.numbers[:, None]
        zj = system.numbers[t.idx]

        def dev(a, dtype=torch.float64):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        masks = []
        for term in self.terms:
            m = ((zi == term.a) & (zj == term.b)) | ((zi == term.b) & (zj == term.a))
            masks.append(dev(m & t.mask, torch.bool))
        return (dev(system.positions), dev(system.cell),
                dev(t.idx, torch.int64), dev(t.off), masks)

    def calculate(self, system):
        pos, cell, idx, off, masks = self._prepare(system)
        with torch.enable_grad():
            pos = pos.requires_grad_(True)
            eps = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device,
                              requires_grad=True)
            e = self._energy(pos, eps, cell, idx, off, masks,
                             self.param_values)
            dpos, deps = torch.autograd.grad(e, (pos, eps))
        w = 0.5 * (deps + deps.T)
        e, dpos, w = (x.detach().cpu().numpy() for x in (e, dpos, w))
        try:
            stress = np.array(
                [w[0, 0], w[1, 1], w[2, 2], w[1, 2], w[0, 2], w[0, 1]]
            ) / system.volume
        except ValueError:
            stress = np.zeros(6)
        return {
            "energy": float(e),
            "forces": -dpos,
            "stress": stress,
        }

    def fit(self, data, forces_weight=1.0, steps=200):
        """Least-squares fit of Func parameters to (energy, forces) data."""
        from scipy.optimize import minimize

        names = sorted(self.param_values.keys())
        prepared = []
        for s in data:
            prepared.append(self._prepare(s) + (
                s.get_potential_energy(),
                torch.as_tensor(s.get_forces(), dtype=torch.float64,
                                device=self.device)))
        eps = torch.zeros((3, 3), dtype=torch.float64, device=self.device)

        def obj(x):
            v = torch.as_tensor(x, dtype=torch.float64,
                                device=self.device).requires_grad_(True)
            params = {n: v[i] for i, n in enumerate(names)}
            loss = 0.0
            with torch.enable_grad():
                for pos, cell, idx, off, masks, e_ref, f_ref in prepared:
                    pos = pos.detach().requires_grad_(True)
                    e = self._energy(pos, eps, cell, idx, off, masks, params)
                    (g,) = torch.autograd.grad(e, pos, create_graph=True)
                    loss = loss + (e - e_ref) ** 2
                    loss = loss + forces_weight * ((-g - f_ref) ** 2).sum()
                (grad,) = torch.autograd.grad(loss, v)
            return float(loss.detach()), grad.detach().cpu().numpy()

        x0 = np.array([self.param_values[n] for n in names])
        res = minimize(obj, x0, jac=True, options={"maxiter": steps})
        self.param_values = {n: float(res.x[i]) for i, n in enumerate(names)}
        return res
