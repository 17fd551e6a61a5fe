"""Effective-medium-theory (EMT) oracle for fcc metals (torch port of
``autoforce_tpu/calculator/emt.py``).

A many-body test potential for on-the-fly learning without DFT: the
Jacobsen-Stoltze-Norskov EMT functional (Surf. Sci. 366, 394 (1996)) with
the standard published parameter set.  The energy is written in torch
(float64, on ``device``) and forces/stress come from autograd, so the
oracle is exactly consistent.

Model (per atom i, neighbors j; beta = (16 pi/3)^(1/3)/sqrt(2)):

    sigma1_i = sum_j chi_ij exp(-eta2_j (r_ij - beta s0_j)) theta(r_ij)
    sigma2_i = sum_j chi_ij exp(-(kappa_j/beta)(r_ij - beta s0_j)) theta(r_ij)
    s_i  = s0_i - log(sigma1_i / (12 gamma1_i)) / (beta eta2_i)
    E_i  = E0_i (1 + lam_i ds) exp(-lam_i ds)          ds = s_i - s0_i
         + 6 V0_i exp(-kappa_i ds)
         - (V0_i / 2) sigma2_i / gamma2_i

with a Fermi cutoff theta between the 3rd and 4th fcc shells and gamma
factors normalizing the perfect-crystal sums (so bulk fcc at s = s0 gives
exactly E0 per atom).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..neighbors import neighbor_table
from ..units import Bohr

BETA = (16.0 * math.pi / 3.0) ** (1.0 / 3.0) / math.sqrt(2.0)

# E0 (eV), s0 (bohr), V0 (eV), eta2 (1/bohr), kappa (1/bohr),
# lambda (1/bohr), n0 (1/bohr^3) — standard EMT parameter set
PARAMETERS = {
    13: (-3.28, 3.00, 1.493, 1.240, 2.000, 1.169, 0.00700),  # Al
    29: (-3.51, 2.67, 2.476, 1.652, 2.740, 1.906, 0.00910),  # Cu
    47: (-2.96, 3.01, 2.132, 1.652, 2.790, 1.892, 0.00547),  # Ag
    79: (-3.80, 3.00, 2.321, 1.674, 2.873, 2.182, 0.00703),  # Au
    28: (-4.44, 2.60, 3.673, 1.669, 2.757, 1.948, 0.01030),  # Ni
    46: (-3.90, 2.87, 2.773, 1.818, 3.107, 2.155, 0.00688),  # Pd
    78: (-5.85, 2.90, 4.067, 1.812, 3.145, 2.192, 0.00802),  # Pt
}

_KEYS = ("E0", "s0", "V0", "eta2", "kappa", "lam", "n0", "gamma1", "gamma2")


class EMT:
    """EMT oracle computing on ``device`` (the card unless the CPU is asked
    for)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._cache = {}

    def _tables(self, numbers):
        """Per-species parameter vectors in eV/Angstrom units."""
        species = sorted(set(int(z) for z in numbers))
        for z in species:
            if z not in PARAMETERS:
                raise ValueError(f"EMT has no parameters for Z={z}")
        p = np.array([PARAMETERS[z] for z in species])
        E0 = p[:, 0]
        s0 = p[:, 1] * Bohr
        V0 = p[:, 2]
        eta2 = p[:, 3] / Bohr
        kappa = p[:, 4] / Bohr
        lam = p[:, 5] / Bohr
        n0 = p[:, 6] / Bohr**3
        s0max = s0.max()
        # Fermi cutoff between 3rd and 4th fcc shells of the largest species
        r3 = BETA * s0max * math.sqrt(3.0)
        r4 = BETA * s0max * 2.0
        rmid = 0.5 * (r3 + r4)
        acut = math.log(9999.0) / (r4 - rmid)
        rmax = rmid + math.log(9999.0) / acut  # theta < 1e-4 beyond

        def theta_np(r):
            return 1.0 / (1.0 + np.exp(np.clip(acut * (r - rmid), -50, 50)))

        # gamma normalization over the first three perfect-fcc shells
        shells = np.array([12.0, 6.0, 24.0])
        gamma1 = np.zeros(len(species))
        gamma2 = np.zeros(len(species))
        for a in range(len(species)):
            d = BETA * s0[a] * np.sqrt(np.array([1.0, 2.0, 3.0]))
            w = theta_np(d)
            gamma1[a] = (shells * w * np.exp(-eta2[a] * (d - BETA * s0[a]))).sum() / 12.0
            gamma2[a] = (
                shells * w * np.exp(-(kappa[a] / BETA) * (d - BETA * s0[a]))
            ).sum() / 12.0
        vals = dict(E0=E0, s0=s0, V0=V0, eta2=eta2, kappa=kappa, lam=lam,
                    n0=n0, gamma1=gamma1, gamma2=gamma2)
        T = {k: torch.as_tensor(vals[k], dtype=torch.float64, device=self.device)
             for k in _KEYS}
        T.update(idx={z: i for i, z in enumerate(species)}, rmid=rmid,
                 acut=acut, rmax=rmax)
        return T

    def calculate(self, system):
        key = tuple(sorted(set(int(z) for z in system.numbers)))
        if key not in self._cache:
            self._cache[key] = self._tables(system.numbers)
        T = self._cache[key]
        t = neighbor_table(system.positions, system.cell, system.pbc, T["rmax"])
        si = np.array([T["idx"][int(z)] for z in system.numbers], dtype=np.int64)

        def dev(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        f64 = torch.float64
        pos = dev(system.positions, f64).requires_grad_(True)
        eps = torch.zeros((3, 3), dtype=f64, device=self.device,
                          requires_grad=True)
        with torch.enable_grad():
            one = torch.eye(3, dtype=f64, device=self.device) + eps
            e = _emt_energy(pos @ one, dev(system.cell, f64) @ one,
                            dev(t.idx, torch.int64), dev(t.off, f64),
                            dev(t.mask), dev(si), dev(si[t.idx]), T)
            dpos, deps = torch.autograd.grad(e, (pos, eps))
        forces = -dpos.cpu().numpy()
        try:
            vol = system.volume
            w = deps.cpu().numpy()
            w = 0.5 * (w + w.T)
            stress = np.array(
                [w[0, 0], w[1, 1], w[2, 2], w[1, 2], w[0, 2], w[0, 1]]
            ) / vol
        except ValueError:
            stress = np.zeros(6)
        return {"energy": float(e.detach()), "forces": forces, "stress": stress}


def _emt_energy(pos, cell, nbr_idx, nbr_off, nbr_mask, si, nbr_si, T):
    r = pos[nbr_idx] - pos[:, None, :] + nbr_off @ cell
    d = torch.sqrt((r * r).sum(-1) + 1e-30)
    theta = 1.0 / (1.0 + torch.exp(torch.clamp(T["acut"] * (d - T["rmid"]),
                                               -50.0, 50.0)))
    theta = torch.where(nbr_mask, theta, torch.zeros_like(theta))
    s0_j = T["s0"][nbr_si]
    chi = T["n0"][nbr_si] / T["n0"][si][:, None]
    w1 = chi * theta * torch.exp(-T["eta2"][nbr_si] * (d - BETA * s0_j))
    w2 = chi * theta * torch.exp(-(T["kappa"][nbr_si] / BETA) * (d - BETA * s0_j))
    sigma1 = w1.sum(dim=1)
    sigma2 = w2.sum(dim=1)
    g1 = T["gamma1"][si]
    g2 = T["gamma2"][si]
    ds = -torch.log(torch.clamp(sigma1 / (12.0 * g1), min=1e-12)) / (
        BETA * T["eta2"][si]
    )
    lam_ds = T["lam"][si] * ds
    e_c = T["E0"][si] * (1.0 + lam_ds) * torch.exp(-lam_ds)
    e_as = 6.0 * T["V0"][si] * torch.exp(-T["kappa"][si] * ds)
    e_pair = -(T["V0"][si] / 2.0) * sigma2 / g2
    return (e_c - T["E0"][si] + e_as + e_pair).sum()
