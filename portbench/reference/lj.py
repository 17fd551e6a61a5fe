"""Per-pair 12-6 Lennard-Jones with a smooth cutoff: the labels a
configuration's model is fitted to.

    phi(d) = 4 eps_ab ((sig_ab / d)^12 - (sig_ab / d)^6) (1 - d/rc)^2,  d < rc

Pairs missing from the configuration's tables take Lorentz-Berthelot
mixing (sigma arithmetic, epsilon geometric mean of the diagonal).
"""

from __future__ import annotations

import math

import torch

from . import neighbors

KB_EV = 1.380649e-23 / 1.602176634e-19  # eV/K
# one femtosecond in the time unit of eV, Angstrom and amu
FS = 1e-5 / math.sqrt(1.66053906660e-27 / 1.602176634e-19)


def tables(lj, species, device):
    """(eps, sig) as (S, S) tensors over the species table."""
    eps = {tuple(int(z) for z in k.split("-")): float(v) for k, v in lj["eps"].items()}
    sig = {tuple(int(z) for z in k.split("-")): float(v) for k, v in lj["sig"].items()}
    S = len(species)
    E = torch.zeros((S, S), dtype=torch.float64)
    G = torch.zeros((S, S), dtype=torch.float64)
    for a, za in enumerate(species):
        for b, zb in enumerate(species):
            key = (za, zb) if (za, zb) in eps else (zb, za)
            if key in eps:
                E[a, b], G[a, b] = eps[key], sig[key]
            else:
                E[a, b] = math.sqrt(eps[(za, za)] * eps[(zb, zb)])
                G[a, b] = 0.5 * (sig[(za, za)] + sig[(zb, zb)])
    return E.to(device), G.to(device)


def image_shifts(cell, rc):
    """Integer image shifts (S, 3) that reach every pair closer than rc."""
    reach = [int(math.ceil(rc / float(w))) for w in neighbors.widths(cell)]
    rng = [torch.arange(-k, k + 1, device=cell.device) for k in reach]
    return torch.stack(torch.meshgrid(*rng, indexing="ij"), -1).reshape(-1, 3)


def energies(pos, cell, sidx, tabs, rc, shifts):
    """Energies (R,) of R copies ``pos`` (R, n, 3) of one small cell, every
    pair over every image in ``shifts`` (dense: no host synchronisation)."""
    eps, sig = tabs
    n = pos.shape[1]
    img = pos[:, None] + (shifts.to(pos.dtype) @ cell)[None, :, None, :]
    r = img[:, None] - pos[:, :, None, None, :]  # (R, i, shift, j, 3)
    d2 = (r * r).sum(-1)
    zero = (shifts == 0).all(-1)
    same = torch.eye(n, dtype=torch.bool, device=pos.device)
    inside = (d2 < rc * rc) & ~(zero[None, :, None] & same[:, None, :])[None]
    d = torch.sqrt(torch.where(inside, d2, torch.full_like(d2, rc * rc)))
    e_ij = eps[sidx[:, None], sidx[None, :]][None, :, None, :]
    s6 = (sig[sidx[:, None], sidx[None, :]][None, :, None, :] / d) ** 6
    phi = 4.0 * e_ij * (s6 * s6 - s6) * (1.0 - d / rc) ** 2
    return 0.5 * torch.where(inside, phi, torch.zeros_like(phi)).sum((1, 2, 3))


def energy_forces(pos, cell, sidx, tabs, rc, shifts):
    """(energies (R,), forces (R, n, 3)) of R copies of one small cell."""
    p = pos.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        e = energies(p, cell, sidx, tabs, rc, shifts)
        (g,) = torch.autograd.grad(e.sum(), p)
    return e.detach(), -g


def frames(pos, cell, sidx, masses, tabs, rc, temperature_K, copies, steps,
           gen, dt=1.0, friction=0.01):
    """``copies`` independent configurations: as many copies of the cell
    at ``pos``, each with its own Maxwell-Boltzmann velocities and noise,
    after ``steps`` BAOAB Langevin steps at ``temperature_K`` under the
    mixture (dt in fs, friction per fs).  Returns (copies, n, 3)."""
    kT = KB_EV * temperature_K
    shifts = image_shifts(cell, rc)
    dtu = dt * FS
    c1 = math.exp(-friction * dt)
    c2 = torch.sqrt(kT * (1.0 - c1 * c1) / masses)[None, :, None]
    m = masses[None, :, None]
    x = pos[None].repeat(copies, 1, 1)
    v = torch.randn(x.shape, generator=gen, dtype=x.dtype,
                    device=x.device) * torch.sqrt(kT / m)
    _, f = energy_forces(x, cell, sidx, tabs, rc, shifts)
    for _ in range(steps):
        v = v + 0.5 * dtu * f / m
        x = x + 0.5 * dtu * v
        v = c1 * v + c2 * torch.randn(x.shape, generator=gen, dtype=x.dtype,
                                      device=x.device)
        x = x + 0.5 * dtu * v
        _, f = energy_forces(x, cell, sidx, tabs, rc, shifts)
        v = v + 0.5 * dtu * f / m
    return x
