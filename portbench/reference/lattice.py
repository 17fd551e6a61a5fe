"""Crystals of the benchmark's configurations, built from their files."""

from __future__ import annotations

import torch

# standard atomic weights (amu) of the species the configurations use
MASSES = {3: 6.94, 15: 30.973761998, 16: 32.06, 29: 63.546, 32: 72.63}
KB_EV = 1.380649e-23 / 1.602176634e-19  # eV/K

FCC_BASIS = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.0), (0.5, 0.0, 0.5), (0.0, 0.5, 0.5))


def repeat(pos, numbers, cell, reps):
    """Tile a cell ``reps`` times, tile-major: every atom of tile (i, j, k)
    before those of the next, tiles in row-major order of (i, j, k)."""
    r = torch.tensor(reps, dtype=pos.dtype, device=pos.device)
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=pos.dtype, device=pos.device) for n in reps],
        indexing="ij"), dim=-1).reshape(-1, 3)
    shift = grid @ cell
    out = (pos[None] + shift[:, None]).reshape(-1, 3)
    return out, numbers.repeat(grid.shape[0]), cell * r[:, None]


def motif(config, device, dtype=torch.float64):
    """(positions, numbers, cell) of the configuration's repeat unit: the
    conventional fcc cell of ``a`` tiled ``motif_reps`` times, its sites
    given ``motif_numbers`` in order."""
    a = float(config["a"])
    basis = torch.tensor(FCC_BASIS, dtype=dtype, device=device) * a
    cell = torch.eye(3, dtype=dtype, device=device) * a
    n0 = torch.zeros(4, dtype=torch.int64, device=device)
    pos, _, cell = repeat(basis, n0, cell, config["motif_reps"])
    numbers = torch.tensor(config["motif_numbers"], dtype=torch.int64,
                           device=device)
    if numbers.shape[0] != pos.shape[0]:
        raise ValueError("motif_numbers does not fill the motif")
    return pos, numbers, cell


def crystal(config, reps, device, dtype=torch.float64):
    """The configuration's motif tiled ``reps`` times."""
    pos, numbers, cell = motif(config, device, dtype)
    return repeat(pos, numbers, cell, reps)


def sample_cell(config, device, dtype=torch.float64):
    """The cell whose rattled copies give the model's inducing environments
    and training data: the motif tiled ``sample_reps`` times."""
    return crystal(config, config["sample_reps"], device, dtype)


def masses(numbers):
    table = torch.zeros(int(numbers.max()) + 1, dtype=torch.float64,
                        device=numbers.device)
    for z, m in MASSES.items():
        if z < table.shape[0]:
            table[z] = m
    out = table[numbers]
    if bool((out == 0).any()):
        raise ValueError("a species without a mass in MASSES")
    return out


def velocities(numbers, temperature_K, gen):
    """Maxwell-Boltzmann velocities (Angstrom per time unit) with no net
    momentum, drawn from ``gen``."""
    m = masses(numbers)
    v = torch.randn((numbers.shape[0], 3), generator=gen, dtype=torch.float64,
                    device=numbers.device)
    v = v * torch.sqrt(KB_EV * temperature_K / m)[:, None]
    p = (m[:, None] * v).sum(0) / m.sum()
    return v - p[None]
