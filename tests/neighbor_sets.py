"""Helpers of the neighbor-table tests, shared by the CPU tests and the
card's tests (this module imports neither JAX nor the JAX package)."""

import torch

from autoforce_tpu_torch.system import bulk_fcc


def rattled(reps=(3, 3, 3), a=3.6, seed=0, stdev=0.1, shear=0.0):
    s = bulk_fcc("Cu", a).repeat(reps)
    if shear:
        cell = s.cell.copy()
        cell[2, 0] += shear
        s.set_cell(cell, scale_atoms=True)
    s.rattle(stdev, seed=seed)
    return s


def row_sets(idx, off, mask):
    return [
        {(int(j), *map(int, o)) for j, o, m in zip(idx[i], off[i], mask[i]) if m}
        for i in range(idx.shape[0])
    ]


def slot_keys(idx, off, mask):
    """Every valid slot of a (rows, K) table as one int64 (row, j, off)
    key, sorted: the row sets of :func:`row_sets` in a form that large
    tables compare in one step on their own device (rows and atom ids
    below 2^19)."""
    n, K = idx.shape
    r = torch.arange(n, dtype=torch.int64, device=idx.device)[:, None].expand(n, K)
    o = off.to(torch.int64) + 128
    code = (o[..., 0] << 16) | (o[..., 1] << 8) | o[..., 2]
    key = ((r * (1 << 20) + idx.to(torch.int64)) << 24) | code
    return torch.sort(key[mask]).values
