"""Every pair of atoms closer than a cutoff, under periodic boundaries.

Pairs are (i, j, n): atom j seen from atom i through the integer image
shift n, so that r_ij = pos[j] - pos[i] + n @ cell, with positions as
given (unwrapped).  A box at least three cutoffs wide on every axis is
binned by fractional coordinates into cells at least a cutoff wide and
each atom meets the atoms of its 27 neighboring bins under the minimum
image; a smaller box is searched over all the images the cutoff reaches.
"""

from __future__ import annotations

import math

import torch


def widths(cell):
    """Perpendicular widths of the cell along its three axes."""
    inv = torch.linalg.inv(cell)
    return 1.0 / torch.linalg.norm(inv, dim=0)


def pairs(pos, cell, rc, block=8192):
    """(i, j, n) of every pair with |r_ij| < rc, both ways, as int64
    tensors (n: (P, 3)), sorted by i then j."""
    w = widths(cell)
    if bool((w >= 3.0 * rc).all()):
        i, j, n = _binned(pos, cell, rc, w, block)
    else:
        i, j, n = _images(pos, cell, rc)
    key = i * pos.shape[0] + j
    order = torch.argsort(key, stable=True)
    return i[order], j[order], n[order]


def displacement(pos, cell, i, j, n):
    return pos[j] - pos[i] + n.to(pos.dtype) @ cell


def _binned(pos, cell, rc, w, block):
    dev = pos.device
    N = pos.shape[0]
    nb = torch.floor(w / rc).to(torch.int64)  # >= 3 on every axis
    frac = pos @ torch.linalg.inv(cell)
    fw = frac - torch.floor(frac)
    b3 = torch.minimum((fw * nb).to(torch.int64), nb - 1)
    nbx, nby, nbz = (int(v) for v in nb)
    bins = (b3[:, 0] * nby + b3[:, 1]) * nbz + b3[:, 2]
    order = torch.argsort(bins, stable=True)
    counts = torch.bincount(bins, minlength=nbx * nby * nbz)
    C = int(counts.max())
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N, device=dev) - start[bins[order]]
    table = torch.full((nbx * nby * nbz, C), -1, dtype=torch.int64, device=dev)
    table[bins[order], rank] = order
    d = torch.tensor([-1, 0, 1], device=dev)
    nbr = torch.stack(torch.meshgrid(d, d, d, indexing="ij"), -1).reshape(27, 3)
    out_i, out_j, out_n = [], [], []
    rc2 = rc * rc
    for lo in range(0, N, block):
        ii = torch.arange(lo, min(lo + block, N), device=dev)
        bb = (b3[ii][:, None, :] + nbr[None]) % nb  # (B, 27, 3)
        flat = (bb[..., 0] * nby + bb[..., 1]) * nbz + bb[..., 2]
        cand = table[flat].reshape(ii.shape[0], 27 * C)  # (B, 27 C)
        ok = cand >= 0
        jj = cand.clamp(min=0)
        g = frac[jj] - frac[ii][:, None, :]
        n = -torch.round(g)
        r = (g + n) @ cell
        d2 = (r * r).sum(-1)
        keep = ok & (d2 < rc2) & (jj != ii[:, None])
        bi, bk = torch.nonzero(keep, as_tuple=True)
        out_i.append(ii[bi])
        out_j.append(jj[bi, bk])
        out_n.append(n[bi, bk].to(torch.int64))
    return torch.cat(out_i), torch.cat(out_j), torch.cat(out_n)


def _images(pos, cell, rc):
    dev = pos.device
    N = pos.shape[0]
    reach = [int(math.ceil(rc / float(v))) for v in widths(cell)]
    rng = [torch.arange(-k, k + 1, device=dev) for k in reach]
    shifts = torch.stack(torch.meshgrid(*rng, indexing="ij"), -1).reshape(-1, 3)
    r = (pos[None, None, :, :] + (shifts.to(pos.dtype) @ cell)[None, :, None, :]
         - pos[:, None, None, :])  # (i, shift, j, 3)
    d2 = (r * r).sum(-1)
    ii = torch.arange(N, device=dev)
    zero = (shifts == 0).all(-1)
    self_pair = zero[None, :, None] & (ii[:, None, None] == ii[None, None, :])
    keep = (d2 < rc * rc) & ~self_pair
    i, s, j = torch.nonzero(keep, as_tuple=True)
    return i, j, shifts[s].to(torch.int64)
