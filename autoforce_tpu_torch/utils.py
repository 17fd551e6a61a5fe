"""Assorted structure utilities (counterparts of theforce/util/{flake,
aseutil}.py and Local.vor).

A copy of ``autoforce_tpu/utils.py`` (numpy only): the port keeps its own
host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np


def generate_random_cluster(n, d, dim=3, seed=None):
    """Random cluster of n points with all nearest-neighbor distances == d
    (reference util/flake.py:6-46, ballistic-deposition style)."""
    rng = np.random.default_rng(seed)
    c = np.zeros((1, dim))
    for _ in range(1, n):
        u = rng.uniform(-1.0, 1.0, size=dim)
        u /= np.linalg.norm(u)
        p = (u * c).sum(axis=1)
        s = np.argsort(p)[::-1]
        x = None
        for j, k in enumerate(s):
            y = np.linalg.norm(c[k] - p[k] * u)
            if y <= d:
                x = p[k] + np.sqrt(d**2 - y**2)
                break
        for k in s[j:]:
            if x - p[k] > d:
                break
            y = np.linalg.norm(c[k] - x * u)
            if y < d:
                z = np.linalg.norm(c[k] - p[k] * u)
                x = p[k] + np.sqrt(d**2 - z**2)
        c = np.concatenate([c, x * u.reshape(1, dim)])
    return c


def make_cell_upper_triangular(system):
    """Rotate the configuration so the cell matrix is upper triangular
    (reference util/aseutil.py:61-71; needed by some MD barostats).

    The rotated cell U preserves the Gram matrix G = C C^T; it is the
    reverse-order Cholesky factor of G (rows: v1 full, v2 in yz, v3 on z).
    """
    G = system.cell @ system.cell.T
    U = np.zeros((3, 3))
    U[2, 2] = np.sqrt(G[2, 2])
    U[1, 2] = G[1, 2] / U[2, 2]
    U[1, 1] = np.sqrt(G[1, 1] - U[1, 2] ** 2)
    U[0, 2] = G[0, 2] / U[2, 2]
    U[0, 1] = (G[0, 1] - U[0, 2] * U[1, 2]) / U[1, 1]
    U[0, 0] = np.sqrt(G[0, 0] - U[0, 1] ** 2 - U[0, 2] ** 2)
    R = np.linalg.solve(system.cell, U)  # rotation: cell @ R = U
    system.positions = system.positions @ R
    system.cell = U
    return system


def average_positions(frames, weights=None):
    """Average structure over trajectory frames (aseutil.py:42-58)."""
    pos = np.stack([f.positions for f in frames])
    cell = np.stack([f.cell for f in frames])
    w = np.ones(len(frames)) if weights is None else np.asarray(weights)
    w = w / w.sum()
    out = frames[0].copy()
    out.positions = (w[:, None, None] * pos).sum(axis=0)
    out.cell = (w[:, None, None] * cell).sum(axis=0)
    return out


def voronoi_neighbors(rvec):
    """Indices of Voronoi-relevant neighbors among displacement vectors:
    j such that (r_k - r_j) . r_j <= 0 for all k (reference Local.vor,
    atoms.py:103-107)."""
    rvec = np.asarray(rvec)
    dots = ((rvec[:, None] - rvec[None]) * rvec[None]).sum(axis=-1)
    return np.flatnonzero((dots <= 0.0).all(axis=1))


def get_repeat(system, spacing=10.0):
    """Repetitions needed so each cell vector exceeds ``spacing``
    (aseutil.py:80-86)."""
    lengths = np.linalg.norm(system.cell, axis=1)
    return [max(1, int(np.ceil(spacing / L))) for L in lengths]


def dope(system, fraction, new_z, species=None, seed=None):
    """Random substitutional doping (reference analysis/doping.py role)."""
    rng = np.random.default_rng(seed)
    out = system.copy()
    cand = (
        np.flatnonzero(out.numbers == species)
        if species is not None
        else np.arange(len(out))
    )
    k = int(round(fraction * len(cand)))
    sel = rng.choice(cand, k, replace=False)
    out.numbers = out.numbers.copy()
    out.numbers[sel] = new_z
    return out


def random_structure(numbers, density=0.05, margin=1.5, seed=None):
    """Random periodic structure with a minimum-distance constraint
    (reference analysis/atomsgen role)."""
    from .system import System

    rng = np.random.default_rng(seed)
    n = len(numbers)
    vol = n / density
    a = vol ** (1.0 / 3.0)
    pos = np.zeros((n, 3))
    for i in range(n):
        for _ in range(2000):
            trial = rng.uniform(0, a, 3)
            if i == 0:
                pos[i] = trial
                break
            delta = pos[:i] - trial
            delta -= a * np.round(delta / a)
            if (np.linalg.norm(delta, axis=1) > margin).all():
                pos[i] = trial
                break
        else:
            raise RuntimeError("could not place atom; lower density")
    return System(numbers=numbers, positions=pos, cell=np.eye(3) * a, pbc=True)
