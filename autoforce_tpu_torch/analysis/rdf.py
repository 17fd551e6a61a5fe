"""Radial distribution functions (counterpart of theforce/analysis/rdf.py).

A copy of ``autoforce_tpu/analysis/rdf.py`` (numpy only): the port keeps
its own host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from ..neighbors import displacements, neighbor_table


def get_numbers_pairs(atoms_numbers, numbers=None, pairs=None):
    if pairs:
        numbers = sorted({a for b in pairs for a in b})
    else:
        if numbers is None:
            numbers = np.unique(atoms_numbers).tolist()
        pairs = [(a, a) for a in numbers]
        pairs += list(itertools.combinations(numbers, 2))
    return numbers, pairs


def rdf(data, rmax, bins=100, rmin=0.0, numbers=None, pairs=None):
    """g(r) per species pair over a list of Systems.

    Returns (r, {pair: g}).
    """
    numbers, pairs = get_numbers_pairs(data[0].numbers, numbers, pairs)
    edges = np.linspace(rmin, rmax, bins + 1)
    hist = {pair: np.zeros(bins) for pair in pairs}
    count = {pair: 0 for pair in pairs}
    density = {n: 0.0 for n in numbers}
    snaps = 0
    for s in data:
        snaps += 1
        z, c = np.unique(s.numbers, return_counts=True)
        for zi, ci in zip(z, c):
            if int(zi) in density:
                density[int(zi)] += ci / s.volume
        t = neighbor_table(s.positions, s.cell, s.pbc, rmax)
        r = displacements(s.positions, s.cell, t)
        d = np.linalg.norm(r, axis=-1)
        nn = s.numbers
        for (a, b) in pairs:
            sel_central = nn == a
            count[(a, b)] += int(sel_central.sum())
            nbr_b = (nn[t.idx] == b) & t.mask
            dd = d[sel_central][nbr_b[sel_central]]
            h, _ = np.histogram(dd, bins=edges)
            hist[(a, b)] += h
    for n in numbers:
        density[n] /= snaps
    r = 0.5 * (edges[:-1] + edges[1:])
    dr = edges[1] - edges[0]
    g = {
        pair: hist[pair]
        / (max(count[pair], 1) * 4 * math.pi * r**2 * dr * density[pair[1]])
        for pair in pairs
    }
    return r, g
