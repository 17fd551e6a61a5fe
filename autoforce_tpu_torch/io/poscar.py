"""VASP POSCAR/CONTCAR reader/writer (minimal, VASP-5 format).

A copy of ``autoforce_tpu/io/poscar.py`` (numpy only): the port keeps its own
host modules so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..data import atomic_numbers, chemical_symbols
from ..system import System


def read_poscar(path):
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    scale = float(lines[1].split()[0])
    cell = np.array(
        [[float(x) for x in lines[2 + i].split()[:3]] for i in range(3)]
    )
    if scale < 0:
        vol = abs(np.linalg.det(cell))
        scale = (-scale / vol) ** (1.0 / 3.0)
    cell = cell * scale
    symbols = lines[5].split()
    counts = [int(x) for x in lines[6].split()]
    k = 7
    selective = lines[k].strip().lower().startswith("s")
    if selective:
        k += 1
    direct = lines[k].strip().lower()[0] in ("d",)
    k += 1
    numbers = []
    for s, c in zip(symbols, counts):
        numbers += [atomic_numbers[s]] * c
    n = sum(counts)
    pos = np.array(
        [[float(x) for x in lines[k + i].split()[:3]] for i in range(n)]
    )
    if direct:
        pos = pos @ cell
    else:
        pos = pos * scale
    return System(numbers=numbers, positions=pos, cell=cell, pbc=True)


def write_poscar(path, system, direct=True):
    numbers = np.asarray(system.numbers)
    order = np.argsort(numbers, kind="stable")
    numbers = numbers[order]
    pos = system.positions[order]
    uniq = []
    counts = []
    for z in numbers:
        if not uniq or uniq[-1] != z:
            uniq.append(int(z))
            counts.append(0)
        counts[-1] += 1
    with open(path, "w") as f:
        f.write("generated by autoforce_tpu_torch\n1.0\n")
        for row in system.cell:
            f.write("  {:20.12f} {:20.12f} {:20.12f}\n".format(*row))
        f.write(" ".join(chemical_symbols[z] for z in uniq) + "\n")
        f.write(" ".join(str(c) for c in counts) + "\n")
        f.write("Direct\n" if direct else "Cartesian\n")
        coords = system.scaled_positions()[order] if direct else pos
        for row in coords:
            f.write("  {:18.12f} {:18.12f} {:18.12f}\n".format(*row))


def read_structure(path, index=-1):
    """Dispatch by filename: POSCAR/CONTCAR/*.vasp or extxyz."""
    import os

    from .xyz import read_xyz

    base = os.path.basename(path)
    if base.startswith(("POSCAR", "CONTCAR")) or base.endswith(".vasp"):
        return read_poscar(path)
    frames = read_xyz(path)
    return frames[index]
