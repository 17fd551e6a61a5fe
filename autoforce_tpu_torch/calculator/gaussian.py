"""Gaussian (electronic-structure code) file-IO adapter (port of
``autoforce_tpu/calculator/gaussian.py``).

Role of theforce/calculator/gaussian.py: run Gaussian as a subprocess from
a user-provided route-section template, parse energy and forces, and
optionally subtract single-atom reference energies.  Gaussian runs on the
host; ``device`` is accepted for the oracle-script convention and places
nothing.  Exposes a module-level ``calc`` and ``make_calc(device)`` for
the socket server and ``calculator = 'GAUSSIAN'`` in an ARGS file.

Template: a ``gjf`` file in the working directory whose molecule block is
replaced per structure; the route section must request ``force``.
"""

from __future__ import annotations

import os
import re
import subprocess

import numpy as np

from ..data import chemical_symbols
from ..units import Bohr, Hartree


def write_gjf(path, system, template="template.gjf", chk="calc.chk"):
    route = "#P force b3lyp/6-31g*\n"
    charge_mult = "0 1"
    if os.path.isfile(template):
        with open(template) as f:
            lines = f.read().splitlines()
        head = []
        for ln in lines:
            if re.match(r"^\s*-?\d+\s+\d+\s*$", ln):
                charge_mult = ln.strip()
                break
            head.append(ln)
        if head:
            route = "\n".join(head) + "\n"
    with open(path, "w") as f:
        f.write(f"%chk={chk}\n")
        f.write(route)
        if not route.endswith("\n\n"):
            f.write("\n")
        f.write("autoforce_tpu single point\n\n")
        f.write(charge_mult + "\n")
        for z, p in zip(system.numbers, system.positions):
            f.write(
                f"{chemical_symbols[z]:3s} {p[0]:16.8f} {p[1]:16.8f} {p[2]:16.8f}\n"
            )
        f.write("\n")


def read_log(path, natoms):
    energy = None
    forces = None
    with open(path) as f:
        lines = f.read().splitlines()
    for i, ln in enumerate(lines):
        if "SCF Done" in ln:
            energy = float(ln.split("=")[1].split()[0]) * Hartree
        if "Forces (Hartrees/Bohr)" in ln:
            rows = []
            for j in range(i + 3, i + 3 + natoms):
                parts = lines[j].split()
                rows.append([float(x) for x in parts[2:5]])
            forces = np.array(rows) * Hartree / Bohr
    return energy, forces


class GaussianCalculator:
    def __init__(self, command=None, template="template.gjf",
                 subtract_atoms=None):
        self.command = command or os.environ.get("GAUSSIAN_COMMAND", "g16")
        self.template = template
        # {Z: single-atom energy} subtracted like the reference
        self.subtract_atoms = subtract_atoms or {}

    def calculate(self, system):
        write_gjf("calc.gjf", system, template=self.template)
        subprocess.run(f"{self.command} calc.gjf", shell=True, check=True)
        log = "calc.log" if os.path.isfile("calc.log") else "calc.out"
        e, f = read_log(log, len(system))
        for z in system.numbers:
            e -= self.subtract_atoms.get(int(z), 0.0)
        return {"energy": e, "forces": f, "stress": np.zeros(6)}


def make_calc(device="cuda"):
    return GaussianCalculator()


calc = GaussianCalculator()
