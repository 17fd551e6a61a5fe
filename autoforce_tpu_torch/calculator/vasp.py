"""VASP file-IO adapter (port of ``autoforce_tpu/calculator/vasp.py``,
role of theforce/calculator/vasp.py).

Runs VASP as a subprocess in a scratch directory using user-provided
INCAR / KPOINTS / POTCAR-mapping files from the working directory, and
parses energy (free energy TOTEN), forces, and stress from vasprun-less
OUTCAR output.  The launch command is read from a ``COMMAND`` file
(e.g. ``mpirun -n 8 vasp_std``), mirroring the reference's convention
(vasp.py:8-87).  VASP runs on the host; ``device`` is accepted for the
oracle-script convention and places nothing.

This module exposes a module-level ``calc`` and ``make_calc(device)`` so
it can be served by ``python -m autoforce_tpu_torch.calculator.calc_server
-calc <this file>`` or named ``calculator = 'VASP'`` in an ARGS file.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from ..io.poscar import write_poscar
from ..units import GPa


def read_outcar(path):
    """Parse TOTEN, forces, and stress (kB) from an OUTCAR."""
    energy = None
    forces = None
    stress = None
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        if "free  energy   TOTEN" in line:
            energy = float(line.split()[-2])
        if "TOTAL-FORCE (eV/Angst)" in line:
            rows = []
            j = i + 2
            # data rows until the closing dashed line (indentation varies
            # across VASP versions — match the stripped prefix) or until a
            # row stops parsing as 6 floats
            while j < len(lines) and not lines[j].strip().startswith("----"):
                parts = lines[j].split()
                if len(parts) >= 6:
                    try:
                        rows.append([float(x) for x in parts[3:6]])
                    except ValueError:
                        break
                j += 1
            forces = np.array(rows)
        if "in kB" in line:
            v = [float(x) for x in line.split()[2:8]]
            # OUTCAR order: XX YY ZZ XY YZ ZX (kBar); convert to Voigt eV/A^3
            stress = -np.array([v[0], v[1], v[2], v[4], v[5], v[3]]) * 1e-1 * GPa
    return energy, forces, stress


class VaspCalculator:
    def __init__(self, directory="vasp_run", command=None):
        self.directory = directory
        if command is None:
            if os.path.isfile("COMMAND"):
                with open("COMMAND") as f:
                    command = f.read().strip()
            else:
                command = os.environ.get("VASP_COMMAND", "vasp_std")
        self.command = command

    def calculate(self, system):
        os.makedirs(self.directory, exist_ok=True)
        write_poscar(os.path.join(self.directory, "POSCAR"), system)
        for f in ("INCAR", "KPOINTS", "POTCAR"):
            if os.path.isfile(f) and not os.path.isfile(
                os.path.join(self.directory, f)
            ):
                shutil.copy(f, self.directory)
        subprocess.run(self.command, shell=True, cwd=self.directory, check=True)
        e, f, s = read_outcar(os.path.join(self.directory, "OUTCAR"))
        out = {"energy": e, "forces": f}
        if s is not None:
            out["stress"] = s
        return out


def make_calc(device="cuda"):
    return VaspCalculator()


calc = VaspCalculator()
