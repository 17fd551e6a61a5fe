"""LAMMPS-driven MLMD via fix external pf/callback (port of
``autoforce_tpu/cl/lmp.py``, counterpart of theforce/cl/lmp.py:42-113):
``python -m autoforce_tpu_torch.cl.lmp -i in.lammps`` with an ARGS file in
the working directory; the model predicts on ARGS' ``calc_device``, the
card by default.

The LAMMPS input script must contain
    #AutoForce atomic_numbers={1: 29, ...}
    fix AutoForce all external pf/callback 1 1
LAMMPS calls back into python each step; positions are gathered, the ML
calculator predicts, and energy/forces/virial are pushed back.  Gated on
the ``lammps`` python module being importable (the driver itself is
testable with a mocked module, tests/test_lmp.py).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

import numpy as np

from ..system import System

# pressure conversion: LAMMPS "nktv2p" per unit system (pressure unit
# per energy/volume unit) — virial pushed back must be in P*V units
NKTV2P = {
    "lj": 1.0,
    "real": 68568.415,
    "metal": 1.6021765e6,
    "si": 1.0,
    "cgs": 1.0,
    "electron": 2.94210108e13,
    "micro": 1.0,
    "nano": 1.0,
}

# unit conversion factors LAMMPS-unit-system -> internal (eV / Angstrom)
_DIST = {"metal": 1.0, "real": 1.0}
_ENERGY = {"metal": 1.0, "real": 0.0433641}  # kcal/mol -> eV
_FORCE = {"metal": 1.0, "real": 0.0433641}


@dataclass
class LammpsScript:
    """Parsed LAMMPS input: the command list plus the AutoForce hooks."""

    commands: list = field(default_factory=list)
    units: str = "metal"
    atomic_numbers: dict = None
    fix_id: str = None
    fix_index: int = None  # position of the fix command in `commands`

    @classmethod
    def parse(cls, path):
        script = cls()
        directive = re.compile(r"atomic_numbers\s*=\s*(\{[^}]*\})")
        for raw in open(path):
            if raw.lstrip().lower().startswith("#autoforce"):
                m = directive.search(raw)
                if m:
                    table = ast.literal_eval(m.group(1))
                    script.atomic_numbers = {
                        int(k): int(v) for k, v in table.items()
                    }
                continue
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            tokens = line.split()
            if tokens[0] == "units" and len(tokens) > 1:
                script.units = tokens[1]
            if (
                tokens[0].lower() == "fix"
                and len(tokens) > 2
                and tokens[1].lower() == "autoforce"
            ):
                script.fix_id = tokens[1]
                script.fix_index = len(script.commands)
            script.commands.append(" ".join(tokens))
        if script.fix_id is None:
            raise RuntimeError("no 'fix AutoForce ... external' in the input script")
        if script.atomic_numbers is None:
            raise RuntimeError(
                "missing '#AutoForce atomic_numbers={type: Z, ...}' directive"
            )
        return script


def read_lammps_file(file):
    """Back-compat tuple view of :meth:`LammpsScript.parse`."""
    s = LammpsScript.parse(file)
    return s.units, s.atomic_numbers, s.fix_id, s.fix_index, s.commands


class LammpsDriver:
    """fix-external callback: gather LAMMPS state -> predict -> push
    energy/forces/virial back in LAMMPS units."""

    def __init__(self, lmp, calc, units, map_numbers, fixID):
        self.lmp = lmp
        self.calc = calc
        self.units = units
        self.map_numbers = map_numbers
        self.fixID = fixID
        self.system = None

    def get_cell(self):
        boxlo, (xhi, yhi, zhi), xy, yz, xz, pbc, _ = self.lmp.extract_box()
        cell = np.array([[xhi, xy, xz], [0.0, yhi, yz], [0.0, 0.0, zhi]])
        return cell * _DIST.get(self.units, 1.0), pbc

    def __call__(self, caller, ntimestep, nlocal, tag, pos, fext):
        lmp = self.lmp
        cell, pbc = self.get_cell()
        xyz = np.array(lmp.gather_atoms("x", 1, 3)).reshape(-1, 3)
        xyz = xyz * _DIST.get(self.units, 1.0)
        if self.system is None:
            types = np.array(lmp.gather_atoms("type", 0, 1))
            numbers = [self.map_numbers[t] for t in types]
            self.system = System(
                numbers=numbers, positions=xyz, cell=cell, pbc=pbc
            )
            self.system.calc = self.calc
        else:
            self.system.set_cell(cell)
            self.system.set_positions(xyz)
        f = self.system.get_forces()[tag - 1]
        e = self.system.get_potential_energy()
        fext[:] = f / _FORCE.get(self.units, 1.0)
        lmp.fix_external_set_energy_global(
            self.fixID, e / _ENERGY.get(self.units, 1.0)
        )
        try:
            v = self.system.get_stress()
            vol = self.system.volume
            v = -v / (NKTV2P[self.units] / vol)
            v = np.array([v[0], v[1], v[2], v[5], v[4], v[3]])
            lmp.fix_external_set_virial_global(self.fixID, v)
        except Exception:
            pass


def main():
    import argparse

    try:
        from lammps import lammps
    except ImportError as e:
        raise SystemExit(
            "the 'lammps' python module is required for the LAMMPS driver"
        ) from e

    from .. import cl as cline

    parser = argparse.ArgumentParser(description="MLMD driven by LAMMPS")
    parser.add_argument("-i", "--input", default="in.lammps")
    args = parser.parse_args()
    cline.refresh()
    script = LammpsScript.parse(args.input)
    lmp = lammps()
    calc = cline.gen_active_calc()
    driver = LammpsDriver(
        lmp, calc, script.units, script.atomic_numbers, script.fix_id
    )
    lmp.commands_list(script.commands[: script.fix_index + 1])
    lmp.set_fix_external_callback(script.fix_id, driver)
    lmp.commands_list(script.commands[script.fix_index + 1 :])


if __name__ == "__main__":
    main()
