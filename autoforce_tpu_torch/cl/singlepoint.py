"""Single-point oracle calculation (port of
``autoforce_tpu/cl/singlepoint.py``, counterpart of
theforce/cl/singlepoint.py): ``python -m autoforce_tpu_torch.cl.singlepoint
-i POSCAR -o singlepoint.extxyz`` labels a structure with the ARGS'
``calculator`` (in this process, or over the socket with
``inprocess = False``)."""

from __future__ import annotations

from .. import cl as cline
from ..io.xyz import write_xyz
from ..system import SinglePointCalculator


def singlepoint(atoms, output="singlepoint.extxyz"):
    calc = cline.ARGS.get("calculator")
    if calc is None:
        raise RuntimeError("no calculator in ARGS")
    atoms.calc = calc
    res = {
        "energy": atoms.get_potential_energy(),
        "forces": atoms.get_forces(),
    }
    try:
        res["stress"] = atoms.get_stress()
    except Exception:
        pass
    atoms.calc = SinglePointCalculator(atoms, **res)
    write_xyz(output, atoms)
    return res


def main():
    import argparse

    from ..io.poscar import read_structure

    parser = argparse.ArgumentParser(description="Oracle single point")
    parser.add_argument("-i", "--input", default="POSCAR")
    parser.add_argument("-o", "--output", default="singlepoint.extxyz")
    args = parser.parse_args()
    cline.refresh()
    singlepoint(read_structure(args.input), args.output)


if __name__ == "__main__":
    main()
