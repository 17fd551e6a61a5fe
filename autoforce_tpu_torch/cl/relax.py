"""ML relaxation: ``python -m autoforce_tpu_torch.cl.relax -i POSCAR``
(port of ``autoforce_tpu/cl/relax.py``, counterpart of
theforce/cl/relax.py).  Reads the ARGS file of the working directory."""

from __future__ import annotations

from .. import cl as cline
from ..opt import FIRE, LBFGS, UnitCellFilter


def relax(
    atoms,
    fmax=0.01,
    cell=False,
    mask=None,
    algo="LBFGS",
    trajectory="relax.extxyz",
    rattle=0.0,
    confirm=True,
    clearance=None,
):
    """Relax with the ML calculator; optionally confirm with the oracle
    (reference relax.py:56-69 re-relaxes until the exact check passes)."""
    calc = cline.gen_active_calc()
    atoms.calc = calc
    if rattle:
        atoms.rattle(rattle)
    # 'BFGS' (the reference default name) maps to LBFGS here; 'DEVICE'
    # runs the whole FIRE loop on the card (opt/device_fire.py),
    # including cell=True (the UnitCellFilter composition lives in the
    # chunk)
    algo = algo.upper()
    algo_cls = {"LBFGS": LBFGS, "BFGS": LBFGS, "FIRE": FIRE,
                "DEVICE": None}[algo]

    from ..io.xyz import write_xyz
    from ..system import SinglePointCalculator

    frames = {"mode": "w"}

    def write_frame():
        snap = atoms.copy()
        snap.calc = SinglePointCalculator(snap, **calc.results)
        write_xyz(trajectory, snap, mode=frames["mode"])
        frames["mode"] = "a"

    for _ in range(20):
        if algo == "DEVICE":
            from ..opt.device_fire import DeviceFIRE

            opt = DeviceFIRE(atoms, calc, cell=cell)
            opt.run(fmax=fmax, steps=500)
            write_frame()
        else:
            target = UnitCellFilter(atoms) if cell else atoms
            opt = algo_cls(target)
            opt.attach(write_frame)
            opt.run(fmax=fmax, steps=500)
        if not (calc.active and confirm):
            break
        # force an exact single-point; if the model updates, re-relax
        size0 = calc.size
        calc.update_data(try_fake=False)
        if calc.size == size0:
            break
    return atoms


def main():
    import argparse

    from ..io.poscar import read_structure, write_poscar

    parser = argparse.ArgumentParser(description="ML structure relaxation")
    parser.add_argument("-i", "--input", default="POSCAR")
    parser.add_argument("-o", "--output", default="CONTCAR")
    args = parser.parse_args()
    cline.refresh()
    atoms = read_structure(args.input)
    kwargs = cline.get_default_args(relax)
    cline.update_args(kwargs)
    relax(atoms, **kwargs)
    write_poscar(args.output, atoms)


if __name__ == "__main__":
    main()
