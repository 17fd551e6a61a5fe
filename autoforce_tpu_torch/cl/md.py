"""MLMD driver: ``python -m autoforce_tpu_torch.cl.md -i POSCAR`` (port
of ``autoforce_tpu/cl/md.py``, counterpart of theforce/cl/md.py).  Reads
the ARGS file of the working directory (see ``cl/__init__``)."""

from __future__ import annotations

import numpy as np

from .. import cl as cline
from .. import units
from ..calculator.active import FilterDeltas
from ..io.xyz import write_xyz
from ..md import BerendsenNPT, BerendsenNVT, Langevin, MTKNPT, NoseHooverNVT
from ..system import maxwell_boltzmann_velocities
from ..utils import make_cell_upper_triangular


def manual_steps(atoms, calc, eps_pos, eps_cell, npt=False):
    """Prime the model before dynamics (reference cl/md.py:175-194): one
    rattled single-point, and for NPT one expanded + one shrunk cell, so
    the initial learning covers the configuration space the dynamics will
    immediately visit.  Positions/cell are restored afterwards."""
    calc.log("manual steps:")
    pos0 = atoms.positions.copy()
    if eps_pos and eps_pos > 0.0:
        calc.log(f"rattle: {eps_pos}")
        atoms.rattle(eps_pos)
        atoms.get_potential_energy()
    if npt and eps_cell and eps_cell > 0.0:
        cell0 = np.asarray(atoms.cell).copy()
        for fac in (1.0 + eps_cell, 1.0 - eps_cell):
            calc.log(f"scale cell: {fac}")
            atoms.set_cell(fac * cell0, scale_atoms=True)
            atoms.get_potential_energy()
        atoms.set_cell(cell0, scale_atoms=True)
    atoms.set_positions(pos0)


def configure_cell(atoms):
    """Vacuum box for isolated systems; upper-triangular cell for
    driver interop (reference cl/md.py:169-172)."""
    if np.allclose(np.asarray(atoms.cell), 0.0):
        span = atoms.positions.max(axis=0) - atoms.positions.min(axis=0)
        atoms.cell = np.diag(span + 12.0)
        atoms.positions = (
            atoms.positions
            - atoms.positions.mean(axis=0)
            + np.diag(atoms.cell) / 2.0
        )
        atoms.pbc = np.array([True, True, True])
    make_cell_upper_triangular(atoms)


def md(
    atoms,
    dynamics="NPT",
    dt=None,
    tem=300.0,
    picos=100,
    bulk_modulus=None,
    stress=0.0,
    mask=None,
    iso=False,
    trajectory="md.extxyz",
    loginterval=1,
    append=False,
    rattle=0.0,
    tdamp=25,
    pdamp=100,
    friction=1e-3,
    ml_filter=0.8,
    eps_pos=0.05,
    eps_cell=0.05,
    thermostat="auto",
    replicas=1,
):
    """MD with on-the-fly learning (reference cl/md.py:15-112 semantics).

    dynamics: 'NPT' (Nose-Hoover; cell moves only if bulk_modulus given,
              like the reference's pfactor gate), 'LANGEVIN', 'BERENDSEN'
              (weak coupling), 'DEVICE' (integrator on the card).
    tem may be a list (temperature ladder); picos > 0 -> duration in ps,
    picos < 0 -> -picos steps.  mask: 3-vector or 3x3, strain components
    allowed to move (NPT).  eps_pos/eps_cell: manual warmup amplitudes.
    """
    calc = cline.gen_active_calc()
    atoms.calc = calc
    if dynamics.upper() == "NPT" or (
        dynamics.upper() == "DEVICE" and bulk_modulus is not None
    ):
        # the device NPT route needs a usable cell too (vacuum box for
        # isolated inputs; volume 0 would zero the barostat inertia)
        configure_cell(atoms)
    if calc.active:
        manual_steps(atoms, calc, eps_pos, eps_cell, npt=bool(bulk_modulus))
    if rattle:
        atoms.rattle(rattle)

    temperatures = tem if hasattr(tem, "__iter__") else [tem]
    maxwell_boltzmann_velocities(atoms, temperatures[0])
    atoms.get_potential_energy()

    if dt is None:
        dt = 0.25 if (np.asarray(atoms.numbers) == 1).any() else 1.0

    if ml_filter:
        filt = FilterDeltas(calc, shrink=ml_filter)
        atoms.calc = filt

    mode = "a" if append else "w"
    frames = {"mode": mode}

    def write_frame():
        from ..system import SinglePointCalculator

        snap = atoms.copy()
        snap.calc = SinglePointCalculator(snap, **calc.results)
        write_xyz(trajectory, snap, mode=frames["mode"])
        frames["mode"] = "a"

    for T in temperatures:
        kind = dynamics.upper()
        if kind == "NPT" and bulk_modulus is not None:
            dyn = MTKNPT(
                atoms,
                dt * units.fs,
                temperature_K=T,
                pressure_GPa=stress,
                tdamp=tdamp * units.fs,
                pdamp=pdamp * units.fs,
                mask=mask,
                isotropic=iso,
                bulk_modulus_GPa=bulk_modulus,
            )
        elif kind == "NPT":
            # reference parity: NPT without bulk_modulus = Nose-Hoover NVT
            # (ase NPT with pfactor=None, cl/md.py:137-140)
            dyn = NoseHooverNVT(
                atoms, dt * units.fs, temperature_K=T, tdamp=tdamp * units.fs
            )
        elif kind == "LANGEVIN":
            dyn = Langevin(
                atoms, dt * units.fs, temperature_K=T, friction=friction / units.fs
            )
        elif kind == "DEVICE" and bulk_modulus is not None:
            # the reference's pfactor gate applied to the device path:
            # bulk_modulus present -> the cell moves (MTK NPT on the
            # card; flexible-cell by default, iso/mask as host)
            from .device_wrap import run_device_npt

            run_device_npt(atoms, calc, dt, T, stress, picos, write_frame,
                           loginterval, tdamp=tdamp, pdamp=pdamp,
                           bulk_modulus=bulk_modulus, mask=mask, iso=iso)
            continue
        elif kind == "DEVICE":
            from .device_wrap import run_device_md

            run_device_md(atoms, calc, dt, T, friction, picos, write_frame,
                          loginterval, thermostat=thermostat, tdamp=tdamp,
                          replicas=replicas)
            continue
        elif kind == "BERENDSEN" and bulk_modulus is not None:
            dyn = BerendsenNPT(
                atoms,
                dt * units.fs,
                temperature_K=T,
                pressure_GPa=stress,
                taut=tdamp * units.fs,
                taup=pdamp * units.fs,
                # beta ~ 1/B, converted from 1/GPa to 1/bar
                compressibility=1e-4 / float(bulk_modulus),
                isotropic=iso,
            )
        else:
            dyn = BerendsenNVT(
                atoms, dt * units.fs, temperature_K=T, taut=tdamp * units.fs
            )
        dyn.attach(write_frame, loginterval)
        if calc.meta is not None:
            dyn.attach(calc.meta.update)
        steps = int(picos * 1000 / dt) if picos > 0 else int(-picos)
        dyn.run(steps)
    return atoms


def main():
    import argparse

    from ..io.poscar import read_structure

    parser = argparse.ArgumentParser(description="Machine-learning MD")
    parser.add_argument("-i", "--input", default="POSCAR")
    args = parser.parse_args()
    cline.refresh()
    atoms = read_structure(args.input)
    kwargs = cline.get_default_args(md)
    cline.update_args(kwargs)
    md(atoms, **kwargs)


if __name__ == "__main__":
    main()
