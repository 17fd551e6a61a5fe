"""Workloads of a Bayesian committee on the card (``chip_smoke.py`` phase 9).

The committee starts from a learned flagship model (``otf_bench``: the
1024-atom 4-species LGPS-like crystal, lmax = nmax = 3, rc = 6 A) through
the committee's own restart: the model is saved as ``bcm_1.pckl`` and a
``BCMActiveCalculator(pckl="bcm.pckl", max_inducing=256, max_data=8)``
finds it as its live model, so its first update freezes it as expert 1
and a fresh model learns beside it.

* ``committee`` — that calculator, with the flagship's oracle and
  thresholds;
* ``grow`` — learning under ``DeviceMD`` (400 K, 2 fs, friction 0.05, the
  trip armed) to a wall cap;
* ``committee_rel_err`` — the device committee in float32 (the kernels)
  against the host committee (``BCMActiveCalculator._predict``) in
  float64 through the plain versions, with both sides' weights;
* ``at_zero_pressure`` — the crystal scaled to where a model's pressure
  vanishes (the start of the committee's NPT run);
* ``lgps_vacancy_hop`` — end points of a Li vacancy hop in the crystal.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import units
from .otf_bench import EPS, RC, SIG, SKIN

TEMPERATURE_K = 400
CHUNK = 50


def committee(folder, max_inducing=256, max_data=8, device="cuda",
              dtype=None):
    """The committee calculator of ``folder``, whose ``bcm_1.pckl`` (a
    model folder, ``io.model_io.save_model``) it finds as its live model,
    learning from the flagship's Lennard-Jones mixture oracle with its
    thresholds."""
    from ..calculator.bcm import BCMActiveCalculator
    from ..calculator.oracles import MixtureLennardJones

    ediff = 2 * units.kcal_mol
    return BCMActiveCalculator(
        pckl=os.path.join(folder, "bcm.pckl"),
        calculator=MixtureLennardJones(EPS, SIG, rc=RC),
        logfile=os.path.join(folder, "active.log"), ediff=ediff,
        ediff_tot=2 * ediff, fdiff=1.5 * ediff, noise_f=0.01,
        max_inducing=max_inducing, max_data=max_data, skin=SKIN,
        device=device, dtype=dtype)


def sizes(calc):
    """(ndata, m) of each frozen expert and of the live model."""
    return [m.size for m in calc.experts.values()] + [calc.size]


def grow(calc, system, wall_cap=45.0, on_start=None):
    """Learning under DeviceMD until ``wall_cap`` seconds have passed;
    returns the stage's numbers."""
    from ..md.device_md import DeviceMD, committee_models
    from ..system import maxwell_boltzmann_velocities

    system.calc = calc
    maxwell_boltzmann_velocities(system, TEMPERATURE_K, seed=13)
    dyn = DeviceMD(system, calc, dt=2 * units.fs, temperature_K=TEMPERATURE_K,
                   friction=0.05, chunk=CHUNK, seed=14)
    if not dyn.check_beta:
        raise AssertionError("the uncertainty trip is not armed")
    nexp0 = len(calc.experts)
    if on_start is not None:
        on_start()
    t0 = time.time()
    steps = 0
    while time.time() - t0 < wall_cap:
        # short runs: an update with its oracle call, solve and expert
        # freeze takes seconds, so the cap overshoots by a step or two
        dyn.run(2)
        steps += 2
    wall = time.time() - t0
    return dict(steps=steps, wall_s=wall, frozen_in_stage=len(calc.experts) - nexp0,
                experts=len(calc.experts), served=len(committee_models(calc)),
                sizes=sizes(calc), fp_calls=calc.event_counts["fp_calls"],
                updates=calc.event_counts["updates"],
                positions_finite=bool(np.isfinite(system.positions).all()))


def committee_rel_err(calc, system):
    """The device committee (``md.device_md._sgpr_forces`` on the stacked
    experts) in the engine's type through the kernels, against the host
    committee in float64 through the plain versions, on ``system``.
    Returns (energy error, |E|, largest force error, force MAE, largest
    |f|, device weights, host weights)."""
    from ..md import device_md as dmd
    from .driver_bench import plain_kernels

    calc._calc = None
    eng = calc.engine
    calc.calculate(system)
    chain = dmd.new_chain(calc, system, False)
    cfg = chain["cfg"]
    with torch.enable_grad():
        p = cfg.positions.detach().requires_grad_(True)
        e, _, w = dmd._committee_e(p, cfg.cell, cfg, chain["ma"],
                                   chain["radii"], chain["vs"],
                                   chain["mean_e"], eng.params, eng.exponent,
                                   chain["ks"], weights=True)
        (g,) = torch.autograd.grad(e.sum(), p)
    n = len(system)
    e32 = float(e[0].detach())
    f32 = (-g[:n]).double().cpu().numpy()
    dtype = eng.dtype
    eng.dtype = torch.float64
    try:
        calc.cfg = None
        calc._make_cfg(system)
        with plain_kernels():
            calc._predict()
    finally:
        eng.dtype = dtype
        calc.cfg = None
        calc._make_cfg(system)
    e64, f64 = calc.results["energy"], calc.results["forces"]
    df = np.abs(f32 - f64)
    return (abs(e32 - e64), abs(e64), float(df.max()), float(df.mean()),
            float(np.abs(f64).max()), w[:, 0].cpu().numpy(),
            np.asarray(calc.weights))


def pressure_GPa(calc, system, kinetic=False):
    """The potential pressure of ``system`` under ``calc``, in GPa; with
    ``kinetic`` the barostat's whole pressure, the kinetic term
    2 KE / (3 V) of the system's velocities added."""
    x = system.copy()
    x.calc = calc
    p = -np.mean(x.get_stress()[:3])
    if kinetic:
        p += 2.0 * system.get_kinetic_energy() / (3.0 * system.volume)
    return float(p / units.GPa)


def at_zero_pressure(calc, system, lo=0.85, hi=1.0, rounds=12):
    """``system`` scaled isotropically (atoms with the cell) to where
    ``calc``'s pressure vanishes, by bisection of the length scale between
    ``lo`` and ``hi`` (where the pressure must change sign).  The
    flagship's crystal, built at a = 3.7 A for NVT, sits near -9 GPa,
    where the Lennard-Jones mixture does not hold its volume under a
    barostat (oracle, single model and committee alike)."""
    cell = np.asarray(system.cell)

    def scaled(f):
        x = system.copy()
        x.set_cell(cell * f, scale_atoms=True)
        return x

    if not pressure_GPa(calc, scaled(lo)) > 0 > pressure_GPa(calc, scaled(hi)):
        raise AssertionError("the pressure does not change sign in the bracket")
    for _ in range(rounds):
        mid = 0.5 * (lo + hi)
        if pressure_GPa(calc, scaled(mid)) > 0:
            lo = mid
        else:
            hi = mid
    return scaled(0.5 * (lo + hi))


def lgps_vacancy_hop(system):
    """End points of a Li vacancy hop: ``system`` with its first Li atom
    removed, and the same with that atom's nearest Li neighbor moved into
    the hole."""
    li = np.flatnonzero(np.asarray(system.numbers) == 3)
    hole = system.positions[li[0]].copy()
    keep = np.delete(np.arange(len(system)), li[0])
    first = system.permuted(keep)
    d = first.positions - hole
    d -= np.round(d @ np.linalg.inv(first.cell)) @ first.cell
    r2 = (d * d).sum(1)
    r2[np.asarray(first.numbers) != 3] = np.inf
    j = int(np.argmin(r2))
    last = first.copy()
    pos = last.positions.copy()
    pos[j] = pos[j] - d[j]  # the hole, as the neighbor's nearest image
    last.set_positions(pos)
    return first, last
