"""Workloads of replica ensembles, metadynamics, multi-task learning and
the parametric potential on the card (``chip_smoke.py`` phase 10), and
the float32-against-float64 checks that read them.

* ``replica_systems`` — ``bench.py``'s ``measure_replicas``: R copies of
  the 1008-atom bench snapshot, each rattled 0.01 A (seed 100 + r) with
  Maxwell-Boltzmann velocities at 300 K (seed 200 + r);
  ``replica_rel_err`` holds the walkers stacked as the ensemble's chunks
  stack them, float32 through the kernels, against each walker alone in
  float64 through the plain versions.
* ``meta_rel_err`` — the ActiveMeta bias as ``DeviceMD`` fuses it, float32
  through the kernels, against ``engine.meta_covloss_fn`` in float64
  through the plain versions; ``committee_floor_err`` — the committee's
  fused floor bias against the host formula from each expert alone.
* ``multitask_calc`` / ``multitask_learn`` — two Lennard-Jones tasks
  (epsilon 0.15 and 0.30 eV, sigma 2.3 A, the oracles of
  tests/test_bcm_multitask.py at the model's cutoff) learned at the bench
  widths (lmax = nmax = 3, rc = 6 A) under ``DeviceMD`` at 600 K on a
  256-atom fcc Cu cell; ``multitask_rel_err`` holds the device's float32 combined
  surface against the host ``_predict`` in float64 through the plain
  versions.
* ``parametric_err`` — ``ParametricCalculator(get_lj_terms(...))`` on the
  card against the Lennard-Jones oracle of the same smoothly cut form.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import units
from .driver_bench import SKIN, plain_kernels

REPLICAS = 16
TEMPERATURE_K = 300
# the parametric potential against the oracle of its own form
# (MixtureLennardJones: the same 12-6 term times (1 - d/rc)^2), both in
# float64: each energy and force sums ~100 pair terms, so the two
# summation orders agree to ~100 eps ~ 2e-14 of the largest term; 1e-10
# of the largest value leaves room for the card's reduction orders
PARAM_TOL = 1e-10
# the ActiveMeta bias forces, float32 through the kernels against float64
# through the plain versions, relative to the largest bias force: the
# bias force sums scale sqrt(vs) dc/dx / (2 beta) over neighbors; dc/dx
# carries the backward's float32 error (BAND_F_TOL, 1e-4 of the largest
# term) and 1/beta amplifies beta's own relative error (the energy bound
# below, 1e-3 where beta ~ 0.1), so 1e-2 of the largest bias force
META_F_TOL = 1e-2
MT_EPS = (0.15, 0.30)
# the multi-task growth's temperature: at 300 K the seeded model already
# spans the crystal's environments and the trip fired once in ~4,000
# steps on the H100, too rare for the stage to show its learning; at
# 600 K it fires within the first few hundred steps
MT_TEMPERATURE_K = 600


def replica_systems(R=REPLICAS):
    """``bench.py`` ``measure_replicas``'s walkers: copies of the bench
    snapshot, rattled and thermalized each from its own seed."""
    from ..system import maxwell_boltzmann_velocities
    from .soap_bench import bench_system

    out = []
    for r in range(R):
        s = bench_system()
        s.rattle(0.01, seed=100 + r)
        maxwell_boltzmann_velocities(s, TEMPERATURE_K, seed=200 + r)
        out.append(s)
    return out


def walker_cfg(cfg, r, n):
    """Walker ``r``'s rows of a stacked configuration, as its own."""
    sl = slice(r * n, (r + 1) * n)
    k = cfg.nbr_idx.shape[1]
    rev = cfg.nbr_rev
    if rev is not None:
        rev = rev[sl]
        rev = torch.where(rev >= 0, rev - r * n * k, rev)
    return cfg._replace(
        positions=cfg.positions[sl], numbers=cfg.numbers[sl],
        atom_mask=cfg.atom_mask[sl], nbr_idx=cfg.nbr_idx[sl] - r * n,
        nbr_off=cfg.nbr_off[sl], nbr_sidx=cfg.nbr_sidx[sl],
        nbr_mask=cfg.nbr_mask[sl], nbr_rev=rev)


def replica_rel_err(dyn):
    """The walkers of ``dyn`` (a ReplicaMD) stacked as its chunks stack
    them, float32 through the kernels, against each walker alone in
    float64 through the plain versions.  Returns (energy error, largest
    |E|, force error, the force scale ``BAND_F_TOL`` holds it to
    (``driver_bench.slot_scale`` of the stacked rows), the largest net
    |f|, the kernels' inputs on the stacked rows)."""
    from ..engine import _env_rvec
    from ..md.device_md import _sgpr_forces
    from .driver_bench import slot_scale

    eng = dyn.calc.engine
    ch = dyn._build_chain()
    cfg, ma, radii, vs = ch["cfg"], ch["ma"], ch["radii"], ch["vs"]
    R = len(dyn.systems)
    n = cfg.npad // R
    args = (eng.params, eng.exponent, False, ch["ks"])
    e32, f32, _ = _sgpr_forces(cfg.positions, cfg, ma, radii, vs, *args,
                               nimg=R)
    f64 = torch.float64
    e_ref, f_ref = [], []
    with plain_kernels():
        for r in range(R):
            one = walker_cfg(cfg, r, n)
            one = one._replace(positions=one.positions.to(f64),
                               cell=one.cell.to(f64))
            e, f, _ = _sgpr_forces(one.positions, one, ma, radii.to(f64),
                                   vs[r * n:(r + 1) * n].to(f64), *args)
            e_ref.append(e)
            f_ref.append(f)
    e_ref, f_ref = torch.stack(e_ref), torch.cat(f_ref)
    scale = slot_scale(cfg, ma, radii, vs, eng, ch["ks"])
    with torch.no_grad():
        rvec = _env_rvec(cfg.positions, cfg.cell, cfg).contiguous()
    rows = (rvec, cfg.nbr_sidx, cfg.nbr_mask & cfg.atom_mask[:, None], radii)
    return ((e32.to(f64) - e_ref).abs().max().item(),
            e_ref.abs().max().item(),
            (f32.to(f64) - f_ref).abs().max().item(), scale,
            f_ref.abs().max().item(), rows)


def meta_rel_err(calc, system, scale):
    """The ActiveMeta bias alone on ``system`` (the model's weights set to
    zero, so the fused step's energy is the bias): float32 through the
    kernels by ``md.device_md._sgpr_forces`` as ``DeviceMD`` calls it,
    against ``engine.meta_covloss_fn`` in float64 through the plain
    versions.  The energy's tolerance comes from this configuration's
    float64 betas: the Gram entries' float32 error (``KB_KE_TOL`` = 1e-5
    relative in ``chip_smoke.py``) moves c = ||choli k||^2 (~1) by at most
    dc = 2e-5, and beta = sqrt(1 - c) then by at most min(dc / (2 beta),
    sqrt(dc)), so the bias by scale * sum_i sqrt(vs_i) times that.
    Returns a dict of the numbers."""
    from ..engine import meta_covloss_fn, predict_fn
    from ..kernels import covloss_beta
    from ..md import device_md as dmd

    calc.calculate(system)
    chain = dmd.new_chain(calc, system, False, meta=True)
    cfg, ma, eng = chain["cfg"], chain["ma"], calc.engine
    zero = ma._replace(mu=torch.zeros_like(ma.mu))
    e32, f32, _ = dmd._sgpr_forces(
        cfg.positions, cfg, zero, chain["radii"], chain["vs"], eng.params,
        eng.exponent, False, chain["ks"], meta_scale=scale,
        meta_vs=chain["meta_vs"])
    f64 = torch.float64
    cfg64 = cfg._replace(positions=cfg.positions.to(f64),
                         cell=cfg.cell.to(f64))
    radii64 = chain["radii"].to(f64)
    vs_raw = torch.as_tensor(calc.model.vscale_for(cfg.numbers.cpu().numpy()),
                             dtype=f64, device=cfg.positions.device)
    with plain_kernels():
        e64, g64 = meta_covloss_fn(cfg64, ma, radii64, vs_raw, eng.params,
                                   eng.exponent, scale)
        cov = predict_fn(cfg64, ma, radii64, vs_raw, eng.params,
                         eng.exponent)[3]
    beta = covloss_beta(ma.choli, cov, torch.ones_like(vs_raw), ma.m_mask)
    n = len(system)
    beta = beta[:n].clamp(min=1e-6)
    meta_vs = chain["meta_vs"][:n].to(f64)
    dc = 2e-5
    dbeta = torch.minimum(0.5 * dc / beta, torch.full_like(beta, dc**0.5))
    e_tol = float(scale * (meta_vs.sqrt() * dbeta).sum())
    f_ref = -g64[:n]
    df = (f32[:n].to(f64) - f_ref).abs().max().item()
    return dict(e32=float(e32), e64=float(e64), e_err=abs(float(e32) - float(e64)),
                e_tol=e_tol, f_err=df, f_scale=f_ref.abs().max().item(),
                beta_min=beta.min().item(), beta_median=beta.median().item())


def committee_floor_err(calc, system, scale):
    """The committee's fused floor bias (``_committee_e`` with and without
    the bias, float32 through the kernels, one evaluation) against the
    host formula -scale * sum_i min_k beta_ki, each expert's beta from its
    own host covloss on the same configuration (an expert's species
    without a scale at 0, the bias's convention).  Returns (fused bias,
    host bias, SOAP launches of the fused evaluation, atoms)."""
    from ..calculator.active import ActiveCalculator
    from ..md import device_md as dmd
    from .driver_bench import launches, reset_launches

    calc._calc = None
    calc.calculate(system)
    chain = dmd.new_chain(calc, system, False, meta=True)
    cfg, eng = chain["cfg"], calc.engine
    args = (cfg.cell, cfg, chain["ma"], chain["radii"], chain["vs"],
            chain["mean_e"], eng.params, eng.exponent, chain["ks"])
    with torch.no_grad():
        e_plain = float(dmd._committee_e(cfg.positions, *args)[0][0])
    reset_launches()
    e_meta, _, _ = dmd._sgpr_forces(
        cfg.positions, cfg, chain["ma"], chain["radii"], chain["vs"],
        eng.params, eng.exponent, False, chain["ks"], chain["mean_e"],
        meta_scale=scale, meta_vs=chain["meta_vs"])
    e_meta = float(e_meta)
    got = launches()
    n = len(system)
    betas = []
    for m in dmd.committee_models(calc):
        ac = ActiveCalculator(covariance=m, calculator=None, logfile=None,
                              pckl=None, tape=None)
        ac._always_fetch_cov = True
        ac.calculate(system.copy())
        c = ac._host_c()
        vs = m.vscale_for(system.numbers)
        vs = np.where(np.isfinite(vs), vs, 0.0)
        betas.append(np.sqrt(np.clip(1.0 - c, 0.0, None)) * np.sqrt(vs))
    host = -scale * np.stack(betas).min(axis=0).sum()
    return e_meta - e_plain, float(host), got, n


def multitask_calc(logfile=None, device="cuda", dtype=None):
    """Two Lennard-Jones tasks at weights (0.7, 0.3) on the bench widths,
    the flagship's default thresholds."""
    from ..calculator.multitask import MultiTaskCalculator
    from ..calculator.oracles import LennardJones

    return MultiTaskCalculator(
        [LennardJones(epsilon=e, sigma=2.3, rc=6.0) for e in MT_EPS],
        weights=[0.7, 0.3], kernel_kw=dict(cutoff=6.0, lmax=3, nmax=3),
        logfile=logfile, pckl=None, tape=None, skin=SKIN, device=device,
        dtype=dtype)


def multitask_system():
    """A 256-atom fcc Cu cell (4 x 4 x 4 cubic cells), rattled."""
    from ..system import bulk_fcc

    s = bulk_fcc("Cu", 3.6).repeat((4, 4, 4))
    s.rattle(0.05, seed=21)
    return s


def multitask_learn(calc, system, wall_cap=30.0, chunk=20):
    """Learning under DeviceMD (``MT_TEMPERATURE_K``, 2 fs, friction
    0.02, the trip armed) until ``wall_cap`` seconds have passed, checked
    after every chunk; returns the stage's numbers."""
    from ..md.device_md import DeviceMD
    from ..system import maxwell_boltzmann_velocities

    system.calc = calc
    maxwell_boltzmann_velocities(system, MT_TEMPERATURE_K, seed=22)
    t0 = time.time()
    system.get_potential_energy()  # the model's seed
    seed_size = calc.size
    dyn = DeviceMD(system, calc, dt=2 * units.fs,
                   temperature_K=MT_TEMPERATURE_K, friction=0.02,
                   chunk=chunk, seed=23)
    if not dyn.check_beta:
        raise AssertionError("the uncertainty trip is not armed")
    while time.time() - t0 < wall_cap:
        dyn.run(chunk)
    return dict(steps=dyn.nsteps, wall_s=time.time() - t0, size=calc.size,
                seed_size=seed_size,
                positions_finite=bool(np.isfinite(system.positions).all()),
                forces_finite=bool(np.isfinite(calc.results["forces"]).all()))


def multitask_rel_err(calc, system):
    """The combined surface at the calculator's weights: float32 through
    the kernels as the device chain serves it (``_sgpr_forces`` with the
    staged mu, plus ``effective_shift``) against the host ``_predict`` in
    float64 through the plain versions.  Returns (energy error, force
    MAE, largest force error, task energies, the device's forces)."""
    from ..md import device_md as dmd

    calc._calc = None
    eng = calc.engine
    calc.calculate(system)
    chain = dmd.new_chain(calc, system, False)
    cfg = chain["cfg"]
    e32, f32, _ = dmd._sgpr_forces(cfg.positions, cfg, chain["ma"],
                                   chain["radii"], chain["vs"], eng.params,
                                   eng.exponent, False, chain["ks"])
    n = len(system)
    e32 = float(e32) + calc.model.effective_shift(calc.weights,
                                                  system.numbers)
    f32 = f32[:n].double().cpu().numpy()
    dtype = eng.dtype
    eng.dtype = torch.float64
    try:
        calc.cfg = None
        calc._make_cfg(system)
        with plain_kernels():
            res = dict(calc._predict())
    finally:
        eng.dtype = dtype
        calc.cfg = None
        calc._make_cfg(system)
    df = np.abs(f32 - res["forces"])
    return (abs(e32 - res["energy"]), float(df.mean()), float(df.max()),
            np.asarray(res["task_energies"]), f32)


def parametric_err(system, device="cuda"):
    """``ParametricCalculator`` with untrainable LJ terms (epsilon 0.15 eV,
    sigma 2.3 A, rc 6 A) on the card against ``MixtureLennardJones`` of
    the same form on the host.  Returns (energy error, |E|, largest force
    error, largest |f|)."""
    from ..calculator.oracles import MixtureLennardJones
    from ..calculator.parametric import ParametricCalculator, get_lj_terms

    pc = ParametricCalculator(get_lj_terms([(29, 29)], epsilon=0.15,
                                           sigma=2.3, rc=6.0,
                                           trainable=False),
                              rc=6.0, device=device)
    res = pc.calculate(system)
    ref = MixtureLennardJones({(29, 29): 0.15}, {(29, 29): 2.3},
                              rc=6.0).calculate(system)
    return (abs(res["energy"] - ref["energy"]), abs(ref["energy"]),
            float(np.abs(res["forces"] - ref["forces"]).max()),
            float(np.abs(ref["forces"]).max()))
