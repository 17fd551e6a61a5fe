"""The structure drivers' workloads on a CUDA card (phase 7 of
``chip_smoke.py``) and the probes that read them.

Workloads, all on the repo's trained Cu model ``baselines/bench_model.pckl``
(lmax = nmax = 3, rc = 6 A, zeta = 4) served by ``ActiveCalculator(
covariance=<model>, calculator=None, skin=1.2)``, at full width:

  * NVT: ``DeviceMD(thermostat="nhc")`` on the 1008-atom bench snapshot
    (``bench.make_system((6, 6, 7))``), 300 K, 2 fs, tdamp 50 fs;
  * NPT: ``bench.py``'s ``npt_1k`` — ``DeviceNPT`` isotropic, 300 K,
    0 GPa, 2 fs, tdamp 50 fs, pdamp 500 fs, chunk 100 — then the flexible
    cell with ``mask=(1, 1, 0)``;
  * FIRE: ``bench.py``'s ``relax_fire_1k`` — ``DeviceFIRE(dt=0.05,
    chunk=150)`` at fmax 1e-12 — then ``DeviceFIRE(cell=True)`` on the same
    tiling at a = 3.65 A;
  * NEB: a vacancy hop in fcc Cu (:func:`vacancy_hop`, 499 atoms), five
    interior images, ``DeviceNEB(k=0.1, climb=True, dt=0.05,
    maxstep=0.1)``; then the same hop with the last end point's cell
    strained along x and a cell per image (:func:`strained_band`).

:func:`stress_rel_err` holds the float32 strain gradient (the kernels)
against float64 (the plain versions) on the card, :func:`band_rel_err` the
stacked NEB band's float32 energies and forces against each image alone in
float64 (the forces relative to :func:`slot_scale`); :func:`chunk_probe`
counts a driver's chunks, steps and kernel launches and runs its first
chunk under CUDA's sync debug mode; :func:`evaluation_probe` checks that
every force evaluation launches each kernel once.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..descriptor import soap_kernels as sk

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL = os.path.join(ROOT, "baselines", "bench_model.pckl")
SKIN = 1.2

# float32 strain gradient dE/deps (the kernels) against float64 (the plain
# versions), relative to its largest component.  dE/deps = sum over the
# ~8e4 live slots of r (x) dE/dr: each term carries the backward kernel's
# float32 error (<= 1e-5 of the largest slot term, chip_smoke F32_REL_TOL,
# typically sqrt(K) eps ~ 1e-6), and the terms, of both signs and ~1e3 eV
# in all before they cancel to vol * stress (~10-100 eV on the snapshot),
# add their errors at random: sqrt(8e4) * 1e-6 * 1e3 / 8e4 ~ 4e-6 eV of
# each ~10 eV component, 1e-6 relative.  1e-4 leaves room for a stress
# two decades smaller than the snapshot's and for the float32 sums of the
# descriptor and Gram products ahead of it.
STRESS_REL_TOL = 1e-4
# the NEB band's energies and forces, float32 through the kernels on the
# stacked rows against float64 through the plain versions on each image
# alone.  Energy, relative to the largest |E| of an image: each atom's
# energy sums (p . x)^4 against the float64 weights, its float32
# descriptor ~sqrt(K) eps ~ 1e-6 relative (K ~ 80 live slots), the 4th
# power ~4e-6 of each term (KB_KE_TOL in chip_smoke.py bounds a Gram
# entry by 1e-5); the weights' signs cancel part of |E| but the atoms'
# errors add at random, so 1e-5 of |E| holds either way.  Forces,
# relative to the largest per-slot term that the backward sums, the
# largest |dE/d rvec| component over the live slots of the rows
# (:func:`slot_scale`): a force row sums ~2K slot terms of both signs from
# the backward kernel (each within 1e-5 of the largest slot term,
# chip_smoke F32_REL_TOL) through the power spectrum's backward, so ten
# times that, as KB_KF_TOL bounds the force columns.  The net |f| of a
# row is no scale for this error: the slot terms cancel to it, and on a
# relaxed band it falls to 0.25-0.6 eV/A while the float32 error stays
# ~3e-5 eV/A.
BAND_E_TOL = 1e-5
BAND_F_TOL = 1e-4


def serving_calc(device="cuda"):
    """The serving calculator of every workload (on the card unless
    ``device`` says otherwise)."""
    from ..calculator.active import ActiveCalculator

    return ActiveCalculator(covariance=MODEL, calculator=None, skin=SKIN,
                            logfile=None, pckl=None, tape=None, device=device)


def launches():
    return {"soap_coeff_fwd": sk.soap_coeff_fwd.launches,
            "soap_coeff_bwd": sk.soap_coeff_bwd.launches}


def reset_launches():
    sk.soap_coeff_fwd.launches = 0
    sk.soap_coeff_bwd.launches = 0


@contextlib.contextmanager
def plain_kernels():
    """Every SOAP-coefficient call goes to the plain torch versions (also
    on a CUDA tensor): the engine's direct calls (columns, the Jacobian
    route) and the descriptors' autograd Function alike.  The float64
    references of the card checks."""
    from .. import engine as engine_mod

    mods = (engine_mod, sk)
    saved = [(m.soap_coeff_fwd, m.soap_coeff_bwd) for m in mods]
    for m in mods:
        m.soap_coeff_fwd = sk.soap_coeff_fwd_plain
        m.soap_coeff_bwd = sk.soap_coeff_bwd_plain
    try:
        yield
    finally:
        for m, (f, b) in zip(mods, saved):
            m.soap_coeff_fwd, m.soap_coeff_bwd = f, b


def stress_rel_err(calc, system):
    """(largest |float32 - float64| of the anisotropic dE/deps, largest
    |dE/deps|, the float64 dE/deps) of ``_sgpr_forces_virial`` on
    ``system``: float32 through the kernels, float64 through the plain
    versions, both on the calculator's device."""
    from ..md.device_npt import _sgpr_forces_virial

    system.calc = calc
    system.get_potential_energy()
    cfg, eng = calc.cfg, calc.engine
    ma = calc.model.full_model_arrays()
    vs = torch.ones(cfg.npad, dtype=cfg.positions.dtype,
                    device=cfg.positions.device)
    args = (ma, eng.radii_table(), vs, eng.params, eng.exponent, False)
    _, _, d32, _ = _sgpr_forces_virial(cfg.positions, cfg.cell, cfg, *args,
                                       aniso=True)
    f64 = torch.float64
    cfg64 = cfg._replace(positions=cfg.positions.to(f64), cell=cfg.cell.to(f64))
    with plain_kernels():
        _, _, d64, _ = _sgpr_forces_virial(
            cfg64.positions, cfg64.cell, cfg64, ma, eng.radii_table().to(f64),
            vs.to(f64), eng.params, eng.exponent, False, aniso=True)
    err = (d32.to(f64) - d64).abs().max().item()
    return err, d64.abs().max().item(), d64.cpu().numpy()


def slot_scale(cfg, ma, radii, vs, eng, ks=None, mean_e=None, nimg=1):
    """The largest |dE/d rvec| component over the live neighbor slots of
    ``cfg``'s rows: the largest single term that the backward kernel sums
    into a force.  One autograd call of the float64 energy through the
    plain versions (the committee energy with ``mean_e``), with respect to
    the rows' displacement vectors."""
    from .. import engine as engine_mod
    from ..md.device_md import _committee_e

    f64 = torch.float64
    pos, cell, radii = cfg.positions.to(f64), cfg.cell.to(f64), radii.to(f64)
    with torch.no_grad():
        rvec = engine_mod._env_rvec(pos, cell, cfg)
    rvec = rvec.detach().requires_grad_(True)
    env_rvec = engine_mod._env_rvec
    # every displacement the energy reads is this leaf
    engine_mod._env_rvec = lambda *a, **k: rvec
    try:
        with plain_kernels(), torch.enable_grad():
            if mean_e is None:
                cov, _, _ = engine_mod._total_cov(
                    pos, cell, cfg, ma.X_desc, ma.X_num, ma.X_lone, radii,
                    eng.params, eng.exponent, ks=ks, pair_d=ma.pair_d,
                    pair_mask=ma.pair_mask)
                cov = cov * (cfg.atom_mask[:, None] & ma.m_mask[None, :])
                e = cov @ ma.mu
            else:
                e, _ = _committee_e(pos, cell, cfg, ma, radii, vs.to(f64),
                                    mean_e, eng.params, eng.exponent, ks,
                                    nimg=nimg)
            (g,) = torch.autograd.grad(e.sum(), rvec)
    finally:
        engine_mod._env_rvec = env_rvec
    live = cfg.nbr_mask & cfg.atom_mask[:, None]
    return g[live].abs().max().item()


def band_rel_err(band):
    """The interior images of ``band`` (a DeviceNEB) as its chunks see
    them: stacked as rows of one configuration, float32 through the
    kernels, against each image alone in float64 through the plain
    versions.  Returns (energy error, largest |E|, force error, the
    force scale ``BAND_F_TOL`` holds it to (:func:`slot_scale` of the
    stacked rows), the largest net |f| (printed beside it), the kernels'
    inputs on the stacked rows: rvec, sidx, mask, radii)."""
    from ..engine import _env_rvec
    from ..opt.device_neb import band_forces

    eng = band.calc.engine
    ch = band._build_chain()
    cfg, ma, radii, vs = ch["cfg"], ch["ma"], ch["radii"], ch["vs"]
    pos = ch["pos"][1:-1]
    mean_e = ch["mean_e"]
    e32, f32, _ = band_forces(pos, cfg, ma, radii, vs, eng.params,
                              eng.exponent, False, ch["ks"], mean_e)
    f64 = torch.float64
    n = pos.shape[1]
    e_ref, f_ref = [], []
    with plain_kernels():
        for r, one in enumerate(ch["interior"]):
            one = one._replace(positions=one.positions.to(f64),
                               cell=one.cell.to(f64))
            e, f, _ = band_forces(one.positions[None], one, ma, radii.to(f64),
                                  vs[..., r * n:(r + 1) * n].to(f64),
                                  eng.params, eng.exponent, False, ch["ks"],
                                  mean_e)
            e_ref.append(e)
            f_ref.append(f)
    e_ref, f_ref = torch.cat(e_ref), torch.cat(f_ref)
    scale = slot_scale(cfg, ma, radii, vs, eng, ch["ks"], mean_e,
                       nimg=pos.shape[0])
    with torch.no_grad():
        rvec = _env_rvec(cfg.positions, cfg.cell, cfg).contiguous()
    rows = (rvec, cfg.nbr_sidx, cfg.nbr_mask & cfg.atom_mask[:, None], radii)
    return ((e32.to(f64) - e_ref).abs().max().item(),
            e_ref.abs().max().item(),
            (f32.to(f64) - f_ref).abs().max().item(), scale,
            f_ref.abs().max().item(), rows)


@contextlib.contextmanager
def chunk_probe(module, name, ndone_at):
    """Wrap the chunk function ``module.name`` while a driver runs: count
    its calls, the steps they did (``out[ndone_at]``) and the SOAP kernel
    launches inside them, and run the first call under CUDA's sync debug
    mode "error" — any wait for the card inside a chunk raises, except
    the documented breach reads (``md.device_md.host_read``).  The step
    count is read after each call, which waits for the chunk to finish:
    ``wall`` sums the calls' elapsed time to that point."""
    import time

    fn = getattr(module, name)
    rec = dict(calls=0, steps=0, soap_coeff_fwd=0, soap_coeff_bwd=0,
               sync_checked=False, wall=0.0)

    def wrapped(*a, **k):
        t0 = time.time()
        before = launches()
        check = not rec["sync_checked"] and torch.cuda.is_available()
        if check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(*a, **k)
        finally:
            if check:
                torch.cuda.set_sync_debug_mode(0)
        rec["sync_checked"] = rec["sync_checked"] or check
        after = launches()
        for key in before:
            rec[key] += after[key] - before[key]
        rec["calls"] += 1
        rec["steps"] += int(out[ndone_at])
        rec["wall"] += time.time() - t0
        return out

    setattr(module, name, wrapped)
    try:
        yield rec
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def evaluation_probe(module, name):
    """Wrap the force function ``module.name`` (one evaluation of a
    configuration or a band per call) while a driver runs: count its calls
    and the calls that did not launch exactly one of each SOAP kernel.
    Every call counts, the steps the loop issued ahead of its stop too."""
    fn = getattr(module, name)
    rec = dict(calls=0, off=0)

    def wrapped(*a, **k):
        before = launches()
        out = fn(*a, **k)
        after = launches()
        rec["calls"] += 1
        rec["off"] += any(after[key] - before[key] != 1 for key in after)
        return out

    setattr(module, name, wrapped)
    try:
        yield rec
    finally:
        setattr(module, name, fn)


def profile_window(run, steps):
    """(device kernels per step, device microseconds per step) of
    ``run()`` doing ``steps`` steps, traced with torch.profiler; (None,
    None) when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not us:
        return None, None
    return len(us) / steps, sum(us) / steps


def vacancy_hop(reps=(5, 5, 5)):
    """End points of a vacancy hop in fcc Cu: the crystal with atom 0
    removed, and the same with atom 0's nearest neighbor moved into the
    hole (unrelaxed)."""
    from ..system import bulk_fcc

    s = bulk_fcc("Cu", 3.6).repeat(reps)
    hole = s.positions[0].copy()
    first = s.permuted(np.arange(1, len(s)))
    d = first.positions - hole
    d -= np.round(d @ np.linalg.inv(first.cell)) @ first.cell
    j = int(np.argmin((d * d).sum(1)))
    last = first.copy()
    pos = last.positions.copy()
    pos[j] = hole
    last.set_positions(pos)
    return first, last


def strained_band(first, last, nimages, strain=0.01):
    """A band from ``first`` to ``last`` whose cells differ: the last end
    point's cell stretched by ``strain`` along x (its atoms scaled with
    it), and each image's cell and fractional coordinates interpolated
    linearly between the ends, so the positions scale with the cells."""
    last = last.copy()
    cell = np.asarray(last.cell).copy()
    cell[:, 0] *= 1.0 + strain
    last.set_cell(cell, scale_atoms=True)
    f0, f1 = first.scaled_positions(), last.scaled_positions()
    c0, c1 = np.asarray(first.cell), np.asarray(last.cell)
    images = []
    for k in range(nimages):
        t = k / (nimages - 1)
        im = first.copy()
        c = (1 - t) * c0 + t * c1
        im.set_cell(c)
        im.set_positions(((1 - t) * f0 + t * f1) @ c)
        images.append(im)
    return images
