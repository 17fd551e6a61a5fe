"""The device mesh's workloads on a CUDA card (phase 12 of
``chip_smoke.py``) and the probes that read them.

The mesh is ``(2, 2)`` over the visible cards in turn (``cuda:i % cards``;
one H100 repeats ``cuda:0``).  Workloads, at full width:

  * serving: the bench model ``baselines/bench_model.pckl`` (lmax = nmax =
    3, rc = 6 A, m = 256) on the 1008-atom bench snapshot, served by
    ``ActiveCalculator(covariance=<model>, calculator=None, skin=1.2,
    mesh=...)``: predict, kernel_block on both routes, DeviceMD, NPT,
    FIRE (both cells), NEB and the fused ActiveMeta bias;
  * the committee of phase 9, restarted from its expert folders under the
    mesh, on the flagship's 1024-atom 4-species crystal;
  * learning: the OTF flagship (``tools/otf_bench.py``: the crystal, the
    Lennard-Jones mixture oracle, lmax = nmax = 3, rc = 6 A, the
    reference's thresholds) from seed under the mesh, wall-capped;
  * a mesh whose data axis adds rows (:func:`padded_md`): phase 5's
    model on the flagship crystal over a 3 x 1 mesh, DeviceMD's first
    chunk against the unsharded driver.

:func:`predict_diff` and :func:`eval_diff` hold a sharded evaluation
against the unsharded one on the same inputs (both float32 through the
kernels) to the tolerances below; :func:`evaluation_counter` checks that
every sharded force evaluation launches each SOAP kernel once per data
shard (``parallel/mesh.py``).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..parallel import mesh as pm
from . import driver_bench as db

MESH_SHAPE = (2, 2)
# sharded against unsharded, both float32 through the kernels on the same
# inputs.  The descriptors of a row are the same numbers on both paths
# (row-local kernels, the same displacements); what differs is the order
# of the sums.  Energy, eV per atom: both sum float64 per-atom energies
# whose terms total ~3.5e7 eV on the bench model (against |E| ~ 190 eV),
# in another order and block split: ~sqrt(N) eps 3.5e7 ~ 3e-7 eV, 3e-10
# eV/atom; 1e-8 leaves 30x.
MESH_E_TOL = 1e-8
# forces, relative to the largest per-slot term that the backward sums
# (driver_bench.slot_scale; the ratio to the largest |f| is printed
# beside it, not held: a committee's weighted forces cancel well below
# their slot terms): the inducing blocks' descriptor cotangents meet in
# float64 and are rounded once, as on the unsharded path, and a force
# row then sums ~2K float32 slot terms of the backward kernel (each
# within 1e-5 of the largest slot term on its own, chip_smoke
# F32_REL_TOL) by a scatter instead of the reverse-slot gather, in
# another order: ten times F32_REL_TOL, as KB_KF_TOL and BAND_F_TOL.
MESH_F_TOL = 1e-4
# the virial (or dE/deps): the same slot terms summed over every slot,
# as driver_bench.STRESS_REL_TOL bounds float32 against float64
MESH_V_TOL = db.STRESS_REL_TOL
# the covariance rows: float64 Gram products of the same descriptors
# with the inducing blocks in other orders, ~D eps ~ 1e-13 relative
MESH_COV_TOL = 1e-9
# beta = sqrt(1 - c) sqrt(vscale) with c a float64 sum of squares of
# choli @ k: an error dc moves beta by at most sqrt(dc vscale), so beta is
# held relative to its bound sqrt(vscale); dc ~ 1e-12 (choli entries of
# ~1e3 on the bench model) gives 1e-6, 1e-4 leaves 100x
MESH_BETA_TOL = 1e-4
# DeviceMD's first chunk under the mesh against without it, from the same
# state and Langevin noise: the forces it returns after MESH_CHUNK_STEPS
# steps, held to MESH_F_TOL of the largest slot term.  The two runs part
# by the force error alone: at MESH_F_TOL (1e-4 eV/A on a slot term of ~1
# eV/A) acting one way on a Cu atom for 5 steps of 2 fs it moves it by
# 1/2 (df/m) t^2 ~ 1e-6 A, which moves a force by ~1e-5 eV/A at a
# curvature of ~10 eV/A^2, a tenth of the tolerance
MESH_CHUNK_STEPS = 5


def traj_bound(slot, mass, duration, ulp):
    """``mesh_bench``'s largest position difference between the sharded
    and the single-device trajectory (same Langevin noise), in A: the
    drift of the lightest atom (``mass``, amu) under a force error at the
    MESH_F_TOL bound (of ``slot``, eV/A) acting one way for the whole run
    (``duration`` in ASE time units), 1/2 (MESH_F_TOL slot / mass) T^2,
    plus four roundings of a position (``ulp``, the spacing of the
    positions' type at their largest value; a velocity that differs in
    its last bits flips a position's last bit).  The actual force errors
    are ~1e-2 of MESH_F_TOL and change sign, so their effect, amplified
    along the run, stays below the bound."""
    return 0.5 * MESH_F_TOL * slot / mass * duration ** 2 + 4 * ulp


def card_mesh(shape=MESH_SHAPE, device="cuda"):
    from ..parallel.mesh_bench import mesh_devices

    return pm.make_mesh(*shape, devices=mesh_devices(device,
                                                     shape[0] * shape[1]))


def force_errs(f, f0, slot):
    """The largest force error relative to the largest slot term
    (``f``, held) and to the largest |f| (``f_net``, printed)."""
    df = (f - f0).abs().max().item()
    return dict(f=df / slot, f_net=df / f0.abs().max().item())


def _errs(e, f, v, cov, beta, ref, n, vs, live, slot):
    """Errors of (e, f, virial, cov, beta) against ``ref``, each relative
    to its scale (energy per atom)."""
    e0, f0, v0, cov0, b0 = ref
    return dict(e=abs(float(e) - float(e0)) / n, **force_errs(f, f0, slot),
                virial=((v - v0).abs().max() / v0.abs().max()).item(),
                cov=((cov - cov0).abs().max() / cov0.abs().max()).item(),
                beta=((beta - b0)[live].abs().max()
                      / torch.sqrt(vs.max())).item())


def within(errs):
    """The failed checks of an error dict (empty: all hold)."""
    tol = dict(e=MESH_E_TOL, f=MESH_F_TOL, virial=MESH_V_TOL,
               cov=MESH_COV_TOL, beta=MESH_BETA_TOL)
    return [k for k, v in errs.items() if k in tol and not v <= tol[k]]


def predict_diff(eng, cfg, ma, vscale, mesh):
    """``Engine.predict`` under ``mesh`` against the same engine without
    it, on the same configuration and model: the error dict."""
    saved = eng.mesh
    eng.mesh = None
    try:
        ref = eng.predict(cfg, ma, vscale)
        eng.mesh = mesh
        got = eng.predict(cfg, ma, vscale)
    finally:
        eng.mesh = saved
    n = int(cfg.atom_mask.sum())
    vs = torch.as_tensor(np.asarray(vscale), dtype=ref[0].dtype,
                         device=ref[0].device)
    slot = db.slot_scale(cfg, ma, eng.radii_table(), None, eng,
                         eng.kernel_space())
    return _errs(*got, ref, n, vs, cfg.atom_mask, slot)


def kernel_block_diff(eng, cfg, ma, mesh, method):
    """``Engine.kernel_block(method)`` under ``mesh`` against without it:
    (ke, kf, kv) errors relative to each block's largest value."""
    saved = eng.mesh
    eng.mesh = None
    try:
        ref = eng.kernel_block(cfg, ma, method=method)
        eng.mesh = mesh
        got = eng.kernel_block(cfg, ma, method=method)
    finally:
        eng.mesh = saved
    return [((g.double() - r.double()).abs().max() / r.abs().max()).item()
            for g, r in zip(got, ref)]


def eval_diff(chain, mesh, eng, virial=False, check_beta=True,
              meta_scale=None):
    """One force evaluation of a driver's chain (``device_md.new_chain``,
    unpadded) sharded over ``mesh`` against unsharded: (e, f, dE/deps or
    None, the trip scalar) errors.  ``virial``: the strain-carrying
    evaluation of NPT / variable-cell FIRE (anisotropic); ``meta_scale``:
    with the fused ActiveMeta bias (the chain's ``meta_vs``)."""
    from ..md.device_md import _sgpr_forces
    from ..md.device_npt import _sgpr_forces_virial

    cfg, p, ex = chain["cfg"], eng.params, eng.exponent
    ch = pm.pad_chain(chain, mesh)
    forces_fn = pm.mesh_chunk(
        ch["cfg"], ch["ma"], ch["radii"], ch["vs"], ch["oidx"], mesh, p, ex,
        check_beta, ch["ks"], ch["mean_e"], meta_scale, ch.get("meta_vs"),
        virial=virial, aniso=True).forces_fn
    n = int(cfg.atom_mask.sum())
    with torch.no_grad():
        if virial:
            ref = _sgpr_forces_virial(cfg.positions, cfg.cell, cfg,
                                      chain["ma"], chain["radii"],
                                      chain["vs"], p, ex, check_beta,
                                      aniso=True, ks=chain["ks"],
                                      mean_e=chain["mean_e"])
            got = forces_fn(ch["cfg"].positions, cfg.cell)
        else:
            ref = _sgpr_forces(cfg.positions, cfg, chain["ma"],
                               chain["radii"], chain["vs"], p, ex, check_beta,
                               chain["ks"], chain["mean_e"],
                               meta_scale=meta_scale,
                               meta_vs=chain.get("meta_vs"))
            got = forces_fn(ch["cfg"].positions)
    slot = db.slot_scale(cfg, chain["ma"], chain["radii"], chain["vs"], eng,
                         chain["ks"], chain["mean_e"])
    out = dict(e=abs(float(got[0]) - float(ref[0])) / n,
               **force_errs(got[1][:n], ref[1][:n], slot))
    if virial:
        out["virial"] = ((got[2] - ref[2]).abs().max()
                         / ref[2].abs().max()).item()
    vmax = float(torch.sqrt(chain["vs"].max()))
    out["beta"] = abs(float(got[-1]) - float(ref[-1])) / vmax
    return out


@contextlib.contextmanager
def chunk_outputs():
    """The (positions, forces) that each ``device_md.md_chunk`` call
    returns while the block runs, in order."""
    from ..md import device_md as dmd

    fn, got = dmd.md_chunk, []

    def recorded(*a, **k):
        out = fn(*a, **k)
        got.append((out[0], out[2]))
        return out

    dmd.md_chunk = recorded
    try:
        yield got
    finally:
        dmd.md_chunk = fn


@contextlib.contextmanager
def evaluation_counter(n_data):
    """Count the sharded force evaluations made while the block runs (the
    closures of ``parallel.mesh._sharded_forces_fn`` /
    ``_sharded_forces_virial_fn``) and those that did not launch each SOAP
    kernel exactly ``n_data`` times."""
    rec = dict(calls=0, off=0)
    made = (pm._sharded_forces_fn, pm._sharded_forces_virial_fn)

    def wrap(make):
        def maker(*a, **k):
            fn = make(*a, **k)

            def counted(*x, **y):
                before = db.launches()
                out = fn(*x, **y)
                after = db.launches()
                rec["calls"] += 1
                rec["off"] += any(after[key] - before[key] != n_data
                                  for key in after)
                return out

            return counted

        return maker

    pm._sharded_forces_fn, pm._sharded_forces_virial_fn = map(wrap, made)
    try:
        yield rec
    finally:
        pm._sharded_forces_fn, pm._sharded_forces_virial_fn = made


def learn(mesh, wall_cap=15.0, chunk=20):
    """The OTF flagship's growth from seed under ``mesh`` (DeviceMD, 400 K,
    2 fs, friction 0.05, the trip armed), stopped at ``wall_cap`` s: no
    model update starts past the cap.  Returns (numbers, calculator,
    system)."""
    from .. import units
    from ..calculator.active import ActiveCalculator
    from ..calculator.oracles import MixtureLennardJones
    from ..md.device_md import DeviceMD
    from ..system import maxwell_boltzmann_velocities
    from . import otf_bench as ob

    oracle = MixtureLennardJones(ob.EPS, ob.SIG, rc=ob.RC)
    ediff = 2 * units.kcal_mol
    calc = ActiveCalculator(
        covariance=None, calculator=oracle, logfile="mesh_active.log",
        pckl=None, tape=None,
        kernel_kw=dict(cutoff=ob.RC, lmax=ob.LMAX, nmax=ob.NMAX),
        ediff=ediff, ediff_tot=2 * ediff, fdiff=1.5 * ediff, noise_f=0.01,
        max_inducing=1024, skin=ob.SKIN, mesh=mesh, device=mesh.first)
    s = ob.make_lgps_system()
    s.calc = calc
    maxwell_boltzmann_velocities(s, 400, seed=13)
    dyn = DeviceMD(s, calc, dt=2 * units.fs, temperature_K=400, friction=0.05,
                   chunk=chunk, seed=14)
    t0 = time.time()
    update = calc.update

    def capped_update(*a, **k):
        if time.time() - t0 > wall_cap:
            return 0, 0
        return update(*a, **k)

    calc.update = capped_update
    steps = 0
    try:
        while time.time() - t0 <= wall_cap:
            dyn.run(chunk)
            steps += chunk
    finally:
        calc.update = update
    wall = time.time() - t0
    return (dict(steps=steps, wall_s=wall, ndata=calc.size[0],
                 m=calc.size[1], fp_calls=calc.event_counts["fp_calls"],
                 finite=bool(np.isfinite(s.positions).all())), calc, s)


def cl_md(model_folder, mesh_expr, steps=40, device="cuda"):
    """``cl.md`` with ``mesh = <mesh_expr>`` in ARGS, serving
    ``model_folder`` on the bench snapshot (device dynamics, 300 K, 2 fs,
    the calculator on ``device``, the mesh's first), in the working
    directory; returns the frames it wrote."""
    from .. import cl
    from ..cl import md as cl_md_mod
    from ..io.xyz import read_xyz
    from . import soap_bench as sb

    args = dict(covariance=model_folder, calculator=None, pckl=None,
                tape=None, logfile=None, skin=db.SKIN,
                calc_device=str(device))
    with open("ARGS", "w") as f:
        for k, v in args.items():
            f.write(f"{k} = {v!r}\n")
        f.write(f"mesh = {mesh_expr}\n")
    cl.refresh()
    if cl.ARGS.get("mesh") is None:
        raise AssertionError("cl: the ARGS mesh was not read")
    kwargs = cl.get_default_args(cl_md_mod.md)
    cl.update_args(kwargs)
    kwargs.update(dynamics="DEVICE", tem=300.0, dt=2.0, picos=-steps,
                  loginterval=steps // 2, trajectory="md.extxyz")
    cl_md_mod.md(sb.bench_system(), **kwargs)
    return read_xyz("md.extxyz")


# a mesh whose data axis adds rows: three data shards on the 1024-atom
# flagship crystal (1024 rows pad to 1026), DeviceMD's first chunk of
# PAD_STEPS steps at 400 K with a 0.3 A skin, so that the hot Li atoms
# breach it inside the chunk (the in-loop rebuild serves each breach with
# one host read)
PAD_SHAPE = (3, 1)
PAD_SKIN = 0.3
PAD_STEPS = 20


def padded_md(folder, mesh, thermostat, device="cuda", steps=PAD_STEPS,
              temperature_K=400.0, system=None):
    """DeviceMD (``thermostat``: "langevin" or "nhc") serving the model
    ``folder`` on ``system()`` (default the flagship crystal) for one
    chunk of ``steps`` steps, under ``mesh`` and without it, from the same
    state and noise.  Returns the numbers: the real, padded and
    mesh-padded row counts, each run's
    breach reads, the force errors of the chunk's last forces
    (:func:`force_errs` against the largest slot term), the largest
    position difference and its bound (:func:`traj_bound`)."""
    from .. import units
    from ..calculator.active import ActiveCalculator
    from ..md import device_md as dmd
    from ..system import maxwell_boltzmann_velocities
    from .otf_bench import make_lgps_system

    system = system or make_lgps_system
    runs = {}
    for label, m in (("unsharded", None), ("sharded", mesh)):
        calc = ActiveCalculator(covariance=folder, calculator=None,
                                skin=PAD_SKIN, logfile=None, pckl=None,
                                tape=None, device=device, mesh=m)
        s = system()
        s.calc = calc
        maxwell_boltzmann_velocities(s, temperature_K, seed=7)
        dyn = dmd.DeviceMD(s, calc, 2 * units.fs, temperature_K=temperature_K,
                           friction=0.05, chunk=steps, seed=8,
                           check_beta=False, thermostat=thermostat)
        reads = [0]
        host_read = dmd.host_read

        @contextlib.contextmanager
        def counted():
            reads[0] += 1
            with host_read():
                yield

        dmd.host_read = counted
        try:
            with chunk_outputs() as out:
                dyn.run(steps)
        finally:
            dmd.host_read = host_read
        chain = dyn._new_chain()
        runs[label] = dict(out=out, reads=reads[0], calc=calc, system=s,
                           rows=chain["cfg"].npad, nsteps=dyn.nsteps)
    u, sh = runs["unsharded"], runs["sharded"]
    calc, s = u["calc"], u["system"]
    n = len(s)
    eng = calc.engine
    chain = dmd.new_chain(calc, s, False)
    slot = db.slot_scale(chain["cfg"], chain["ma"], chain["radii"],
                         chain["vs"], eng, chain["ks"])
    (p0, f0), (p1, f1) = u["out"][-1], sh["out"][-1]
    errs = force_errs(f1[:n], f0[:n], slot)
    dpos = (p1[:n] - p0[:n]).abs().max().item()
    ulp = float(np.spacing(p0[:n].abs().max().cpu().numpy()))
    bound = traj_bound(slot, float(s.get_masses().min()),
                       steps * 2 * units.fs, ulp)
    return dict(thermostat=thermostat, natoms=n, rows=u["rows"],
                mesh_rows=sh["rows"], mesh=f"{mesh.shape['data']}x"
                f"{mesh.shape['model']}", steps=(u["nsteps"], sh["nsteps"]),
                chunks=(len(u["out"]), len(sh["out"])),
                breach_reads=(u["reads"], sh["reads"]), slot=slot, **errs,
                dpos=dpos, dpos_bound=bound)
