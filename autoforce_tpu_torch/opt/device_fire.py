"""Device-resident structure relaxation: FIRE on the GPU (port of
``autoforce_tpu/opt/device_fire.py``), on one SGPR model or a committee.

The whole FIRE loop — forces (SGPR predict), the velocity-mixing update,
the adaptive (dt, alpha) schedule and the convergence test — runs as
eager device steps through :func:`..md.device_md.drive`; the host is
re-entered only when

  * the max force drops below the target (converged),
  * the covloss uncertainty trips (active learning samples at the exact
    geometry, reference per-evaluation semantics),
  * the Verlet skin is breached and the in-loop rebuild cannot serve it
    (bucket overflow), or
  * the step budget is exhausted.

The convergence test is an on-device flag like the other exits: the host
reads fmax once per chunk, never per iteration.  The step math is exactly
opt/fire.FIRE.step (branches as ``torch.where``), so device trajectories
equal the host optimizer's to float rounding; convergence is checked
before each step like Optimizer.run.  ``cell=True`` runs the
opt/filters.UnitCellFilter composition on the card, the strain rows'
forces taken from the same backward pass as the atom forces.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import device_fetch
from ..md.device_md import (_go, _graft, _inloop_table, _sgpr_forces,
                            check_plain_surface, drive, mesh_chain,
                            new_chain, padded_rows, skin_table)
from ..md.device_npt import (_sgpr_forces_virial, _table_omax,
                             moving_skin_table)
from ..neighbors_device import det3, inv3
from ..profiling import span


def _fire_update(f, v, dt, a, n_uphill, fire, m, extra=()):
    """The velocity mixing and (dt, alpha, n_uphill) schedule of
    opt/fire.FIRE.step over a vector made of the masked rows of ``f`` /
    ``v`` (mask ``m``) and the ``extra`` (force, velocity) blocks (the
    scaled deformation rows of the variable-cell FIRE).  Returns (v,
    extra velocities, dt, a, n_uphill); the position update is the
    caller's."""
    vf = ((f * v) * m).sum()
    fn2 = ((f * f) * m).sum()
    vn2 = ((v * v) * m).sum()
    for fe, ve in extra:
        vf = vf + (fe * ve).sum()
        fn2 = fn2 + (fe * fe).sum()
        vn2 = vn2 + (ve * ve).sum()
    up = vf > 0
    fn = torch.sqrt(fn2)
    vn = torch.sqrt(vn2)
    if extra:
        mixs = a * vn / (fn + 1e-30)
        v_mix = (1.0 - a) * v + mixs * f
        vex = [(1.0 - a) * ve + mixs * fe for fe, ve in extra]
    else:
        v_mix = (1.0 - a) * v + a * (f / (fn + 1e-30)) * vn
        vex = []
    v = torch.where(up, v_mix, torch.zeros_like(v))
    vex = [torch.where(up, x, torch.zeros_like(x)) for x in vex]
    inc = up & (n_uphill > fire["nmin"])
    dt = torch.where(inc, (dt * fire["finc"]).clamp(max=fire["dtmax"]),
                     torch.where(up, dt, dt * fire["fdec"]))
    a = torch.where(inc, a * fire["fa"],
                    torch.where(up, a, torch.full_like(a, fire["astart"])))
    n_uphill = torch.where(up, n_uphill + 1, torch.zeros_like(n_uphill))
    v = v + dt * f
    vex = [x + dt * fe for x, (fe, _) in zip(vex, extra)]
    return v, vex, dt, a, n_uphill


def fire_chunk(
    cfg,
    model,
    radii,
    vscale_atom,
    v,  # (N, 3) FIRE velocity (optimizer state, not physical)
    pos0,  # positions at neighbor-table build time
    dt,  # current adaptive step (0-d, carried across chunks)
    a,  # current mixing alpha (0-d)
    n_uphill,  # uphill (power > 0) step counter (0-d)
    skin_half,
    fmax_target,
    beta_thresh,
    nsteps,
    fire,  # dict maxstep, dtmax, nmin, finc, fdec, astart, fa (floats)
    params=None,
    exponent=4,
    check_beta=True,
    rebuild=False,  # in-loop neighbor rebuild at skin breaches
    rebuild_cut=None,
    sidx_atom=None,
    sidx_ok=None,
    ks=None,  # the engine's kernel space (Engine.kernel_space())
    mean_e=None,  # (E,) expert mean energies: ``model`` is a committee
    mesh=None,  # a device mesh (parallel.mesh): cfg, model mesh-padded
    own_idx=None,  # the mesh's row ids (parallel.mesh.mesh_pad)
):
    """Up to ``nsteps`` FIRE steps on the device; early exit on
    convergence (fmax < fmax_target, checked before stepping like
    Optimizer.run), an uncertainty trip, or an unserviceable skin breach.
    Returns (pos, v, f, e, beta_max, fmax, dt, a, n_uphill, ndone[, tbl,
    pos0]).  With ``mesh`` the forces are sharded
    (``parallel.mesh.mesh_chunk``, the JAX package's
    ``sharded_fire_chunk``), the table returned the whole
    configuration's."""
    whole = None
    if mesh is not None:
        from ..parallel.mesh import mesh_chunk

        forces_fn, tbl0, rebuild_fn, whole, _ = mesh_chunk(
            cfg, model, radii, vscale_atom, own_idx, mesh, params, exponent,
            check_beta, ks, mean_e, rebuild=rebuild, rebuild_cut=rebuild_cut,
            sidx_atom=sidx_atom, sidx_ok=sidx_ok)
    else:
        cfg_with, tbl0, rebuild_fn = _inloop_table(
            cfg, rebuild, rebuild_cut, sidx_atom, sidx_ok
        )

        def forces_fn(pos, tbl):
            return _sgpr_forces(pos, cfg_with(tbl), model, radii,
                                vscale_atom, params, exponent, check_beta,
                                ks, mean_e)

    with torch.no_grad():
        st = _fire_loop(
            forces_fn, cfg.positions, cfg.atom_mask[:, None], v, pos0, dt, a,
            n_uphill, float(skin_half), float(fmax_target),
            float(beta_thresh), int(nsteps), fire, check_beta, tbl0=tbl0,
            rebuild_fn=rebuild_fn,
        )
    out = (st["pos"], st["v"], st["f"], st["e"], st["beta"], st["fmax"],
           st["dt"], st["a"], st["nu"], st["i"])
    if rebuild:
        out = out + (st["tbl"] if whole is None else whole(st["tbl"]),
                     st["pos0"])
    return out


def _fire_loop(forces_fn, positions, amask, v, pos0, dt, a, n_uphill,
               skin_half, fmax_target, beta_thresh, nsteps, fire, check_beta,
               tbl0=None, rebuild_fn=None):
    """The FIRE loop.  ``forces_fn(pos, tbl) -> (e, f, beta_max)``;
    ``rebuild_fn(pos) -> (tbl, ok)`` enables in-loop table rebuilds.  The
    JAX loop rebuilds between the move and the forces; here a step
    evaluates the forces with the table it has, and a breach (which ends
    the run of steps) has them recomputed with the rebuilt table at the
    same positions — the same state.  Returns the final state dict."""

    breach, with_rebuild = skin_table(amask, skin_half, rebuild_fn)

    def fmax_of(f):
        return torch.sqrt(((f * f) * amask).sum(-1).max())

    def forces(pos, tbl):
        e, f, beta = forces_fn(pos, tbl)
        return dict(e=e, f=f, beta=beta, fmax=fmax_of(f))

    def step(st, it):
        v, vex, dt, a, nu = _fire_update(st["f"], st["v"], st["dt"], st["a"],
                                         st["nu"], fire, amask)
        dr = dt * v
        norm = torch.sqrt((dr * dr).sum(dim=1).max())
        dr = dr * torch.where(norm > fire["maxstep"],
                              fire["maxstep"] / (norm + 1e-30),
                              torch.ones_like(norm))
        pos = st["pos"] + dr * amask
        out = forces(pos, st["tbl"])
        out.update(pos=pos, v=v, dt=dt, a=a, nu=nu,
                   ok=~breach(pos, st["pos0"]))
        return out

    def rebuild(st):
        out = with_rebuild(st["pos"], st["tbl"], st["pos0"])
        out.update(forces(st["pos"], out["tbl"]))
        return out

    st = dict(pos=positions, v=v, dt=dt, a=a, nu=n_uphill, tbl=tbl0,
              pos0=pos0,
              i=torch.zeros((), dtype=torch.int64, device=positions.device))
    with span("af.chunk_start"):
        if rebuild_fn is not None:
            st.update(with_rebuild(positions, tbl0, pos0))
        else:
            st["ok"] = ~breach(positions, pos0)
        st.update(forces(positions, st["tbl"]))
    go = _go(nsteps, beta_thresh if check_beta else None, fmax_target)
    return drive(st, step, go, nsteps,
                 rebuild=rebuild if rebuild_fn is not None else None)


def fire_cell_chunk(
    cfg,
    model,
    radii,
    vscale_atom,
    v,  # (N, 3) FIRE velocity of the (undeformed) positions
    v_def,  # (3, 3) FIRE velocity of the scaled deformation rows
    deform,  # (3, 3) current deformation gradient
    cell0,  # (3, 3) reference cell (deform applies to it)
    pos0,  # (N, 3) real-coordinate table-build origin
    tbl_cell,  # (3, 3) cell the incoming table was built with
    offmax,  # max Sum|off| of the incoming table (0-d)
    dt,
    a,
    n_uphill,
    skin_half,
    fmax_target,
    beta_thresh,
    nsteps,
    cell_factor,
    pressure,  # external scalar pressure (eV/A^3)
    fire,
    params=None,
    exponent=4,
    check_beta=True,
    rebuild=False,
    rebuild_cut=None,
    sidx_atom=None,
    sidx_ok=None,
    ks=None,
    mean_e=None,  # (E,) expert mean energies: ``model`` is a committee
    mesh=None,  # a device mesh (parallel.mesh): cfg, model mesh-padded
    own_idx=None,  # the mesh's row ids (parallel.mesh.mesh_pad)
):
    """Variable-cell FIRE on the device: the exact opt/filters.
    UnitCellFilter + opt/fire.FIRE composition — positions in the
    undeformed frame plus 3 scaled deformation rows form ONE optimization
    vector; the strain rows' forces are -vol*(stress + P*I)/cell_factor,
    with the stress tensor from the same backward pass as the forces
    (md/device_npt._sgpr_forces_virial, aniso).  Table validity under the
    moving cell uses the NPT loop's displacement + image-drift metric.
    cfg.positions are REAL coordinates (pos_und @ deform.T).  Returns
    (pos_real, v, v_def, deform, f, e, beta_max, fmax, dt, a, n_uphill,
    ndone[, tbl, pos0, tbl_cell, offmax]).  With ``mesh`` the forces and
    stress are sharded (``parallel.mesh.mesh_chunk``, the JAX package's
    ``sharded_fire_cell_chunk``), a rebuilt table's lever arm the max over
    the shards, the table returned the whole configuration's."""
    whole, omax_of = None, _table_omax
    if mesh is not None:
        from ..parallel.mesh import mesh_chunk

        forces_fn, tbl0, rebuild_fn, whole, omax_of = mesh_chunk(
            cfg, model, radii, vscale_atom, own_idx, mesh, params, exponent,
            check_beta, ks, mean_e, virial=True, aniso=True, rebuild=rebuild,
            rebuild_cut=rebuild_cut, sidx_atom=sidx_atom, sidx_ok=sidx_ok)
    else:
        cfg_with, tbl0, rebuild_fn = _inloop_table(
            cfg, rebuild, rebuild_cut, sidx_atom, sidx_ok
        )

        def forces_fn(pos, cell, tbl):
            return _sgpr_forces_virial(pos, cell, cfg_with(tbl), model,
                                       radii, vscale_atom, params, exponent,
                                       check_beta, aniso=True, ks=ks,
                                       mean_e=mean_e)

    with torch.no_grad():
        st = _fire_cell_loop(
            forces_fn, cfg.positions, cfg.atom_mask[:, None], v, v_def,
            deform, cell0, pos0, tbl_cell, offmax, dt, a, n_uphill,
            float(skin_half), float(fmax_target), float(beta_thresh),
            int(nsteps), float(cell_factor), float(pressure), fire,
            check_beta, tbl0=tbl0, rebuild_fn=rebuild_fn,
            rebuild_cut=rebuild_cut, omax_of=omax_of,
        )
    amask = cfg.atom_mask[:, None]
    deform_f = st["defc"] / float(cell_factor)
    pos_real = st["pu"] @ deform_f.T * amask
    out = (pos_real, st["v"], st["vd"], deform_f, st["fu"], st["e"],
           st["beta"], st["fmax"], st["dt"], st["a"], st["nu"], st["i"])
    if rebuild:
        tbl = st["tbl"] if whole is None else whole(st["tbl"])
        out = out + (tbl, st["pos0"], st["tcell"], st["omax"])
    return out


def _fire_cell_loop(forces_fn, positions, amask, v, v_def, deform, cell0,
                    pos0, tbl_cell, offmax, dt, a, n_uphill, skin_half,
                    fmax_target, beta_thresh, nsteps, cell_factor, pressure,
                    fire, check_beta, tbl0=None, rebuild_fn=None,
                    rebuild_cut=None, omax_of=_table_omax):
    """The variable-cell FIRE loop.  ``forces_fn(pos, cell, tbl) -> (e,
    f_real, deps = vol*stress, beta_max)``; ``rebuild_fn(pos, cell) ->
    (tbl, ok)`` enables in-loop table rebuilds (``omax_of``:
    ``md.device_npt.moving_skin_table``).  Returns the final state dict
    (``pu``: undeformed positions, ``defc``: deform * cell_factor)."""
    eye = torch.eye(3, dtype=positions.dtype, device=positions.device)
    breach, with_rebuild = moving_skin_table(amask, skin_half, rebuild_fn,
                                             rebuild_cut, omax_of)

    def frame(pu, defc):
        """Real positions and cell of the optimization vector."""
        deform = defc / cell_factor
        return pu @ deform.T * amask, cell0 @ deform.T, deform

    def eval_all(pu, defc, tbl):
        pos, cell, deform = frame(pu, defc)
        e, f, deps, beta = forces_fn(pos, cell, tbl)
        vol = det3(cell).abs()
        fu = (f @ deform) * amask
        fd = (-deps - pressure * vol * eye) / cell_factor
        fmax = torch.sqrt(torch.maximum(((fu * fu) * amask).sum(-1).max(),
                                        (fd * fd).sum(-1).max()))
        return dict(e=e, fu=fu, fd=fd, beta=beta, fmax=fmax)

    def step(st, it):
        # FIRE over the stacked (positions + scaled-deform) vector
        v, (vd,), dt, a, nu = _fire_update(
            st["fu"], st["v"], st["dt"], st["a"], st["nu"], fire, amask,
            extra=((st["fd"], st["vd"]),))
        dr = dt * v
        dr_def = dt * vd
        norm = torch.sqrt(torch.maximum(((dr * dr) * amask).sum(-1).max(),
                                        (dr_def * dr_def).sum(-1).max()))
        sc = torch.where(norm > fire["maxstep"],
                         fire["maxstep"] / (norm + 1e-30),
                         torch.ones_like(norm))
        pu = st["pu"] + sc * dr * amask
        defc = st["defc"] + sc * dr_def
        pos, cell, _ = frame(pu, defc)
        out = eval_all(pu, defc, st["tbl"])
        out.update(pu=pu, defc=defc, v=v, vd=vd, dt=dt, a=a, nu=nu,
                   ok=~breach(pos, st["pos0"], cell, st["tcell"],
                              st["omax"]))
        return out

    def rebuild(st):
        pos, cell, _ = frame(st["pu"], st["defc"])
        out = with_rebuild(pos, cell, st["tbl"], st["pos0"], st["tcell"],
                           st["omax"])
        out.update(eval_all(st["pu"], st["defc"], out["tbl"]))
        return out

    # initial state: real positions -> undeformed frame
    pu0 = positions @ inv3(deform) * amask
    st = dict(pu=pu0, defc=deform * cell_factor, v=v, vd=v_def, dt=dt, a=a,
              nu=n_uphill, tbl=tbl0, pos0=pos0, tcell=tbl_cell, omax=offmax,
              i=torch.zeros((), dtype=torch.int64, device=positions.device))
    cell = cell0 @ deform.T
    with span("af.chunk_start"):
        if rebuild_fn is not None:
            st.update(with_rebuild(positions, cell, tbl0, pos0, tbl_cell,
                                   offmax))
        else:
            st["ok"] = ~breach(positions, pos0, cell, tbl_cell, offmax)
        st.update(eval_all(st["pu"], st["defc"], st["tbl"]))
    go = _go(nsteps, beta_thresh if check_beta else None, fmax_target)
    return drive(st, step, go, nsteps,
                 rebuild=rebuild if rebuild_fn is not None else None)


class DeviceFIRE:
    """Chunked on-device FIRE relaxation around an (inference or active)
    calculator — the geometry-optimization sibling of
    :class:`..md.device_md.DeviceMD`.

    Matches opt/fire.FIRE's schedule exactly (same defaults); active
    learning keeps reference semantics: the chunk stops at the exact
    geometry where the covloss threshold trips, the host samples, and
    relaxation resumes on the updated model.  ``cell=True`` relaxes the
    cell too (the opt/filters.UnitCellFilter composition on the card).
    A committee calculator is served on the card as in DeviceMD.  Under
    ``calc.engine.mesh`` the chunks run sharded (``fire_chunk`` /
    ``fire_cell_chunk`` with ``mesh=``)."""

    def __init__(self, system, calc, dt=0.1, maxstep=0.2, dtmax=1.0, nmin=5,
                 finc=1.1, fdec=0.5, astart=0.1, fa=0.99, logfile=None,
                 chunk=50, check_beta=None, in_loop_rebuild=True,
                 cell=False, scalar_pressure=0.0, cell_factor=None):
        check_plain_surface(calc, "DeviceFIRE")
        self.system = system
        self.calc = calc
        self.params = dict(dt=float(dt), maxstep=float(maxstep),
                           dtmax=float(dtmax), nmin=float(nmin),
                           finc=float(finc), fdec=float(fdec),
                           astart=float(astart), fa=float(fa))
        self.logfile = logfile
        self.chunk = int(chunk)
        self.check_beta = (
            check_beta if check_beta is not None else calc.active
        )
        self.in_loop_rebuild = bool(in_loop_rebuild)
        self.nsteps = 0
        self.cell = bool(cell)
        self.pressure = float(scalar_pressure)
        self.cell_factor = float(cell_factor or len(system))
        self.cell0 = np.asarray(system.cell).copy()
        self.deform = np.eye(3)
        self._v_def = np.zeros((3, 3))
        # optimizer state (persists across run() calls like opt/fire.FIRE)
        self.dt_cur = float(dt)
        self.a = float(astart)
        self.n_uphill = 0.0
        self.fmax = float("inf")  # max |F| after the last chunk
        self._v = None
        self._stall = 0
        self._committee = {}  # committee_stack's staging across chains
        self.mesh = getattr(calc.engine, "mesh", None)

    def log(self, fmax, e):
        if self.logfile:
            with open(self.logfile, "a") as f:
                f.write(f"DeviceFIRE step {self.nsteps} "
                        f"E={e:.6f} fmax={fmax:.4f}\n")

    def _new_chain(self):
        from ..neighbors_device import device_rebuild_ok

        calc, system = self.calc, self.system
        chain = mesh_chain(new_chain(calc, system, self.check_beta,
                                     self._committee), self.mesh)
        cfg = chain["cfg"]
        like = chain["pos0"]
        # (re)build the FIRE velocity at the chain's padding: a sampling
        # event can grow npad
        chain["v"] = padded_rows(
            np.zeros((len(system), 3)) if self._v is None else self._v,
            cfg.npad, like)
        chain["inloop"] = self.in_loop_rebuild and device_rebuild_ok(
            system.cell, system.pbc, chain["cut"])
        if self.cell:
            off = np.abs(cfg.nbr_off.cpu().numpy().astype(np.int64)).sum(-1)
            msk = cfg.nbr_mask.cpu().numpy()

            def t(a):
                return torch.as_tensor(np.asarray(a, dtype=float),
                                       dtype=like.dtype, device=like.device)

            chain["offmax"] = t(float(off[msk].max()) if msk.any() else 0.0)
            # the table was just built with the system's cell
            chain["tbl_cell"] = t(system.cell)
            chain["cell0"] = t(self.cell0)
        return chain

    def _sync_host(self, pos_dev):
        system = self.system
        if self.cell:
            system.set_cell(self.cell0 @ self.deform.T)
        (p_h,) = device_fetch(pos_dev)
        system.set_positions(p_h[: len(system)])

    def _host_step(self, pos_dev):
        """One host FIRE step: no progress even after a host visit (e.g.
        the device beta stays marginally above the threshold while host
        sampling declines)."""
        from .filters import UnitCellFilter
        from .fire import FIRE

        system, calc, p = self.system, self.calc, self.params
        self._sync_host(pos_dev)
        system.calc = calc
        if self.cell:
            target = UnitCellFilter(system, scalar_pressure=self.pressure,
                                    cell_factor=self.cell_factor)
            target.cell0 = self.cell0.copy()
            target.deform = self.deform.copy()
        else:
            target = system
        opt = FIRE(target, dt=p["dt"], maxstep=p["maxstep"],
                   dtmax=p["dtmax"], nmin=int(p["nmin"]), finc=p["finc"],
                   fdec=p["fdec"], astart=p["astart"], fa=p["fa"])
        opt.dt = self.dt_cur
        opt.a = self.a
        opt.n_uphill = int(self.n_uphill)
        if self._v is not None:
            opt.v = (np.concatenate([self._v, self._v_def]) if self.cell
                     else self._v.copy())
        opt.step(target.get_forces())
        self.dt_cur = opt.dt
        self.a = opt.a
        self.n_uphill = float(opt.n_uphill)
        if self.cell:
            self._v = opt.v[:-3].copy()
            self._v_def = opt.v[-3:].copy()
            self.deform = target.deform.copy()
        else:
            self._v = opt.v.copy()

    def run(self, fmax=0.05, steps=1000):
        """Relax until max|F| < fmax or the step budget runs out; returns
        True on convergence (host Optimizer.run contract)."""
        calc = self.calc
        system = self.system
        eng = calc.engine
        done = 0
        first = True
        need_host = True
        pos_dev = v_dev = None
        chain = None
        converged = False
        while done < steps and not converged:
            if pos_dev is None or need_host or chain is None:
                if pos_dev is not None:
                    self._sync_host(pos_dev)
                    (v_h,) = device_fetch(v_dev)
                    self._v = v_h[: len(system)]
                    pos_dev = None
                if first or (self.check_beta and need_host):
                    system.calc = calc
                    system.get_potential_energy()
                    first = False
                else:
                    calc.system = system
                    calc._make_cfg(system)
                chain = self._new_chain()
                v_dev = chain["v"]
            else:
                chain["cfg"] = chain["cfg"]._replace(positions=pos_dev)

            n = min(self.chunk, steps - done)
            like = chain["pos0"]

            def t(x):
                return torch.as_tensor(np.asarray(x, dtype=float),
                                       dtype=like.dtype, device=like.device)

            inloop_kw = {}
            if chain["inloop"]:
                inloop_kw = dict(rebuild=True, rebuild_cut=chain["cut"],
                                 sidx_atom=chain["sidx_atom"],
                                 sidx_ok=chain["sidx_ok"])
            common = (t(self.dt_cur), t(self.a), t(self.n_uphill), 0.5 * calc._nlcache.skin, fmax,
                      chain["beta_thresh"], n)
            kw = dict(params=eng.params, exponent=eng.exponent,
                      check_beta=self.check_beta, ks=chain["ks"],
                      mean_e=chain["mean_e"], mesh=self.mesh,
                      own_idx=chain.get("oidx"), **inloop_kw)
            if self.cell:
                out = fire_cell_chunk(
                    chain["cfg"], chain["ma"], chain["radii"], chain["vs"],
                    v_dev, t(self._v_def), t(self.deform),
                    chain["cell0"], chain["pos0"], chain["tbl_cell"],
                    chain["offmax"], *common, self.cell_factor,
                    self.pressure, self.params, **kw,
                )
                (pos, v, vd, deform, f, e, beta_max, fmax_cur, dtc, a, nu,
                 i) = out[:12]
                if chain["inloop"]:
                    tbl, p0, tcell, omax = out[12:]
                    chain["tbl_cell"] = tcell
                    chain["offmax"] = omax
                extra = (vd, deform)
            else:
                out = fire_chunk(
                    chain["cfg"], chain["ma"], chain["radii"], chain["vs"],
                    v_dev, chain["pos0"], *common, self.params, **kw,
                )
                pos, v, f, e, beta_max, fmax_cur, dtc, a, nu, i = out[:10]
                if chain["inloop"]:
                    tbl, p0 = out[10:]
                extra = ()
            if chain["inloop"]:
                chain["cfg"] = _graft(chain["cfg"], tbl)
                chain["pos0"] = p0
            # one host read for every boundary scalar (and the cell state)
            got = device_fetch(dtc, a, nu, i.to(torch.int32), fmax_cur, e,
                               beta_max, *extra)
            dtc, a, nu, i_h, fmax_h, e_h, bm_h = (float(x) for x in got[:7])
            if self.cell:
                self._v_def, self.deform = got[7], got[8]
            self.dt_cur, self.a, self.n_uphill = dtc, a, nu
            ndone = int(i_h)
            pos_dev, v_dev = pos, v
            self.log(fmax_h, e_h)
            self.fmax = fmax_h
            converged = fmax_h < fmax
            need_host = self.check_beta and bm_h >= chain["beta_thresh"]
            if converged:
                done += ndone
                self.nsteps += ndone
                break
            if ndone < n and not need_host:
                # unserviceable skin breach: host rebuild next round
                chain = None
            if ndone == 0:
                self._stall += 1
                if self._stall >= 2:
                    (v_h,) = device_fetch(v_dev)
                    self._v = v_h[: len(system)]
                    self._host_step(pos_dev)
                    pos_dev = None
                    chain = None
                    ndone = 1
                    self._stall = 0
            else:
                self._stall = 0
            done += ndone
            self.nsteps += ndone
        if pos_dev is not None:
            self._sync_host(pos_dev)
            (v_h,) = device_fetch(v_dev)
            self._v = v_h[: len(system)]
        # refresh calc.results at the final geometry for callers that read
        # energies right after (the host Optimizer leaves the calc current)
        system.calc = calc
        system.get_potential_energy()
        return converged
