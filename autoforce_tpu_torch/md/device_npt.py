"""Device-resident MTK NPT (isotropic or flexible-cell) on the GPU (port
of ``autoforce_tpu/md/device_npt.py``), on one SGPR model or a committee.

The whole NPT step — particle and cell Nose-Hoover chains, the barostat
velocity, the MTK position/cell drift and the SGPR forces with the virial
— runs as eager device steps through :func:`..md.device_md.drive`.  The
virial comes from the same backward pass as the forces: the energy is
differentiated with respect to the positions and a strain of positions
and cell together.

Early exit: a Verlet-skin breach — under a moving cell the validity metric
is ``max|dpos| + 0.5 max_pairs |off @ (cell - tbl_cell)| < skin/2``, since
the periodic images drift with the cell as well — or an uncertainty trip.
With the in-loop rebuild a breach rebuilds the table on the device from
the current positions and cell (one host read), provided every
perpendicular width of the current cell still admits the single-image
build.

The 3x3 algebra of the step is written out (:func:`expm_sym`,
``neighbors_device.det3`` / ``inv3``): ``torch.linalg.det``, ``inv``,
``eigh`` and ``matrix_exp`` check for errors or choose their scaling on
the host, which would make every step wait for the card.

Deterministic (no noise): device trajectories are equality-tested against
the host MTKNPT driver (md/nose_hoover.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import units
from ..engine import _total_cov, device_fetch
from ..neighbors_device import det3
from ..profiling import span
from .device_md import (_beta_max, _committee_e, _floor_max, _go, _graft,
                        _inloop_table, _nhc_half, _where, check_plain_surface,
                        drive, mesh_chain, new_chain, padded_rows)
from .nose_hoover import _as_mask

# scaling and squaring of expm_sym: the Taylor polynomial's degree, the
# norm it is used up to (its truncation error there is 0.25^13 / 13! ~
# 2e-18) and the most squarings issued (norms up to 0.25 * 2^16; exp of
# anything larger is far outside float range)
_EXPM_TERMS = 12
_EXPM_THETA = 0.25
_EXPM_SQUARINGS = 16


def expm_sym(a):
    """exp of (..., 3, 3) matrices (the symmetric strain rates of the MTK
    step) by scaling and squaring with a Taylor polynomial, with nothing
    decided on the host: the scaling exponent s = ceil(log2(|a|_1 /
    theta)) is a device tensor, every squaring is issued and takes effect
    only while its index is below s."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    nrm = a.abs().sum(-2).amax(-1)  # 1-norm
    s = torch.ceil(torch.log2(nrm / _EXPM_THETA)).clamp(0, _EXPM_SQUARINGS)
    x = a / torch.exp2(s)[..., None, None]
    t = eye + x / _EXPM_TERMS
    for k in range(_EXPM_TERMS - 1, 0, -1):
        t = eye + (x @ t) / k
    due = torch.arange(_EXPM_SQUARINGS, device=a.device) < s[..., None]
    for k in range(_EXPM_SQUARINGS):
        t = torch.where(due[..., k, None, None], t @ t, t)
    return t


def offsum_max(off, msk, dtype):
    """Max Sum|off| over the valid slots of a neighbor table — the
    periodic-image lever arm of the moving-cell Verlet bound."""
    s = off.to(torch.int32).abs().sum(-1)
    return torch.where(msk, s, torch.zeros_like(s)).max().to(dtype)


def moving_cell_breach(pos, p0, cell, tcell, omax, amask, skin_half):
    """Verlet validity under a MOVING cell: a pair's relative motion is
    bounded by 2*max|dpos| + |off @ (cell - tbl_cell)|; the image term is
    not covered by atomic displacements (shear, or strain of a box the
    atoms do not fill), so it consumes skin budget too.  Shared by the
    NPT and variable-cell FIRE loops."""
    disp = torch.sqrt(((pos - p0) ** 2 * amask).sum(-1).max())
    d = cell - tcell
    drift = omax * torch.sqrt((d * d).sum(-1)).max()
    return disp + 0.5 * drift >= skin_half


def _table_omax(tbl):
    return offsum_max(tbl[1], tbl[3], torch.float64)


def moving_skin_table(amask, skin_half, rebuild_fn=None, rebuild_cut=None,
                      omax_of=_table_omax):
    """(breach, with_rebuild) of a loop under a moving cell (NPT,
    variable-cell FIRE): ``breach(pos, p0, cell, tcell, omax)`` is
    :func:`moving_cell_breach`; ``with_rebuild(pos, cell, tbl, p0, tcell,
    omax)`` gives the table, origin, table cell, lever arm and ``ok`` after
    a (masked) rebuild at (pos, cell) — one that is not due or fails
    (bucket overflow, MIC violation for the current cell) keeps the old
    ones, and drops ``ok`` only when it failed.  ``omax_of(tbl)``: a
    table's lever arm (a mesh's sharded table: the max over its
    shards)."""

    def breach(pos, p0, cell, tcell, omax):
        return moving_cell_breach(pos, p0, cell, tcell, omax, amask,
                                  skin_half)

    def with_rebuild(pos, cell, tbl, p0, tcell, omax):
        hit = breach(pos, p0, cell, tcell, omax)
        new_tbl, rok = rebuild_fn(pos, cell)
        rok = rok & (_min_perp_width(cell) >= 2.0 * rebuild_cut)
        take = hit & rok
        return dict(tbl=_where(take, new_tbl, tbl),
                    pos0=torch.where(take, pos, p0),
                    tcell=torch.where(take, cell, tcell),
                    omax=torch.where(take, omax_of(new_tbl).to(omax.dtype),
                                     omax),
                    ok=~hit | rok)

    return breach, with_rebuild


def _min_perp_width(cell):
    """Smallest perpendicular width of a cell (rows = lattice vectors):
    the in-loop MIC validity measure — the device rebuild is a
    single-image build, valid iff every width >= 2 * cutoff, evaluated on
    the CURRENT cell because the barostat moves it mid-chunk."""
    vol = det3(cell).abs()
    areas = torch.stack([
        torch.linalg.norm(torch.linalg.cross(cell[1], cell[2])),
        torch.linalg.norm(torch.linalg.cross(cell[2], cell[0])),
        torch.linalg.norm(torch.linalg.cross(cell[0], cell[1])),
    ])
    return vol / areas.max()


def _sgpr_forces_virial(pos, cell, cfg, model, radii, vscale_atom, params,
                        exponent, check_beta, aniso=False, ks=None,
                        mean_e=None):
    """(energy, forces, dE/deps, beta_max) with eps a strain of positions
    and cell together, from ONE backward pass shared with the forces.

    ``aniso=False``: eps is an isotropic scalar, dE/deps = vol*tr(stress)
    (the potential-pressure numerator).  ``aniso=True``: eps is a full
    3x3 strain (rows transform as x -> x @ (I+eps)^T), dE/deps symmetrized
    = vol * stress tensor — the flexible-cell MTK barostat's input.  With
    ``mean_e`` the model is a committee (device_md._committee_e): the
    gradient of its weighted energy gives the committee forces and
    virial, as the host combines the experts' virials with the same
    weights."""
    with span("af.forces"):
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            eps = torch.zeros((3, 3) if aniso else (), dtype=pos.dtype,
                              device=pos.device, requires_grad=True)
            if aniso:
                sc = torch.eye(3, dtype=p.dtype, device=p.device) + eps
                p_s, cell_s = p @ sc.T, cell @ sc.T
            else:
                p_s, cell_s = p * (1.0 + eps), cell * (1.0 + eps)
            if mean_e is not None:
                e, bmax = _committee_e(p_s, cell_s, cfg, model, radii,
                                       vscale_atom, mean_e, params, exponent,
                                       ks)
                g, deps = torch.autograd.grad(e.sum(), (p, eps))
                if aniso:
                    deps = 0.5 * (deps + deps.T)
                return (e[0].detach(), -g * cfg.atom_mask[:, None], deps,
                        _floor_max(bmax[0], check_beta))
            cov, lone, alpha = _total_cov(
                p_s, cell_s, cfg, model.X_desc, model.X_num, model.X_lone,
                radii, params, exponent, use_rev=True, ks=ks,
                pair_d=model.pair_d, pair_mask=model.pair_mask,
            )
            cov = cov * (cfg.atom_mask[:, None] & model.m_mask[None, :])
            e = (cov @ model.mu).sum()
            g, deps = torch.autograd.grad(e, (p, eps))
        if aniso:
            deps = 0.5 * (deps + deps.T)
        f = -g * cfg.atom_mask[:, None]
        return e.detach(), f, deps, _beta_max(cov.detach(), cfg, model,
                                              vscale_atom, alpha, check_beta,
                                              pos)


def md_chunk_npt(
    cfg,
    model,
    radii,
    vscale_atom,
    velocities,  # (N, 3)
    masses,  # (N, 1)
    pos0,  # positions at neighbor-table build time
    cell0,  # (3, 3) current cell (cfg.cell is the table-build cell)
    dt,
    kT,
    p_ext,  # external pressure, eV/A^3
    W,  # barostat inertia
    skin_half,
    beta_thresh,
    nsteps,
    nhc_Q,  # (3,) particle-chain masses
    nhc_dof,  # 3 * n_real
    nhc_vxi,
    nhc_xi,
    bch_Q,  # (3,) cell-chain masses (dof = 1 isotropic / ncell aniso)
    bch_vxi,
    bch_xi,
    vg,  # strain rate: 0-d (isotropic) or (3, 3) symmetric (aniso)
    params=None,
    exponent=4,
    check_beta=True,
    rebuild=False,  # in-loop neighbor rebuild at skin breaches
    rebuild_cut=None,  # rc + skin (required when rebuild)
    sidx_atom=None,  # (N,) i32 species-table index per atom
    sidx_ok=None,  # (N,) bool: species known to the engine table
    aniso=False,  # flexible-cell MTK (vg/mask are 3x3)
    mask=None,  # (3, 3) strain-component mask (aniso; 1 = free)
    bch_dof=None,  # cell-chain dof (aniso: count_nonzero(mask))
    tbl_cell=None,  # (3, 3) cell the incoming table was built with
    offmax=None,  # max Sum|off| of the incoming table
    ks=None,  # the engine's kernel space (Engine.kernel_space())
    mean_e=None,  # (E,) expert mean energies: ``model`` is a committee
    mesh=None,  # a device mesh (parallel.mesh): cfg, model mesh-padded
    own_idx=None,  # the mesh's row ids (parallel.mesh.mesh_pad)
):
    """Up to ``nsteps`` MTK NPT steps on the device; early exit on a skin
    breach or an uncertainty trip.  The exact Trotter splitting of
    md/nose_hoover.MTKNPT.step — isotropic by default, the full
    flexible-cell MTK with ``aniso=True``.  Returns (pos, vel, cell, f, e,
    beta_max, ndone, nhc_vxi, nhc_xi, bch_vxi, bch_xi, vg), with
    ``rebuild=True`` followed by (tbl, pos0, tbl_cell, offmax) for
    chaining.  With ``mesh``: forces and virial from one backward of the
    mesh-summed energy (``parallel.mesh.mesh_chunk``, the JAX package's
    ``sharded_npt_chunk``), a rebuilt table's lever arm the max over the
    shards, the table returned the whole configuration's."""
    dtype = cfg.positions.dtype
    whole, omax_of = None, _table_omax
    if mesh is not None:
        from ..parallel.mesh import mesh_chunk

        forces_fn, tbl0, rebuild_fn, whole, omax_of = mesh_chunk(
            cfg, model, radii, vscale_atom, own_idx, mesh, params, exponent,
            check_beta, ks, mean_e, virial=True, aniso=aniso,
            rebuild=rebuild, rebuild_cut=rebuild_cut, sidx_atom=sidx_atom,
            sidx_ok=sidx_ok)
    else:
        cfg_with, tbl0, rebuild_fn = _inloop_table(
            cfg, rebuild, rebuild_cut, sidx_atom, sidx_ok
        )

        def forces_fn(pos, cell, tbl):
            return _sgpr_forces_virial(pos, cell, cfg_with(tbl), model,
                                       radii, vscale_atom, params, exponent,
                                       check_beta, aniso=aniso, ks=ks,
                                       mean_e=mean_e)

    if tbl_cell is None:
        tbl_cell = cfg.cell  # host build: cfg.cell IS the table cell
    if offmax is None:
        offmax = offsum_max(cfg.nbr_off, cfg.nbr_mask, dtype)
    one = torch.ones((), dtype=dtype, device=cfg.positions.device)
    with torch.no_grad():
        st = _npt_loop(
            forces_fn, cfg.positions, cfg.atom_mask[:, None], velocities,
            masses, pos0, cell0, float(dt), float(kT), float(p_ext), float(W),
            float(skin_half), float(beta_thresh), int(nsteps),
            torch.stack([nhc_Q, bch_Q]),
            torch.stack([one * nhc_dof, one * (1.0 if bch_dof is None
                                               else bch_dof)]),
            float(nhc_dof), torch.stack([nhc_vxi, bch_vxi]),
            torch.stack([nhc_xi, bch_xi]), vg, aniso, mask, check_beta,
            tbl_cell, offmax, tbl0=tbl0, rebuild_fn=rebuild_fn,
            rebuild_cut=rebuild_cut, omax_of=omax_of,
        )
    out = (st["pos"], st["vel"], st["cell"], st["f"], st["e"], st["beta"],
           st["i"], st["vxi"][0], st["xi"][0], st["vxi"][1], st["xi"][1],
           st["vg"])
    if rebuild:
        tbl = st["tbl"] if whole is None else whole(st["tbl"])
        out = out + (tbl, st["pos0"], st["tcell"], st["omax"])
    return out


def _npt_loop(forces_fn, positions, amask, velocities, masses, pos0, cell0,
              dt, kT, p_ext, W, skin_half, beta_thresh, nsteps, Q2, dof2,
              nhc_dof, vxi2, xi2, vg, aniso, mask, check_beta, tbl_cell,
              offmax, tbl0=None, rebuild_fn=None, rebuild_cut=None,
              omax_of=_table_omax):
    """The MTK NPT loop.  ``forces_fn(pos, cell, tbl) -> (e, f, deps,
    beta_max)`` supplies the physics; ``rebuild_fn(pos, cell) -> (tbl,
    ok)`` enables in-loop table rebuilds under the moving cell
    (``omax_of``: :func:`moving_skin_table`).  The
    particle and cell chains are stacked on a leading axis (``Q2``,
    ``dof2``, ``vxi2``, ``xi2``: particle row 0, cell row 1) so that both
    run in the same launches.  Returns the final state dict."""
    eye = torch.eye(3, dtype=positions.dtype, device=positions.device)
    breach, with_rebuild = moving_skin_table(amask, skin_half, rebuild_fn,
                                             rebuild_cut, omax_of)

    def ke2(vel):
        return (masses * vel * vel * amask).sum()

    def bke2(vg):
        # barostat "kinetic" input: W * sum(vg^2); the isotropic scalar
        # stands for diag(vg) so the sum is 3 vg^2 (host MTKNPT)
        return W * (vg * vg).sum() if aniso else W * 3.0 * vg * vg

    def chains_half(vel, vg, vxi2, xi2):
        ke_pair = torch.stack([ke2(vel), bke2(vg)])
        s2, _, vxi2, xi2 = _nhc_half(ke_pair, vxi2, xi2, Q2, kT, dof2, dt)
        return s2[0], s2[1], vxi2, xi2

    def vg_half(vel, vg, cell, deps):
        """Barostat velocity half-step (host MTKNPT._vg_half).  The
        potential stress tensor is deps/vol (deps = vol * stress from the
        shared backward); P = -stress + kinetic."""
        vol = det3(cell).abs()
        KE2 = ke2(vel)
        if aniso:
            P = (-deps + ((masses * vel) * amask).T @ (vel * amask)) / vol
            G = (vol * (P - p_ext * eye) + KE2 / nhc_dof * eye) / W
            G = 0.5 * (G + G.T) * mask
            return (vg + 0.5 * dt * G) * mask
        # isotropic: p = tr(P)/3, tr(deps) already contracted by the
        # scalar-strain gradient
        p = (-deps + KE2) / (3.0 * vol)
        G = (3.0 * vol * (p - p_ext) + KE2 / nhc_dof * 3.0) / W
        return vg + 0.5 * dt * G / 3.0

    def step(st, it):
        pos, vel, cell, f = st["pos"], st["vel"], st["cell"], st["f"]
        # thermostats (particles + cell) half-step, stacked chains
        s, sb, vxi2, xi2 = chains_half(vel, st["vg"], st["vxi"], st["xi"])
        vel = vel * s
        vg = st["vg"] * sb
        # barostat velocity half-step (uses the current forces' virial)
        vg = vg_half(vel, vg, cell, st["deps"])
        if aniso:
            # particle velocity half-step with box coupling; exp(dt vg)
            # as the square of exp(dt vg / 2)
            A = vg + (torch.trace(vg) / nhc_dof) * eye
            Em, E2 = expm_sym(torch.stack([-0.5 * dt * A, 0.5 * dt * vg]))
            E = E2 @ E2
            vel = vel @ Em.T
            vel = vel + 0.5 * dt * f / masses
            # position + cell drift (full step)
            pos = pos @ E.T + dt * (vel @ E2.T)
            cell = cell @ E.T
        else:
            em = torch.exp(-0.5 * dt * vg * (1.0 + 3.0 / nhc_dof))
            vel = vel * em
            vel = vel + 0.5 * dt * f / masses
            E = torch.exp(dt * vg)
            E2 = torch.exp(0.5 * dt * vg)
            pos = pos * E + dt * vel * E2
            cell = cell * E
        # second half
        e, f, deps, beta = forces_fn(pos, cell, st["tbl"])
        vel = vel + 0.5 * dt * f / masses
        vel = vel @ Em.T if aniso else vel * em
        vg = vg_half(vel, vg, cell, deps)
        s, sb, vxi2, xi2 = chains_half(vel, vg, vxi2, xi2)
        vg = vg * sb
        vel = vel * s
        return dict(pos=pos, vel=vel, cell=cell, f=f, e=e, deps=deps,
                    beta=beta, vxi=vxi2, xi=xi2, vg=vg,
                    ok=~breach(pos, st["pos0"], cell, st["tcell"],
                               st["omax"]))

    def rebuild(st):
        out = with_rebuild(st["pos"], st["cell"], st["tbl"], st["pos0"],
                           st["tcell"], st["omax"])
        e, f, deps, beta = forces_fn(st["pos"], st["cell"], out["tbl"])
        out.update(e=e, f=f, deps=deps, beta=beta)
        return out

    st = dict(pos=positions, vel=velocities, cell=cell0, vxi=vxi2, xi=xi2,
              vg=vg, tbl=tbl0, pos0=pos0, tcell=tbl_cell, omax=offmax,
              i=torch.zeros((), dtype=torch.int64, device=positions.device))
    with span("af.chunk_start"):
        if rebuild_fn is not None:
            st.update(with_rebuild(positions, cell0, tbl0, pos0, tbl_cell,
                                   offmax))
        else:
            st["ok"] = ~breach(positions, pos0, cell0, tbl_cell, offmax)
        e, f, deps, beta = forces_fn(positions, cell0, st["tbl"])
        st.update(e=e, f=f, deps=deps, beta=beta)
    go = _go(nsteps, beta_thresh if check_beta else None)
    return drive(st, step, go, nsteps,
                 rebuild=rebuild if rebuild_fn is not None else None)


class DeviceNPT:
    """Chunked on-device MTK NPT (isotropic or flexible-cell) around an
    (inference or active) calculator — the NPT sibling of
    :class:`..md.device_md.DeviceMD`.

    Skin breaches under the moving cell are rebuilt inside the chunk
    where the box admits the device build (``in_loop_rebuild``); the host
    is re-entered on uncertainty trips (sampling at the exact step),
    bucket overflows and MIC violations.  Args mirror
    md/nose_hoover.MTKNPT, including the default ``isotropic=False``
    (full flexible-cell MTK; ``mask`` gates strain components).  A
    committee calculator is served on the card as in DeviceMD.  Under
    ``calc.engine.mesh`` the chunks run sharded (``md_chunk_npt(mesh=...)``:
    forces and virial from one backward of the mesh-summed energy)."""

    def __init__(self, system, calc, dt, temperature_K, pressure_GPa=0.0,
                 tdamp=None, pdamp=None, bulk_modulus_GPa=None, chunk=50,
                 check_beta=None, tchain=3, in_loop_rebuild=True,
                 isotropic=False, mask=None):
        check_plain_surface(calc, "DeviceNPT")
        if tchain != 3:
            raise NotImplementedError(
                "the device NHC is fixed at chain length 3 (the host "
                "MTKNPT default)"
            )
        self.system = system
        self.calc = calc
        self.dt = float(dt)
        self.kT = units.kB * float(temperature_K)
        self.p_ext = float(pressure_GPa) * units.GPa
        self.tdamp = float(tdamp) if tdamp else 100.0 * self.dt
        self.pdamp = float(pdamp) if pdamp else 1000.0 * self.dt
        n = len(system)
        self.dof = 3.0 * n
        if bulk_modulus_GPa:
            # cl/md.py pfactor convention: W = pdamp^2 * B * V0
            self.W = (
                self.pdamp**2 * float(bulk_modulus_GPa) * units.GPa
                * system.volume
            )
        else:
            # MTK canonical choice
            self.W = (self.dof + 3.0) * self.kT * self.pdamp**2 / 3.0
        self.chunk = int(chunk)
        self.check_beta = (
            check_beta if check_beta is not None else calc.active
        )
        self.in_loop_rebuild = bool(in_loop_rebuild)
        self.isotropic = bool(isotropic)
        self.mask = _as_mask(mask)
        self.ncell = (
            1.0 if self.isotropic else float(np.count_nonzero(self.mask))
        )
        self.nsteps = 0
        # chain state: host copies, refreshed by each chunk's one read;
        # the device copies chain from chunk to chunk
        self.nhc_vxi = np.zeros(3)
        self.nhc_xi = np.zeros(3)
        self.bch_vxi = np.zeros(3)
        self.bch_xi = np.zeros(3)
        self.vg = 0.0 if self.isotropic else np.zeros((3, 3))
        self._dev_state = None
        self._stall = 0
        self._committee = {}  # committee_stack's staging across chains
        self.mesh = getattr(calc.engine, "mesh", None)

    def _chain_masses(self):
        Q = np.full(3, self.kT * self.tdamp**2)
        Q[0] *= self.dof
        # cell chain: dof = 1 (isotropic) / count_nonzero(mask) (aniso)
        Qb = np.full(3, self.kT * self.pdamp**2)
        Qb[0] *= self.ncell
        return Q, Qb

    def _state_tensors(self, like):
        """Device copies of the chain state (from the host copies when the
        previous chunk's are gone)."""
        if self._dev_state is None:
            self._dev_state = tuple(
                torch.as_tensor(np.asarray(a, dtype=float), dtype=like.dtype,
                                device=like.device)
                for a in (self.nhc_vxi, self.nhc_xi, self.bch_vxi,
                          self.bch_xi, self.vg))
        return self._dev_state

    def _new_chain(self):
        from ..neighbors_device import device_rebuild_ok

        calc, system = self.calc, self.system
        chain = mesh_chain(new_chain(calc, system, self.check_beta,
                                     self._committee), self.mesh)
        cfg = chain["cfg"]
        like = chain["pos0"]

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=float),
                                   dtype=like.dtype, device=like.device)

        Q, Qb = self._chain_masses()
        chain.update(
            vel=padded_rows(system.get_velocities(), cfg.npad, like),
            cell=t(system.cell),
            inloop=self.in_loop_rebuild and device_rebuild_ok(
                system.cell, system.pbc, chain["cut"]),
            tbl_cell=None,  # host build: derived from cfg.cell
            offmax=None,
            Q=t(Q), Qb=t(Qb),
            mask=None if self.isotropic else t(self.mask),
        )
        return chain

    def _host_step(self, pos_dev, vel_dev, cell_dev):
        """One host MTK step from the device state (no progress even after
        a host visit, e.g. sampling vetoed while beta stays high)."""
        from .nose_hoover import MTKNPT

        system = self.system
        p_h, v_h, c_h = device_fetch(pos_dev, vel_dev, cell_dev)
        system.set_positions(p_h[: len(system)])
        system.set_velocities(v_h[: len(system)])
        system.set_cell(c_h)
        drv = MTKNPT(
            system, self.dt, temperature_K=self.kT / units.kB,
            pressure_GPa=self.p_ext / units.GPa, tdamp=self.tdamp,
            pdamp=self.pdamp, isotropic=self.isotropic,
            mask=None if self.isotropic else self.mask,
        )
        drv.W = self.W
        drv.chain.vxi = self.nhc_vxi.copy()
        drv.chain.xi = self.nhc_xi.copy()
        drv.bchain.vxi = self.bch_vxi.copy()
        drv.bchain.xi = self.bch_xi.copy()
        drv.vg = (self.vg * np.eye(3) if self.isotropic
                  else np.asarray(self.vg).copy())
        drv.step()
        self.nhc_vxi = drv.chain.vxi.copy()
        self.nhc_xi = drv.chain.xi.copy()
        self.bch_vxi = drv.bchain.vxi.copy()
        self.bch_xi = drv.bchain.xi.copy()
        self.vg = (float(np.trace(drv.vg) / 3.0) if self.isotropic
                   else drv.vg.copy())
        self._dev_state = None

    def run(self, steps):
        calc = self.calc
        system = self.system
        eng = calc.engine
        done = 0
        first = True
        need_host = True
        pos_dev = vel_dev = cell_dev = None
        chain = None
        while done < steps:
            if pos_dev is None or need_host or chain is None:
                if pos_dev is not None:
                    p_h, v_h, c_h = device_fetch(pos_dev, vel_dev, cell_dev)
                    system.set_positions(p_h[: len(system)])
                    system.set_velocities(v_h[: len(system)])
                    system.set_cell(c_h)
                    pos_dev = vel_dev = cell_dev = None
                if first or (self.check_beta and need_host):
                    system.calc = calc
                    system.get_potential_energy()
                    first = False
                else:
                    calc.system = system
                    calc._make_cfg(system)
                chain = self._new_chain()
            else:
                chain["cfg"] = chain["cfg"]._replace(positions=pos_dev)
                chain["vel"] = vel_dev
                chain["cell"] = cell_dev

            n = min(self.chunk, steps - done)
            vxi, xi, bvxi, bxi, vg = self._state_tensors(chain["pos0"])
            inloop_kw = {}
            if chain["inloop"]:
                inloop_kw = dict(rebuild=True, rebuild_cut=chain["cut"],
                                 sidx_atom=chain["sidx_atom"],
                                 sidx_ok=chain["sidx_ok"])
            out = md_chunk_npt(
                chain["cfg"], chain["ma"], chain["radii"], chain["vs"],
                chain["vel"], chain["masses"], chain["pos0"], chain["cell"],
                self.dt, self.kT, self.p_ext, self.W,
                0.5 * calc._nlcache.skin, chain["beta_thresh"], n,
                chain["Q"], self.dof, vxi, xi, chain["Qb"], bvxi, bxi, vg,
                params=eng.params, exponent=eng.exponent,
                check_beta=self.check_beta, aniso=not self.isotropic,
                mask=chain["mask"],
                bch_dof=None if self.isotropic else self.ncell,
                tbl_cell=chain["tbl_cell"], offmax=chain["offmax"],
                ks=chain["ks"], mean_e=chain["mean_e"], mesh=self.mesh,
                own_idx=chain.get("oidx"), **inloop_kw,
            )
            pos, vel, cell, f, e, beta_max, i = out[:7]
            self._dev_state = out[7:12]
            if chain["inloop"]:
                tbl, p0, tcell, omax = out[12:]
                chain["cfg"] = _graft(chain["cfg"], tbl)
                chain["pos0"] = p0
                chain["tbl_cell"] = tcell
                chain["offmax"] = omax
            # one host read for every boundary scalar and the chain state
            (bm_h, i_h, self.nhc_vxi, self.nhc_xi, self.bch_vxi, self.bch_xi,
             vg_h) = device_fetch(beta_max, i.to(torch.int32),
                                  *self._dev_state)
            self.vg = float(vg_h) if self.isotropic else vg_h
            ndone = int(i_h)
            pos_dev, vel_dev, cell_dev = pos, vel, cell
            need_host = (
                self.check_beta and float(bm_h) >= chain["beta_thresh"]
            )
            if ndone < n and not need_host:
                # without the in-loop rebuild: skin breach -> host rebuild
                # next round.  With it: neighbor-bucket overflow or a MIC
                # violation for the shrunken cell — the host grows the
                # bucket / re-gates.
                chain = None
            if ndone == 0:
                self._stall += 1
                if self._stall >= 2:
                    self._host_step(pos_dev, vel_dev, cell_dev)
                    pos_dev = vel_dev = cell_dev = None
                    chain = None
                    ndone = 1
                    self._stall = 0
            else:
                self._stall = 0
            done += ndone
            self.nsteps += ndone
        if pos_dev is not None:
            p_h, v_h, c_h = device_fetch(pos_dev, vel_dev, cell_dev)
            system.set_positions(p_h[: len(system)])
            system.set_velocities(v_h[: len(system)])
            system.set_cell(c_h)
        return True
