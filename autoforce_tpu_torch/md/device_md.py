"""Device-resident molecular dynamics: the integrator stays on the GPU
(port of ``autoforce_tpu/md/device_md.py``, single model).

The whole inner loop — forces (SGPR predict), thermostat, position update
and the stopping checks — runs as tensor operations on the card.  The JAX
package expresses it as one ``lax.while_loop``; here it is a Python loop
of eager launches that never waits for the device to decide whether to go
on.  An on-device ``active`` flag carries the loop condition: once it
drops (uncertainty trip, Verlet-skin breach or failed rebuild) every state
update becomes a ``torch.where`` no-op, so the state the loop returns is
that of the step on which the JAX loop stops.  The host notices the drop
without blocking: each step copies the flag into pinned host memory behind
an event, and the loop stops issuing steps once an event reports a
dropped flag.  The host reads ``(beta_max, ndone)`` once per chunk.

With the in-loop neighbor rebuild, a skin breach ends the current run of
steps; the table is rebuilt on the device from the breached positions,
forces are recomputed with it, and stepping resumes — the same state the
JAX loop's in-loop ``lax.cond`` rebuild produces, at one host read per
breach instead of a rebuild on every step.

Integrators: velocity Verlet (NVE) and BAOAB Langevin (NVT).  The Langevin
noise of global step ``t`` comes from a ``torch.Generator`` seeded with
``(seed, t)``, so a seeded run is reproducible however far the host ran
ahead of the device.  It cannot reproduce ``jax.random``'s numbers.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from .. import units
from ..engine import ConfigArrays, ModelArrays, _total_cov, device_fetch
from ..kernels import covloss_beta


def _sgpr_forces(pos, cfg, model, radii, vscale_atom, params, exponent,
                 check_beta):
    """(energy, forces, beta_max) of one configuration under one SGPR
    model — the physics of the device MD step (predict_fn minus virial)."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        cov, lone, alpha = _total_cov(
            p, cfg.cell, cfg, model.X_desc, model.X_num, model.X_lone,
            radii, params, exponent, use_rev=True,
        )
        cov = cov * (cfg.atom_mask[:, None] & model.m_mask[None, :])
        e = (cov @ model.mu).sum()
        (g,) = torch.autograd.grad(e, p)
    f = -g * cfg.atom_mask[:, None]
    if check_beta:
        beta = covloss_beta(model.choli, cov.detach(), vscale_atom,
                            model.m_mask, alpha=alpha)
        beta_max = torch.where(cfg.atom_mask, beta,
                               torch.full_like(beta, -math.inf)).max()
    else:
        beta_max = torch.zeros((), dtype=pos.dtype, device=pos.device)
    return e.detach(), f, beta_max


def _graft(cfg, tbl):
    """``cfg`` with the neighbor-table tuple (idx, off, sidx, mask[, rev])."""
    idx, off, sx, mk = tbl[:4]
    rv = tbl[4] if len(tbl) > 4 else None
    return cfg._replace(nbr_idx=idx, nbr_off=off, nbr_sidx=sx, nbr_mask=mk,
                        nbr_rev=rv)


def _inloop_table(cfg, rebuild, rebuild_cut, sidx_atom, sidx_ok):
    """In-loop rebuild plumbing: (cfg_with, tbl0, rebuild_fn).
    ``cfg_with(tbl)`` grafts a neighbor-table tuple onto ``cfg``; ``tbl0``
    is the incoming table; ``rebuild_fn(pos) -> (tbl, ok)`` rebuilds it
    from device positions (ok=False on bucket overflow, int8 offset
    overflow or asymmetry — the host path then takes over)."""
    use_rev = cfg.nbr_rev is not None

    def cfg_with(tbl):
        return _graft(cfg, tbl) if rebuild else cfg

    if not rebuild:
        return cfg_with, None, None

    from ..neighbors_device import device_neighbor_table, reverse_slots

    kpad = cfg.nbr_idx.shape[1]
    off_dtype = cfg.nbr_off.dtype

    def rebuild_fn(pos):
        idx, off, mask, kmax, off_over = device_neighbor_table(
            pos, cfg.cell, cfg.atom_mask, rebuild_cut, kpad
        )
        off = off.to(off_dtype)
        sx = sidx_atom[idx.long()]
        mask = mask & sidx_ok[idx.long()]
        ok = (kmax <= kpad) & ~off_over
        tbl = (idx, off, sx, mask)
        if use_rev:
            rev = reverse_slots(idx, off, mask)
            # an asymmetric table would silently drop force contributions
            # in the reverse-slot backward (cannot happen for the MIC
            # builder, but guarded like make_config)
            ok = ok & ~torch.any(mask & (rev < 0))
            tbl = tbl + (rev,)
        return tbl, ok

    tbl0 = (cfg.nbr_idx, cfg.nbr_off, cfg.nbr_sidx, cfg.nbr_mask)
    if use_rev:
        tbl0 = tbl0 + (cfg.nbr_rev,)
    return cfg_with, tbl0, rebuild_fn


def _where(flag, new, old):
    """Elementwise select of a tensor or a tuple of tensors."""
    if isinstance(new, tuple):
        return tuple(_where(flag, n, o) for n, o in zip(new, old))
    return torch.where(flag, new, old)


class _FlagWatch:
    """Non-blocking view of the on-device ``active`` flag.

    On a card, each step copies the flag into a pinned host slot behind a
    CUDA event; :meth:`dropped` polls the events that have completed and
    never waits.  On the CPU every operation has already run, so the flag
    is read directly."""

    def __init__(self, device, nslots):
        self.cuda = device.type == "cuda"
        self.flag = None
        if self.cuda:
            self.buf = torch.ones(max(nslots, 1), dtype=torch.bool,
                                  pin_memory=True)
            self.pending = collections.deque()

    def push(self, slot, active):
        if not self.cuda:
            self.flag = active
            return
        self.buf[slot].copy_(active, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.pending.append((slot, ev))

    def dropped(self):
        if not self.cuda:
            return self.flag is not None and not bool(self.flag)
        while self.pending and self.pending[0][1].query():
            slot, _ = self.pending.popleft()
            if not bool(self.buf[slot]):
                return True
        return False


def _noise(gen, shape, dtype, seed, step):
    """Standard normal noise of global step ``step`` of stream ``seed``
    (``gen``: a generator on the target device, reseeded here)."""
    gen.manual_seed((int(seed) * 0x9E3779B1 + int(step)) % (1 << 63))
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def _chunk_loop(forces_fn, pos_init, amask, velocities, masses, pos0, dt, kT,
                friction, skin_half, beta_thresh, nsteps, thermostat,
                check_beta, seed=0, step0=0, tbl=None, rebuild_fn=None):
    """The integrator loop.

    ``forces_fn(pos, tbl) -> (e, f, beta_max)`` supplies the physics; the
    loop does velocity-Verlet / BAOAB-Langevin stepping with early exit on
    a Verlet-skin breach or an uncertainty trip.  ``amask``: (N, 1) atom
    mask.  Returns (pos, vel, f, e, beta_max, ndone, tbl, pos0) with
    ``ndone`` a 0-d device tensor.

    With ``rebuild_fn`` a skin breach does not end the loop: the table is
    rebuilt from the breached positions (``rebuild_fn(pos) -> (tbl,
    ok)``), forces are recomputed with it, and stepping continues; the
    loop ends early only on an uncertainty trip or a failed rebuild (the
    host then grows the bucket).  A failed rebuild keeps the last good
    table and origin.
    """
    if thermostat not in ("langevin", "none"):
        raise NotImplementedError(f"thermostat {thermostat!r} is not ported yet")
    dev = pos_init.device
    dtype = pos_init.dtype
    c1 = math.exp(-friction * dt)
    c2 = torch.sqrt(kT * (1.0 - c1 * c1) / masses)
    half = 0.5 * dt
    gen = torch.Generator(device=dev) if thermostat == "langevin" else None

    def breach(pos, p0):
        return ((pos - p0) ** 2 * amask).sum(-1).max() >= skin_half**2

    def go(ok, beta_max, i):
        g = ok & (i < nsteps)
        if check_beta:
            g = g & (beta_max < beta_thresh)
        return g

    def with_rebuild(pos, tbl, p0):
        """Table and origin after a (masked) rebuild at ``pos``: a rebuild
        that is not due (no breach) or fails keeps the old ones."""
        hit = breach(pos, p0)
        new_tbl, rok = rebuild_fn(pos)
        take = hit & rok
        return _where(take, new_tbl, tbl), torch.where(take, pos, p0), ~hit | rok

    pos, vel = pos_init, velocities
    if rebuild_fn is not None:
        tbl, pos0, ok = with_rebuild(pos, tbl, pos0)
    else:
        ok = ~breach(pos, pos0)
    e, f, beta_max = forces_fn(pos, tbl)
    i = torch.zeros((), dtype=torch.int64, device=dev)
    watch = _FlagWatch(dev, nsteps + 1)
    it = 0  # iterations issued: committed steps are a prefix of them
    rebuilt_at = 0  # committed-step count of the last rebuild
    while True:
        active = go(ok, beta_max, i)
        watch.push(0, active)
        while it < nsteps:
            if watch.dropped():
                break
            v = vel + half * f / masses  # B
            p = pos + half * v  # A
            if thermostat == "langevin":
                noise = _noise(gen, v.shape, dtype, seed, step0 + it)
                v = c1 * v + c2 * noise  # O
            p = p + half * v  # A
            e2, f2, b2 = forces_fn(p, tbl)
            v = v + half * f2 / masses  # B
            pos, vel = _where(active, p, pos), _where(active, v, vel)
            e, f = _where(active, e2, e), _where(active, f2, f)
            beta_max = _where(active, b2, beta_max)
            i = i + active.to(i.dtype)
            ok = torch.where(active, ~breach(pos, pos0), ok)
            active = go(ok, beta_max, i)
            it += 1
            watch.push(it, active)
        if rebuild_fn is None:
            break
        # a breach stopped the run: rebuild at the breached positions and
        # recompute forces with the fresh table (one host read per breach).
        # ok still down with no step since the last rebuild: it failed.
        ok_h, i_h = device_fetch(ok, i.to(torch.int32))
        if bool(ok_h) or int(i_h) == rebuilt_at:
            break
        tbl, pos0, ok = with_rebuild(pos, tbl, pos0)
        e, f, beta_max = forces_fn(pos, tbl)
        rebuilt_at = it = int(i_h)
        if it >= nsteps:
            break
        watch = _FlagWatch(dev, nsteps + 1)
    return pos, vel, f, e, beta_max, i, tbl, pos0


def md_chunk(
    cfg: ConfigArrays,
    model: ModelArrays,
    radii,
    vscale_atom,
    velocities,  # (N, 3)
    masses,  # (N, 1)
    pos0,  # positions at neighbor-table build time
    dt,
    kT,
    friction,
    skin_half,
    beta_thresh,
    nsteps=20,
    params=None,
    exponent=4,
    check_beta=True,
    thermostat="langevin",  # "langevin" | "none"
    rebuild=False,  # in-loop neighbor rebuild at skin breaches
    rebuild_cut=None,  # rc + skin (required when rebuild)
    sidx_atom=None,  # (N,) i32 species-table index per atom
    sidx_ok=None,  # (N,) bool: species known to the engine table
    seed=0,  # Langevin noise stream
    step0=0,  # global index of this chunk's first step (noise counter)
):
    """Run up to ``nsteps`` MD steps on the device; early-exit on a skin
    breach or the uncertainty threshold.
    Returns (pos, vel, f, e, beta_max, ndone) with ``ndone`` a 0-d device
    tensor; with ``rebuild=True`` also (tbl, pos0): the live table tuple
    (idx, off, sidx, mask[, rev]) and its build origin, for chaining into
    the next chunk."""
    cfg_with, tbl0, rebuild_fn = _inloop_table(
        cfg, rebuild, rebuild_cut, sidx_atom, sidx_ok
    )

    def forces_fn(pos, tbl):
        return _sgpr_forces(pos, cfg_with(tbl), model, radii, vscale_atom,
                            params, exponent, check_beta)

    with torch.no_grad():
        out = _chunk_loop(
            forces_fn, cfg.positions, cfg.atom_mask[:, None], velocities,
            masses, pos0, float(dt), float(kT), float(friction),
            float(skin_half), float(beta_thresh), int(nsteps), thermostat,
            check_beta, seed=seed, step0=step0, tbl=tbl0,
            rebuild_fn=rebuild_fn,
        )
    pos, vel, f, e, beta_max, i, tbl, pos0 = out
    if rebuild:
        return pos, vel, f, e, beta_max, i, tbl, pos0
    return pos, vel, f, e, beta_max, i


class DeviceMD:
    """Chunked on-device MD around an inference ActiveCalculator.

    A drop-in fast MD engine for a frozen model.  The chunk stops at the
    exact step on which the uncertainty crosses the calculator's ``ediff``
    when ``check_beta`` is on, and the host then runs the calculator's
    full ``calculate`` there."""

    def __init__(self, system, calc, dt, temperature_K=None, friction=0.01,
                 chunk=50, seed=0, check_beta=None, thermostat="auto"):
        from ..neighbors_device import device_rebuild_ok

        if getattr(calc, "meta", None) is not None:
            raise NotImplementedError("metadynamics is not ported yet")
        self.system = system
        self.calc = calc
        self.dt = float(dt)
        self.kT = units.kB * temperature_K if temperature_K else 0.0
        self.friction = float(friction)
        self.chunk = int(chunk)
        self.seed = int(seed)
        self.nsteps = 0
        self.check_beta = (
            check_beta if check_beta is not None else calc.active
        )
        if thermostat == "auto":
            thermostat = "langevin" if self.kT > 0 else "none"
        if thermostat not in ("langevin", "none"):
            raise NotImplementedError(f"thermostat {thermostat!r} is not ported yet")
        self.thermostat = thermostat
        # the in-loop device rebuild where the MIC builder holds; otherwise
        # a skin breach ends the chunk and the host rebuilds the table
        self.in_loop_rebuild = device_rebuild_ok(
            system.cell, system.pbc,
            calc.engine.params.rc + calc._nlcache.skin,
        )
        self._stall = 0

    def _new_chain(self):
        """Device state of a chain of chunks, from the calculator's
        current configuration."""
        calc, system, eng = self.calc, self.system, self.calc.engine
        model = calc.model
        cfg = calc.cfg
        dtype, dev = cfg.positions.dtype, cfg.positions.device
        ma = model.full_model_arrays()
        vs = model.vscale_for(cfg.numbers.cpu().numpy())
        # unseen species: a huge finite sentinel (the host's inf semantics:
        # any uncertainty trips sampling) that keeps 0 * inf out of beta
        vs = np.where(np.isfinite(vs), vs, 1e8)
        npad = cfg.npad
        vel = np.zeros((npad, 3))
        vel[: len(system)] = system.get_velocities()
        masses = np.ones((npad, 1))
        masses[: len(system), 0] = system.get_masses()
        pos0 = np.zeros((npad, 3))
        pos0[: len(system)] = calc._nlcache._pos
        sidx = eng.species_index(cfg.numbers.cpu().numpy())

        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        return dict(
            cfg=cfg,
            ma=ma,
            radii=eng.radii_table(),
            vs=t(vs),
            vel=t(vel),
            masses=t(masses),
            pos0=t(pos0),
            sidx_atom=t(np.maximum(sidx, 0), torch.int32),
            sidx_ok=t(sidx >= 0, torch.bool),
            cut=eng.params.rc + calc._nlcache.skin,
            beta_thresh=calc.ediff if self.check_beta else np.inf,
        )

    def run(self, steps):
        calc = self.calc
        system = self.system
        eng = calc.engine
        done = 0
        first = True
        need_host = True
        pos_dev = vel_dev = None
        chain = None
        while done < steps:
            if pos_dev is None or need_host or chain is None:
                if pos_dev is not None:
                    p_h, v_h = device_fetch(pos_dev, vel_dev)
                    system.set_positions(p_h[: len(system)])
                    system.set_velocities(v_h[: len(system)])
                    pos_dev = vel_dev = None
                if first or (self.check_beta and need_host):
                    # full calculator semantics (predict + log) at the boundary
                    system.calc = calc
                    system.get_potential_energy()
                    first = False
                else:
                    # skin-only rebuild: refresh the neighbor table / config
                    calc.system = system
                    calc._make_cfg(system)
                chain = self._new_chain()
            else:
                # continue on the device: same table, origin and model
                chain["cfg"] = chain["cfg"]._replace(positions=pos_dev)
                chain["vel"] = vel_dev

            n = min(self.chunk, steps - done)
            inloop = self.in_loop_rebuild
            out = md_chunk(
                chain["cfg"], chain["ma"], chain["radii"], chain["vs"],
                chain["vel"], chain["masses"], chain["pos0"],
                self.dt, self.kT, self.friction, 0.5 * calc._nlcache.skin,
                chain["beta_thresh"], n,
                params=eng.params, exponent=eng.exponent,
                check_beta=self.check_beta, thermostat=self.thermostat,
                rebuild=inloop, rebuild_cut=chain["cut"],
                sidx_atom=chain["sidx_atom"], sidx_ok=chain["sidx_ok"],
                seed=self.seed, step0=self.nsteps,
            )
            if inloop:
                pos, vel, f, e, beta_max, i, tbl, p0 = out
                chain["cfg"] = _graft(chain["cfg"], tbl)
                chain["pos0"] = p0
            else:
                pos, vel, f, e, beta_max, i = out
            # one host read for every boundary scalar
            bm_h, i_h = device_fetch(beta_max, i.to(torch.int32))
            ndone = int(i_h)
            pos_dev, vel_dev = pos, vel
            # host attention only if the uncertainty tripped (the chunk then
            # stopped at the exact step a sampling check is due)
            need_host = self.check_beta and float(bm_h) >= chain["beta_thresh"]
            if ndone < n and not need_host:
                # skin breach (or, in-loop, a failed rebuild: the bucket
                # overflowed, so go to the host path, which grows it)
                chain = None
            if ndone == 0:
                # no progress: a host round trip (rebuild) should resolve
                # it — force one host step only if that already failed
                self._stall += 1
                if self._stall >= 2:
                    from .langevin import Langevin
                    from .verlet import VelocityVerlet

                    p_h, v_h = device_fetch(pos_dev, vel_dev)
                    system.set_positions(p_h[: len(system)])
                    system.set_velocities(v_h[: len(system)])
                    pos_dev = vel_dev = None
                    chain = None
                    if self.thermostat == "langevin" and self.kT > 0:
                        drv = Langevin(system, self.dt, self.kT / units.kB,
                                       self.friction)
                    else:
                        drv = VelocityVerlet(system, self.dt)
                    drv.step()
                    ndone = 1
                    self._stall = 0
            else:
                self._stall = 0
            done += ndone
            self.nsteps += ndone
        # final host sync so callers observe the end-of-run state
        if pos_dev is not None:
            p_h, v_h = device_fetch(pos_dev, vel_dev)
            system.set_positions(p_h[: len(system)])
            system.set_velocities(v_h[: len(system)])
        return True
