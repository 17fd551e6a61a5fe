"""Device-resident molecular dynamics: the integrator stays on the GPU
(port of ``autoforce_tpu/md/device_md.py``).

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

Integrators: velocity Verlet (NVE), BAOAB Langevin and a Nose-Hoover
chain (NVT).  The Langevin noise of global step ``t`` comes from a
``torch.Generator`` seeded with ``(seed, t)``, so a seeded run is
reproducible however far the host ran ahead of the device.  It cannot
reproduce ``jax.random``'s numbers.

Under a device mesh (``calc.engine.mesh``, :mod:`..parallel.mesh`) the
same loop runs with sharded forces (``md_chunk(mesh=...)``): one launch
of each SOAP kernel per data shard and step.

A Bayesian committee (:class:`..calculator.bcm.BCMActiveCalculator` with
frozen experts) is served on the card as well (:func:`_committee_e`): the
descriptors are computed once per step for every expert, so each SOAP
kernel still launches once per step whatever the number of experts.

R walkers that share one model (:func:`md_chunk_replicas`,
``md/replica_md.py``) are stacked as rows of one configuration, so an
ensemble step too launches each SOAP kernel once.  The ActiveMeta bias
(``calculator/meta.py``) is fused into the differentiated energy of the
step, on one model or on a committee's floor.

:func:`drive` is the loop machinery shared by every device driver of the
port (this module, md/device_npt.py, opt/device_fire.py,
opt/device_neb.py).
"""

from __future__ import annotations

import collections
import contextlib
import math

import numpy as np
import torch

from .. import units
from ..engine import ConfigArrays, ModelArrays, _total_cov, device_fetch
from ..kernels import covloss_beta, covloss_bias
from ..profiling import span


_W3 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_SY3 = (_W3, 1.0 - 2.0 * _W3, _W3)


def _nhc_half(KE2, vxi, xi, Q, kT, dof, dt, nc=2):
    """Nose-Hoover chain half-step (M = 3, Suzuki-Yoshida; the exact math
    of md/nose_hoover.NHChain.half_step with its loops unrolled).  Chains
    may be stacked on leading axes: ``KE2``/``dof`` (...), ``vxi``, ``xi``
    and ``Q`` (..., 3), so the particle and cell chains of the NPT step
    share every elementwise launch.  Returns (velocity scale, KE2, vxi,
    xi)."""
    v = [vxi[..., 0], vxi[..., 1], vxi[..., 2]]
    x = [xi[..., 0], xi[..., 1], xi[..., 2]]
    q = [Q[..., 0], Q[..., 1], Q[..., 2]]

    def force(j):
        if j == 0:
            return (KE2 - dof * kT) / q[0]
        return (q[0] * v[0] ** 2 - kT) / q[1]

    scale = torch.ones_like(KE2)
    for _ in range(nc):
        for w in _SY3:
            wdt = w * dt / nc  # see md/nose_hoover.py NHChain.half_step
            v[2] = v[2] + 0.25 * wdt * (q[1] * v[1] ** 2 - kT) / q[2]
            for j in (1, 0):
                ef = torch.exp(-0.125 * wdt * v[j + 1])
                v[j] = (v[j] * ef + 0.25 * wdt * force(j)) * ef
            sc = torch.exp(-0.5 * wdt * v[0])
            scale = scale * sc
            KE2 = KE2 * sc * sc
            x = [x[j] + 0.5 * wdt * v[j] for j in range(3)]
            for j in (0, 1):
                ef = torch.exp(-0.125 * wdt * v[j + 1])
                v[j] = (v[j] * ef + 0.25 * wdt * force(j)) * ef
            v[2] = v[2] + 0.25 * wdt * (q[1] * v[1] ** 2 - kT) / q[2]
    return scale, KE2, torch.stack(v, -1), torch.stack(x, -1)


def _sgpr_forces(pos, cfg, model, radii, vscale_atom, params, exponent,
                 check_beta, ks=None, mean_e=None, nimg=None, meta_scale=None,
                 meta_vs=None):
    """(energy, forces, beta_max) of one configuration under one SGPR
    model — the physics of the device MD step (predict_fn minus virial);
    ``ks``: the engine's kernel space (None: the plain dot kernel).  With
    ``mean_e`` the model is a committee (:func:`_committee_e`).

    ``nimg``: ``cfg`` stacks that many images (walkers) of equal row
    counts; the energy and beta_max are then given per image, (nimg,),
    and the forces of all of them come from one backward.

    ``meta_scale`` / ``meta_vs`` fuse the ActiveMeta uncertainty-seeking
    bias ``E -= meta_scale * sum_i beta_i sqrt(meta_vs_i)`` into the
    differentiated energy (the formula of :func:`engine.meta_covloss_fn`;
    under a committee the committee floor, :func:`_committee_e`), so one
    backward gives the biased forces and the step launches each SOAP kernel
    once.  ``meta_vs`` maps a species without a scale to 0, the host meta
    convention, not to :data:`VS_UNSEEN`."""
    with span("af.forces"):
        k = nimg or 1
        if mean_e is not None:
            with torch.enable_grad():
                p = pos.detach().requires_grad_(True)
                e, bmax = _committee_e(p, cfg.cell, cfg, model, radii,
                                       vscale_atom, mean_e, params, exponent,
                                       ks, nimg=k, meta_scale=meta_scale,
                                       meta_vs=meta_vs)
                (g,) = torch.autograd.grad(e.sum(), p)
            f = -g * cfg.atom_mask[:, None]
            e, bmax = e.detach(), _floor_max(bmax, check_beta)
            return (e, f, bmax) if nimg else (e[0], f, bmax[0])
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            cov, lone, alpha = _total_cov(
                p, cfg.cell, cfg, model.X_desc, model.X_num, model.X_lone,
                radii, params, exponent, use_rev=True, ks=ks,
                pair_d=model.pair_d, pair_mask=model.pair_mask,
            )
            cov = cov * (cfg.atom_mask[:, None] & model.m_mask[None, :])
            e = cov @ model.mu
            e = e.reshape(k, -1).sum(1) if nimg else e.sum()
            if meta_scale is not None:
                e = e - meta_scale * covloss_bias(model.choli, cov, meta_vs,
                                                  cfg.atom_mask)
            (g,) = torch.autograd.grad(e.sum(), p)
        f = -g * cfg.atom_mask[:, None]
        return e.detach(), f, _beta_max(cov.detach(), cfg, model,
                                        vscale_atom, alpha, check_beta, pos,
                                        nimg)


def _committee_e(p, cell, cfg, models, radii, vscale_atoms, mean_e, params,
                 exponent, ks=None, nimg=1, weights=False, meta_scale=None,
                 meta_vs=None):
    """(weighted committee energy, committee covloss floor max), one of
    each per image, at positions ``p`` under ``cell``: the physics that
    every device driver serving a Bayesian committee shares.  ``cfg`` may
    stack ``nimg`` images of equal row counts (``opt.device_neb``).

    ``models``: ModelArrays whose leaves carry a leading expert axis E;
    ``vscale_atoms``: (E, N); ``mean_e``: (E,).  The descriptors are
    computed once for the whole committee (one forward launch of the SOAP
    kernel), every expert's Gram block is one product against the
    experts' inducing sets laid end to end, and the gradient of the
    returned energy takes one backward launch.  Expert energies combine
    with the weights ``scale_k = -log(covmax_k) / covmax_k`` (covmax_k:
    the expert's largest beta over the image's atoms), which are computed
    without autograd as the host combination is, so differentiating the
    energy gives the committee forces and virial.  The sampling trigger is
    the committee floor ``min_k beta_k``.  ``weights``: also return the
    (E, R) weights.

    ``meta_scale`` / ``meta_vs`` ((E, N), a species without a scale at 0)
    add the ActiveMeta bias on the committee floor, ``E -= scale * sum_i
    min_k beta_ki sqrt(meta_vs_ki)`` with 1 - c clipped at 1e-12, as the
    JAX package defines it; this term is differentiated (the minimum
    shares its gradient among tied experts), the weights are not."""
    E, mcap = models.m_mask.shape

    def flat(t):  # (E, mcap, ...) -> (E * mcap, ...)
        return t.reshape(E * mcap, *t.shape[2:])

    pair_d = pair_mask = None
    if models.pair_d is not None:
        # (E, T, mcap, KX) -> (T, E * mcap, KX)
        T = models.pair_d.shape[1]
        pair_d = models.pair_d.transpose(0, 1).reshape(T, E * mcap, -1)
        pair_mask = models.pair_mask.transpose(0, 1).reshape(T, E * mcap, -1)
    cov, lone, alpha = _total_cov(
        p, cell, cfg, flat(models.X_desc), flat(models.X_num),
        flat(models.X_lone), radii, params, exponent, use_rev=True, ks=ks,
        pair_d=pair_d, pair_mask=pair_mask,
    )
    N = cov.shape[0]
    cov = cov.reshape(N, E, mcap).transpose(0, 1)  # (E, N, mcap)
    cov = cov * (cfg.atom_mask[None, :, None] & models.m_mask[:, None, :])
    e_k = (cov @ models.mu[..., None])[..., 0]  # (E, N)
    e_k = e_k.reshape(E, nimg, N // nimg).sum(-1)  # (E, R)
    mm = models.m_mask.to(cov.dtype)[:, None, :]
    # the covloss c under autograd only where the bias differentiates it
    with contextlib.nullcontext() if meta_scale is not None else \
            torch.no_grad():
        b = (models.choli * mm) @ (cov * mm).transpose(1, 2)  # (E, mcap, N)
        c = (b * b).sum(1) / alpha
    with torch.no_grad():
        trig = torch.sqrt(torch.clamp(1.0 - c, min=0.0)) * torch.sqrt(
            vscale_atoms)
        betas = torch.where(cfg.atom_mask[None, :], trig,
                            torch.full_like(trig, -math.inf))
        betas = betas.reshape(E, nimg, N // nimg)
        covmax = betas.amax(-1).clamp(1e-12, 1.0)  # (E, R)
        scale = torch.where(covmax < 1.0, -torch.log(covmax),
                            torch.zeros_like(covmax)) / covmax
        tot = scale.sum(0)
        w = torch.where(tot > 0, scale / torch.where(tot > 0, tot, 1.0),
                        torch.full_like(scale, 1.0 / E))
        bmax = betas.amin(0).amax(-1)  # (R,)
    e_tot = (w * (e_k + mean_e[:, None])).sum(0)
    if meta_scale is not None:
        # 1e-12 floor, not 0: sqrt'(0) = inf would make the bias forces NaN
        # where an expert knows an environment exactly
        floor = (torch.sqrt(torch.clamp(1.0 - c, min=1e-12))
                 * torch.sqrt(meta_vs)).amin(0)  # (N,)
        floor = torch.where(cfg.atom_mask, floor, torch.zeros_like(floor))
        e_tot = e_tot - meta_scale * floor.reshape(nimg, N // nimg).sum(-1)
    return (e_tot, bmax, w) if weights else (e_tot, bmax)


def _floor_max(bmax, check_beta):
    """The committee's trip scalar, 0 when the trip is off."""
    return bmax if check_beta else torch.zeros_like(bmax)


def _beta_max(cov, cfg, model, vscale_atom, alpha, check_beta, pos,
              nimg=None):
    """Largest per-atom uncertainty of a configuration, or of each of its
    ``nimg`` stacked images (0 when the trip is off)."""
    if not check_beta:
        return torch.zeros(() if nimg is None else (nimg,), dtype=pos.dtype,
                           device=pos.device)
    beta = covloss_beta(model.choli, cov, vscale_atom, model.m_mask,
                        alpha=alpha.detach())
    beta = torch.where(cfg.atom_mask, beta, torch.full_like(beta, -math.inf))
    return beta.max() if nimg is None else beta.reshape(nimg, -1).amax(1)


def _graft(cfg, tbl):
    """``cfg`` with the neighbor-table tuple (idx, off, sidx, mask[, rev])."""
    idx, off, sx, mk = tbl[:4]
    rv = tbl[4] if len(tbl) > 4 else None
    return cfg._replace(nbr_idx=idx, nbr_off=off, nbr_sidx=sx, nbr_mask=mk,
                        nbr_rev=rv)


def _inloop_table(cfg, rebuild, rebuild_cut, sidx_atom, sidx_ok, nrep=1):
    """In-loop rebuild plumbing: (cfg_with, tbl0, rebuild_fn).
    ``cfg_with(tbl)`` grafts a neighbor-table tuple onto ``cfg``; ``tbl0``
    is the incoming table; ``rebuild_fn(pos, cell=None) -> (tbl, ok)``
    rebuilds it from device positions under ``cell`` (the moving cell of
    the NPT and variable-cell FIRE loops; ``cfg.cell`` by default);
    ok=False on bucket overflow, int8 offset overflow or asymmetry — the
    host path then takes over.  ``nrep``: ``cfg`` stacks that many walkers
    of equal row counts under one cell (:func:`md_chunk_replicas`); each
    walker's table is rebuilt from its own rows and offset by its block."""
    use_rev = cfg.nbr_rev is not None

    def cfg_with(tbl):
        return _graft(cfg, tbl) if rebuild else cfg

    if not rebuild:
        return cfg_with, None, None

    from ..neighbors_device import device_neighbor_table, reverse_slots

    kpad = cfg.nbr_idx.shape[1]
    off_dtype = cfg.nbr_off.dtype

    def rebuild_fn(pos, cell=None):
        with span("af.rebuild"):
            cell = cfg.cell if cell is None else cell
            if nrep == 1:
                idx, off, mask, kmax, off_over = device_neighbor_table(
                    pos, cell, cfg.atom_mask, rebuild_cut, kpad)
            else:
                n = pos.shape[0] // nrep
                idx, off, mask, kmax, off_over = device_neighbor_table(
                    pos.reshape(nrep, n, 3), cell,
                    cfg.atom_mask.reshape(nrep, n), rebuild_cut, kpad)
                block = torch.arange(nrep, dtype=idx.dtype, device=idx.device)
                idx = (idx + n * block[:, None, None]).reshape(nrep * n, kpad)
                off = off.reshape(nrep * n, kpad, 3)
                mask = mask.reshape(nrep * n, kpad)
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
    """Elementwise select of a tensor or a (nested) tuple of tensors, which
    may lie on other devices than the flag (a mesh's sharded tables)."""
    if isinstance(new, tuple):
        return tuple(_where(flag, n, o) for n, o in zip(new, old))
    if new.device != flag.device:
        flag = flag.to(new.device)
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


@contextlib.contextmanager
def host_read():
    """A documented host read inside a device loop (the breach read that
    precedes an in-loop table rebuild): CUDA's sync debug mode, which
    ``chip_smoke.py`` turns on around one chunk of each driver to prove
    that the steps themselves never wait for the card, is lifted here."""
    if not torch.cuda.is_available():
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _go(nsteps, beta_thresh=None, fmax_target=None):
    """The loop condition of a device driver on its state dict: no
    unserviced skin breach (``ok``), steps left, and where armed no
    uncertainty trip (``beta``) and no convergence (``fmax``)."""

    def go(st):
        g = st["ok"] & (st["i"] < nsteps)
        if beta_thresh is not None:
            b = st["beta"]  # one per walker in a replica chunk
            g = g & ((b.max() if b.dim() else b) < beta_thresh)
        if fmax_target is not None:
            g = g & (st["fmax"] >= fmax_target)
        return g

    return go


def drive(state, step, go, nsteps, rebuild=None):
    """The eager counterpart of the JAX drivers' ``lax.while_loop``.

    ``state`` is a dict of device tensors with ``i`` (0-d int64, steps
    done) and ``ok`` (0-d bool, no unserviced skin breach);
    ``step(state, it) -> dict`` gives the body's new values for iteration
    ``it``, each committed only where ``go(state)`` held before the step,
    so the state that comes out is that of the step on which the JAX loop
    stops, however far the host ran ahead.  The host stops issuing steps
    once a :class:`_FlagWatch` event reports the flag down, and never
    waits for the card on the way.

    ``rebuild(state) -> dict``, where given, serves a skin breach: after a
    run of steps ended with ``ok`` down, one host read (``host_read``)
    finds out whether a breach ended it; the table is then rebuilt at the
    breached state and the forces recomputed with it — what the JAX
    loop's in-loop ``lax.cond`` rebuild yields — and stepping resumes.
    ``ok`` still down with no step since the last rebuild means that the
    rebuild failed: the loop ends and the host path takes over.

    Under a torch profiler the loop is the span ``af.chunk`` and each
    issued iteration, committed or not, an ``af.step``
    (:func:`..profiling.span`)."""
    dev = state["i"].device
    it = 0  # iterations issued: committed steps are a prefix of them
    rebuilt_at = 0  # committed-step count of the last rebuild
    with span("af.chunk"):
        while True:
            watch = _FlagWatch(dev, nsteps + 1)
            active = go(state)
            watch.push(0, active)
            while it < nsteps:
                if watch.dropped():
                    break
                with span("af.step"):
                    new = step(state, it)
                    for k, v in new.items():
                        state[k] = _where(active, v, state[k])
                    state["i"] = state["i"] + active.to(state["i"].dtype)
                    active = go(state)
                    it += 1
                    watch.push(it, active)
            if rebuild is None:
                break
            with host_read():
                ok_h, i_h = device_fetch(state["ok"],
                                         state["i"].to(torch.int32))
                if bool(ok_h) or int(i_h) == rebuilt_at:
                    break
                state.update(rebuild(state))
            rebuilt_at = it = int(i_h)
            if it >= nsteps:
                break
    return state


def skin_table(amask, skin_half, rebuild_fn=None):
    """(breach, with_rebuild) of a loop under a fixed cell.
    ``breach(pos, p0)``: an atom moved half the skin since the table's
    build at ``p0``; ``with_rebuild(pos, tbl, p0)``: the table, origin and
    ``ok`` after a (masked) rebuild at ``pos`` — one that is not due (no
    breach) or fails keeps the old table and origin, and drops ``ok``
    only when it failed."""

    def breach(pos, p0):
        return ((pos - p0) ** 2 * amask).sum(-1).max() >= skin_half**2

    def with_rebuild(pos, tbl, p0):
        hit = breach(pos, p0)
        new_tbl, rok = rebuild_fn(pos)
        take = hit & rok
        return dict(tbl=_where(take, new_tbl, tbl),
                    pos0=torch.where(take, pos, p0), ok=~hit | rok)

    return breach, with_rebuild


def _noise(gen, shape, dtype, seed, step):
    """Standard normal noise of global step ``step`` of stream ``seed``
    (``gen``: a generator on the target device, reseeded here)."""
    gen.manual_seed((int(seed) * 0x9E3779B1 + int(step)) % (1 << 63))
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def _chunk_loop(forces_fn, pos_init, amask, velocities, masses, pos0, dt, kT,
                friction, skin_half, beta_thresh, nsteps, thermostat,
                check_beta, seed=0, step0=0, tbl=None, rebuild_fn=None,
                nhc=None, nrep=1, noise_rows=None):
    """The integrator loop.

    ``forces_fn(pos, tbl) -> (e, f, beta_max)`` supplies the physics; the
    loop does velocity-Verlet / BAOAB-Langevin / NHC stepping with early
    exit on a Verlet-skin breach or an uncertainty trip.  ``amask``: (N, 1)
    atom mask; ``nhc``: (Q (3,), dof, vxi (3,), xi (3,)) of the chain
    (thermostat "nhc").  Returns (pos, vel, f, e, beta_max, ndone, tbl,
    pos0, vxi, xi) with ``ndone`` a 0-d device tensor.

    ``nrep`` > 1: the rows are that many walkers' blocks of equal size
    (:func:`md_chunk_replicas`); ``seed`` is then a sequence of one noise
    stream per walker, the chain state is (nrep, 3) and ``forces_fn``
    gives one energy and one beta_max per walker.  ``noise_rows``: the
    first rows, which alone draw Langevin noise (the rest, a mesh's
    padding, none).

    With ``rebuild_fn`` a skin breach does not end the loop: the table is
    rebuilt from the breached positions (``rebuild_fn(pos) -> (tbl,
    ok)``), forces are recomputed with it, and stepping continues; the
    loop ends early only on an uncertainty trip or a failed rebuild (the
    host then grows the bucket).  A failed rebuild keeps the last good
    table and origin.
    """
    if thermostat not in ("langevin", "nhc", "none"):
        raise ValueError(f"unknown thermostat {thermostat!r}")
    dev = pos_init.device
    dtype = pos_init.dtype
    c1 = math.exp(-friction * dt)
    c2 = torch.sqrt(kT * (1.0 - c1 * c1) / masses)
    half = 0.5 * dt
    gen = torch.Generator(device=dev) if thermostat == "langevin" else None

    breach, with_rebuild = skin_table(amask, skin_half, rebuild_fn)
    nper = pos_init.shape[0] // nrep

    def ke2(vel):
        k = masses * vel * vel * amask
        return k.sum() if nrep == 1 else k.reshape(nrep, -1).sum(1)

    def scaled(vel, sc):  # each walker's velocities times its chain scale
        if nrep == 1:
            return vel * sc
        return (vel.reshape(nrep, nper, 3) * sc[:, None, None]).reshape(
            vel.shape)

    def noise(it):
        if noise_rows is not None:
            xi = _noise(gen, (noise_rows, 3), dtype, seed, step0 + it)
            return torch.cat([xi, xi.new_zeros(
                (velocities.shape[0] - noise_rows, 3))])
        if nrep == 1:
            return _noise(gen, velocities.shape, dtype, seed, step0 + it)
        return torch.cat([_noise(gen, (nper, 3), dtype, sd, step0 + it)
                          for sd in seed])

    def step(st, it):
        pos, vel, f = st["pos"], st["vel"], st["f"]
        out = {}
        if thermostat == "nhc":
            Q, dof = nhc[0], nhc[1]
            # chain-half, B, drift, B, chain-half (md/nose_hoover.py step)
            s, _, vxi, xi = _nhc_half(ke2(vel), st["vxi"], st["xi"], Q, kT,
                                      dof, dt)
            v = scaled(vel, s)
            v = v + half * f / masses
            p = pos + dt * v
            e2, f2, b2 = forces_fn(p, st["tbl"])
            v = v + half * f2 / masses
            s, _, vxi, xi = _nhc_half(ke2(v), vxi, xi, Q, kT, dof, dt)
            v = scaled(v, s)
            out.update(vxi=vxi, xi=xi)
        else:
            v = vel + half * f / masses  # B
            p = pos + half * v  # A
            if thermostat == "langevin":
                v = c1 * v + c2 * noise(it)  # O
            p = p + half * v  # A
            e2, f2, b2 = forces_fn(p, st["tbl"])
            v = v + half * f2 / masses  # B
        out.update(pos=p, vel=v, e=e2, f=f2, beta=b2,
                   ok=~breach(p, st["pos0"]))
        return out

    def rebuild(st):
        out = with_rebuild(st["pos"], st["tbl"], st["pos0"])
        out["e"], out["f"], out["beta"] = forces_fn(st["pos"], out["tbl"])
        return out

    st = dict(pos=pos_init, vel=velocities, tbl=tbl, pos0=pos0,
              i=torch.zeros((), dtype=torch.int64, device=dev))
    with span("af.chunk_start"):
        if rebuild_fn is not None:
            st.update(with_rebuild(pos_init, tbl, pos0))
        else:
            st["ok"] = ~breach(pos_init, pos0)
        st["e"], st["f"], st["beta"] = forces_fn(pos_init, st["tbl"])
    if nhc is not None:
        st.update(vxi=nhc[2], xi=nhc[3])
    go = _go(nsteps, beta_thresh if check_beta else None)
    st = drive(st, step, go, nsteps,
               rebuild=rebuild if rebuild_fn is not None else None)
    return (st["pos"], st["vel"], st["f"], st["e"], st["beta"], st["i"],
            st["tbl"], st["pos0"], st.get("vxi"), st.get("xi"))


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
    thermostat="langevin",  # "langevin" | "nhc" | "none"
    rebuild=False,  # in-loop neighbor rebuild at skin breaches
    rebuild_cut=None,  # rc + skin (required when rebuild)
    sidx_atom=None,  # (N,) i32 species-table index per atom
    sidx_ok=None,  # (N,) bool: species known to the engine table
    seed=0,  # Langevin noise stream
    step0=0,  # global index of this chunk's first step (noise counter)
    nhc_Q=None,  # (3,) chain masses (thermostat="nhc")
    nhc_dof=None,  # 3 * n_real
    nhc_vxi=None,  # (3,) chain velocities (carried across chunks)
    nhc_xi=None,  # (3,) chain positions
    ks=None,  # the engine's kernel space (Engine.kernel_space())
    mean_e=None,  # (E,) expert mean energies: ``model`` is a committee
    meta_scale=None,  # ActiveMeta bias strength (eV), fused into the step
    meta_vs=None,  # (N,), or (E, N) under a committee: inf / unseen -> 0
    nrep=1,  # walkers stacked in ``cfg`` (md_chunk_replicas)
    mesh=None,  # a device mesh (parallel.mesh): cfg, model mesh-padded
    own_idx=None,  # the mesh's row ids (parallel.mesh.mesh_pad)
    noise_rows=None,  # rows that draw Langevin noise (default: all)
):
    """Run up to ``nsteps`` MD steps on the device; early-exit on a skin
    breach or the uncertainty threshold.
    Returns (pos, vel, f, e, beta_max, ndone) with ``ndone`` a 0-d device
    tensor; with ``rebuild=True`` also (tbl, pos0): the live table tuple
    (idx, off, sidx, mask[, rev]) and its build origin, for chaining into
    the next chunk; with ``thermostat="nhc"`` then (nhc_vxi, nhc_xi), the
    chain state for the next chunk.  ``meta_scale`` / ``meta_vs`` bias the
    surface with ActiveMeta (:func:`_sgpr_forces`).  With ``mesh`` the
    forces are sharded (``parallel.mesh.mesh_chunk``, the JAX package's
    ``sharded_md_chunk``) on inputs padded by ``parallel.mesh.pad_chain``,
    whose ``noise_rows`` keep the unsharded chain's noise; the table it
    returns is the whole configuration's."""
    whole = None
    if mesh is not None:
        from ..parallel.mesh import mesh_chunk

        forces_fn, tbl0, rebuild_fn, whole, _ = mesh_chunk(
            cfg, model, radii, vscale_atom, own_idx, mesh, params, exponent,
            check_beta, ks, mean_e, meta_scale, meta_vs, rebuild=rebuild,
            rebuild_cut=rebuild_cut, sidx_atom=sidx_atom, sidx_ok=sidx_ok)
    else:
        cfg_with, tbl0, rebuild_fn = _inloop_table(
            cfg, rebuild, rebuild_cut, sidx_atom, sidx_ok, nrep
        )
        nimg = nrep if nrep > 1 else None

        def forces_fn(pos, tbl):
            return _sgpr_forces(pos, cfg_with(tbl), model, radii,
                                vscale_atom, params, exponent, check_beta,
                                ks, mean_e, nimg, meta_scale, meta_vs)

    nhc = None
    if thermostat == "nhc":
        nhc = (nhc_Q, float(nhc_dof), nhc_vxi, nhc_xi)
    with torch.no_grad():
        out = _chunk_loop(
            forces_fn, cfg.positions, cfg.atom_mask[:, None], velocities,
            masses, pos0, float(dt), float(kT), float(friction),
            float(skin_half), float(beta_thresh), int(nsteps), thermostat,
            check_beta, seed=seed, step0=step0, tbl=tbl0,
            rebuild_fn=rebuild_fn, nhc=nhc, nrep=nrep, noise_rows=noise_rows,
        )
    pos, vel, f, e, beta_max, i, tbl, pos0, vxi, xi = out
    ret = (pos, vel, f, e, beta_max, i)
    if rebuild:
        ret = ret + (tbl if whole is None else whole(tbl), pos0)
    if nhc is not None:
        ret = ret + (vxi, xi)
    return ret


def md_chunk_replicas(cfgs, model, radii, vscale_atom, velocities, masses,
                      pos0, dt, kT, friction, skin_half, beta_thresh,
                      nsteps=20, seeds=(0,), **kw):
    """R MD walkers that share one model, stepped in lockstep (the
    counterpart of the JAX package's ``md_chunk_replicas``, which
    ``vmap``s :func:`md_chunk`).

    ``cfgs``: the walkers' configurations (one bucket, one cell), stacked
    here as rows of one configuration (:func:`stack_images`), so each
    ensemble step is one launch of each SOAP kernel, one Gram product and
    one backward for all walkers.  ``velocities``, ``pos0``: (R, N, 3);
    ``vscale_atom``: (N,) and ``masses``: (N, 1), shared.  Walker r draws
    its Langevin noise from stream ``seeds[r]``, so it reproduces
    ``md_chunk(..., seed=seeds[r])``; the NHC chain state ``nhc_vxi`` /
    ``nhc_xi`` is (R, 3).  The chunk ends at the first uncertainty trip of
    any walker, or at the first skin breach of any walker unless the
    in-loop rebuild (``rebuild=True``, which rebuilds every walker's table)
    serves it; ``kw``: as :func:`md_chunk`, with ``sidx_atom`` / ``sidx_ok``
    of one walker.  Returns (pos, vel, f) of shape (R, N, 3), e (R,),
    beta_max (R,), ndone, then what :func:`md_chunk` adds: the table and
    its origin on the stacked rows, the chain state."""
    R, N = velocities.shape[:2]
    if kw.get("rebuild"):
        kw["sidx_atom"] = kw["sidx_atom"].repeat(R)
        kw["sidx_ok"] = kw["sidx_ok"].repeat(R)
    out = md_chunk(stack_images(cfgs, shared_cell=True), model, radii,
                   vscale_atom.repeat(R), velocities.reshape(R * N, 3),
                   masses.repeat(R, 1), pos0.reshape(R * N, 3), dt, kT,
                   friction, skin_half, beta_thresh, nsteps,
                   seed=list(seeds), nrep=R, **kw)
    pos, vel, f = (t.reshape(R, N, 3) for t in out[:3])
    return (pos, vel, f) + tuple(out[3:])


def stack_images(cfgs, shared_cell=False):
    """One configuration whose rows are the rows of ``cfgs`` (same
    bucket): neighbor indices and reverse slots are offset by each
    image's row block, so the images stay independent, and each row
    carries its image's cell ((N, 3, 3), engine._env_rvec) — or, with
    ``shared_cell`` (walkers in one box), the first image's (3, 3)."""
    n, k = cfgs[0].nbr_idx.shape
    rev = None
    if all(c.nbr_rev is not None for c in cfgs):
        rev = torch.cat([torch.where(c.nbr_rev >= 0, c.nbr_rev + r * n * k,
                                     c.nbr_rev) for r, c in enumerate(cfgs)])
    cell = (cfgs[0].cell if shared_cell
            else torch.cat([c.cell.expand(n, 3, 3) for c in cfgs]))
    return ConfigArrays(
        positions=torch.cat([c.positions for c in cfgs]),
        cell=cell,
        numbers=torch.cat([c.numbers for c in cfgs]),
        atom_mask=torch.cat([c.atom_mask for c in cfgs]),
        nbr_idx=torch.cat([c.nbr_idx + r * n for r, c in enumerate(cfgs)]),
        nbr_off=torch.cat([c.nbr_off for c in cfgs]),
        nbr_sidx=torch.cat([c.nbr_sidx for c in cfgs]),
        nbr_mask=torch.cat([c.nbr_mask for c in cfgs]),
        nbr_rev=rev,
    )


def check_plain_surface(calc, what="DeviceMD", allow_covloss_meta=False):
    """The device chunks integrate the plain (possibly committee) SGPR
    surface; a metadynamics bias or a per-step multi-task schedule acts in
    the host ``calculate`` and would be dropped between chunk boundaries,
    so it is refused.

    With ``allow_covloss_meta`` an :class:`~..calculator.meta.ActiveMeta`
    bias is admitted (kernel-space math without state, which the chunk
    fuses into its energy gradient) and returned for the caller to wire
    up.  A :class:`~..calculator.multitask.MultiTaskCalculator` with static
    weights is a plain SGPR surface with ``mu = effective_mu(weights)``
    and is admitted; weight schedules (``weights_sample``, ``weights_fin``)
    and bond restraints (``ij``) are refused."""
    meta = getattr(calc, "meta", None)
    if meta is not None:
        if allow_covloss_meta:
            from ..calculator.meta import ActiveMeta

            if isinstance(meta, ActiveMeta):
                return meta
        raise NotImplementedError(
            f"{what} integrates the plain SGPR surface; this "
            "metadynamics bias is applied per step by the host drivers "
            "(md.Langevin / md.VelocityVerlet / md.NoseHooverNVT)")
    from ..calculator.multitask import MultiTaskCalculator

    if isinstance(calc, MultiTaskCalculator) and (
            calc.weights_sample is not None or calc.weights_fin is not None
            or (calc.ij is not None and len(calc.ij) > 0)):
        raise NotImplementedError(
            f"{what} integrates a fixed multi-task surface; per-step "
            "weight schedules (thermodynamic integration, weights_sample) "
            "and bond restraints are applied by the host calculate: use "
            "the host MD drivers for those")
    return None


# vscale sentinel for a species a model has never seen: the host's inf
# (any uncertainty trips sampling; an expert's covmax saturates at 1, so
# its weight goes to 0) as a huge finite value that keeps 0 * inf out of
# beta
VS_UNSEEN = 1e8


def committee_models(calc):
    """The frozen experts and the live model of a committee calculator
    with experts (each solved and non-empty); [] for one model.  Shared
    by every device driver that serves committees."""
    from ..calculator.bcm import BCMActiveCalculator, servable

    if not (isinstance(calc, BCMActiveCalculator) and calc.experts):
        return []
    # with a frozen expert the committee serves, even when only one model
    # is servable (the live one may be freshly spawned and empty)
    return servable([*calc.experts.values(), calc.model])


def committee_stack(calc, system, models, cfg, state):
    """The committee's model state on the device: ModelArrays with a
    leading expert axis at a common inducing capacity, with the experts'
    (E, N) vscale rows and (E,) mean energies.  ``state`` carries the
    sticky capacity ``mcap`` and the per-expert staging ``cache`` across
    a driver's chain rebuilds: a frozen expert is staged and uploaded
    again only when its ``state_version``, the capacity, the species
    table, the numbers or the pair buffer changed."""
    eng = calc.engine
    numbers = cfg.numbers.cpu().numpy()
    # doubling growth from 32, as SgprModel.full_model_arrays
    mcap = max(state.get("mcap", 0), 32)
    for m in models:
        m.adopt_engine(eng)
        while mcap < m.m:
            mcap *= 2
        if eng.pair_terms:
            for x in m.X:
                eng.grow_pair_kx(x)
    state["mcap"] = mcap
    cache = state.get("cache", {})
    new_cache = {}
    token0 = (mcap, tuple(eng.species), numbers.tobytes(),
              np.asarray(system.numbers).tobytes(), eng.pair_kx)
    mas, vs_rows, mean_rows = [], [], []
    for m in models:
        token = (m.state_version,) + token0
        ent = cache.get(id(m))
        if ent is None or ent[0] is not m or ent[1] != token:
            Xd = (np.stack([x.desc for x in m.X]) if m.m
                  else np.zeros((0, eng.dim)))
            Xn = np.array([x.number for x in m.X], dtype=np.int32)
            Xl = np.array([x.lone for x in m.X], dtype=bool)
            ma = eng.model_arrays(Xd, Xn, Xl, m.mu, m.choli, mcap=mcap,
                                  envs=m.X)
            vs = m.vscale_for(numbers)
            ent = (m, token, (ma, np.where(np.isfinite(vs), vs, VS_UNSEEN),
                              m.mean_energy(system.numbers)))
        new_cache[id(m)] = ent
        ma, vs_row, mean_row = ent[2]
        mas.append(ma)
        vs_rows.append(vs_row)
        mean_rows.append(mean_row)
    state["cache"] = new_cache
    stacked = ModelArrays(*(None if xs[0] is None else torch.stack(xs)
                            for xs in zip(*mas)))
    return stacked, np.stack(vs_rows), np.asarray(mean_rows)


def new_chain(calc, system, check_beta, committee=None, meta=False):
    """Device state shared by a chain of chunks of any device driver, from
    the calculator's current configuration: the config, model arrays,
    radii, uncertainty scale, masses, the table's build origin and the
    in-loop rebuild's species tables and cutoff, and the kernel space.
    Under a committee (``committee``: the driver's staging state of
    :func:`committee_stack`) ``ma`` carries the expert axis, ``vs`` is
    (E, N) and ``mean_e`` holds the experts' mean energies (else None).
    With ``meta``, ``meta_vs`` holds the ActiveMeta bias's scale rows (a
    species without a scale at 0, not :data:`VS_UNSEEN`)."""
    eng = calc.engine
    cfg = calc.cfg
    dtype, dev = cfg.positions.dtype, cfg.positions.device
    models = committee_models(calc)
    if models:
        ma, vs, mean_e = committee_stack(
            calc, system, models, cfg, {} if committee is None else committee)
        meta_vs = np.where(vs >= VS_UNSEEN, 0.0, vs)
    else:
        ma, mean_e = calc.model.full_model_arrays(), None
        vs = calc.model.vscale_for(cfg.numbers.cpu().numpy())
        meta_vs = np.where(np.isfinite(vs), vs, 0.0)
        vs = np.where(np.isfinite(vs), vs, VS_UNSEEN)
    npad = cfg.npad
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
        mean_e=None if mean_e is None else t(mean_e, eng.model_dtype),
        radii=eng.radii_table(),
        vs=t(vs),
        masses=t(masses),
        pos0=t(pos0),
        sidx_atom=t(np.maximum(sidx, 0), torch.int32),
        sidx_ok=t(sidx >= 0, torch.bool),
        cut=eng.params.rc + calc._nlcache.skin,
        beta_thresh=calc.ediff if check_beta else np.inf,
        ks=eng.kernel_space(),
        meta_vs=t(meta_vs) if meta else None,
    )


def mesh_chain(chain, mesh):
    """``chain`` padded to ``mesh`` (``parallel.mesh.pad_chain``), or as it
    is without one."""
    if mesh is None:
        return chain
    from ..parallel.mesh import pad_chain

    return pad_chain(chain, mesh)


def padded_rows(a, npad, like):
    """Host rows ``a`` zero-padded to ``npad`` rows, as a tensor of
    ``like``'s type on its device."""
    out = np.zeros((npad,) + np.shape(a)[1:])
    out[: len(a)] = a
    return torch.as_tensor(out, dtype=like.dtype, device=like.device)


class DeviceMD:
    """Chunked on-device MD around an inference ActiveCalculator.

    A drop-in fast MD engine for a frozen model or a committee of them
    (:func:`committee_models`).  The chunk stops at the
    exact step on which the uncertainty crosses the calculator's ``ediff``
    when ``check_beta`` is on, and the host then runs the calculator's
    full ``calculate`` there.  Thermostats: BAOAB Langevin, a Nose-Hoover
    chain (``"nhc"``: M = 3, canonical and deterministic, the device
    counterpart of md/nose_hoover.NoseHooverNVT; its state is carried
    across chunks on the card) or none (NVE).  An ActiveMeta bias
    (``calc.meta``) is fused into the step's energy, on the plain dot
    kernel only; a multi-task calculator with static weights serves its
    combined surface.  Under ``calc.engine.mesh`` the chunks run sharded
    (``md_chunk(mesh=...)``), with the same in-loop rebuild: each data
    shard rebuilds its own rows."""

    def __init__(self, system, calc, dt, temperature_K=None, friction=0.01,
                 chunk=50, seed=0, check_beta=None, thermostat="auto",
                 tdamp=None):
        from ..neighbors_device import device_rebuild_ok

        meta = check_plain_surface(calc, "DeviceMD", allow_covloss_meta=True)
        if meta is not None and not calc.engine.plain_kernel:
            raise NotImplementedError(
                "the device-fused ActiveMeta needs the plain dot kernel (the "
                "host bias formula, engine.meta_covloss_fn, is defined "
                "there): use the host MD drivers")
        self.meta_scale = float(meta.scale) if meta is not None else None
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
        if thermostat not in ("langevin", "nhc", "none"):
            raise ValueError(f"unknown thermostat {thermostat!r}")
        self.thermostat = thermostat
        self.tdamp = float(tdamp) if tdamp else 100.0 * self.dt
        # chain state: host copies, refreshed by each chunk's one read
        self.nhc_vxi = np.zeros(3)
        self.nhc_xi = np.zeros(3)
        self._nhc_dev = None
        # the in-loop device rebuild where the MIC builder holds; otherwise
        # a skin breach ends the chunk and the host rebuilds the table
        self.in_loop_rebuild = device_rebuild_ok(
            system.cell, system.pbc,
            calc.engine.params.rc + calc._nlcache.skin,
        )
        self._stall = 0
        self._committee = {}  # committee_stack's staging across chains
        self.mesh = getattr(calc.engine, "mesh", None)

    def _new_chain(self):
        """Device state of a chain of chunks, from the calculator's
        current configuration (padded to the mesh under one)."""
        chain = new_chain(self.calc, self.system, self.check_beta,
                          self._committee, meta=self.meta_scale is not None)
        chain["vel"] = padded_rows(self.system.get_velocities(),
                                   chain["cfg"].npad, chain["pos0"])
        return mesh_chain(chain, self.mesh)

    def _nhc_kw(self, like):
        """The chain's masses, dof and device state for the next chunk."""
        n = len(self.system)
        Q = np.full(3, self.kT * self.tdamp**2)
        Q[0] *= 3.0 * n
        if self._nhc_dev is None:
            self._nhc_dev = tuple(
                torch.as_tensor(a, dtype=like.dtype, device=like.device)
                for a in (self.nhc_vxi, self.nhc_xi))
        return dict(nhc_Q=torch.as_tensor(Q, dtype=like.dtype,
                                          device=like.device),
                    nhc_dof=3.0 * n, nhc_vxi=self._nhc_dev[0],
                    nhc_xi=self._nhc_dev[1])

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
            nhc = self.thermostat == "nhc"
            nhc_kw = self._nhc_kw(chain["pos0"]) if nhc else {}
            out = md_chunk(
                chain["cfg"], chain["ma"], chain["radii"], chain["vs"],
                chain["vel"], chain["masses"], chain["pos0"],
                self.dt, self.kT, self.friction, 0.5 * calc._nlcache.skin,
                chain["beta_thresh"], n,
                params=eng.params, exponent=eng.exponent,
                check_beta=self.check_beta, thermostat=self.thermostat,
                rebuild=inloop, rebuild_cut=chain["cut"],
                sidx_atom=chain["sidx_atom"], sidx_ok=chain["sidx_ok"],
                seed=self.seed, step0=self.nsteps, ks=chain["ks"],
                mean_e=chain["mean_e"], meta_scale=self.meta_scale,
                meta_vs=chain["meta_vs"], mesh=self.mesh,
                own_idx=chain.get("oidx"),
                noise_rows=chain.get("noise_rows"), **nhc_kw,
            )
            pos, vel, f, e, beta_max, i = out[:6]
            if inloop:
                tbl, p0 = out[6:8]
                chain["cfg"] = _graft(chain["cfg"], tbl)
                chain["pos0"] = p0
            if nhc:
                self._nhc_dev = out[-2:]
                # one host read for every boundary scalar and the chain
                bm_h, i_h, self.nhc_vxi, self.nhc_xi = device_fetch(
                    beta_max, i.to(torch.int32), *self._nhc_dev)
            else:
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
                        # NHC / NVE chains stay deterministic: plain Verlet
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
