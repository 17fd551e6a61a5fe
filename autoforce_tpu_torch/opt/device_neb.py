"""Device-resident NEB: the whole band relaxes on the GPU (port of
``autoforce_tpu/opt/device_neb.py``), on one SGPR model or a committee.

The JAX package evaluates the images with ``jax.vmap``; the SOAP kernels
have no batching rule here, so the moving (interior) images are stacked
as rows of one configuration instead: each image keeps its own neighbor
indices and reverse slots, offset by its row block, and its own cell, one
per row, and every band evaluation is one forward and one backward
kernel launch (the energy is summed per image, its gradient is the forces
of every image at once).  Under a committee the experts' weights are
taken per image (``md.device_md._committee_e``).  The end points never
move: their energies and uncertainties are evaluated once per chain of
chunks.

Around that, the improved-tangent projection (Henkelman-Jonsson, JCP
113, 9978 (2000)), the spring forces, the optional climbing image (JCP
113, 9901 (2000)) and the band FIRE update run as eager device steps
through :func:`..md.device_md.drive`.  Host re-entry: band convergence,
an uncertainty trip on any image (every image is then re-evaluated
through the full calculator, what the host NEB's _compute does), a
Verlet-skin breach on any image (the tables are rebuilt between chunks),
or the step budget.

The math is exactly opt/neb.NEB.get_forces + opt/fire.FIRE.step over the
stacked interior coordinates, so device bands equal the host optimizer's
to float rounding while no FIRE branch sits on an fp knife edge.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import device_fetch
from ..md.device_md import (VS_UNSEEN, _go, _sgpr_forces,
                            check_plain_surface, committee_models,
                            committee_stack, drive, skin_table,
                            stack_images)
from ..profiling import span
from .device_fire import _fire_update


def band_forces(pos, cfg, model, radii, vscale_atom, params, exponent,
                check_beta, ks=None, mean_e=None, mesh=None, own_idx=None):
    """(e (R,), f (R, N, 3), beta_max (R,)) of R images of N rows each,
    ``pos`` (R, N, 3), stacked in ``cfg`` (:func:`stack_images`): one
    forward and one backward kernel launch for all of them; ``ks``: the
    engine's kernel space.  With ``mean_e`` the model is a committee:
    each image's energy is its weighted committee energy and its beta
    the committee floor.  ``mesh``: :func:`band_fn`'s."""
    return band_fn(cfg, model, radii, vscale_atom, params, exponent,
                   check_beta, ks, mean_e, pos.shape[0], mesh, own_idx)(pos)


def band_fn(cfg, model, radii, vscale_atom, params, exponent, check_beta,
            ks=None, mean_e=None, nimg=1, mesh=None, own_idx=None):
    """:func:`band_forces` of ``nimg`` images as a function of their
    positions.  With ``mesh`` the images are mesh-padded
    (``parallel.mesh.pad_images_for_mesh``) and every image's atoms are
    sharded alike over 'data', laid out once here
    (``parallel.mesh.mesh_chunk``): each evaluation launches each SOAP
    kernel once per data shard."""
    if mesh is None:
        def forces(pos):
            R, N = pos.shape[:2]
            e, f, bmax = _sgpr_forces(pos.reshape(R * N, 3), cfg, model,
                                      radii, vscale_atom, params, exponent,
                                      check_beta, ks, mean_e, nimg=R)
            return e, f.reshape(R, N, 3), bmax

        return forces
    from ..parallel.mesh import mesh_chunk

    fn = mesh_chunk(cfg, model, radii, vscale_atom, own_idx, mesh, params,
                    exponent, check_beta, ks, mean_e, nimg=nimg).forces_fn

    def forces(pos):
        R, N = pos.shape[:2]
        e, f, bmax = fn(pos.reshape(R * N, 3))
        if R == 1:
            e, bmax = e[None], bmax[None]
        return e, f.reshape(R, N, 3), bmax

    return forces


def neb_chunk(
    cfg,  # ConfigArrays of the stacked interior images (stack_images)
    model,
    radii,
    vscale_atom,  # (R_int * N,), or (E, R_int * N) under a committee
    pos,  # (R, N, 3) whole band, end points included
    e_end,  # (2,) end-point energies
    b_end,  # 0-d end-point uncertainty max
    v,  # (R, N, 3) band FIRE velocity (zeros on the end points)
    pos0,  # (R, N, 3) table-build origins
    dt,
    a,
    n_uphill,
    skin_half,
    fmax_target,
    beta_thresh,
    nsteps,
    k_spring,
    fire,  # dict maxstep, dtmax, nmin, finc, fdec, astart, fa (floats)
    params=None,
    exponent=4,
    check_beta=True,
    climb=False,
    ks=None,  # the engine's kernel space (Engine.kernel_space())
    mean_e=None,  # (E,) expert mean energies: ``model`` is a committee
    mesh=None,  # a device mesh (parallel.mesh): images mesh-padded
    own_idx=None,  # one image's row ids (pad_images_for_mesh)
):
    """Up to ``nsteps`` band-FIRE iterations on the device; early exit on
    band convergence (max interior |F_neb| < fmax_target, checked before
    the step like Optimizer.run), an uncertainty trip on any image, or a
    skin breach on any image.  Returns (pos, v, f_neb, e (R,), beta_max,
    fmax, dt, a, n_uphill, ndone).  With ``mesh`` the band is sharded
    once per chunk (:func:`band_fn`, the JAX package's
    ``sharded_neb_chunk``)."""
    forces_int = band_fn(cfg, model, radii, vscale_atom, params, exponent,
                         check_beta, ks, mean_e, pos.shape[0] - 2, mesh,
                         own_idx)

    amask = cfg.atom_mask[: pos.shape[1], None]  # images share the system
    with torch.no_grad():
        st = _neb_loop(forces_int, pos, e_end, b_end, amask, v, pos0, dt, a,
                       n_uphill, float(skin_half), float(fmax_target),
                       float(beta_thresh), int(nsteps), float(k_spring),
                       fire, check_beta, climb)
    return (st["pos"], st["v"], st["f"], st["e"], st["beta"], st["fmax"],
            st["dt"], st["a"], st["nu"], st["i"])


def _neb_loop(forces_int, positions, e_end, b_end, amask, v, pos0, dt, a,
              n_uphill, skin_half, fmax_target, beta_thresh, nsteps,
              k_spring, fire, check_beta, climb):
    """The band loop.  ``forces_int(pos (R-2, N, 3)) -> (e, f, beta)`` of
    the interior images; the improved-tangent projection, springs,
    climbing image and band FIRE update live here.  Returns the final
    state dict."""
    R = positions.shape[0]
    dev = positions.device
    imask = torch.arange(R, device=dev)
    imask = ((imask > 0) & (imask < R - 1)).to(positions.dtype)
    m = imask[:, None, None] * amask
    is_int = torch.arange(1, R - 1, device=dev)

    def neb_forces(pos):
        """Energies + NEB-projected forces (opt/neb.NEB.get_forces with
        the improved tangent, vectorized over interior images)."""
        e_int, fi, b_int = forces_int(pos[1:-1])
        e = torch.cat([e_end[:1], e_int, e_end[1:]])
        Em, E0, Ep = e[:-2], e[1:-1], e[2:]  # neighbors of interior i
        tp = (pos[2:] - pos[1:-1]) * amask  # (R-2, N, 3)
        tm = (pos[1:-1] - pos[:-2]) * amask
        dE_p = (Ep - E0).abs()
        dE_m = (Em - E0).abs()
        dEmax = torch.maximum(dE_p, dE_m)[:, None, None]
        dEmin = torch.minimum(dE_p, dE_m)[:, None, None]
        up = ((Ep > E0) & (E0 > Em))[:, None, None]
        dn = ((Ep < E0) & (E0 < Em))[:, None, None]
        hi = (Ep > Em)[:, None, None]
        t = torch.where(
            up, tp,
            torch.where(dn, tm, torch.where(hi, tp * dEmax + tm * dEmin,
                                            tp * dEmin + tm * dEmax)),
        )
        tnorm = torch.sqrt((t * t).sum(dim=(1, 2), keepdim=True))
        t = t / (tnorm + 1e-30)
        f_par = (fi * t).sum(dim=(1, 2), keepdim=True) * t
        f_perp = fi - f_par
        dp = torch.sqrt((tp * tp).sum(dim=(1, 2), keepdim=True))
        dm = torch.sqrt((tm * tm).sum(dim=(1, 2), keepdim=True))
        f_neb = f_perp + k_spring * (dp - dm) * t
        if climb:
            imax = torch.argmax(e)  # over ALL images (host NEB)
            is_climb = (is_int == imax)[:, None, None]
            f_neb = torch.where(is_climb, fi - 2.0 * f_par, f_neb)
        zero = torch.zeros_like(fi[:1])
        f = torch.cat([zero, f_neb, zero])
        beta = torch.maximum(b_int.max(), b_end)
        fmax = torch.sqrt(((f * f) * amask).sum(-1).max())
        return dict(e=e, f=f, beta=beta, fmax=fmax)

    breach = skin_table(amask, skin_half)[0]

    def step(st, it):
        # opt/fire.FIRE.step over the stacked interior coordinates (the
        # host optimizer sees the band as ONE (R_int*n, 3) vector)
        v, _, dt, a, nu = _fire_update(st["f"], st["v"], st["dt"], st["a"],
                                       st["nu"], fire, m)
        dr = dt * v
        norm = torch.sqrt(((dr * dr) * m).sum(dim=-1).max())
        dr = dr * torch.where(norm > fire["maxstep"],
                              fire["maxstep"] / (norm + 1e-30),
                              torch.ones_like(norm))
        pos = st["pos"] + dr * m
        out = neb_forces(pos)
        out.update(pos=pos, v=v, dt=dt, a=a, nu=nu, ok=~breach(pos, pos0))
        return out

    with span("af.chunk_start"):
        st = dict(pos=positions, v=v, dt=dt, a=a, nu=n_uphill,
                  ok=~breach(positions, pos0),
                  i=torch.zeros((), dtype=torch.int64, device=dev))
        st.update(neb_forces(positions))
    go = _go(nsteps, beta_thresh if check_beta else None, fmax_target)
    return drive(st, step, go, nsteps)


class DeviceNEB:
    """Chunked on-device NEB relaxation: the band's moving images are one
    row-stacked device configuration; the whole improved-tangent NEB +
    FIRE loop runs on the card.

    ``run(fmax, steps)`` relaxes the interior images in place (host
    Optimizer.run contract) and returns True on convergence; ``barrier()``
    then evaluates max(E) - E[0] through the calculator.  The images must
    share atoms and species; each keeps its own cell.  A committee
    calculator is served on the card, its weights taken per image.  Under
    ``calc.engine.mesh`` every image's atoms are sharded alike over the
    mesh's 'data' axis (``neb_chunk(mesh=...)``), the images still
    stacked as rows.
    """

    def __init__(self, images, calc, k=0.1, climb=False, dt=0.05,
                 maxstep=0.1, dtmax=1.0, nmin=5, finc=1.1, fdec=0.5,
                 astart=0.1, fa=0.99, chunk=50, check_beta=None):
        check_plain_surface(calc, "DeviceNEB")
        n0 = len(images[0])
        for im in images:
            if len(im) != n0 or not np.array_equal(
                np.asarray(im.numbers), np.asarray(images[0].numbers)
            ):
                raise ValueError("NEB images must share atom count/species")
        if len(images) < 3:
            raise ValueError("a band needs at least one interior image")
        self.images = images
        self.calc = calc
        self.k = float(k)
        self.climb = bool(climb)
        self.params = dict(dt=float(dt), maxstep=float(maxstep),
                           dtmax=float(dtmax), nmin=float(nmin),
                           finc=float(finc), fdec=float(fdec),
                           astart=float(astart), fa=float(fa))
        self.chunk = int(chunk)
        self.check_beta = (
            check_beta if check_beta is not None else calc.active
        )
        self.nsteps = 0
        self.dt_cur = float(dt)
        self.a = float(astart)
        self.n_uphill = 0.0
        self.fmax = float("inf")  # max |F_neb| after the last chunk
        self._v = None  # (R, n, 3) host copy of the band FIRE velocity
        self._npad = 0
        self._kpad = 0
        self._stall = 0
        self._committee = {}  # committee_stack's staging across chains
        self.mesh = getattr(calc.engine, "mesh", None)

    def _host_eval(self):
        """Evaluate every image through the full calculator (host NEB
        _compute semantics: sampling can trigger on any image)."""
        for im in self.images:
            im.calc = self.calc
            im.get_potential_energy()

    def _build_chain(self):
        from ..neighbors import neighbor_table, round_up

        calc = self.calc
        eng = calc.engine
        cutoff = eng.params.rc + calc._nlcache.skin
        tables = [
            neighbor_table(s.positions, s.cell, s.pbc, cutoff)
            for s in self.images
        ]
        n0 = len(self.images[0])
        self._npad = max(self._npad, round_up(n0, 16))
        kmax = max(t.kmax for t in tables)
        self._kpad = max(self._kpad, round_up(int(kmax * 1.2) + 4, 16))
        cfgs = [
            eng.make_config(s, npad=self._npad, kpad=self._kpad,
                            table=t.pad_to(self._kpad))
            for s, t in zip(self.images, tables)
        ]
        like = cfgs[0].positions
        dtype, dev = like.dtype, like.device
        models = committee_models(calc)
        if models:
            ma, vs, mean_e = committee_stack(calc, self.images[0], models,
                                             cfgs[0], self._committee)
            mean_e = torch.as_tensor(mean_e, dtype=eng.model_dtype,
                                     device=dev)
        else:
            model = calc.model
            ma, mean_e = model.full_model_arrays(), None
            vs = model.vscale_for(self.images[0].numbers)
            vs = np.where(np.isfinite(vs), vs, VS_UNSEEN)
            vs = np.concatenate([vs, np.zeros(self._npad - n0)])
        R = len(self.images)
        own_idx = None
        if self.mesh is not None:  # every image's rows split evenly
            from ..parallel.mesh import pad_images_for_mesh

            cfgs, ma, own_idx, vs_t = pad_images_for_mesh(
                cfgs, ma, vs, self.mesh, dtype, committee=bool(models))
        else:
            vs_t = torch.as_tensor(vs, dtype=dtype, device=dev)
        npad = cfgs[0].npad

        def vs_rows(k):  # the per-atom rows of k stacked images
            return vs_t.repeat(*([1] * (vs_t.dim() - 1)), k)

        ends = stack_images([cfgs[0], cfgs[-1]])
        pos = torch.stack([c.positions for c in cfgs])
        ks = eng.kernel_space()
        with torch.no_grad():
            e_end, _, b_end = band_forces(
                pos[[0, -1]], ends, ma, eng.radii_table(), vs_rows(2),
                eng.params, eng.exponent, self.check_beta, ks, mean_e,
                self.mesh, own_idx)
        varr = np.zeros((R, npad, 3))
        if self._v is not None:
            varr[:, :n0] = self._v
        return dict(
            cfg=stack_images(cfgs[1:-1]),
            interior=cfgs[1:-1],
            ma=ma,
            mean_e=mean_e,
            radii=eng.radii_table(),
            vs=vs_rows(R - 2),
            pos=pos,
            e_end=e_end,
            b_end=b_end.max(),
            v=torch.as_tensor(varr, dtype=dtype, device=dev),
            pos0=pos,
            beta_thresh=calc.ediff if self.check_beta else np.inf,
            ks=ks,
            oidx=own_idx,
        )

    def _sync_host(self, pos):
        n0 = len(self.images[0])
        (arr,) = device_fetch(pos)
        for r, im in enumerate(self.images):
            im.set_positions(arr[r, :n0])

    def _pull_v(self, v_dev):
        n0 = len(self.images[0])
        (v_h,) = device_fetch(v_dev)
        self._v = v_h[:, :n0]

    def _host_step(self, pos_dev):
        """One host band-FIRE step: no progress even after a host visit
        (sampling vetoed while a device beta stays above the threshold)."""
        from .fire import FIRE
        from .neb import NEB

        self._sync_host(pos_dev)
        for im in self.images:
            im.calc = self.calc
        band = NEB(self.images, k=self.k, climb=self.climb)
        p = self.params
        opt = FIRE(band, dt=p["dt"], maxstep=p["maxstep"], dtmax=p["dtmax"],
                   nmin=int(p["nmin"]), finc=p["finc"], fdec=p["fdec"],
                   astart=p["astart"], fa=p["fa"])
        opt.dt = self.dt_cur
        opt.a = self.a
        opt.n_uphill = int(self.n_uphill)
        if self._v is not None:
            opt.v = np.concatenate(self._v[1:-1], axis=0)
        opt.step(band.get_forces())
        self.dt_cur = opt.dt
        self.a = opt.a
        self.n_uphill = float(opt.n_uphill)
        n0 = len(self.images[0])
        R = len(self.images)
        vv = np.zeros((R, n0, 3))
        vv[1:-1] = opt.v.reshape(R - 2, n0, 3)
        self._v = vv

    def run(self, fmax=0.05, steps=500):
        calc = self.calc
        eng = calc.engine
        done = 0
        first = True
        need_host = True
        chain = None
        pos_dev = v_dev = None
        converged = False
        while done < steps and not converged:
            if chain is None or need_host:
                if pos_dev is not None:
                    self._sync_host(pos_dev)
                    self._pull_v(v_dev)
                    pos_dev = None
                if first or need_host:
                    # full calculator pass over every image (sampling can
                    # trigger on any of them, host NEB _compute semantics)
                    self._host_eval()
                    first = False
                # breach-only rebuilds skip it: _build_chain derives the
                # fresh tables directly
                chain = self._build_chain()
                pos_dev, v_dev = chain["pos"], chain["v"]
            n = min(self.chunk, steps - done)
            like = chain["pos0"]

            def t(x):
                return torch.full((), float(x), dtype=like.dtype,
                                  device=like.device)

            pos, v, f, e, beta_max, fm, dtc, a, nu, i = neb_chunk(
                chain["cfg"], chain["ma"], chain["radii"], chain["vs"],
                pos_dev, chain["e_end"], chain["b_end"], v_dev,
                chain["pos0"], t(self.dt_cur), t(self.a), t(self.n_uphill),
                0.5 * calc._nlcache.skin, fmax, chain["beta_thresh"], n,
                self.k, self.params, params=eng.params,
                exponent=eng.exponent, check_beta=self.check_beta,
                climb=self.climb, ks=chain["ks"], mean_e=chain["mean_e"],
                mesh=self.mesh, own_idx=chain["oidx"],
            )
            # one host read for every boundary scalar
            dtc, a, nu, i_h, fm_h, bm_h = (float(x) for x in device_fetch(
                dtc, a, nu, i.to(torch.int32), fm, beta_max))
            self.dt_cur, self.a, self.n_uphill = dtc, a, nu
            ndone = int(i_h)
            pos_dev, v_dev = pos, v
            self.fmax = fm_h
            converged = fm_h < fmax
            need_host = self.check_beta and bm_h >= chain["beta_thresh"]
            if converged:
                done += ndone
                self.nsteps += ndone
                break
            if ndone < n and not need_host:
                chain = None  # skin breach on some image: rebuild tables
            if ndone == 0:
                self._stall += 1
                if self._stall >= 2:
                    self._pull_v(v_dev)
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
            self._pull_v(v_dev)
        self._host_eval()  # leave every image's results current
        return converged

    def barrier(self):
        es = [im.get_potential_energy() for im in self.images]
        return max(es) - es[0]
