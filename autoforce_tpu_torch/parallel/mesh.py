"""Sharded execution over a ('data', 'model') device mesh (port of
``autoforce_tpu/parallel/mesh.py``).

The JAX package runs one ``shard_map`` over a mesh of devices: atom rows
are sharded over the mesh axis ``'data'``, inducing columns over
``'model'``, the energy is ``psum``-reduced inside the differentiated
function, so one backward gives the globally reduced forces and strain.
The port keeps that single-controller design in one process: a
:class:`Mesh` is an ``(n_data, n_model)`` grid of ``torch.device`` s, a
device may repeat (the CPU tests run a 4x2 layout on ``cpu``, one H100
runs a 2x2 layout on ``cuda:0``), and a user declares one with one line,
``mesh = make_mesh(...)``.  The collectives become:

  * ``psum``: the shards' partials brought to the mesh's first device
    and summed there in a fixed shard order (:func:`_psum`); autograd
    runs back through the ``.to(device)`` copies, so differentiating the
    summed energy gives the reduced forces and virial, as differentiating
    through ``psum`` does in JAX;
  * ``all_gather`` over ``'model'``: a ``torch.cat`` of a data shard's
    covariance blocks along the inducing axis (covloss beta needs whole
    rows and the whole, replicated ``choli``);
  * ``pmax`` over ``'data'``: a max of the shards' maxima.

Positions, velocities and every integrator state stay whole on the first
device; the neighbor tables, atom numbers and masks are sharded by rows,
and ``own_idx`` maps a shard's table rows to its atoms.  Model state
stays float64 (``Engine.model_dtype``), the partial energies are summed
in it.

**Kernel launches.**  A data shard's descriptors are computed once, on
the shard's first device ``devices[d, 0]``, and copied across the model
axis for the Gram products, so a sharded force evaluation (an MD, NPT,
FIRE or band step, ``sharded_predict``) launches the SOAP forward kernel
``n_data`` times and the backward kernel ``n_data`` times, whatever
``n_model`` is and however many committee experts or band images the
rows carry.  ``sharded_kernel_block_jac`` launches each ``n_data`` times
too (the one-hot backward launch); ``sharded_kernel_block`` launches the
forward ``n_data`` times and the backward once per batch of
``batch_size`` live columns and data shard.  The columns of
``kernel_block`` run on the data shard's device, where its coefficients
are: the model axis splits the Gram products of the force evaluations.

The drivers (``md/device_md.py``, ``md/device_npt.py``,
``opt/device_fire.py``, ``opt/device_neb.py``) are eager loops around
``device_md.drive`` with one host read per chunk.  The JAX package's
``sharded_{md,npt,fire,fire_cell,neb}_chunk`` are the port's
``md_chunk``, ``md_chunk_npt``, ``fire_chunk``, ``fire_cell_chunk`` and
``neb_chunk`` called with ``mesh=`` and ``own_idx=``: the same loop, its
physics from :func:`mesh_chunk`.  No step reads the host: the validity
of a rebuilt table is a device ``all`` over the shards.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from ..engine import (ConfigArrays, LceRows, ModelArrays, kernel_block_fn,
                      kernel_block_jac_fn, lce_rows, rows_cov)
from ..kernels import covloss_beta, covloss_bias
from ..md.device_md import _graft
from ..md.device_npt import offsum_max
from ..profiling import span


class Mesh:
    """An ``(n_data, n_model)`` grid of torch devices (a device may
    repeat); ``shape`` maps the axis names to their sizes as the JAX
    mesh's does."""

    axis_names = ("data", "model")

    def __init__(self, devices):
        rows = [[torch.device(d) for d in row] for row in devices]
        nd, nm = len(rows), len(rows[0])
        if nd < 1 or nm < 1 or any(len(r) != nm for r in rows):
            raise ValueError("a mesh is a non-empty (n_data, n_model) grid")
        self.devices = np.empty((nd, nm), dtype=object)
        for d in range(nd):
            for m in range(nm):
                self.devices[d, m] = rows[d][m]
        self.shape = {"data": nd, "model": nm}

    @property
    def first(self):
        """The device that holds the whole state and the reductions."""
        return self.devices[0, 0]

    def __repr__(self):
        names = [[str(d) for d in row] for row in self.devices]
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, " \
               f"devices={names})"


def make_mesh(n_data=None, n_model=1, devices=None, *, data=None, model=None):
    """Create a ('data', 'model') mesh.  ``data``/``model`` are aliases for
    ``n_data``/``n_model`` (the short forms of ARGS files).  ``devices``
    defaults to every visible CUDA device, never the CPU; a list may name
    a device more than once (``["cuda:0"] * 4`` for a 2x2 mesh on one
    card, ``["cpu"] * 8`` on the CPU).  Raises when there are too few."""
    if data is not None:
        n_data = data
    if model is not None:
        n_model = model
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    devices = [torch.device(d) for d in devices]
    n_data = n_data if n_data is not None else len(devices) // n_model
    need = n_data * n_model
    if n_data < 1 or n_model < 1 or need > len(devices):
        kind = devices[0].type if devices else "cuda"
        raise ValueError(f"mesh {n_data}x{n_model} needs {max(need, 1)} "
                         f"devices, have {len(devices)} ({kind})")
    grid = [devices[d * n_model:(d + 1) * n_model] for d in range(n_data)]
    return Mesh(grid)


def same_device(a, b):
    """Two torch devices are one (``cuda`` is the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index
    cur = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)


# --------------------------------------------------------------------------
# padding to mesh-divisible sizes
# --------------------------------------------------------------------------


def _pad_to(x, size, axis=0, fill=0):
    if x is None:
        return None
    extra = size - x.shape[axis]
    if extra <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = extra
    return torch.cat([x, x.new_full(shape, fill)], dim=axis)


def _pad_cfg(cfg: ConfigArrays, n2):
    """Pad a config's rows to ``n2``.  The reverse-slot table is dropped:
    padding invalidates its flat i*K+k indexing, and the mesh paths use
    the scatter backward of ``engine._env_rvec`` with ``oidx``."""
    cell = cfg.cell if cfg.cell.dim() == 2 else _pad_to(cfg.cell, n2)
    return ConfigArrays(
        positions=_pad_to(cfg.positions, n2),
        cell=cell,
        numbers=_pad_to(cfg.numbers, n2),
        atom_mask=_pad_to(cfg.atom_mask, n2),
        nbr_idx=_pad_to(cfg.nbr_idx, n2),
        nbr_off=_pad_to(cfg.nbr_off, n2),
        nbr_sidx=_pad_to(cfg.nbr_sidx, n2),
        nbr_mask=_pad_to(cfg.nbr_mask, n2),
        nbr_rev=None,
    )


def _pad_model(model: ModelArrays, m2, lead=0):
    """Pad the inducing axis to ``m2`` (``choli`` on both of its axes).
    ``lead=1``: the expert-stacked committee layout ((E, m, ...) leaves)."""
    ax = lead
    return ModelArrays(
        X_desc=_pad_to(model.X_desc, m2, ax),
        X_num=_pad_to(model.X_num, m2, ax),
        X_lone=_pad_to(model.X_lone, m2, ax),
        m_mask=_pad_to(model.m_mask, m2, ax),
        mu=_pad_to(model.mu, m2, ax),
        choli=_pad_to(_pad_to(model.choli, m2, ax), m2, ax + 1),
        pair_d=_pad_to(model.pair_d, m2, ax + 1),
        pair_mask=_pad_to(model.pair_mask, m2, ax + 1),
    )


def _ceil_to(n, k):
    return -(-n // k) * k


def mesh_pad(cfg: ConfigArrays, model: ModelArrays, vscale_atom, mesh,
             dtype=None, committee=False):
    """Pad a (ConfigArrays, ModelArrays) pair to mesh-divisible sizes.
    Returns (cfg2, model2, own_idx, vscale2); slice outputs back with the
    original npad / mcap.  ``vscale_atom`` may be None (then vscale2 is).
    ``committee``: ``model`` leaves carry a leading expert axis and
    ``vscale_atom`` is (E, N) (the JAX package's ``pad_for_mesh``)."""
    lead = 1 if committee else 0
    n2 = _ceil_to(cfg.positions.shape[0], mesh.shape["data"])
    m2 = _ceil_to(model.mu.shape[lead], mesh.shape["model"])
    dev = cfg.positions.device
    vs = None
    if vscale_atom is not None:
        vs = _pad_to(torch.as_tensor(vscale_atom, device=dev,
                                     dtype=dtype or cfg.positions.dtype),
                     n2, axis=lead)
    return (_pad_cfg(cfg, n2), _pad_model(model, m2, lead),
            torch.arange(n2, device=dev), vs)


def pad_images_for_mesh(cfgs, model, vscale_atom, mesh, dtype,
                        committee=False):
    """:func:`mesh_pad` for the images of a band (DeviceNEB): each image's
    rows padded to a mesh-divisible count, the same for all.  Returns
    (cfgs2, model2, own_idx, vscale2) with ``own_idx`` the rows of one
    image."""
    cfg2, ma2, own_idx, vs2 = mesh_pad(cfgs[0], model, vscale_atom, mesh,
                                       dtype, committee)
    n2 = cfg2.npad
    return [cfg2] + [_pad_cfg(c, n2) for c in cfgs[1:]], ma2, own_idx, vs2


def pad_chain(chain, mesh):
    """A driver's chain (``device_md.new_chain``) with every per-atom row
    padded to the mesh and the model to its inducing blocks; adds
    ``oidx`` (``own_idx``) and ``noise_rows``, the rows before the mesh's
    padding (``device_md.md_chunk`` draws its Langevin noise for them
    only, so that it is the unsharded chain's).  The padding rows are
    empty (masked atoms at the origin, at rest) and weigh 1, as
    ``new_chain``'s own padding does: the integrators divide by the
    masses."""
    cfg = chain["cfg"]
    committee = chain["mean_e"] is not None
    cfg2, ma2, own_idx, vs2 = mesh_pad(cfg, chain["ma"], chain["vs"], mesh,
                                       cfg.positions.dtype, committee)
    n2 = cfg2.npad
    out = dict(chain, cfg=cfg2, ma=ma2, vs=vs2, oidx=own_idx,
               noise_rows=cfg.npad)
    for key, fill in (("masses", 1), ("pos0", 0), ("sidx_atom", 0),
                      ("sidx_ok", 0), ("vel", 0)):
        if chain.get(key) is not None:
            out[key] = _pad_to(chain[key], n2, fill=fill)
    if chain.get("meta_vs") is not None:
        out["meta_vs"] = _pad_to(chain["meta_vs"], n2, axis=1 if committee
                                 else 0)
    return out


# --------------------------------------------------------------------------
# the shards
# --------------------------------------------------------------------------


def _model_to(ma: ModelArrays, dev):
    return ModelArrays(*(None if x is None else x.to(dev) for x in ma))


def _ks_to(ks, dev):
    if ks is None:
        return None
    return ks._replace(**{k: getattr(ks, k).to(dev)
                          for k in ("znum", "chem_z", "mixL")
                          if getattr(ks, k) is not None})


def _rows_to(rows: LceRows, dev):
    return LceRows(rows.p.to(dev), rows.lone.to(dev), rows.alpha.to(dev),
                   tuple((d.to(dev), m.to(dev)) for d, m in rows.pairs))


class Shards(NamedTuple):
    """One configuration and model laid out over a mesh.  ``cfgs[d]``:
    data shard d's rows on ``devices[d, 0]`` (its ``positions`` whole);
    ``oidx[d]``: their rows of the whole configuration; ``blocks[d][m]``:
    inducing block m on ``devices[d, m]``; ``choli[d]`` / ``m_mask[d]``:
    the whole, replicated ones on ``devices[d, 0]``; ``nimg``: images of
    equal row counts stacked in the configuration (a band), each sharded
    alike."""
    mesh: Mesh
    cfgs: tuple
    oidx: tuple
    blocks: tuple
    choli: tuple
    m_mask: tuple
    radii: tuple
    ks: tuple
    amask: torch.Tensor  # (N,) whole atom mask on the first device
    nimg: int
    committee: bool


def _block(x, d, nb, nimg, dev):
    """Data shard ``d``'s rows of a per-row array ``x`` on ``dev``: block
    ``d`` of ``nb`` rows of each of the ``nimg`` stacked images (a view
    for one image).  Blocks by position, as the JAX package's
    ``P('data')`` splits an array; no host read."""
    if nimg == 1:
        return x[d * nb:(d + 1) * nb].to(dev)
    xs = x.reshape(nimg, -1, *x.shape[1:])[:, d * nb:(d + 1) * nb]
    return xs.reshape(nimg * nb, *x.shape[1:]).to(dev)


def shard_rows(own_idx, mesh, nrows, nimg=1):
    """Each data shard's rows of a configuration of ``nrows`` rows that
    stacks ``nimg`` images of ``own_idx.shape[0]`` rows: shard d takes
    block d of ``own_idx`` (the ids of one image's rows) from every
    image."""
    nd = mesh.shape["data"]
    nper = nrows // nimg
    nb = own_idx.shape[0] // nd
    out = []
    for d in range(nd):
        blk = own_idx[d * nb:(d + 1) * nb].long()
        if nimg > 1:
            step = nper * torch.arange(nimg, device=blk.device)
            blk = (blk[None, :] + step[:, None]).reshape(-1)
        out.append(blk.to(mesh.devices[d, 0]))
    return out


def shard(cfg: ConfigArrays, model: ModelArrays, radii, mesh, own_idx,
          ks=None, nimg=1, committee=False) -> Shards:
    """Lay a mesh-padded configuration and model out over ``mesh``."""
    nd, nm = mesh.shape["data"], mesh.shape["model"]
    oidx = shard_rows(own_idx, mesh, cfg.nbr_idx.shape[0], nimg)
    nb = own_idx.shape[0] // nd
    lead = 1 if committee else 0
    mb = model.mu.shape[lead] // nm
    cfgs, blocks, cholis, masks, rads, kss = [], [], [], [], [], []
    for d in range(nd):
        dev = mesh.devices[d, 0]

        def rows(x):
            return _block(x, d, nb, nimg, dev)

        cfgs.append(ConfigArrays(
            positions=cfg.positions.to(dev),
            cell=cfg.cell.to(dev) if cfg.cell.dim() == 2 else rows(cfg.cell),
            numbers=rows(cfg.numbers), atom_mask=rows(cfg.atom_mask),
            nbr_idx=rows(cfg.nbr_idx), nbr_off=rows(cfg.nbr_off),
            nbr_sidx=rows(cfg.nbr_sidx), nbr_mask=rows(cfg.nbr_mask),
            nbr_rev=None))
        row = []
        for m in range(nm):
            sl = slice(m * mb, (m + 1) * mb)

            def cols(x, ax=lead):
                return None if x is None else x.narrow(ax, sl.start, mb)

            blk = ModelArrays(
                X_desc=cols(model.X_desc), X_num=cols(model.X_num),
                X_lone=cols(model.X_lone), m_mask=cols(model.m_mask),
                mu=cols(model.mu), choli=None,
                pair_d=cols(model.pair_d, lead + 1),
                pair_mask=cols(model.pair_mask, lead + 1))
            row.append(_model_to(blk, mesh.devices[d, m]))
        blocks.append(tuple(row))
        cholis.append(model.choli.to(dev))
        masks.append(model.m_mask.to(dev))
        rads.append(radii.to(dev))
        kss.append(tuple(_ks_to(ks, mesh.devices[d, m]) for m in range(nm)))
    return Shards(mesh, tuple(cfgs), tuple(oidx), tuple(blocks),
                  tuple(cholis), tuple(masks), tuple(rads), tuple(kss),
                  cfg.atom_mask.to(mesh.first), nimg, committee)


def shard_vector(x, sh: Shards):
    """Each data shard's rows of a per-atom vector (N,), or of (E, N)
    committee rows (the last axis)."""
    if x is None:
        return None
    nb = sh.cfgs[0].nbr_idx.shape[0] // sh.nimg
    out = []
    for d in range(sh.mesh.shape["data"]):
        dev = sh.mesh.devices[d, 0]
        if x.dim() == 1:
            out.append(_block(x, d, nb, sh.nimg, dev))
        else:
            out.append(torch.stack([_block(r, d, nb, sh.nimg, dev)
                                    for r in x]))
    return tuple(out)


def _psum(parts, dev):
    """The shards' partials summed on ``dev`` in shard order."""
    total = None
    for x in parts:
        x = x.to(dev)
        total = x if total is None else total + x
    return total


def _pmax(parts, dev):
    """The elementwise max of the shards' values, on ``dev``."""
    return torch.stack([x.to(dev) for x in parts]).amax(0)


# --------------------------------------------------------------------------
# the energy closures
# --------------------------------------------------------------------------


def _shard_pass(sh: Shards, d, pos, cell, params, exponent):
    """Data shard ``d`` at whole positions ``pos``: its rows (one forward
    launch of the SOAP kernel), then per inducing block its masked
    covariance block and partial energies, one per image ((nimg,), or
    (E, nimg) per expert of a committee).  ``cell``: a (3, 3) cell, or
    None for the rows' own cells."""
    mesh = sh.mesh
    dev_d = mesh.devices[d, 0]
    c = sh.cfgs[d]
    cell_l = c.cell if cell is None else cell.to(dev_d)
    rows = lce_rows(pos.to(dev_d), cell_l, c, sh.radii[d], params, exponent,
                    sh.ks[d][0], oidx=sh.oidx[d])
    # the rows in the Gram block's type once, so that the blocks' cotangents
    # meet in it and are rounded to the descriptors' type once, as on the
    # unsharded path (float32 descriptors against the float64 model)
    gt = torch.promote_types(rows.p.dtype, sh.blocks[d][0].X_desc.dtype)
    rows = rows._replace(p=rows.p.to(gt), pairs=tuple(
        (dd.to(gt), mk) for dd, mk in rows.pairs))
    covs, es = [], []
    for m, blk in enumerate(sh.blocks[d]):
        dev = mesh.devices[d, m]
        r = rows if dev == dev_d else _rows_to(rows, dev)
        numbers = c.numbers.to(dev)
        amask = c.atom_mask.to(dev)
        if sh.committee:
            E, mb = blk.m_mask.shape

            def flat(t):
                return t.reshape(E * mb, *t.shape[2:])

            pair_d = pair_mask = None
            if blk.pair_d is not None:
                T = blk.pair_d.shape[1]
                pair_d = blk.pair_d.transpose(0, 1).reshape(T, E * mb, -1)
                pair_mask = blk.pair_mask.transpose(0, 1).reshape(
                    T, E * mb, -1)
            cov = rows_cov(r, numbers, flat(blk.X_desc), flat(blk.X_num),
                           flat(blk.X_lone), exponent, sh.ks[d][m], pair_d,
                           pair_mask)
            n = cov.shape[0]
            cov = cov.reshape(n, E, mb).transpose(0, 1)  # (E, n, mb)
            cov = cov * (amask[None, :, None] & blk.m_mask[:, None, :])
            e = (cov @ blk.mu[..., None])[..., 0]
            es.append(e.reshape(E, sh.nimg, -1).sum(-1))
        else:
            cov = rows_cov(r, numbers, blk.X_desc, blk.X_num, blk.X_lone,
                           exponent, sh.ks[d][m], blk.pair_d, blk.pair_mask)
            cov = cov * (amask[:, None] & blk.m_mask[None, :])
            es.append((cov @ blk.mu).reshape(sh.nimg, -1).sum(-1))
        covs.append(cov)
    return rows, covs, es


def _gathered(covs, dev):
    """A data shard's whole covariance rows: its blocks gathered over the
    model axis (the JAX package's ``all_gather`` over 'model')."""
    return torch.cat([c.to(dev) for c in covs], dim=-1)


def _gathered_beta(sh: Shards, d, rows, covs, vs):
    """Covloss beta (n,) of data shard ``d``'s rows from its gathered
    covariance and the whole ``choli`` (``kernels.covloss_beta``), -inf
    on padding."""
    dev = sh.mesh.devices[d, 0]
    cov_full = _gathered([c.detach() for c in covs], dev)
    beta = covloss_beta(sh.choli[d], cov_full, vs, sh.m_mask[d],
                        alpha=rows.alpha.detach())
    return torch.where(sh.cfgs[d].atom_mask, beta,
                       torch.full_like(beta, -math.inf))


def _psum_energy(sh: Shards, pos, cell, params, exponent, meta_scale=None,
                 meta_vs=None):
    """(E per image (nimg,), per-shard (rows, covariance blocks)): the
    single-model energy summed over both mesh axes, with the ActiveMeta
    bias ``E -= scale * sum_i beta_i sqrt(meta_vs_i)`` (the formula of
    ``engine.meta_covloss_fn``) fused in when ``meta_scale`` is given;
    the bias needs the gathered rows, and is summed over the data
    shards."""
    parts, passes, bias = [], [], []
    for d in range(sh.mesh.shape["data"]):
        rows, covs, es = _shard_pass(sh, d, pos, cell, params, exponent)
        parts.extend(es)
        passes.append((rows, covs))
        if meta_scale is not None:
            dev = sh.mesh.devices[d, 0]
            bias.append(covloss_bias(sh.choli[d], _gathered(covs, dev),
                                     meta_vs[d], sh.cfgs[d].atom_mask))
    e = _psum(parts, sh.mesh.first)
    if meta_scale is not None:
        e = e - meta_scale * _psum(bias, sh.mesh.first)
    return e, passes


def _psum_committee_energy(sh: Shards, pos, cell, params, exponent, vs,
                           mean_e, meta_scale=None, meta_vs=None):
    """(weighted committee energy per image, committee floor max per
    image): ``device_md._committee_e`` over the mesh.  The experts'
    partial energies are summed over both axes; each expert's covmax is
    its largest beta over every shard's atoms; the weights are computed
    without autograd, as the host combination is.  With ``meta_scale``
    the ActiveMeta bias on the committee floor is added (differentiated,
    the weights not)."""
    mesh = sh.mesh
    meta = meta_scale is not None
    ek, cmax, floor, bias = [], [], [], []
    for d in range(mesh.shape["data"]):
        dev = mesh.devices[d, 0]
        rows, covs, es = _shard_pass(sh, d, pos, cell, params, exponent)
        ek.extend(es)
        cov = _gathered(covs, dev)  # (E, n, M)
        mm = sh.m_mask[d].to(cov.dtype)[:, None, :]
        amask = sh.cfgs[d].atom_mask
        with contextlib.nullcontext() if meta else torch.no_grad():
            b = (sh.choli[d] * mm) @ (cov * mm).transpose(1, 2)
            c = (b * b).sum(1) / rows.alpha
        with torch.no_grad():
            trig = torch.sqrt(torch.clamp(1.0 - c, min=0.0)) * torch.sqrt(
                vs[d])
            betas = torch.where(amask[None, :], trig,
                                torch.full_like(trig, -math.inf))
            betas = betas.reshape(betas.shape[0], sh.nimg, -1)
            cmax.append(betas.amax(-1))  # (E, R)
            floor.append(betas.amin(0).amax(-1))  # (R,)
        if meta:
            fl = (torch.sqrt(torch.clamp(1.0 - c, min=1e-12))
                  * torch.sqrt(meta_vs[d])).amin(0)
            fl = torch.where(amask, fl, torch.zeros_like(fl))
            bias.append(fl.reshape(sh.nimg, -1).sum(-1))
    dev0 = mesh.first
    e_k = _psum(ek, dev0)  # (E, R)
    with torch.no_grad():
        covmax = _pmax(cmax, dev0).clamp(1e-12, 1.0)
        scale = torch.where(covmax < 1.0, -torch.log(covmax),
                            torch.zeros_like(covmax)) / covmax
        tot = scale.sum(0)
        w = torch.where(tot > 0, scale / torch.where(tot > 0, tot, 1.0),
                        torch.full_like(scale, 1.0 / scale.shape[0]))
        bmax = _pmax(floor, dev0)
    e_tot = (w * (e_k + mean_e[:, None])).sum(0)
    if meta:
        e_tot = e_tot - meta_scale * _psum(bias, dev0)
    return e_tot, bmax


def _sharded_beta_max(sh: Shards, passes, vs, check_beta, like):
    """The uncertainty trip scalar per image: each shard's largest beta,
    maxed over the data shards (0 when the trip is off)."""
    if not check_beta:
        return torch.zeros(sh.nimg, dtype=like.dtype, device=like.device)
    maxes = [_gathered_beta(sh, d, rows, covs, vs[d]).reshape(sh.nimg, -1)
             .amax(1) for d, (rows, covs) in enumerate(passes)]
    return _pmax(maxes, sh.mesh.first).to(like.dtype)


# --------------------------------------------------------------------------
# forces closures of the drivers
# --------------------------------------------------------------------------


def _sharded_inloop(sh: Shards, atom_mask, rebuild, rebuild_cut, sidx_atom,
                    sidx_ok):
    """In-loop rebuild plumbing of the sharded chunks — the counterpart of
    ``device_md._inloop_table``: (shards_with, tbl0, rebuild_fn).  Each
    data shard rebuilds the rows of its own atoms (``row_ids``) from the
    whole positions; the table is valid only if every shard's is (a
    device ``all``, the JAX package's ``pmax`` over 'data'); the tables
    carry no reverse slots."""

    def shards_with(tbl):
        if not rebuild or tbl is None:
            return sh
        return sh._replace(cfgs=tuple(_graft(c, t)
                                      for c, t in zip(sh.cfgs, tbl)))

    if not rebuild:
        return shards_with, None, None

    from ..neighbors_device import device_neighbor_table

    mesh = sh.mesh
    kpad = sh.cfgs[0].nbr_idx.shape[1]
    off_dtype = sh.cfgs[0].nbr_off.dtype
    cand = atom_mask
    on = [(cand.to(mesh.devices[d, 0]), sidx_atom.to(mesh.devices[d, 0]),
           sidx_ok.to(mesh.devices[d, 0])) for d in range(mesh.shape["data"])]

    def rebuild_fn(pos, cell=None):
        with span("af.rebuild"):
            tbls, oks = [], []
            for d, c in enumerate(sh.cfgs):
                dev = mesh.devices[d, 0]
                cand_d, sx_d, ok_d = on[d]
                idx, off, mask, kmax, over = device_neighbor_table(
                    pos.to(dev), c.cell if cell is None else cell.to(dev),
                    cand_d, rebuild_cut, kpad, row_ids=sh.oidx[d],
                    row_mask=c.atom_mask)
                li = idx.long()
                tbls.append((idx, off.to(off_dtype), sx_d[li],
                             mask & ok_d[li]))
                oks.append((kmax <= kpad) & ~over)
            ok = torch.stack([o.to(mesh.first) for o in oks]).all()
            return tuple(tbls), ok

    tbl0 = tuple((c.nbr_idx, c.nbr_off, c.nbr_sidx, c.nbr_mask)
                 for c in sh.cfgs)
    return shards_with, tbl0, rebuild_fn


def _omax_of(tbl):
    """The periodic-image lever arm of a sharded table: the max over the
    shards (the JAX package's ``omax_pmax``)."""
    first = tbl[0][1].device
    return torch.stack([offsum_max(t[1], t[3], torch.float64).to(first)
                        for t in tbl]).amax()


def unshard_table(tbl, sh: Shards):
    """A sharded table (one (idx, off, sidx, mask) per data shard) as the
    whole configuration's, on the first device (the shards' rows are its
    blocks in order)."""
    dev = sh.mesh.first
    return tuple(torch.cat([t[j].to(dev) for t in tbl]) for j in range(4))


def _sharded_forces_fn(shards_with, vs, amask, params, exponent, check_beta,
                       mean_e=None, meta_scale=None, meta_vs=None):
    """``forces_fn(pos, tbl) -> (e, f, beta_max)`` of the position-only
    sharded chunks (MD, FIRE, bands): the single-model or the committee
    energy over the mesh, the forces from one backward of it, the trip
    scalar maxed over the mesh.  Per image ((nimg,)) when the shards stack
    images, else scalars."""

    def forces_fn(pos, tbl=None):
        with span("af.forces"):
            sh = shards_with(tbl)
            with torch.enable_grad():
                p = pos.detach().requires_grad_(True)
                # the leaf's one consumer is a view on its own device, so
                # its gradient reaches the leaf from that device's stream;
                # fed straight into the shards' copies it arrived from each
                # copy's backward on another card, which torch reports as
                # an AccumulateGrad stream mismatch (a sync, and a stop to
                # CUDA graph capture).  The virial path's strain product
                # and sharded_predict's do the same.
                p_in = p.view_as(p)
                if mean_e is not None:
                    e, bmax = _psum_committee_energy(
                        sh, p_in, None, params, exponent, vs, mean_e,
                        meta_scale, meta_vs)
                    if not check_beta:
                        bmax = torch.zeros_like(bmax)
                else:
                    e, passes = _psum_energy(sh, p_in, None, params, exponent,
                                             meta_scale, meta_vs)
                (g,) = torch.autograd.grad(e.sum(), p)
            f = -g * amask
            if mean_e is None:
                bmax = _sharded_beta_max(sh, passes, vs, check_beta, pos)
            e = e.detach()
            return (e, f, bmax) if sh.nimg > 1 else (e[0], f, bmax[0])

    return forces_fn


def _sharded_forces_virial_fn(shards_with, vs, amask, params, exponent,
                              check_beta, mean_e=None, aniso=False):
    """``forces_fn(pos, cell, tbl) -> (e, f, dE/deps, beta_max)`` of the
    strain-carrying sharded chunks (NPT, variable-cell FIRE): the energy
    over the mesh differentiated with respect to positions and a strain of
    positions and cell together (``md.device_npt._sgpr_forces_virial``),
    so forces and virial come out reduced over every shard."""

    def forces_fn(pos, cell, tbl=None):
        with span("af.forces"):
            sh = shards_with(tbl)
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
                    e, bmax = _psum_committee_energy(sh, p_s, cell_s, params,
                                                     exponent, vs, mean_e)
                    bmax = bmax if check_beta else torch.zeros_like(bmax)
                else:
                    e, passes = _psum_energy(sh, p_s, cell_s, params,
                                             exponent)
                g, deps = torch.autograd.grad(e.sum(), (p, eps))
            if aniso:
                deps = 0.5 * (deps + deps.T)
            if mean_e is None:
                bmax = _sharded_beta_max(sh, passes, vs, check_beta, pos)
            return e.detach()[0], -g * amask, deps, bmax[0]

    return forces_fn


class MeshChunk(NamedTuple):
    """The sharded physics of one device chunk (:func:`mesh_chunk`)."""
    forces_fn: object  # as the unsharded chunk's
    tbl0: object  # the sharded table, or None without the in-loop rebuild
    rebuild_fn: object  # each data shard rebuilds its own rows, or None
    whole: object  # a sharded table as the whole configuration's
    omax_of: object  # a sharded table's lever arm (the JAX omax_pmax)


def mesh_chunk(cfg, model, radii, vscale_atom, own_idx, mesh, params,
               exponent, check_beta, ks=None, mean_e=None, meta_scale=None,
               meta_vs=None, virial=False, aniso=False, nimg=1,
               rebuild=False, rebuild_cut=None, sidx_atom=None,
               sidx_ok=None) -> MeshChunk:
    """Lay a mesh-padded chunk (:func:`pad_chain`) out over ``mesh`` once
    and give the device loops their physics from it: ``forces_fn(pos,
    tbl)`` of :func:`_sharded_forces_fn` (``virial``: ``forces_fn(pos,
    cell, tbl)`` of :func:`_sharded_forces_virial_fn`, ``aniso`` its
    strain), per image when ``nimg`` images are stacked as rows;
    ``mean_e``: a committee (``model`` expert-stacked, ``vscale_atom``
    (E, N)); ``meta_scale`` / ``meta_vs``: the fused ActiveMeta bias;
    ``rebuild``: the in-loop rebuild of :func:`_sharded_inloop`."""
    sh = shard(cfg, model, radii, mesh, own_idx, ks, nimg=nimg,
               committee=mean_e is not None)
    vs = shard_vector(vscale_atom, sh)
    amask = cfg.atom_mask[:, None]
    shards_with, tbl0, rebuild_fn = _sharded_inloop(
        sh, cfg.atom_mask, rebuild, rebuild_cut, sidx_atom, sidx_ok)
    if virial:
        forces_fn = _sharded_forces_virial_fn(shards_with, vs, amask, params,
                                              exponent, check_beta, mean_e,
                                              aniso)
    else:
        forces_fn = _sharded_forces_fn(shards_with, vs, amask, params,
                                       exponent, check_beta, mean_e,
                                       meta_scale, shard_vector(meta_vs, sh))
    return MeshChunk(forces_fn, tbl0, rebuild_fn,
                     lambda tbl: unshard_table(tbl, sh), _omax_of)


# --------------------------------------------------------------------------
# predict and the training covariance
# --------------------------------------------------------------------------


def sharded_predict(cfg: ConfigArrays, model: ModelArrays, radii,
                    vscale_atom, own_idx, mesh, params, exponent, ks=None):
    """Sharded ``engine.predict_fn`` on a mesh-padded configuration and
    model (:func:`mesh_pad`): (E, forces (N, 3), virial (3, 3), cov
    (N, M), beta (N,)), every kernel configuration of the unsharded path
    (pair terms, chemical mixing, rbf / normed / expression kernels)."""
    sh = shard(cfg, model, radii, mesh, own_idx, ks)
    vs = shard_vector(vscale_atom, sh)
    dev0 = mesh.first
    pos = cfg.positions.detach().requires_grad_(True)
    eps = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device,
                      requires_grad=True)
    with torch.enable_grad():
        one = torch.eye(3, dtype=pos.dtype, device=pos.device) + eps
        e, passes = _psum_energy(sh, pos @ one, cfg.cell @ one, params,
                                 exponent)
        dpos, deps = torch.autograd.grad(e.sum(), (pos, eps))
    forces = -dpos * cfg.atom_mask[:, None]
    virial = 0.5 * (deps + deps.T)
    cov = torch.cat([_gathered([c.detach() for c in covs], dev0)
                     for _, covs in passes])
    beta = torch.cat([_gathered_beta(sh, d, rows, covs, vs[d]).to(dev0)
                      for d, (rows, covs) in enumerate(passes)])
    return e.detach()[0], forces, virial, cov, beta


def sharded_kernel_block(cfg: ConfigArrays, model: ModelArrays, radii,
                         own_idx, mesh, params, exponent, batch_size=64,
                         ks=None):
    """(Ke row (M,), Kf block (N, 3, M), Kv block (3, 3, M)) of a
    mesh-padded configuration against the inducing set, sharded over
    'data': ``engine.kernel_block_fn`` on each data shard's rows (one
    forward launch, then ``batch_size`` live columns per backward launch,
    on the shard's device, where its coefficients are), the shards'
    partial rows summed."""
    sh = shard(cfg, model, radii, mesh, own_idx, ks)
    m_live = int(model.m_mask.sum())
    parts = []
    for d, c in enumerate(sh.cfgs):
        dev = mesh.devices[d, 0]
        parts.append(kernel_block_fn(
            c, _model_to(model, dev), sh.radii[d], params, exponent,
            batch_size=batch_size, ks=sh.ks[d][0], m=m_live, oidx=sh.oidx[d],
            amask=sh.amask.to(dev)))
    return tuple(_psum([p[j] for p in parts], mesh.first) for j in range(3))


def sharded_kernel_block_jac(cfg: ConfigArrays, model: ModelArrays, radii,
                             own_idx, mesh, params, exponent, chunk=128):
    """The Jacobian route of :func:`sharded_kernel_block` for the plain
    dot kernel (``engine.kernel_block_jac_fn`` per data shard: one forward
    and one one-hot backward launch each), the shards' partial rows
    summed."""
    sh = shard(cfg, model, radii, mesh, own_idx)
    m_live = int(model.m_mask.sum())
    parts = []
    for d, c in enumerate(sh.cfgs):
        dev = mesh.devices[d, 0]
        parts.append(kernel_block_jac_fn(
            c, _model_to(model, dev), sh.radii[d], params, exponent,
            chunk=chunk, m=m_live, oidx=sh.oidx[d], amask=sh.amask.to(dev)))
    return tuple(_psum([p[j] for p in parts], mesh.first) for j in range(3))
