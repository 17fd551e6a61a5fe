"""Device engine: predict / descriptor / kernel-block functions on torch
tensors (port of ``autoforce_tpu/engine.py``).

The host state machine (:mod:`..calculator.active`, :mod:`..regression.sgpr`)
calls a small set of functions on padded, statically-shaped tensors:

  * ``predict_fn``        — descriptors → cov → energy, forces, virial, beta
                            (the per-MD-step hot path; one forward + one
                            backward pass)
  * ``descriptors_fn``    — per-LCE descriptors of a configuration
  * ``env_descriptors_fn``— descriptors of raw environments (inducing set)
  * ``gram_self_fn``      — LCE x LCE kernel of one configuration (seeding)
  * ``kernel_cols_multi_fn`` — (Ke, -dKe/dpos, dKe/deps) columns of several
                            inducing envs against several configurations
                            (add_inducing; the Engine's ``kernel_col`` and
                            ``kernel_col_batch`` are its one-env cases)
  * ``kernel_block_fn``   — the same against the whole inducing set
                            (add_data)
  * ``meta_covloss_fn``   — the ActiveMeta bias energy and its gradient

  * ``kernel_block_jac_fn`` — the same block through the descriptor
                            Jacobian (one one-hot backward-kernel launch,
                            then matrix products; the dot kernel only)

The descriptor inside them goes through the SOAP coefficient kernels
(``descriptor.soap_kernels.sesoap_descriptors_k``).  The kernel space of
the JAX package rides along as a :class:`KernelSpace` (``Engine.
kernel_space()``): the base kernel (``"dot"``, ``"rbf"``, ``"normed"`` or a
:class:`~.kernelalgebra.KernelExpr`), the alchemical central factor and
species mixing (``chemical="rbf"``) and two-body pair terms
(:mod:`.pairkernels`, plain torch on the neighbor distances).  With a
device mesh (``Engine(mesh=...)``, :mod:`.parallel.mesh`) ``predict`` and
``kernel_block`` run sharded: atom rows over the mesh's ``'data'`` axis,
inducing columns over its ``'model'`` axis.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple

import numpy as np
import torch

from . import resolve_device
from .descriptor.radial import as_radii
from .descriptor.soap import SoapParams, _spectrum_constants, power_spectrum
from .descriptor.soap_kernels import (
    sesoap_descriptors_k,
    soap_coeff_bwd,
    soap_coeff_fwd,
)
from .kernelalgebra import KernelExpr
from .kernels import (
    base_kernel,
    base_kernel_grad,
    central_factor,
    covloss_beta,
    covloss_bias,
    gram,
)
from .neighbors import neighbor_table, reverse_slots_host, round_up
from .pairkernels import (
    _factor,
    _psi,
    config_pair_mask,
    pair_diag,
    pair_gram,
    pair_slot_derivative,
    pair_slot_sums,
    psi_factor_grads,
    stage_env_pairs,
)
from .profiling import span


class ConfigArrays(NamedTuple):
    """Padded device-ready representation of one configuration."""

    positions: torch.Tensor  # (N, 3)
    cell: torch.Tensor  # (3, 3), or (N, 3, 3): one per row (stacked images)
    numbers: torch.Tensor  # (N,) int32 atomic numbers (0 for padding)
    atom_mask: torch.Tensor  # (N,) bool
    nbr_idx: torch.Tensor  # (N, K) int32
    nbr_off: torch.Tensor  # (N, K, 3) int8 (int32 for very thin cells)
    nbr_sidx: torch.Tensor  # (N, K) int32 species-table index of neighbor
    nbr_mask: torch.Tensor  # (N, K) bool
    # flat reverse slot (i*K + k) of each table entry, -1 if masked
    # (neighbors_device.reverse_slots); None disables the gather backward
    nbr_rev: torch.Tensor = None  # (N, K) int32 or None

    @property
    def npad(self):
        return self.positions.shape[0]


class ModelArrays(NamedTuple):
    """Padded device-side SGPR model state."""

    X_desc: torch.Tensor  # (M, D)
    X_num: torch.Tensor  # (M,) int32
    X_lone: torch.Tensor  # (M,) bool
    m_mask: torch.Tensor  # (M,) bool
    mu: torch.Tensor  # (M,)
    choli: torch.Tensor  # (M, M), zero-padded
    pair_d: torch.Tensor = None  # (T, M, KX) pair distances per pair term
    pair_mask: torch.Tensor = None  # (T, M, KX)


class EnvArrays(NamedTuple):
    """Raw local environments (for descriptor recomputation)."""

    rvec: torch.Tensor  # (B, K, 3)
    sidx: torch.Tensor  # (B, K) int32
    mask: torch.Tensor  # (B, K) bool


class KernelSpace(NamedTuple):
    """Everything of the kernel beyond the descriptor and zeta: the
    species table's atomic numbers ``znum`` (S,), the pair terms, the
    alchemical chi table ``chem_z`` (Zmax, Zmax) and mixing cholesky
    ``mixL`` (S, S) (None without ``chemical``), and the base kernel
    ``kind``.  ``None`` in place of a KernelSpace is the plain dot
    kernel."""

    znum: torch.Tensor = None
    pair_terms: tuple = ()
    chem_z: torch.Tensor = None
    mixL: torch.Tensor = None
    kind: object = "dot"


PLAIN = KernelSpace()


class _NbrGatherRev(torch.autograd.Function):
    """``positions[nbr_idx]`` whose backward is a reverse-slot GATHER
    instead of a scatter-add.

    Neighbor tables are symmetric, so the cotangent sum over all slots
    pointing at atom j equals the sum over row j's reverse slots
    (neighbors_device.reverse_slots) — a gather + row reduction.  Unlike
    the ``index_add`` that plain indexing backpropagates through, whose
    atomic order on CUDA changes from run to run, the sum order here is
    fixed: forces are deterministic.  Masked-slot cotangents are zeroed
    explicitly (they are analytically zero: every consumer masks before
    any nonlinearity).  First order only."""

    @staticmethod
    def forward(ctx, positions, nbr_idx, nbr_rev, nbr_mask):
        ctx.save_for_backward(nbr_rev, nbr_mask)
        return positions[nbr_idx]

    @staticmethod
    def backward(ctx, ct):
        nbr_rev, nbr_mask = ctx.saved_tensors
        ct = torch.where(nbr_mask[..., None], ct, torch.zeros_like(ct))
        flat = ct.reshape(-1, ct.shape[-1])
        good = nbr_rev >= 0
        taken = flat[nbr_rev.clamp(0, flat.shape[0] - 1)]
        dpos = torch.where(good[..., None], taken, torch.zeros_like(taken))
        return dpos.sum(dim=1), None, None, None


def _env_rvec(positions, cell, cfg: ConfigArrays, oidx=None, use_rev=False):
    """Neighbor displacement vectors (N, K, 3).

    ``cell``: (3, 3), or (N, 3, 3) with a cell per row (the stacked images
    of a band whose images differ in cell).  ``oidx`` maps table rows to
    rows of ``positions``: under a mesh the tables are sharded by rows
    while the positions stay whole (neighbors cross shard boundaries), so
    row i of the table is atom ``oidx[i]``; None means they are aligned.
    ``use_rev``: route the neighbor gather through the reverse-slot
    backward (first-order callers only — the MD/predict hot paths); with
    ``oidx`` the backward is the plain scatter, as padding a sharded table
    breaks the flat ``i*K + k`` reverse slots."""
    own = positions if oidx is None else positions[oidx]
    if use_rev and cfg.nbr_rev is not None and oidx is None:
        nbrs = _NbrGatherRev.apply(positions, cfg.nbr_idx, cfg.nbr_rev,
                                   cfg.nbr_mask)
    else:
        nbrs = positions[cfg.nbr_idx]
    # image shifts off @ cell, written out: a (N K, 3) x (3, 3) product is
    # a poor shape for a GEMM
    off = cfg.nbr_off.to(positions.dtype)
    c = cell if cell.dim() == 2 else cell[:, None]
    shift = (off[..., 0, None] * c[..., 0, :]
             + off[..., 1, None] * c[..., 1, :]
             + off[..., 2, None] * c[..., 2, :])
    return nbrs - own[:, None, :] + shift


def _chem_mix(p, mixL, nspecies):
    """Alchemical species mixing of the power spectrum (chemical.py):
    p~ = (L (x) L) p over the two species axes."""
    if mixL is None:
        return p
    batch = p.shape[:-1]
    q = p.reshape(*batch, nspecies, nspecies, -1)
    L = mixL.to(p.dtype)
    q = torch.einsum("ab,cd,...bdk->...ack", L, L, q)
    return q.reshape(*batch, -1)


def _config_descriptors(positions, cell, cfg, radii, params, oidx=None,
                        use_rev=False):
    rvec = _env_rvec(positions, cell, cfg, oidx=oidx, use_rev=use_rev)
    mask = cfg.nbr_mask & cfg.atom_mask[:, None]
    p = sesoap_descriptors_k(rvec, cfg.nbr_sidx, mask, radii, params)
    # neighbor tables may carry skin-buffered pairs beyond rc (inert in the
    # descriptor); lone-atom detection must only count pairs within rc
    d2 = (rvec * rvec).sum(-1)
    within = mask & (d2 < params.rc**2)
    lone = cfg.atom_mask & ~within.any(dim=1)
    return p, lone


def _pair_rows(rvec, cfg, znum, term, oidx=None):
    """(distances (N, K), selected-pair mask) of a configuration's rows
    for one pair term (``oidx``: the rows' atoms, :func:`_env_rvec`)."""
    d = torch.sqrt((rvec * rvec).sum(-1) + 1e-30)
    nbrz = znum[cfg.nbr_sidx.long().clamp(0, znum.shape[0] - 1)]
    mask = cfg.nbr_mask & cfg.atom_mask[:, None]
    m1 = config_pair_mask(term, cfg.numbers, nbrz, cfg.nbr_idx, cfg.nbr_off,
                          mask, own_idx=oidx)
    return d, m1


def _self_alpha(p, lone, exponent, ks):
    """The true kernel diagonal k(x, x) of each LCE (SOAP part), from its
    (mixed) descriptor: 1 for the normalized dot and rbf kernels."""
    kind = ks.kind
    if isinstance(kind, KernelExpr):
        # the expression on the self-dot, plus the White same-environment
        # variance
        alpha = kind.value((p * p).sum(dim=-1)) + float(kind.white_diag(xp=np))
    elif ks.mixL is None or kind == "rbf":
        return torch.ones(p.shape[0], dtype=p.dtype, device=p.device)
    else:
        alpha = (p * p).sum(dim=-1) ** exponent
    alpha = torch.where(lone, alpha + 1.0, alpha)
    return torch.clamp(alpha, min=1e-12)


class LceRows(NamedTuple):
    """The per-row part of a covariance block: (mixed) descriptors, lone
    flags, the kernel diagonal alpha and each pair term's (distances,
    selected-pair mask)."""
    p: torch.Tensor
    lone: torch.Tensor
    alpha: torch.Tensor
    pairs: tuple = ()


def lce_rows(posd, celld, cfg, radii, params, exponent, ks=None, oidx=None,
             use_rev=False) -> LceRows:
    """The rows of :func:`_total_cov`, computed once whatever the columns
    (under a mesh: once per data shard, for every inducing block)."""
    ks = ks or PLAIN
    p, lone = _config_descriptors(posd, celld, cfg, radii, params, oidx=oidx,
                                  use_rev=use_rev)
    p = _chem_mix(p, ks.mixL, radii.shape[0])
    alpha = _self_alpha(p, lone, exponent, ks)
    pairs = []
    if ks.pair_terms:
        rvec = _env_rvec(posd, celld, cfg, oidx=oidx, use_rev=use_rev)
        for term in ks.pair_terms:
            d, m1 = _pair_rows(rvec, cfg, ks.znum, term, oidx=oidx)
            pairs.append((d, m1))
            alpha = alpha + pair_diag(d, m1, term)
    return LceRows(p, lone, alpha, tuple(pairs))


def rows_cov(rows: LceRows, numbers, X_desc, X_num, X_lone, exponent, ks=None,
             pair_d=None, pair_mask=None):
    """The covariance block (n, M) of ``rows`` against inducing columns
    (``pair_d`` / ``pair_mask``: their staged pair distances (T, M, KX))."""
    ks = ks or PLAIN
    cov = gram(rows.p, numbers, rows.lone, X_desc, X_num, X_lone, exponent,
               chem=ks.chem_z, kind=ks.kind)
    for t, (term, (d, m1)) in enumerate(zip(ks.pair_terms, rows.pairs)):
        cov = cov + pair_gram(d, m1, pair_d[t], pair_mask[t], term)
    return cov


def _total_cov(posd, celld, cfg, X_desc, X_num, X_lone, radii, params,
               exponent, use_rev=False, ks=None, pair_d=None, pair_mask=None,
               oidx=None):
    """SOAP covariance block (n, M) plus the pair terms' contributions,
    lone flags and the per-LCE kernel diagonal alpha (the covloss
    normalization; 1 for the normalized dot kernel).  ``ks``: the
    :class:`KernelSpace` (None: the plain dot kernel); ``pair_d`` /
    ``pair_mask``: the inducing set's staged pair distances (T, M, KX);
    ``oidx``: see :func:`_env_rvec`."""
    rows = lce_rows(posd, celld, cfg, radii, params, exponent, ks, oidx,
                    use_rev)
    cov = rows_cov(rows, cfg.numbers, X_desc, X_num, X_lone, exponent, ks,
                   pair_d, pair_mask)
    return cov, rows.lone, rows.alpha


def predict_fn(cfg: ConfigArrays, model: ModelArrays, radii, vscale_atom,
               params, exponent, ks=None):
    """Energy, forces, virial, covariance and beta from one backward pass
    over (positions, strain) (reference hot path §3.1)."""
    pos = cfg.positions.detach().requires_grad_(True)
    eps = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device,
                      requires_grad=True)
    with torch.enable_grad():
        one = torch.eye(3, dtype=pos.dtype, device=pos.device) + eps
        posd = pos @ one
        celld = cfg.cell @ one
        cov, lone, alpha = _total_cov(
            posd, celld, cfg, model.X_desc, model.X_num, model.X_lone,
            radii, params, exponent, use_rev=True, ks=ks,
            pair_d=model.pair_d, pair_mask=model.pair_mask,
        )
        cov = cov * (cfg.atom_mask[:, None] & model.m_mask[None, :])
        e = (cov @ model.mu).sum()
        dpos, deps = torch.autograd.grad(e, (pos, eps))
    forces = -dpos * cfg.atom_mask[:, None]
    virial = 0.5 * (deps + deps.T)
    cov = cov.detach()
    beta = covloss_beta(model.choli, cov, vscale_atom, model.m_mask,
                        alpha=alpha.detach())
    beta = torch.where(cfg.atom_mask, beta, torch.full_like(beta, -np.inf))
    return e.detach(), forces, virial, cov, beta


def meta_covloss_fn(cfg: ConfigArrays, model: ModelArrays, radii, vscale_atom,
                    params, exponent, scale):
    """The uncertainty-seeking bias energy E = -scale * sum_i beta_i
    sqrt(vscale_i) and its position gradient (reference ActiveMeta,
    active.py:1170-1186), through torch autograd; the plain dot kernel.
    ``vscale_atom`` maps inf (a species without a scale) to 0 here, the
    host meta convention."""
    vs = torch.where(torch.isfinite(vscale_atom), vscale_atom,
                     torch.zeros_like(vscale_atom))
    with torch.enable_grad():
        pos = cfg.positions.detach().requires_grad_(True)
        p, lone = _config_descriptors(pos, cfg.cell, cfg, radii, params,
                                      use_rev=True)
        cov = gram(p, cfg.numbers, lone, model.X_desc, model.X_num,
                   model.X_lone, exponent)
        cov = cov * (cfg.atom_mask[:, None] & model.m_mask[None, :])
        e = -scale * covloss_bias(model.choli, cov, vs, cfg.atom_mask)
        (g,) = torch.autograd.grad(e, pos)
    return e.detach(), g


@torch.no_grad()
def descriptors_fn(cfg: ConfigArrays, radii, params):
    return _config_descriptors(cfg.positions, cfg.cell, cfg, radii, params)


@torch.no_grad()
def pair_self_fn(cfg: ConfigArrays, ks):
    """The pair terms' share of each LCE's kernel diagonal k(x, x)."""
    rvec = _env_rvec(cfg.positions, cfg.cell, cfg)
    out = torch.zeros(rvec.shape[0], dtype=rvec.dtype, device=rvec.device)
    for term in ks.pair_terms:
        d, m1 = _pair_rows(rvec, cfg, ks.znum, term)
        out = out + pair_diag(d, m1, term)
    return out


@torch.no_grad()
def env_descriptors_fn(envs: EnvArrays, radii, params, mixL=None):
    """Descriptors for a batch of raw environments (inducing set staging),
    alchemically mixed with ``mixL``."""
    p = sesoap_descriptors_k(envs.rvec, envs.sidx, envs.mask, radii, params)
    p = _chem_mix(p, mixL, radii.shape[0])
    lone = ~envs.mask.any(dim=-1)
    return p, lone


@torch.no_grad()
def gram_self_fn(cfg: ConfigArrays, radii, params, exponent, ks=None):
    """LCE x LCE kernel of one configuration (model seeding)."""
    ks = ks or PLAIN
    p, lone = _config_descriptors(cfg.positions, cfg.cell, cfg, radii, params)
    p = _chem_mix(p, ks.mixL, radii.shape[0])
    k = gram(p, cfg.numbers, lone, p, cfg.numbers, lone, exponent,
             chem=ks.chem_z, kind=ks.kind)
    if isinstance(ks.kind, KernelExpr):
        # same-environment White variance belongs on the true diagonal
        k = k + float(ks.kind.white_diag(xp=np)) * torch.eye(
            k.shape[0], dtype=k.dtype, device=k.device)
    if ks.pair_terms:
        rvec = _env_rvec(cfg.positions, cfg.cell, cfg)
        for term in ks.pair_terms:
            d, m1 = _pair_rows(rvec, cfg, ks.znum, term)
            k = k + pair_gram(d, m1, d, m1, term)
    return k


def _atom_sum(rbar, cfg):
    """sum over the slots (i, k) with nbr_idx[i, k] = b of rbar[..., i, k, :]
    for every atom b: the neighbor-gather part of d/dpos.  Through the
    reverse slots (a gather, fixed sum order) where the config has them,
    else a scatter-add."""
    lead = rbar.shape[:-3]
    n, k = cfg.nbr_idx.shape
    flat = rbar.reshape(*lead, n * k, 3)
    if cfg.nbr_rev is not None:
        good = (cfg.nbr_rev >= 0)[..., None]
        taken = flat[..., cfg.nbr_rev.long().clamp(0, n * k - 1), :]
        return torch.where(good, taken, torch.zeros_like(taken)).sum(dim=-2)
    out = torch.zeros((*lead, n, 3), dtype=rbar.dtype, device=rbar.device)
    return out.index_add_(len(lead), cfg.nbr_idx.reshape(-1).long(), flat)


def _force_virial(rbar, r0, cfg, oidx=None, amask=None):
    """(Kf (C, N, 3), Kv (C, 3, 3)) of C columns from their displacement
    gradients rbar (C, N, K, 3) = dKe/drvec: forces_energy = -leftgrad,
    virial = sym(sum rvec (x) rbar).  ``oidx``: the table rows are these
    atoms of a configuration whose atom mask is ``amask`` (a mesh shard's
    rows, :func:`_env_rvec`); Kf then covers every atom, a partial sum
    over this shard's rows."""
    if oidx is None:
        dpos = _atom_sum(rbar, cfg) - rbar.sum(dim=-2)
        amask = cfg.atom_mask
    else:
        lead, n = rbar.shape[:-3], amask.shape[0]
        dpos = torch.zeros((*lead, n, 3), dtype=rbar.dtype, device=rbar.device)
        dpos.index_add_(len(lead), cfg.nbr_idx.reshape(-1).long(),
                        rbar.reshape(*lead, -1, 3))
        dpos.index_add_(len(lead), oidx, -rbar.sum(dim=-2))
    kf = -dpos * amask[:, None].to(dpos.dtype)
    deps = torch.einsum("nka,cnkb->cab", r0, rbar)
    return kf, 0.5 * (deps + deps.transpose(1, 2))


class _Rows(NamedTuple):
    """The rows of same-bucket configurations stacked, their coefficients
    (one forward launch) and the (mixed) power spectrum, its graph kept
    for the column backwards."""
    r0: torch.Tensor
    sidx: torch.Tensor
    mask: torch.Tensor
    numbers: torch.Tensor
    amask: torch.Tensor
    lone: torch.Tensor
    cr: torch.Tensor
    ci: torch.Tensor
    p: torch.Tensor


def _stack_rows(cfgs, radii, params, mixL=None, oidx=None) -> _Rows:
    """The per-configuration part of the kernel columns (``oidx``: one
    configuration's rows, :func:`_env_rvec`)."""
    with torch.no_grad():
        r0 = torch.cat([_env_rvec(c.positions, c.cell, c, oidx=oidx)
                        for c in cfgs])
        mask = torch.cat([c.nbr_mask & c.atom_mask[:, None] for c in cfgs])
        sidx = torch.cat([c.nbr_sidx for c in cfgs])
        numbers = torch.cat([c.numbers for c in cfgs])
        amask = torch.cat([c.atom_mask for c in cfgs])
        cr, ci = soap_coeff_fwd(r0, sidx, mask, radii, params)
        within = mask & ((r0 * r0).sum(-1) < params.rc**2)
        lone = amask & ~within.any(dim=1)
    S, L = radii.shape[0], params.lmax + 1
    shape = (r0.shape[0], S, params.nmax + 1, L, L)
    cr.requires_grad_(True)
    ci.requires_grad_(True)
    with torch.enable_grad():
        p = power_spectrum(cr.reshape(shape), ci.reshape(shape), params)
        p = _chem_mix(p, mixL, S)
    return _Rows(r0, sidx, mask, numbers, amask, lone, cr, ci, p)


def _pair_columns(rows: _Rows, cfgs, x_pd, x_pm, ks, oidx=None):
    """Pair terms' (ke (C, B), rbar (C, B n, K, 3)) of C staged pair sets
    (x_pd, x_pm: (C, T, KX)) against the stacked rows, in plain torch on
    the distances: every per-slot contribution depends on its own slot's
    distance only, so dKe/dd is elementwise (``pair_slot_derivative``)."""
    n, kpad = cfgs[0].nbr_idx.shape
    B, C = len(cfgs), x_pd.shape[0]
    r0 = rows.r0.reshape(B, n, kpad, 3)
    dtype = torch.promote_types(r0.dtype, x_pd.dtype)
    ke = torch.zeros((C, B), dtype=dtype, device=r0.device)
    rbar = torch.zeros((C, B, n, kpad, 3), dtype=dtype, device=r0.device)
    for b, cfg in enumerate(cfgs):
        for t, term in enumerate(ks.pair_terms):
            d, m1 = _pair_rows(r0[b], cfg, ks.znum, term, oidx=oidx)
            d = d.to(dtype)
            x1, f1 = _psi(d, term), _factor(d, term) * m1
            x2 = _psi(x_pd[:, t].to(dtype), term)
            f2 = _factor(x_pd[:, t].to(dtype), term) * x_pm[:, t]
            dpsi, dfac = psi_factor_grads(d, term)
            unit = r0[b].to(dtype) / d[..., None]  # d d / d rvec
            for lo, hi, A, Bs in pair_slot_sums(x1, x2, f2, term):
                ke[lo:hi, b] += term.signal**2 * (f1 * A).sum(dim=(1, 2))
                dh = pair_slot_derivative(A, Bs, f1, dpsi, dfac, m1, term)
                rbar[lo:hi, b] += dh[..., None] * unit
    return ke, rbar.reshape(C, B * n, kpad, 3)


def _column_grads(rows: _Rows, cfgs, x_desc, x_num, x_lone, radii, params,
                  exponent, ks=None, x_pd=None, x_pm=None, oidx=None):
    """The per-column part: (ke (C, B), rbar (C, B n, K, 3) = dKe/drvec)
    of C inducing environments against the stacked rows of ``cfgs``."""
    ks = ks or PLAIN
    n, kpad = cfgs[0].nbr_idx.shape
    B, C = len(cfgs), x_desc.shape[0]
    p, amask = rows.p, rows.amask
    dtype = torch.promote_types(p.dtype, x_desc.dtype)
    x = x_desc.to(dtype)
    dot = p.detach().to(dtype) @ x.T  # (B n, C)
    cf = central_factor(rows.numbers, x_num, ks.chem_z, dtype)
    valid = cf * amask[:, None].to(dtype)
    eq = (rows.numbers[:, None] == x_num[None, :]).to(dtype)
    lone = (rows.lone[:, None] & x_lone[None, :]).to(dtype) * eq
    k = (base_kernel(dot, exponent, ks.kind) + lone) * valid
    ke = k.reshape(B, n, C).sum(dim=1).T
    # dKe_j / dp_i = k'(p_i . x_j) cf_ij x_j  (lone term: constant); with
    # mixing, p is the mixed spectrum and the backward passes through it
    w = base_kernel_grad(dot, exponent, ks.kind) * valid
    g = w.T.to(p.dtype)[:, :, None] * x.to(p.dtype)[:, None, :]  # (C, B n, D)
    gcr, gci = torch.autograd.grad(p, (rows.cr, rows.ci), g,
                                   is_grads_batched=True, retain_graph=True)
    nrows = B * n
    rbar = soap_coeff_bwd(
        rows.r0.repeat(C, 1, 1), rows.sidx.repeat(C, 1),
        rows.mask.repeat(C, 1), radii,
        gcr.reshape(C * nrows, -1).contiguous(),
        gci.reshape(C * nrows, -1).contiguous(), params,
    ).reshape(C, nrows, kpad, 3)
    if ks.pair_terms:
        ke_p, rbar_p = _pair_columns(rows, cfgs, x_pd, x_pm, ks, oidx)
        ke = ke + ke_p.to(ke.dtype)
        rbar = rbar + rbar_p.to(rbar.dtype)
    return ke, rbar


def _columns(rows: _Rows, cfgs, x_desc, x_num, x_lone, radii, params,
             exponent, ks=None, x_pd=None, x_pm=None):
    """(ke (C, B), kf (C, B, N, 3), kv (C, B, 3, 3)) of C inducing
    environments against the stacked rows of ``cfgs``."""
    n, kpad = cfgs[0].nbr_idx.shape
    B, C = len(cfgs), x_desc.shape[0]
    ke, rbar = _column_grads(rows, cfgs, x_desc, x_num, x_lone, radii, params,
                             exponent, ks, x_pd, x_pm)
    rbar = rbar.reshape(C, B, n, kpad, 3)
    kf, kv = [], []
    r0 = rows.r0.reshape(B, n, kpad, 3)
    for b, cfg in enumerate(cfgs):
        f, v = _force_virial(rbar[:, b], r0[b], cfg)
        kf.append(f)
        kv.append(v)
    return ke, torch.stack(kf, dim=1), torch.stack(kv, dim=1)


def kernel_cols_multi_fn(cfgs, x_desc, x_num, x_lone, radii, params, exponent,
                         ks=None, x_pd=None, x_pm=None):
    """(Ke, Kf, Kv) of C inducing environments against B same-bucket
    configurations: ke (C, B), kf (C, B, N, 3), kv (C, B, 3, 3).

        Ke[j, b] = sum_i k(p_i, x_j) over the atoms of config b
        Kf = -dKe/dpos,  Kv = sym(dKe/deps)   (one strain per config)

    The JAX package takes one VJP per column under ``vmap``
    (``kernel_col_batch_fn`` / ``kernel_cols_multi_fn`` /
    ``kernel_block_fn``).  Here the configurations' rows are stacked, the
    forward kernel runs once on all of them, the C column cotangents are
    carried through the power spectrum (and the alchemical mixing) by one
    batched backward, and the backward kernel runs once on the rows
    repeated C times.  Pair terms (``x_pd``/``x_pm``: the envs' staged
    pair distances (C, T, KX)) add their columns through the distances.
    Descriptors and both kernels work in the configurations' type; the
    Gram block in the higher of that and the inducing descriptors' (as
    ``predict_fn``)."""
    cfgs = list(cfgs)
    mixL = ks.mixL if ks is not None else None
    return _columns(_stack_rows(cfgs, radii, params, mixL), cfgs, x_desc,
                    x_num, x_lone, radii, params, exponent, ks, x_pd, x_pm)


def _model_pairs(model, sl):
    """The inducing rows ``sl``'s staged pair sets as (C, T, KX)."""
    if model.pair_d is None:
        return None, None
    return (model.pair_d[:, sl].transpose(0, 1),
            model.pair_mask[:, sl].transpose(0, 1))


def kernel_block_fn(cfg: ConfigArrays, model: ModelArrays, radii, params,
                    exponent, batch_size=64, ks=None, m=None, oidx=None,
                    amask=None):
    """(Ke row (M,), Kf block (N, 3, M), Kv block (3, 3, M)) of a
    configuration against the inducing set: one forward launch and power
    spectrum, then ``batch_size`` columns per backward-kernel launch;
    columns beyond the live inducing set (the first ``m``, counted here
    when not given) are 0 (the padding rows' kernel is 0 in the JAX
    package too).  ``oidx`` / ``amask``: the table rows are these atoms
    of a configuration with this atom mask (a mesh shard's rows); the
    block is then this shard's partial sum."""
    mcap = model.mu.shape[0]
    m = int(model.m_mask.sum()) if m is None else m
    n = cfg.nbr_idx.shape[0] if amask is None else amask.shape[0]
    dtype = torch.promote_types(cfg.positions.dtype, model.X_desc.dtype)
    dev = cfg.positions.device
    ke = torch.zeros(mcap, dtype=dtype, device=dev)
    kf = torch.zeros((n, 3, mcap), dtype=cfg.positions.dtype, device=dev)
    kv = torch.zeros((3, 3, mcap), dtype=cfg.positions.dtype, device=dev)
    mixL = ks.mixL if ks is not None else None
    rows = _stack_rows([cfg], radii, params, mixL, oidx=oidx)
    for lo in range(0, m, batch_size):
        sl = slice(lo, min(lo + batch_size, m))
        x_pd, x_pm = _model_pairs(model, sl)
        e, rbar = _column_grads(rows, [cfg], model.X_desc[sl],
                                model.X_num[sl], model.X_lone[sl], radii,
                                params, exponent, ks, x_pd, x_pm, oidx)
        f, v = _force_virial(rbar, rows.r0, cfg, oidx, amask)
        ke[sl] = e[:, 0]
        kf[..., sl] = f.permute(1, 2, 0)
        kv[..., sl] = v.permute(1, 2, 0)
    return ke, kf, kv


# --------------------------------------------------------------------------
# the Jacobian route
# --------------------------------------------------------------------------


def coeff_jacobian(rvec, sidx, mask, radii, params):
    """(2, Q, N, K, 3) = d c[i, s_k, q] / d rvec[i, k] for the real (0) and
    imaginary (1) coefficients, Q = (nmax+1)(lmax+1)^2 channels per
    species, from ONE launch of the backward kernel on the rows repeated
    2Q times with one-hot cotangents.  A slot feeds only its own species'
    segment, so the one-hot at channel q, set in every species segment at
    once, gives each slot's derivative of its own species' channel."""
    N, K, _ = rvec.shape
    S = radii.shape[0]
    L = params.lmax + 1
    Q = (params.nmax + 1) * L * L
    eye = torch.eye(Q, dtype=rvec.dtype, device=rvec.device)
    hot = eye[:, None, None, :].expand(Q, N, S, Q).reshape(Q * N, S * Q)
    zero = torch.zeros_like(hot)
    crb = torch.cat([hot, zero]).contiguous()
    cib = torch.cat([zero, hot]).contiguous()
    rbar = soap_coeff_bwd(rvec.repeat(2 * Q, 1, 1), sidx.repeat(2 * Q, 1),
                          mask.repeat(2 * Q, 1), radii, crb, cib, params)
    return rbar.reshape(2, Q, N, K, 3)


def _sym_blocks(x, S, params):
    """(..., L, S nf, S nf) blocks Xs[l, (a,u), (b,v)] = (x[a,b,u,v,l] +
    x[b,a,v,u,l]) nnl[u,v,l] of descriptor-space vectors x (..., D): the
    power spectrum's bilinear form, so that d(x . p~)/dc[a,u,l,m] =
    w[l,m] sum_(b,v) Xs[l,(a,u),(b,v)] c[b,v,l,m]."""
    nf, L = params.nmax + 1, params.lmax + 1
    lead = x.shape[:-1]
    nl = len(lead)
    xr = x.reshape(*lead, S, S, nf, nf, L)
    x1 = xr.permute(*range(nl), nl + 4, nl, nl + 2, nl + 1, nl + 3)
    x2 = x1.permute(*range(nl), nl, nl + 3, nl + 4, nl + 1, nl + 2)
    _, nnl = _spectrum_constants(params, x.dtype, x.device)
    w = nnl.permute(2, 0, 1)[:, None, :, None, :]  # (L, 1, u, 1, v)
    return ((x1 + x2) * w).reshape(*lead, L, S * nf, S * nf)


def _spectrum_vjp(xs, cl, wlm, lead_eq):
    """d(x . p~)/dc from ``_sym_blocks`` ``xs`` and per-l coefficient
    blocks ``cl`` (N, L, S nf, L): (N, C, L, S nf, L) for a column batch
    xs (C, L, P, P), or (N, L, S nf, L) for per-row xs (N, L, P, P)
    (``lead_eq``)."""
    if lead_eq:
        return torch.einsum("ilpq,ilqm->ilpm", xs, cl) * wlm
    return torch.einsum("jlpq,ilqm->ijlpm", xs, cl) * wlm


class _Chain(NamedTuple):
    """A configuration's coefficients, their Jacobian and the pieces of
    the chain through the power spectrum and the normalisation."""
    r0: torch.Tensor  # (N, K, 3)
    lone: torch.Tensor  # (N,)
    praw: torch.Tensor  # (N, D) the unnormalized spectrum p~
    nrm: torch.Tensor  # (N, 1) |p~|
    p: torch.Tensor  # (N, D)
    jfull: torch.Tensor  # (N, 2 S Q, K 3) dc / drvec, (Re|Im, s, q) rows
    crl: torch.Tensor  # (N, L, S nf, L) per-l blocks of cR
    cil: torch.Tensor
    wlm: torch.Tensor  # (L, 1, L) the m weights


def _coeff_chain(cfg: ConfigArrays, radii, params, oidx=None) -> _Chain:
    """One forward launch, one one-hot backward launch, and the spectrum
    in the configuration's type (``oidx``: :func:`_env_rvec`)."""
    n, kpad = cfg.nbr_idx.shape
    S = radii.shape[0]
    nf, L = params.nmax + 1, params.lmax + 1
    P, Q = S * nf, nf * L * L
    wd = cfg.positions.dtype
    r0 = _env_rvec(cfg.positions, cfg.cell, cfg, oidx=oidx)
    mask = cfg.nbr_mask & cfg.atom_mask[:, None]
    sidx = cfg.nbr_sidx
    cr, ci = soap_coeff_fwd(r0, sidx, mask, radii, params)
    jc = coeff_jacobian(r0, sidx, mask, radii, params)  # (2, Q, n, K, 3)
    within = mask & ((r0 * r0).sum(-1) < params.rc**2)
    lone = cfg.atom_mask & ~within.any(dim=1)
    shape = (n, S, nf, L, L)
    praw = power_spectrum(cr.reshape(shape), ci.reshape(shape),
                          dataclasses.replace(params, normalize=False))
    if params.normalize:
        eps = torch.finfo(wd).eps
        nrm = torch.sqrt((praw * praw).sum(-1, keepdim=True) + eps * eps)
    else:
        nrm = torch.ones((n, 1), dtype=wd, device=praw.device)
    # the full coefficient Jacobian: species s's channels see only the
    # slots of species s
    hot = (sidx.long()[:, None, :] == torch.arange(S, device=sidx.device)
           [None, :, None]).to(wd)  # (n, S, K)
    jfull = (jc.permute(2, 0, 1, 3, 4)[:, :, None]
             * hot[:, None, :, None, :, None]).reshape(n, 2 * S * Q, kpad * 3)
    w_lm, _ = _spectrum_constants(params, wd, cr.device)

    def blocks(c):
        return c.reshape(shape).permute(0, 3, 1, 2, 4).reshape(n, L, P, L)

    return _Chain(r0, lone, praw, nrm, praw / nrm, jfull, blocks(cr),
                  blocks(ci), w_lm[:, None, :])


def _chain_vjp(ch: _Chain, xs, S, params, lead_eq):
    """d(x . p~)/d(cR, cI) for ``_sym_blocks`` ``xs``, in the (Re|Im, s, n,
    l, m) order of ``jfull``'s rows."""
    nf, L = params.nmax + 1, params.lmax + 1

    def to_coeff(g):  # (..., L, P, L) -> (..., S Q) in (s, n, l, m)
        lead = g.shape[:-3]
        g = g.reshape(*lead, L, S, nf, L)
        g = g.permute(*range(len(lead)), -3, -2, -4, -1)
        return g.reshape(*lead, S * nf * L * L)

    return torch.cat([to_coeff(_spectrum_vjp(xs, ch.crl, ch.wlm, lead_eq)),
                      to_coeff(_spectrum_vjp(xs, ch.cil, ch.wlm, lead_eq))],
                     -1)


def kernel_block_jac_fn(cfg: ConfigArrays, model: ModelArrays, radii, params,
                        exponent, chunk=128, m=None, oidx=None, amask=None):
    """(Ke row, Kf block, Kv block) via the descriptor Jacobian.

    Instead of one backward per inducing column (``kernel_block_fn``), the
    coefficient Jacobian dc/drvec comes once from one launch of the
    backward kernel with one-hot cotangents (``coeff_jacobian``), and
    every column is matrix products through the bilinear power spectrum
    and the normalisation:

        W[i, j]    = zeta (p_i . x_j)^(zeta-1) delta(z_i, Z_j)
        g_ij       = d(p_i . x_j)/dc_i = J_i^T (x_j - (p_i . x_j) p_i) / |p~_i|
        dKe_j/dr_ik = W[i, j] g_ij . dc_i/dr_ik
        Kf[b, :, j] = -(sum_{(i,k): idx[i,k]=b} - sum_{i=b}) dKe_j/dr_ik
        Kv[j]       = sym(sum_{i,k} rvec[i,k] (x) dKe_j/dr_ik)

    (the JAX package's ``kernel_block_jac_fn``, which takes the descriptor
    Jacobian by forward mode).  SOAP dot kernel only: no pair terms, no
    alchemical mixing, no other base kernel.  The products run in the
    configuration's type, W in the Gram block's.  ``m``, ``oidx`` and
    ``amask`` as in :func:`kernel_block_fn`."""
    n, kpad = cfg.nbr_idx.shape
    nout = n if amask is None else amask.shape[0]
    S = radii.shape[0]
    wd = cfg.positions.dtype
    mcap = model.mu.shape[0]
    m = int(model.m_mask.sum()) if m is None else m
    with torch.no_grad():
        ch = _coeff_chain(cfg, radii, params, oidx)
        gd = torch.promote_types(wd, model.X_desc.dtype)
        dot = ch.p.to(gd) @ model.X_desc.to(gd).T  # (n, M)
        same = (cfg.numbers[:, None] == model.X_num[None, :]).to(gd)
        valid = same * (cfg.atom_mask[:, None] & model.m_mask[None, :]).to(gd)
        lterm = (ch.lone[:, None] & model.X_lone[None, :]).to(gd)
        ke = ((dot**exponent + lterm) * valid).sum(dim=0)
        W = (exponent * dot ** (exponent - 1) * valid).to(wd)
        dotw = dot.to(wd)
        # J_i^T p~_i, once per row
        bt = _chain_vjp(ch, _sym_blocks(ch.praw, S, params), S, params, True)
        kf = torch.zeros((nout, 3, mcap), dtype=wd, device=ch.p.device)
        kv = torch.zeros((3, 3, mcap), dtype=wd, device=ch.p.device)
        for lo in range(0, m, chunk):
            sl = slice(lo, min(lo + chunk, m))
            xs = _sym_blocks(model.X_desc[sl].to(wd), S, params)
            a = _chain_vjp(ch, xs, S, params, False)
            # g_ij = (J^T x_j - t_ij J^T p~_i / |p~_i|) / |p~_i|
            g = (a - (dotw[:, sl] / ch.nrm)[..., None] * bt[:, None, :]) \
                / ch.nrm[..., None]
            g = g * W[:, sl, None]
            rbar = torch.bmm(g, ch.jfull).reshape(n, -1, kpad, 3).transpose(0, 1)
            f, v = _force_virial(rbar, ch.r0, cfg, oidx, amask)
            kf[..., sl] = f.permute(1, 2, 0)
            kv[..., sl] = v.permute(1, 2, 0)
    return ke, kf, kv


@torch.no_grad()
def descriptor_jacobian(cfg: ConfigArrays, radii, params):
    """(p (N, D), lone (N,), dp/dpos (N, D, N, 3)) of a configuration: the
    normalized (unmixed) descriptors and their full position Jacobian,
    from the coefficient Jacobian of one one-hot backward-kernel launch
    chained through the power spectrum and the normalisation.  O(N^2 D):
    for the exact GP and the force-aware LML at small data sizes."""
    n, kpad = cfg.nbr_idx.shape
    S = radii.shape[0]
    ch = _coeff_chain(cfg, radii, params)
    p, nrm = ch.p, ch.nrm
    D = p.shape[1]
    # rows of d p~ / d c: the spectrum's vjp of every unit vector
    eye = _sym_blocks(torch.eye(D, dtype=p.dtype, device=p.device), S, params)
    jp = _chain_vjp(ch, eye, S, params, False)  # (n, D, 2 S Q)
    if params.normalize:
        jp = (jp - p[:, :, None] * torch.einsum("id,idc->ic", p, jp)[:, None]) \
            / nrm[..., None]
    jr = torch.bmm(jp, ch.jfull).reshape(n, D, kpad, 3)  # dp_i / d rvec_ik
    mask = cfg.nbr_mask & cfg.atom_mask[:, None]
    onehot = (cfg.nbr_idx.long()[..., None]
              == torch.arange(n, device=p.device)).to(p.dtype) * mask[..., None]
    jpos = torch.einsum("idkx,ikb->idbx", jr, onehot)
    idx = torch.arange(n, device=p.device)
    jpos[idx, :, idx, :] -= jr.sum(dim=2)
    return p, ch.lone, jpos


def jac_bytes(npad, kpad, nspecies, params, esize, chunk=128):
    """Device bytes of ``kernel_block_jac_fn``'s largest intermediates:
    the one-hot launch's cotangents and output, the full coefficient
    Jacobian, and one chunk's coefficient gradients."""
    L = params.lmax + 1
    Q = (params.nmax + 1) * L * L
    ch2 = 2 * nspecies * Q
    onehot = 2 * Q * npad * (2 * nspecies * Q + kpad * 3)
    jfull = npad * ch2 * kpad * 3
    per_chunk = 3 * npad * chunk * ch2
    return esize * (onehot + jfull + per_chunk)


# --------------------------------------------------------------------------
# host-side engine
# --------------------------------------------------------------------------

VOIGT = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]


def device_fetch(*tensors):
    """Pull several device tensors to the host in ONE transfer: flatten and
    concatenate on the device (as float64, which holds every int32 value
    exactly), one copy, split on the host and cast back."""
    with span("af.host_read"):
        for t in tensors:
            if t.dtype == torch.int64:
                raise TypeError("device_fetch: int64 payloads do not survive "
                                "the float64 buffer; fetch them separately")
        if len(tensors) == 1:
            return [tensors[0].detach().cpu().numpy()]
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                          for t in tensors])
        buf = flat.cpu().numpy()
        out = []
        o = 0
        for t in tensors:
            n = t.numel()
            dt = np.dtype(str(t.dtype).replace("torch.", ""))
            out.append(buf[o:o + n].astype(dt).reshape(tuple(t.shape)))
            o += n
        return out


def voigt6(t):
    """3x3 symmetric tensor -> Voigt [xx, yy, zz, yz, xz, xy]."""
    t = np.asarray(t)
    return np.array([t[i, j] for i, j in VOIGT])


class Engine:
    """Host wrapper: species table, buckets, device and working type."""

    def __init__(self, params: SoapParams = None, exponent=4, radii=None,
                 species=None, dtype=None, device="cuda", pair_terms=(),
                 chemical=None, mesh=None, kernel=None):
        self.params = params or SoapParams()
        self.exponent = int(exponent)
        self.radii = as_radii(radii if radii is not None else 1.0)
        self.species = sorted(int(z) for z in (species or []))
        self.pair_terms = tuple(pair_terms)
        self.pair_kx = 16  # pair-distance buffer bucket (grow_pair_kx)
        self.env_kpad = 8  # sticky env-staging neighbor bucket (make_envs)
        # alchemical species similarity: None -> Dirac delta; 'rbf' ->
        # element-embedding RBF (chemical.py)
        self.chemical = chemical
        # base kernel on descriptors: 'dot' (DotProd**zeta, default), 'rbf',
        # 'normed', or any composable KernelExpr (kernelalgebra.py)
        self.kernel_kind = kernel if kernel is not None else "dot"
        if not (isinstance(self.kernel_kind, KernelExpr)
                or self.kernel_kind in ("dot", "rbf", "normed")):
            raise ValueError(f"unknown kernel kind {self.kernel_kind!r}")
        self.device = resolve_device(device)
        # ('data', 'model') device mesh (parallel/mesh.py): predict and
        # kernel_block then run sharded; its first device is this one
        self.mesh = mesh
        # float32 is the working type of configurations and descriptors on
        # the card (as on the TPU).  The model state (inducing descriptors,
        # weights, choli) stays float64: the energy sum(cov @ mu) cancels
        # terms whose magnitudes add up to ~1e5 times |E| (bench model:
        # 3.5e7 eV against 190 eV), so the float32 rounding of each
        # inducing descriptor's norm, shared by every atom, moves the
        # energy by ~1e-4 eV/atom even for an exactly computed descriptor
        # stored in float32; float32 restaging adds a few times more.
        self.dtype = dtype if dtype is not None else torch.float32
        self.model_dtype = torch.float64
        self._tables = {}  # species tuple -> (znum, chem_z, mixL) on device

    @property
    def mesh(self):
        return self._mesh

    @mesh.setter
    def mesh(self, mesh):
        if mesh is not None:
            from .parallel.mesh import Mesh, same_device

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.Mesh (make_mesh), "
                                f"not {type(mesh).__name__}")
            if not same_device(mesh.first, self.device):
                raise ValueError(f"the mesh's first device {mesh.first} is "
                                 f"not the engine's {self.device}")
        self._mesh = mesh

    def clone_config(self):
        """A fresh Engine with the same kernel configuration (params,
        exponent, radii, species, pair terms, chemical, base kernel, mesh,
        device and types)."""
        eng = Engine(params=self.params, exponent=self.exponent,
                     radii=self.radii, species=list(self.species),
                     dtype=self.dtype, device=self.device,
                     pair_terms=self.pair_terms, chemical=self.chemical,
                     mesh=self.mesh,
                     kernel=self.kernel_kind if self.kernel_kind != "dot" else None)
        eng.pair_kx = self.pair_kx
        eng.env_kpad = self.env_kpad
        return eng

    @property
    def plain_kernel(self):
        """The normalized SOAP dot kernel alone (k(x, x) = 1)."""
        return (not self.pair_terms and not self.chemical
                and self.kernel_kind == "dot")

    def _species_tables(self):
        """(znum, chem_z, mixL) of the current species table on the device,
        uploaded once per table."""
        key = tuple(self.species)
        if key not in self._tables:
            table = self.species if self.species else [0]
            znum = self._tensor(np.asarray(table, dtype=np.int32))
            chem_z = mixL = None
            if self.chemical:
                from .chemical import chem_rbf_table, mixing_cholesky

                chem_z = self._tensor(chem_rbf_table(), self.model_dtype)
                mixL = self._tensor(mixing_cholesky(table), self.model_dtype)
            self._tables[key] = (znum, chem_z, mixL)
        return self._tables[key]

    def chem_args(self):
        """(chem_z table, per-table mixing cholesky) or (None, None)."""
        return self._species_tables()[1:]

    def kernel_space(self):
        """The :class:`KernelSpace` the device functions take (None for
        the plain dot kernel)."""
        if self.plain_kernel:
            return None
        znum, chem_z, mixL = self._species_tables()
        return KernelSpace(znum=znum, pair_terms=self.pair_terms,
                           chem_z=chem_z, mixL=mixL, kind=self.kernel_kind)

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def znum_table(self):
        return self._species_tables()[0]

    # -------------------------------------------------------------- species
    @property
    def nspecies(self):
        return len(self.species)

    @property
    def dim(self):
        return self.params.dim(max(self.nspecies, 1))

    def species_index(self, numbers):
        """Map atomic numbers to table indices; -1 if absent."""
        numbers = np.asarray(numbers)
        out = np.full(numbers.shape, -1, dtype=np.int32)
        for i, z in enumerate(self.species):
            out[numbers == z] = i
        return out

    def ensure_species(self, numbers):
        """Grow the species table; returns True if it changed."""
        new = sorted(set(int(z) for z in np.asarray(numbers).reshape(-1)) - set(self.species))
        if new:
            self.species = sorted(self.species + new)
            return True
        return False

    def radii_table(self):
        table = self.species if self.species else [0]
        return self._tensor(self.radii.table(table), self.dtype)

    # -------------------------------------------------------------- configs
    def make_config(self, system, npad=None, kpad=None, table=None) -> ConfigArrays:
        """Build padded device tensors for a System."""
        n = len(system)
        npad = npad or round_up(n, 16)
        if table is None:
            table = neighbor_table(
                system.positions, system.cell, system.pbc, self.params.rc
            )
        if kpad is not None:
            table = table.pad_to(kpad)
        sidx = self.species_index(system.numbers)  # (n,)
        nbr_sidx = sidx[table.idx]
        nbr_mask = table.mask & (nbr_sidx >= 0)

        def pad(a, fill=0):
            out = np.full((npad,) + a.shape[1:], fill, dtype=a.dtype)
            out[:n] = a
            return out

        positions = pad(system.positions.astype(np.float64))
        numbers = pad(system.numbers.astype(np.int32))
        atom_mask = np.zeros(npad, bool)
        atom_mask[:n] = True
        nbr_idx = pad(table.idx)
        nbr_off = pad(table.off)
        if np.abs(nbr_off).max(initial=0) <= 127:
            # PBC image offsets fit int8 except for pathologically thin
            # cells; the (N, K, 3) offsets are the largest upload
            nbr_off = nbr_off.astype(np.int8)
        nbr_sidx = pad(np.maximum(nbr_sidx, 0).astype(np.int32))
        nbr_mask = pad(nbr_mask)
        idx_t = self._tensor(nbr_idx)
        off_t = self._tensor(nbr_off)
        mask_t = self._tensor(nbr_mask)
        # the sharded paths never read the reverse slots (padding for the
        # mesh breaks their flat i*K + k indexing): no table under a mesh
        rev_t = None if self.mesh is not None else self._reverse_slots(
            nbr_idx, nbr_off, nbr_mask, idx_t, off_t, mask_t)
        return ConfigArrays(
            positions=self._tensor(positions, self.dtype),
            cell=self._tensor(system.cell, self.dtype),
            numbers=self._tensor(numbers),
            atom_mask=self._tensor(atom_mask),
            nbr_idx=idx_t,
            nbr_off=off_t,
            nbr_sidx=self._tensor(nbr_sidx),
            nbr_mask=mask_t,
            nbr_rev=rev_t,
        )

    def _reverse_slots(self, nbr_idx, nbr_off, nbr_mask, idx_t, off_t,
                       mask_t):
        """The table's reverse slots on the device, None if asymmetric."""
        rev = reverse_slots_host(nbr_idx, nbr_off, nbr_mask)
        if rev is None:  # table too large for the host int64 key encoding
            from .neighbors_device import reverse_slots

            rev_t = reverse_slots(idx_t, off_t, mask_t)
            asym = bool(torch.any(mask_t & (rev_t < 0)))
        else:
            asym = bool((nbr_mask & (rev < 0)).any())
            rev_t = self._tensor(rev)
        # the reverse-slot backward silently drops a pair's cotangent if its
        # mirror entry is missing; both builders emit symmetric tables, but
        # guard against an asymmetric producer: use the plain indexing path
        if asym:
            logging.getLogger(__name__).warning(
                "asymmetric neighbor table: disabling the reverse-slot "
                "force backward (plain scatter path)"
            )
            return None
        return rev_t

    def update_positions(self, cfg: ConfigArrays, system) -> ConfigArrays:
        """Refresh only positions/cell of a cached config (neighbor table
        unchanged thanks to the Verlet skin)."""
        pos = np.zeros((cfg.npad, 3))
        pos[: len(system)] = system.positions
        return cfg._replace(
            positions=self._tensor(pos, self.dtype),
            cell=self._tensor(system.cell, self.dtype),
        )

    def make_envs(self, env_list, kpad=None, dtype=None) -> EnvArrays:
        """Pad a list of raw (rvec, numbers) environments; the neighbor axis
        uses a sticky bucket (env_kpad).  ``dtype`` defaults to the working
        type."""
        kmax = max([len(e[1]) for e in env_list] + [1])
        if kpad is None:
            self.env_kpad = max(self.env_kpad, round_up(kmax, 8))
            kpad = self.env_kpad
        m = len(env_list)
        rvec = np.zeros((m, kpad, 3))
        sidx = np.zeros((m, kpad), dtype=np.int32)
        mask = np.zeros((m, kpad), bool)
        for i, (rv, nums) in enumerate(env_list):
            c = len(nums)
            rvec[i, :c] = rv
            si = self.species_index(nums)
            sidx[i, :c] = np.maximum(si, 0)
            mask[i, :c] = si >= 0
        return EnvArrays(
            rvec=self._tensor(rvec, dtype or self.dtype),
            sidx=self._tensor(sidx),
            mask=self._tensor(mask),
        )

    # ---------------------------------------------------------- computations
    def descriptors(self, cfg: ConfigArrays):
        """Per-LCE descriptors (alchemically mixed when chemical is on)."""
        p, lone = descriptors_fn(cfg, self.radii_table(), self.params)
        _, mixL = self.chem_args()
        return _chem_mix(p, mixL, len(self.species) or 1), lone

    def pair_self(self, cfg: ConfigArrays):
        """Per-LCE pair-term share of k(x, x) (zeros without pair terms)."""
        return pair_self_fn(cfg, self.kernel_space() or PLAIN)

    def env_descriptors(self, envs: EnvArrays):
        radii = self.radii_table().to(envs.rvec.dtype)
        _, mixL = self.chem_args()
        return env_descriptors_fn(envs, radii, self.params, mixL=mixL)

    def predict(self, cfg: ConfigArrays, model: ModelArrays, vscale_atom):
        vs = self._tensor(np.asarray(vscale_atom, dtype=np.float64), self.dtype)
        if self.mesh is not None:
            from .parallel.mesh import mesh_pad, sharded_predict

            cfg2, model2, oidx, vs2 = mesh_pad(cfg, model, vs, self.mesh)
            e, f, w, cov, beta = sharded_predict(
                cfg2, model2, self.radii_table(), vs2, oidx, self.mesh,
                self.params, self.exponent, ks=self.kernel_space())
            npad, mcap = cfg.npad, model.mu.shape[0]
            return e, f[:npad], w, cov[:npad, :mcap], beta[:npad]
        return predict_fn(cfg, model, self.radii_table(), vs, self.params,
                          self.exponent, ks=self.kernel_space())

    def gram_self(self, cfg: ConfigArrays):
        return gram_self_fn(cfg, self.radii_table(), self.params, self.exponent,
                            ks=self.kernel_space())

    def _env_pairs(self, B, x_pds, x_pms):
        """Pair sets (B, T, KX) on the device (empty ones when not given)."""
        if not self.pair_terms:
            return None, None
        if x_pds is None:
            x_pds = np.zeros((B, len(self.pair_terms), self.pair_kx))
            x_pms = np.zeros(x_pds.shape, dtype=bool)
        return (self._tensor(np.asarray(x_pds), self.model_dtype),
                self._tensor(np.asarray(x_pms, dtype=bool)))

    def kernel_cols_multi(self, cfg_list, x_descs, x_nums, x_lones,
                          x_pds=None, x_pms=None):
        """(ke, kf, kv) of a batch of inducing envs against a list of
        same-bucket configurations, output axes (env, config, ...).

        ``x_descs`` / ``x_lones`` may be device tensors (fresh staging
        outputs): they are consumed without a host sync, so callers can
        chain staging -> columns -> one device_fetch.  ``x_pds`` /
        ``x_pms``: the envs' staged pair distances (B, T, KX)."""
        if isinstance(x_descs, torch.Tensor):
            desc = x_descs.to(self.device, self.model_dtype)
        else:
            desc = self._tensor(np.asarray(x_descs), self.model_dtype)
        if isinstance(x_lones, torch.Tensor):
            lone = x_lones.to(self.device, torch.bool)
        else:
            lone = self._tensor(np.asarray(x_lones, dtype=bool))
        num = self._tensor(np.asarray(x_nums, dtype=np.int32))
        pd, pm = self._env_pairs(len(num), x_pds, x_pms)
        return kernel_cols_multi_fn(list(cfg_list), desc, num, lone,
                                    self.radii_table(), self.params,
                                    self.exponent, ks=self.kernel_space(),
                                    x_pd=pd, x_pm=pm)

    def kernel_col_batch(self, cfg_list, x_desc, x_num, x_lone, x_pd=None,
                         x_pm=None):
        """(ke (B,), kf (B, N, 3), kv (B, 3, 3)) of one inducing env
        against a list of same-bucket configurations."""
        ke, kf, kv = self.kernel_cols_multi(
            cfg_list, np.asarray(x_desc)[None], [x_num], [bool(x_lone)],
            x_pds=None if x_pd is None else np.asarray(x_pd)[None],
            x_pms=None if x_pm is None else np.asarray(x_pm)[None])
        return ke[0], kf[0], kv[0]

    def kernel_col(self, cfg: ConfigArrays, x_desc, x_num, x_lone, x_pd=None,
                   x_pm=None):
        """(ke, kf (N, 3), kv (3, 3)) of one inducing env against one
        configuration."""
        ke, kf, kv = self.kernel_col_batch([cfg], x_desc, x_num, x_lone,
                                           x_pd, x_pm)
        return ke[0], kf[0], kv[0]

    # the Jacobian route's intermediates may take at most this many bytes
    # (a fifth of the H100's 80 GB)
    JAC_BYTES_CAP = 16e9

    def kernel_block(self, cfg: ConfigArrays, model: ModelArrays,
                     batch_size=64, method="auto"):
        """(Ke (M,), Kf (N, 3, M), Kv (3, 3, M)) of a configuration against
        the inducing set.  ``method``: "vjp" (the column route,
        ``kernel_block_fn``), "jac" (the descriptor Jacobian,
        ``kernel_block_jac_fn``; the plain dot kernel only) or "auto": the
        JAX package's rule, the Jacobian for the plain dot kernel once
        m >= 64 while its intermediates stay under ``JAC_BYTES_CAP`` (under
        a mesh, a data shard's: the guard is divided by the shard count)."""
        if method == "auto":
            m = int(model.m_mask.sum())
            nbytes = jac_bytes(cfg.npad, cfg.nbr_idx.shape[1],
                               max(self.nspecies, 1), self.params,
                               cfg.positions.element_size())
            if self.mesh is not None:
                nbytes /= self.mesh.shape["data"]
            method = ("jac" if self.plain_kernel and m >= 64
                      and nbytes < self.JAC_BYTES_CAP else "vjp")
        if method not in ("jac", "vjp"):
            raise ValueError(f"unknown kernel_block method {method!r}")
        if method == "jac" and not self.plain_kernel:
            raise ValueError("the Jacobian route serves the plain dot "
                             "kernel only (no pair terms, chemical or "
                             "other kinds)")
        if self.mesh is not None:
            from .parallel.mesh import (mesh_pad, sharded_kernel_block,
                                        sharded_kernel_block_jac)

            cfg2, model2, oidx, _ = mesh_pad(cfg, model, None, self.mesh)
            if method == "jac":
                ke, kf, kv = sharded_kernel_block_jac(
                    cfg2, model2, self.radii_table(), oidx, self.mesh,
                    self.params, self.exponent)
            else:
                ke, kf, kv = sharded_kernel_block(
                    cfg2, model2, self.radii_table(), oidx, self.mesh,
                    self.params, self.exponent, batch_size=batch_size,
                    ks=self.kernel_space())
            npad, mcap = cfg.npad, model.mu.shape[0]
            return ke[:mcap], kf[:npad, :, :mcap], kv[..., :mcap]
        if method == "jac":
            return kernel_block_jac_fn(cfg, model, self.radii_table(),
                                       self.params, self.exponent)
        return kernel_block_fn(cfg, model, self.radii_table(), self.params,
                               self.exponent, batch_size=batch_size,
                               ks=self.kernel_space())

    def grow_pair_kx(self, env):
        """Grow the pair buffer bucket to fit this env (rare host event)."""
        from .pairkernels import env_pair_counts

        need = max(env_pair_counts(env, self.pair_terms) + [1])
        if need > self.pair_kx:
            self.pair_kx = round_up(need, 8)
            return True
        return False

    def env_pair_data(self, env):
        """Host: padded pair distances for one env (all pair terms)."""
        if not self.pair_terms:
            return None, None
        self.grow_pair_kx(env)
        return stage_env_pairs(env, self.pair_terms, self.pair_kx)

    # ------------------------------------------------------------ model sync
    def model_arrays(self, X_desc, X_num, X_lone, mu, choli, mcap=None,
                     envs=None) -> ModelArrays:
        """Pad host model state to the inducing-capacity bucket, on the
        device in ``model_dtype``; with pair terms, ``envs`` (the inducing
        environments) give the staged pair distances."""
        m = len(X_num)
        mcap = mcap or max(32, round_up(max(m, 1), 32))
        D = X_desc.shape[1] if m else self.dim
        Xd = np.zeros((mcap, D))
        Xn = np.zeros(mcap, dtype=np.int32)
        Xl = np.zeros(mcap, bool)
        mm = np.zeros(mcap, bool)
        muv = np.zeros(mcap)
        ch = np.zeros((mcap, mcap))
        if m:
            Xd[:m] = X_desc
            Xn[:m] = X_num
            Xl[:m] = X_lone
            mm[:m] = True
            muv[:m] = mu
            ch[:m, :m] = choli
        pair_d = pair_mask = None
        if self.pair_terms:
            T = len(self.pair_terms)
            pd = np.zeros((T, mcap, self.pair_kx))
            pm = np.zeros((T, mcap, self.pair_kx), dtype=bool)
            for i, env in enumerate(envs or []):
                pd[:, i], pm[:, i] = stage_env_pairs(env, self.pair_terms,
                                                     self.pair_kx)
            pair_d = self._tensor(pd, self.model_dtype)
            pair_mask = self._tensor(pm)
        return ModelArrays(
            X_desc=self._tensor(Xd, self.model_dtype),
            X_num=self._tensor(Xn),
            X_lone=self._tensor(Xl),
            m_mask=self._tensor(mm),
            mu=self._tensor(muv, self.model_dtype),
            choli=self._tensor(ch, self.model_dtype),
            pair_d=pair_d,
            pair_mask=pair_mask,
        )
