"""Kernel-hyperparameter optimization over the composable kernel algebra
(torch port of ``autoforce_tpu/regression/hpo.py``).

The objective is the exact-GP log marginal likelihood over energy targets
(``make_energy_lml``), or over energy and force targets
(``make_ef_lml``), as a function of the flat parameter vector of a
:class:`~..kernelalgebra.KernelExpr` (softplus free form,
``value_with_params``).  The descriptors do not depend on the kernel's
parameters, so they (and, for the force rows, their position Jacobians)
are computed once through the SOAP kernels; the value and gradient then
come from torch autograd in float64 on the engine's device, and a scipy
L-BFGS loop on the host drives them, as in the JAX package.

After the hyperparameters move, the SGPR covariance blocks are stale;
``SgprModel.rebuild_kernel_matrices`` re-derives M/Ke/Kf/Kv from the
stored raw data and re-solves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device

F64 = torch.float64


def collect_dot_data(engine, records):
    """Stack per-structure descriptors for the LML objective.

    Returns (P (S, n_pad, D), Z (S, n_pad), mask (S, n_pad)) as numpy; the
    target vector (energies minus the model mean) is assembled by the
    caller.
    """
    descs = []
    for rec in records:
        if rec.cfg is None:
            rec.cfg = engine.make_config(rec.system)
        p, lone = engine.descriptors(rec.cfg)
        n = rec.natoms
        descs.append((p.detach().cpu().numpy().astype(np.float64)[:n],
                      np.asarray(rec.system.numbers)))
    S = len(descs)
    n_pad = max(p.shape[0] for p, _ in descs)
    D = descs[0][0].shape[1]
    P = np.zeros((S, n_pad, D))
    Z = np.zeros((S, n_pad), dtype=np.int32)
    mask = np.zeros((S, n_pad), dtype=bool)
    for i, (p, z) in enumerate(descs):
        P[i, : len(z)] = p
        Z[i, : len(z)] = z
        mask[i, : len(z)] = True
    return P, Z, mask


def energy_lml_bytes(S, n_pad):
    """Device bytes of ``make_energy_lml``'s (S, S, n, n) float64 tensors:
    the dot products T, the species mask and about four autograd
    intermediates of the kernel expression."""
    return 8 * 6 * S * S * n_pad * n_pad


def _value_and_grad(neg_lml, device):
    """(value, gradient) as host numbers of a torch function of the flat
    parameter tensor (evaluated on ``device``)."""

    def vg(q):
        qt = torch.as_tensor(np.asarray(q, dtype=np.float64), dtype=F64,
                             device=device).requires_grad_(True)
        with torch.enable_grad():
            v = neg_lml(qt)
            (g,) = torch.autograd.grad(v, qt)
        return float(v.detach()), g.detach().cpu().numpy()

    return vg


def _gauss_nll(C, y, nreal=1):
    """0.5 (y^T C^-1 y / nreal + log det C + n log 2 pi) through the
    Cholesky factor."""
    L = torch.linalg.cholesky(C)
    yy = y if y.dim() == 2 else y[:, None]
    alpha = torch.cholesky_solve(yy, L)
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    return 0.5 * ((yy * alpha).sum() / nreal + logdet
                  + C.shape[0] * math.log(2.0 * math.pi))


def make_energy_lml(expr, P, Z, mask, y, noise_e=1e-3, device="cuda"):
    """(negative LML, grad) of the energy-target exact GP as a function of
    the flat kernel parameter vector:

    C[a, b] = sum_{i in a, j in b} delta(z_i, z_j) f(p_i . p_j)
              (+ same-LCE White variance on the diagonal)
    """
    dev = resolve_device(device)
    P = torch.as_tensor(np.asarray(P), dtype=F64, device=dev)
    yt = torch.as_tensor(np.asarray(y, dtype=np.float64), device=dev)
    T = torch.einsum("and,bmd->abnm", P, P)
    Z = np.asarray(Z)
    mask = np.asarray(mask)
    same = ((Z[:, None, :, None] == Z[None, :, None, :])
            & mask[:, None, :, None] & mask[None, :, None, :])
    same = torch.as_tensor(same, device=dev)
    natoms = torch.as_tensor(mask.sum(axis=1).astype(np.float64), device=dev)
    S = P.shape[0]
    eye = torch.eye(S, dtype=F64, device=dev)

    def neg_lml(q):
        params = list(q)
        K = expr.value_with_params(T, params) * same
        C = K.reshape(S, S, -1).sum(dim=-1)
        # same-environment White variance: each LCE with itself
        white = expr._white(list(q), torch)
        C = C + torch.diag(white * natoms) + noise_e**2 * eye
        return _gauss_nll(C, yt)

    return _value_and_grad(neg_lml, dev)


def make_ef_lml(expr, engine, records, means, noise_e=1e-3, noise_f=0.05,
                Y=None):
    """(negative LML, grad) of the exact GP over [energy; FORCE] targets as
    a function of the flat kernel parameter vector (the reference's full
    marginal likelihood, gppotential.py:344-371).

    ``Y``: optional (total, R) matrix of R independent target realizations
    sharing the covariance (rows in record order: [e_i; f_i...] per
    record, mean already removed); the objective is then the mean
    per-realization negative LML.  When omitted, the records' own (e, f)
    targets form the single realization."""
    natoms = [rec.natoms for rec in records]
    sizes = [1 + 3 * n for n in natoms]
    ofs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    total = int(ofs[-1])
    y = np.zeros(total)
    noise = np.zeros(total)
    for i, rec in enumerate(records):
        o = ofs[i]
        y[o] = float(rec.e) - float(means[i])
        y[o + 1: o + 1 + 3 * natoms[i]] = np.asarray(rec.f).reshape(-1)
        noise[o] = noise_e ** 2 * natoms[i]
        noise[o + 1: o + 1 + 3 * natoms[i]] = noise_f ** 2
    dev = engine.device
    if Y is None:
        yt = torch.as_tensor(y, device=dev)
        nreal = 1
    else:
        Y = np.asarray(Y, dtype=np.float64)
        if Y.shape[0] != total:
            raise ValueError(f"Y rows ({Y.shape[0]}) != target rows ({total})")
        yt = torch.as_tensor(Y.reshape(total, -1), device=dev)
        nreal = yt.shape[1]
    noise_t = torch.diag(torch.as_tensor(noise, device=dev))
    cov = ef_covariance_fn(expr, engine, records)

    def neg_lml(q):
        return _gauss_nll(cov(q) + noise_t, yt, nreal)

    return _value_and_grad(neg_lml, dev)


def ef_covariance_fn(expr, engine, records):
    """The [E; F] covariance C(q) of make_ef_lml as a function of the flat
    kernel parameter tensor ``q`` (differentiable in it): the (ee, ef, fe,
    ff) blocks of ``exactgp.CrossTerms``, whose parameter-independent parts
    (descriptors, position Jacobians, their products) are computed once in
    float64."""
    from .exactgp import CrossTerms, config_terms, kernel_derivatives

    radii = torch.as_tensor(engine.radii.table(engine.species or [0]),
                            dtype=F64, device=engine.device)
    sp = engine.params
    terms = []
    for rec in records:
        if rec.cfg is None:
            rec.cfg = engine.make_config(rec.system)
        cfg = rec.cfg._replace(positions=rec.cfg.positions.to(F64),
                               cell=rec.cfg.cell.to(F64))
        terms.append(config_terms(cfg, radii, sp, natoms=rec.natoms))
    natoms = [rec.natoms for rec in records]
    sizes = [1 + 3 * n for n in natoms]
    ofs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    total = int(ofs[-1])
    S = len(records)
    pairs = {(i, j): CrossTerms(terms[i], terms[j])
             for i in range(S) for j in range(i, S)}
    dev = engine.device

    def cov(q):
        rows = [[None] * S for _ in range(S)]
        for (i, j), ct in pairs.items():
            ee, ef, fe, ff = ct.blocks(
                *kernel_derivatives(ct.t, engine.exponent, expr, qvec=q))
            ni, nj = natoms[i], natoms[j]
            top = torch.cat([ee.reshape(1, 1), ef.reshape(1, 3 * nj)], dim=1)
            low = torch.cat([fe.reshape(3 * ni, 1),
                             ff.reshape(3 * ni, 3 * nj)], dim=1)
            blk = torch.cat([top, low], dim=0)
            rows[i][j] = blk
            if j > i:
                rows[j][i] = blk.T
        C = torch.cat([torch.cat(r, dim=1) for r in rows], dim=0)
        # same-LCE White variance contributes to the ENERGY diagonal only
        # (position-independent, so its derivative blocks vanish)
        white = expr._white(list(q), torch)
        wdiag = torch.zeros(total, dtype=F64, device=dev)
        wdiag[ofs[:-1]] = torch.as_tensor(natoms, dtype=F64, device=dev)
        return C + torch.diag(white * wdiag)

    return cov


def _minimize(vg, x0, maxiter):
    from scipy.optimize import minimize

    return minimize(lambda x: vg(x), x0, jac=True, method="L-BFGS-B",
                    options=dict(maxiter=maxiter))


def optimize_expr_ef(expr, engine, records, means, noise_e=1e-3,
                     noise_f=0.05, maxiter=60, Y=None):
    """L-BFGS on the force-aware LML (see make_ef_lml)."""
    x0 = np.asarray(expr.params(), dtype=np.float64)
    if x0.size == 0:
        return expr, None
    vg = make_ef_lml(expr, engine, records, means, noise_e=noise_e,
                     noise_f=noise_f, Y=Y)
    res = _minimize(vg, x0, maxiter)
    return expr.with_params(res.x.tolist()), res


def optimize_expr(expr, P, Z, mask, y, noise_e=1e-3, maxiter=60,
                  device="cuda"):
    """L-BFGS over the expression's trainable parameters; returns
    (optimized expr, scipy result).  No-op for parameter-free exprs."""
    x0 = np.asarray(expr.params(), dtype=np.float64)
    if x0.size == 0:
        return expr, None
    vg = make_energy_lml(expr, P, Z, mask, y, noise_e=noise_e, device=device)
    res = _minimize(vg, x0, maxiter)
    return expr.with_params(res.x.tolist()), res


def optimize_kernel_params(model, noise_e=1e-3, maxiter=60, min_data=3,
                           forces="auto", noise_f=0.05, ef_row_cap=400):
    """Optimize the engine's KernelExpr hyperparameters on the model's
    training targets; returns True if they moved.

    ``forces``: 'auto' uses the force-aware LML (make_ef_lml) whenever the
    stacked target count sum(1 + 3N) fits ``ef_row_cap`` (the objective
    is O(rows^3) dense); True forces it; False keeps the energy-only
    objective.

    The caller owns the follow-up ``rebuild_kernel_matrices`` (all K
    blocks are stale once the kernel changes); the ActiveCalculator
    ``kernel_hpo`` hook does both.
    """
    from ..kernelalgebra import KernelExpr

    expr = model.engine.kernel_kind
    if not isinstance(expr, KernelExpr) or not expr.params():
        return False
    if model.ndata < min_data:
        return False
    if any(np.ndim(rec.e) != 0 for rec in model.data):
        return False
    means = np.array(
        [model.mean_energy(rec.system.numbers) for rec in model.data]
    )
    rows = sum(1 + 3 * rec.natoms for rec in model.data)
    use_f = forces is True or (forces == "auto" and rows <= ef_row_cap)
    if use_f:
        new, res = optimize_expr_ef(expr, model.engine, model.data, means,
                                    noise_e=noise_e, noise_f=noise_f,
                                    maxiter=maxiter)
    else:
        P, Z, mask = collect_dot_data(model.engine, model.data)
        energies = np.array([rec.e for rec in model.data], dtype=np.float64)
        new, res = optimize_expr(expr, P, Z, mask, energies - means,
                                 noise_e=noise_e, maxiter=maxiter,
                                 device=model.engine.device)
    if res is None or not res.success and not np.isfinite(res.fun):
        return False
    moved = not np.allclose(new.params(), expr.params(), rtol=1e-6, atol=1e-8)
    if moved:
        model.engine.kernel_kind = new
    return moved
