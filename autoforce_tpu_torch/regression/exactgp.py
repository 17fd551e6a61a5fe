"""Exact (non-sparse) Gaussian-process potential (torch port of
``autoforce_tpu/regression/exactgp.py``).

The covariance over [energies; forces] targets is built from the kernel
and its first and second position derivatives,

    ee = k(P, Q)            ef = -d k / d pos_Q        (energy_forces)
    fe = -d k / d pos_P     ff = d^2 k / d pos_P d pos_Q  (forces_forces)

The JAX package differentiates the cross-structure kernel with
``jax.grad`` / ``jax.jacfwd``.  Here every block comes from the
descriptors' position Jacobians (``engine.descriptor_jacobian``: one
one-hot launch of the backward kernel per configuration) and the
elementwise derivatives k', k'' of the base kernel: across two
configurations, with t_ab = p_a . q_b,

    d k / d pos_P = sum_ab k'(t_ab) J_a^T q_b
    ff = sum_ab [k''(t_ab) (J_a^T q_b)(K_b^T p_a)^T + k'(t_ab) J_a^T K_b]

so no second derivative of the descriptor is needed.  Intended for small
data sets (it is O((N_targets)^3)).
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import ConfigArrays, descriptor_jacobian
from ..kernelalgebra import KernelExpr
from . import solver


def kernel_derivatives(t, exponent, kind="dot", qvec=None):
    """(k, k', k'') of the base kernel at the dot products ``t``,
    elementwise; with ``qvec`` (a KernelExpr's flat parameter tensor) all
    three stay differentiable in it."""
    with torch.enable_grad():
        tt = t.detach().requires_grad_(True)
        if isinstance(kind, KernelExpr):
            k = (kind.value(tt) if qvec is None
                 else kind.value_with_params(tt, list(qvec)))
        elif kind == "dot":
            k = tt**exponent
        elif kind == "rbf":
            k = torch.exp(tt - 1.0)
        elif kind == "normed":
            k = tt * 1.0
        else:
            raise ValueError(f"unknown kernel kind {kind}")
        k = k * torch.ones_like(tt)
        out = [k]
        for _ in range(2):
            prev = out[-1]
            if prev.requires_grad:
                (d,) = torch.autograd.grad(prev.sum(), tt, create_graph=True,
                                           allow_unused=True)
            else:
                d = None
            out.append(torch.zeros_like(tt) if d is None else d)
    return out


class CrossTerms:
    """The parameter-independent parts of the blocks between two
    configurations, each given as (p, lone, dp/dpos, numbers, atom mask):
    the dot products, the species and lone masks, and J_a^T q_b,
    K_b^T p_a."""

    def __init__(self, d1, d2):
        (p1, l1, j1, z1, m1), (p2, l2, j2, z2, m2) = d1, d2
        self.t = p1 @ p2.T
        self.same = ((z1[:, None] == z2[None, :])
                     & m1[:, None] & m2[None, :]).to(p1.dtype)
        self.lone = (l1[:, None] & l2[None, :]).to(p1.dtype) * self.same
        self.j1, self.j2 = j1, j2
        n1, n2 = p1.shape[0], p2.shape[0]
        self.u = torch.einsum("adx,bd->abx", j1.reshape(n1, -1, 3 * n1), p2)
        self.v = torch.einsum("bdy,ad->aby", j2.reshape(n2, -1, 3 * n2), p1)

    def blocks(self, k, k1, k2):
        """(ee, ef (n2, 3), fe (n1, 3), ff (n1, 3, n2, 3)) from the kernel
        derivatives at ``t``."""
        n1, n2 = self.t.shape
        ks, k1s, k2s = k * self.same, k1 * self.same, k2 * self.same
        ee = ks.sum() + self.lone.sum()
        fe = -torch.einsum("ab,abx->x", k1s, self.u)
        ef = -torch.einsum("ab,aby->y", k1s, self.v)
        ff = torch.einsum("ab,abx,aby->xy", k2s, self.u, self.v)
        a = torch.einsum("ab,bdy->ady", k1s, self.j2.reshape(n2, -1, 3 * n2))
        ff = ff + torch.einsum("adx,ady->xy", self.j1.reshape(n1, -1, 3 * n1), a)
        return (ee, ef.reshape(n2, 3), fe.reshape(n1, 3),
                ff.reshape(n1, 3, n2, 3))


def config_terms(cfg: ConfigArrays, radii, params, natoms=None):
    """(p, lone, dp/dpos, numbers, atom mask) of the first ``natoms`` rows
    of a configuration (all rows by default)."""
    p, lone, jpos = descriptor_jacobian(cfg, radii, params)
    n = cfg.npad if natoms is None else natoms
    return (p[:n], lone[:n] & cfg.atom_mask[:n], jpos[:n, :, :n],
            cfg.numbers[:n], cfg.atom_mask[:n])


def cross_kernel_blocks(cfg1: ConfigArrays, cfg2: ConfigArrays, radii, params,
                        exponent, kind="dot"):
    """(ee, ef, fe, ff) covariance blocks between two configurations.

    ee: scalar; ef: (N2, 3); fe: (N1, 3); ff: (N1, 3, N2, 3), over the
    padded rows (padding rows are zero).  ``kind`` accepts the composable
    kernel algebra too."""
    ct = CrossTerms(config_terms(cfg1, radii, params),
                    config_terms(cfg2, radii, params))
    return ct.blocks(*kernel_derivatives(ct.t, exponent, kind))


class ExactGP:
    """Full GP over [energy; force] targets of a set of structures."""

    def __init__(self, engine, noise_e=1e-3, noise_f=1e-3):
        self.engine = engine
        self.noise_e = noise_e
        self.noise_f = noise_f
        self.data = []
        self._C = None
        self.alpha = None

    def add_data(self, record):
        if record.cfg is None:
            record.cfg = self.engine.make_config(record.system)
        self.data.append(record)
        self._C = None

    def _blocks(self, cfg1, cfg2):
        eng = self.engine
        out = cross_kernel_blocks(cfg1, cfg2, eng.radii_table(), eng.params,
                                  eng.exponent, kind=eng.kernel_kind)
        return tuple(o.detach().cpu().numpy().astype(np.float64) for o in out)

    def covariance(self):
        if self._C is not None:
            return self._C
        sizes = [1 + 3 * rec.natoms for rec in self.data]
        total = sum(sizes)
        C = np.zeros((total, total))
        ofs = np.concatenate([[0], np.cumsum(sizes)])
        for i, ri in enumerate(self.data):
            for j, rj in enumerate(self.data):
                if j < i:
                    continue
                ee, ef, fe, ff = self._blocks(ri.cfg, rj.cfg)
                ni, nj = ri.natoms, rj.natoms
                blk = np.zeros((sizes[i], sizes[j]))
                blk[0, 0] = ee
                blk[0, 1:] = ef[:nj].reshape(-1)
                blk[1:, 0] = fe[:ni].reshape(-1)
                blk[1:, 1:] = ff[:ni, :, :nj, :].reshape(3 * ni, 3 * nj)
                C[ofs[i]:ofs[i + 1], ofs[j]:ofs[j + 1]] = blk
                if j > i:
                    C[ofs[j]:ofs[j + 1], ofs[i]:ofs[i + 1]] = blk.T
        self._C = C
        self._sizes = sizes
        self._ofs = ofs
        return C

    def targets(self):
        y = []
        for rec in self.data:
            y.append([rec.e - self.mean(rec)])
            y.append(rec.f.reshape(-1))
        return np.concatenate([np.atleast_1d(v) for v in y])

    def mean(self, rec):
        return 0.0

    def noise_diag(self):
        d = []
        for rec in self.data:
            d.append([self.noise_e**2 * rec.natoms])
            d.append(np.full(3 * rec.natoms, self.noise_f**2))
        return np.concatenate([np.atleast_1d(v) for v in d])

    def fit(self):
        C = self.covariance() + np.diag(self.noise_diag())
        L, ridge = solver.jitter_cholesky(C)
        y = self.targets()
        self.alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
        self._L = L
        return self

    def log_marginal_likelihood(self):
        """log N(Y; 0, C + noise) (reference loss, gppotential.py:352-371)."""
        if self.alpha is None:
            self.fit()
        y = self.targets()
        logdet = 2.0 * np.log(np.diag(self._L)).sum()
        n = len(y)
        return float(
            -0.5 * y @ self.alpha - 0.5 * logdet - 0.5 * n * np.log(2 * np.pi)
        )

    def predict(self, system, return_var=False):
        """(energy, forces) for a new configuration; with
        ``return_var=True`` also the predictive variance of the energy and
        the per-component force variances:

            var = diag(K_** - K_*X (K_XX + noise)^-1 K_X*)
        """
        if self.alpha is None:
            self.fit()
        cfg = self.engine.make_config(system)
        n = len(system)
        k_row = np.zeros((1 + 3 * n, len(self.alpha)))
        for j, rj in enumerate(self.data):
            ee, ef, fe, ff = self._blocks(cfg, rj.cfg)
            nj = rj.natoms
            o = self._ofs[j]
            k_row[0, o] = ee
            k_row[0, o + 1 : o + 1 + 3 * nj] = ef[:nj].reshape(-1)
            k_row[1:, o] = fe[:n].reshape(-1)
            k_row[1:, o + 1 : o + 1 + 3 * nj] = ff[:n, :, :nj, :].reshape(
                3 * n, 3 * nj
            )
        pred = k_row @ self.alpha
        energy, forces = float(pred[0]), pred[1:].reshape(n, 3)
        if not return_var:
            return energy, forces
        # prior self-covariance diagonal of the probe's [E; F] block
        ee_s, _ef_s, _fe_s, ff_s = self._blocks(cfg, cfg)
        prior = np.concatenate(
            [[ee_s],
             np.einsum("iaia->ia", ff_s[:n, :, :n, :]).reshape(-1)]
        )
        # explained variance: rows through the same noisy Cholesky the
        # mean used (so var >= 0 up to roundoff by construction)
        w = np.linalg.solve(self._L, k_row.T)
        explained = (w * w).sum(axis=0)
        var = np.clip(prior - explained, 0.0, None)
        return energy, forces, float(var[0]), var[1:].reshape(n, 3)
