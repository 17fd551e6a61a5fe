"""Two-body (pair) similarity kernels, composable with the SOAP kernel
(torch port of ``autoforce_tpu/pairkernels.py``).

Kernels between LCEs built from species-pair-selected interatomic
distances,

    k(P, Q) = sum_{pairs d in P} sum_{pairs d' in Q}
              kappa(psi(d), psi(d')) * fac(d) * fac(d')

with psi = identity (``kind="rbf"``) or log (``"logrbf"``), kappa = RBF,
and fac = 1 | PolyCut (``"polycut"``) | repulsive core * PolyCut
(``"repulsive"``).  Pairs are deduplicated: within a configuration each
physical pair belongs to exactly one LCE (j > i, or the lexicographic
offset rule for self-image pairs).

The device functions work on torch tensors (plain torch: no SOAP kernel
is involved); ``pair_gram`` runs over chunks of the inducing axis so the
(n, m, K, K') tensor never materializes.  The host functions below them
are numpy copies of the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class PairTerm:
    a: int  # species pair (atomic numbers)
    b: int
    kind: str = "rbf"  # 'rbf' (distance) | 'logrbf' (log distance)
    lengthscale: float = 1.0
    signal: float = 1.0
    factor: str | None = "polycut"  # None | 'polycut' | 'repulsive'
    rc: float = 6.0
    factor_n: int = 2
    eta: int = 1


def _psi(d, term: PairTerm):
    if term.kind == "logrbf":
        return torch.log(torch.clamp(d, min=1e-12))
    return d


def _factor(d, term: PairTerm):
    if term.factor is None:
        return torch.ones_like(d)
    t = 1.0 - d / term.rc
    cut = torch.where(d < term.rc, t**term.factor_n, torch.zeros_like(d))
    if term.factor == "repulsive":
        return cut / torch.clamp(d, min=1e-6) ** term.eta
    return cut


def _lex3(off):
    """First-nonzero-positive rule for self-image pairs."""
    o0, o1, o2 = off[..., 0], off[..., 1], off[..., 2]
    return torch.where(
        o0 != 0, o0 > 0,
        torch.where(o1 != 0, o1 > 0, torch.where(o2 != 0, o2 > 0,
                                                 torch.ones_like(o0 > 0))),
    )


def _select(term: PairTerm, zi, zj):
    return ((zi == term.a) & (zj == term.b)) | ((zi == term.b) & (zj == term.a))


def config_pair_mask(term: PairTerm, numbers, nbr_numbers, nbr_idx, nbr_off,
                     nbr_mask, own_idx=None):
    """Species selection + dedup for all LCEs of a configuration.
    ``own_idx``: the atom of each table row (a mesh shard's rows, whose
    ``nbr_idx`` hold whole-configuration indices); None: rows are atoms
    0..n-1."""
    sel = _select(term, numbers[:, None], nbr_numbers)
    if own_idx is None:
        row = torch.arange(numbers.shape[0], device=numbers.device)[:, None]
    else:
        row = own_idx[:, None]
    dedup = (nbr_idx > row) | ((nbr_idx == row) & _lex3(nbr_off))
    return sel & nbr_mask & dedup


def env_pair_mask(term: PairTerm, number, nbr_numbers, nbr_mask):
    """Species selection for a detached env (central j=0, all kept)."""
    return _select(term, number, nbr_numbers) & nbr_mask


def _pow_grad(t, n):
    """d(t**n)/dt, with torch's rule for n = 0 (zero)."""
    return torch.zeros_like(t) if n == 0 else n * t ** (n - 1)


def psi_factor_grads(d, term: PairTerm):
    """(psi'(d), fac'(d)) elementwise, in closed form: the derivatives of
    :func:`_psi` and :func:`_factor`, clamps included (a clamped value's
    derivative is 0 below its floor).  No forward-mode AD: this runs in
    autograd's backward, which on a mesh of several cards runs one
    thread per card, and forward-mode AD's dual level is one shared
    state that concurrent threads enter and leave under each other."""
    zero = torch.zeros_like(d)
    if term.kind == "logrbf":
        dpsi = torch.where(d >= 1e-12, 1.0 / torch.clamp(d, min=1e-12), zero)
    else:
        dpsi = torch.ones_like(d)
    if term.factor is None:
        return dpsi, zero
    t = 1.0 - d / term.rc
    inside = d < term.rc
    cut = torch.where(inside, t**term.factor_n, zero)
    dcut = torch.where(inside, _pow_grad(t, term.factor_n) * (-1.0 / term.rc),
                       zero)
    if term.factor == "repulsive":
        c = torch.clamp(d, min=1e-6)
        dc = (d >= 1e-6).to(d.dtype)
        dfac = (dcut / c**term.eta
                - cut * _pow_grad(c, term.eta) * dc / c ** (2 * term.eta))
        return dpsi, dfac
    return dpsi, dcut


# elements of the (C, n, K, K2) difference tensor per step of
# ``pair_slot_sums``: 1 GB in float64
PAIR_CHUNK_ELEMS = 1 << 27


def pair_slot_sums(x1, x2, f2, term: PairTerm):
    """Chunks (lo, hi, A, B) over the C pair sets of ``x2``/``f2`` (C, K2)
    against rows ``x1`` (n, K):

        A[j, i, k] = sum_k' exp(-(x1_ik - x2_jk')^2 / 2l^2) f2_jk'
        B[j, i, k] = sum_k' exp(...) f2_jk' (x1_ik - x2_jk')

    at most ``PAIR_CHUNK_ELEMS`` elements of the (C, n, K, K2) difference
    tensor at a time, so it never materializes whole."""
    ell2 = 2.0 * term.lengthscale**2
    n, k1 = x1.shape
    m, k2 = x2.shape
    step = max(1, PAIR_CHUNK_ELEMS // max(n * k1 * k2, 1))
    for lo in range(0, m, step):
        hi = min(lo + step, m)
        diff = x1[None, :, :, None] - x2[lo:hi, None, None, :]
        e = torch.exp(-(diff**2) / ell2) * f2[lo:hi, None, None, :]
        yield lo, hi, e.sum(-1), (e * diff).sum(-1)


def pair_slot_derivative(A, B, f1, dpsi, dfac, m1, term: PairTerm):
    """d/dd_ik of the per-slot contribution s^2 f1 A (C, n, K)."""
    ell2 = 2.0 * term.lengthscale**2
    return term.signal**2 * (dfac * m1 * A - (2.0 / ell2) * f1 * dpsi * B)


class _PairGram(torch.autograd.Function):
    """The (n, m) pair Gram block with a backward to the row distances
    that recomputes each chunk instead of keeping the (n, m, K, K2)
    intermediates: forces stay O(chunk) in memory."""

    @staticmethod
    def forward(ctx, d1, m1, d2, m2, term):
        dtype = torch.promote_types(d1.dtype, d2.dtype)
        d1c, d2c = d1.to(dtype), d2.to(dtype)
        x1 = _psi(d1c, term)
        f1 = _factor(d1c, term) * m1
        x2 = _psi(d2c, term)
        f2 = _factor(d2c, term) * m2
        cols = [term.signal**2 * (f1 * A).sum(-1)
                for _, _, A, _ in pair_slot_sums(x1, x2, f2, term)]
        ctx.term = term
        ctx.save_for_backward(d1, m1, d2, m2)
        if not cols:
            return torch.zeros((d1.shape[0], 0), dtype=dtype, device=d1.device)
        return torch.cat(cols).T

    @staticmethod
    def backward(ctx, g):
        d1, m1, d2, m2 = ctx.saved_tensors
        term = ctx.term
        dtype = g.dtype
        d1c, d2c = d1.to(dtype), d2.to(dtype)
        x1 = _psi(d1c, term)
        f1 = _factor(d1c, term) * m1
        x2 = _psi(d2c, term)
        f2 = _factor(d2c, term) * m2
        dpsi, dfac = psi_factor_grads(d1c, term)
        grad = torch.zeros_like(d1c)
        for lo, hi, A, B in pair_slot_sums(x1, x2, f2, term):
            dh = pair_slot_derivative(A, B, f1, dpsi, dfac, m1, term)
            grad = grad + torch.einsum("nc,cnk->nk", g[:, lo:hi], dh)
        return grad.to(d1.dtype), None, None, None, None


def pair_gram(d1, m1, d2, m2, term: PairTerm):
    """(n, m) Gram block between pair-distance sets, differentiable in
    ``d1``.

    d1 (n, K), m1 (n, K) bool; d2 (m, K2), m2 (m, K2) bool.
    """
    return _PairGram.apply(d1, m1, d2, m2, term)


def pair_diag(d, m, term: PairTerm):
    """k(P, P) for each LCE (needed for covloss normalization)."""
    x = _psi(d, term)
    f = _factor(d, term) * m
    ell2 = 2.0 * term.lengthscale**2
    diff = x[:, :, None] - x[:, None, :]
    k = torch.exp(-(diff**2) / ell2)
    w = f[:, :, None] * f[:, None, :]
    return term.signal**2 * (k * w).sum(dim=(1, 2))


# --------------------------------------------------------------------------
# host (numpy) functions
# --------------------------------------------------------------------------


def env_pair_counts(env, terms):
    """Per-term selected-pair counts (for buffer sizing)."""
    out = []
    for term in terms:
        sel = ((env.number == term.a) & (env.numbers == term.b)) | (
            (env.number == term.b) & (env.numbers == term.a)
        )
        out.append(int(sel.sum()))
    return out


def stage_env_pairs(env, terms, kx):
    """Host: padded (T, kx) distances + masks for an InducingEnv."""
    T = len(terms)
    d = np.zeros((T, kx))
    m = np.zeros((T, kx), dtype=bool)
    dist = np.linalg.norm(env.rvec, axis=1) if len(env.numbers) else np.zeros(0)
    for t, term in enumerate(terms):
        sel = ((env.number == term.a) & (env.numbers == term.b)) | (
            (env.number == term.b) & (env.numbers == term.a)
        )
        c = int(sel.sum())
        if c > kx:
            raise ValueError("pair buffer overflow; increase kx")
        d[t, :c] = dist[sel]
        m[t, :c] = True
    return d, m


def _np_psi(d, term):
    return np.log(np.maximum(d, 1e-12)) if term.kind == "logrbf" else d


def _np_factor(d, term):
    if term.factor is None:
        return np.ones_like(d)
    cut = np.where(d < term.rc, (1.0 - d / term.rc) ** term.factor_n, 0.0)
    if term.factor == "repulsive":
        return cut / np.maximum(d, 1e-6) ** term.eta
    return cut


def env_pair_list(env, term):
    """Selected pair distances of a detached env (host numpy)."""
    if len(env.numbers) == 0:
        return np.zeros(0)
    sel = ((env.number == term.a) & (env.numbers == term.b)) | (
        (env.number == term.b) & (env.numbers == term.a)
    )
    return np.linalg.norm(env.rvec[sel], axis=1)


def pair_kernel_env_vs_stage_np(env, d2, m2, terms):
    """(m,) pair-kernel column of one env against staged (T, m, kx)
    distance/mask arrays — the vectorized form of the per-env
    pair_kernel_envs_np loop (reference pair.py forward over LocalsData)."""
    out = np.zeros(d2.shape[1])
    for t, term in enumerate(terms):
        d1 = env_pair_list(env, term)
        if d1.size == 0:
            continue
        x1 = _np_psi(d1, term)[:, None, None]
        f1 = _np_factor(d1, term)[:, None, None]
        x2 = _np_psi(d2[t], term)[None]
        f2 = (_np_factor(d2[t], term) * m2[t])[None]
        k = np.exp(-((x1 - x2) ** 2) / (2 * term.lengthscale**2))
        out += term.signal**2 * (k * f1 * f2).sum(axis=(0, 2))
    return out


def pair_cols_config_np(positions, cell, numbers, nl, rc, env, terms,
                        chunk=2048):
    """(N,) pair-kernel column of every LCE of a configuration against one
    detached env — vectorized over atoms (replaces the O(N) python
    extract_env loop in the sampling path)."""
    n = len(numbers)
    out = np.zeros(n)
    have = [env_pair_list(env, term) for term in terms]
    if all(d.size == 0 for d in have):
        return out
    idx = nl.idx
    off = nl.off
    msk = nl.mask
    for lo in range(0, n, chunk):
        sl = slice(lo, min(lo + chunk, n))
        r = (
            positions[idx[sl]]
            - positions[sl][:, None, :]
            + off[sl] @ cell
        )
        d = np.linalg.norm(r, axis=-1)
        within = msk[sl] & (d <= rc)
        zi = numbers[sl][:, None]
        zj = numbers[idx[sl]]
        for t, term in enumerate(terms):
            d1 = have[t]
            if d1.size == 0:
                continue
            sel = ((zi == term.a) & (zj == term.b)) | (
                (zi == term.b) & (zj == term.a)
            )
            f = _np_factor(d, term) * (sel & within)
            x = _np_psi(d, term)
            x2 = _np_psi(d1, term)[None, None, :]
            f2 = _np_factor(d1, term)[None, None, :]
            k = np.exp(
                -((x[:, :, None] - x2) ** 2) / (2 * term.lengthscale**2)
            )
            out[sl] += term.signal**2 * (
                k * f[:, :, None] * f2
            ).sum(axis=(1, 2))
    return out


def pair_kernel_envs_np(env1, env2, terms):
    """Host kernel between two envs, summed over pair terms."""
    total = 0.0
    for term in terms:
        d1 = _np_psi(env_pair_list(env1, term), term)
        d2 = _np_psi(env_pair_list(env2, term), term)
        if d1.size == 0 or d2.size == 0:
            continue
        f1 = _np_factor(env_pair_list(env1, term), term)
        f2 = _np_factor(env_pair_list(env2, term), term)
        k = np.exp(-((d1[:, None] - d2[None, :]) ** 2) / (2 * term.lengthscale**2))
        total += term.signal**2 * (k * (f1[:, None] * f2[None, :])).sum()
    return float(total)
