"""Kernel (covariance) Gram blocks between local chemical environments
(torch port of ``autoforce_tpu/kernels.py``).

The default kernel between two LCEs with descriptors p, q and central
atomic numbers z_p, z_q is

    k(p, q) = delta(z_p, z_q) * (p . q)^zeta          (universal.py:109-122)

plus the lone-atom correction: two neighborless LCEs of the same species
have k = 1 (similarity.py:94-103).  The base kernel may also be ``"rbf"``,
``"normed"`` or any :class:`~.kernelalgebra.KernelExpr`, and the central
factor the alchemical chi(z_p, z_q) table (``chem``).

The JAX package wraps physics-carrying reductions in ``precise_sum``, an
optimization barrier against an XLA rewrite that folds a reduce of a
matmul into one bfloat16 contraction.  PyTorch runs the matmul and the sum
as two separate operations in the working type (TF32 is off, see
``__init__``), so a plain ``.sum()`` is already that exact reduction.
"""

import torch

from .kernelalgebra import KernelExpr


def base_kernel(dot, exponent, kind="dot", lengthscale=1.0):
    """Base-kernel algebra on normalized-descriptor dot products: 'dot' ->
    (p.q)^zeta, 'rbf' -> exp((p.q - 1)/l^2), 'normed' -> p.q, or a
    KernelExpr."""
    if isinstance(kind, KernelExpr):
        return kind.value(dot)
    if kind == "dot":
        return dot**exponent
    if kind == "rbf":
        return torch.exp((dot - 1.0) / lengthscale**2)
    if kind == "normed":
        return dot
    raise ValueError(f"unknown kernel kind {kind}")


def base_kernel_grad(dot, exponent, kind="dot", lengthscale=1.0):
    """d base_kernel / d dot, elementwise (the column cotangent)."""
    if isinstance(kind, KernelExpr):
        with torch.enable_grad():
            t = dot.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(kind.value(t).sum(), t)
        return g
    if kind == "dot":
        return exponent * dot ** (exponent - 1)
    if kind == "rbf":
        return torch.exp((dot - 1.0) / lengthscale**2) / lengthscale**2
    if kind == "normed":
        return torch.ones_like(dot)
    raise ValueError(f"unknown kernel kind {kind}")


def central_factor(z1, z2, chem_z, dtype):
    """delta(z1, z2) or the alchemical chi(z1, z2) central-species factor,
    (n, m)."""
    if chem_z is None:
        return (z1[:, None] == z2[None, :]).to(dtype)
    return chem_z[z1.long()[:, None], z2.long()[None, :]].to(dtype)


def gram(p1, z1, lone1, p2, z2, lone2, exponent, chem=None, kind="dot",
         lengthscale=1.0):
    """Kernel block (n, m) between two sets of LCEs.

    p1: (n, D) descriptors; z1: (n,) central atomic numbers; lone1: (n,)
    bool, True for environments with zero neighbors; p2/z2/lone2 likewise.
    chem: optional (Zmax, Zmax) alchemical central-species factor; None ->
    Dirac delta.
    """
    # the higher of the two types: float32 descriptors meet the float64
    # inducing set in float64 (see Engine.model_arrays)
    dtype = torch.promote_types(p1.dtype, p2.dtype)
    dot = p1.to(dtype) @ p2.to(dtype).T
    same = central_factor(z1, z2, chem, dtype)
    k = base_kernel(dot, exponent, kind, lengthscale) * same
    # the lone-atom correction stays a strict same-species rule
    lone = (lone1[:, None] & lone2[None, :]).to(dtype)
    if chem is None:
        return k + lone * same
    eq = (z1[:, None] == z2[None, :]).to(dtype)
    return k + lone * eq * same


def covloss_beta(choli, cov, vscale_atom, m_mask, alpha=None):
    """Per-atom uncertainty beta (reference active.py:781-804).

    beta_i = sqrt(max(0, 1 - ||choli @ k_i||^2 / k(x_i,x_i))) * sqrt(vscale(z_i))
    """
    mm = m_mask.to(cov.dtype)
    b = (choli * mm[None, :]) @ (cov * mm[None, :]).T  # (M, n)
    c = (b * b).sum(dim=0)
    if alpha is not None:
        c = c / alpha
    beta = torch.sqrt(torch.clamp(1.0 - c, min=0.0))
    return beta * torch.sqrt(vscale_atom)


def covloss_bias(choli, cov, meta_vs, atom_mask):
    """sum_i beta_i sqrt(meta_vs_i) over the atoms of ``atom_mask``, the
    ActiveMeta bias of the plain dot kernel (reference active.py:1170-1186;
    ``engine.meta_covloss_fn``): beta_i = sqrt(1 - ||choli @ k_i||^2)
    with 1 - c clipped at 1e-12, where sqrt' stays finite.  c sits next to
    1, so it is summed in the type of ``cov`` (the model's float64)."""
    b = choli @ cov.T  # (M, n)
    c = (b * b).sum(dim=0)
    beta = torch.sqrt(torch.clamp(1.0 - c, min=1e-12))
    return (beta * torch.sqrt(meta_vs) * atom_mask).sum()
