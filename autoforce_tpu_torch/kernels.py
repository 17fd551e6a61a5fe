"""Kernel (covariance) Gram blocks between local chemical environments
(torch port of ``autoforce_tpu/kernels.py``, dot kernel only).

    k(p, q) = delta(z_p, z_q) * (p . q)^zeta          (universal.py:109-122)

plus the lone-atom correction: two neighborless LCEs of the same species
have k = 1 (similarity.py:94-103).

The JAX package wraps physics-carrying reductions in ``precise_sum``, an
optimization barrier against an XLA rewrite that folds a reduce of a
matmul into one bfloat16 contraction.  PyTorch runs the matmul and the sum
as two separate operations in the working type (TF32 is off, see
``__init__``), so a plain ``.sum()`` is already that exact reduction.
"""

import torch


def base_kernel(dot, exponent, kind="dot"):
    """(p.q)^zeta on normalized-descriptor dot products."""
    if kind != "dot":
        raise NotImplementedError(f"kernel kind {kind!r} is not ported yet")
    return dot**exponent


def gram(p1, z1, lone1, p2, z2, lone2, exponent, kind="dot"):
    """Kernel block (n, m) between two sets of LCEs.

    p1: (n, D) descriptors; z1: (n,) central atomic numbers; lone1: (n,)
    bool, True for environments with zero neighbors; p2/z2/lone2 likewise.
    """
    # the higher of the two types: float32 descriptors meet the float64
    # inducing set in float64 (see Engine.model_arrays)
    dtype = torch.promote_types(p1.dtype, p2.dtype)
    dot = p1.to(dtype) @ p2.to(dtype).T
    same = (z1[:, None] == z2[None, :]).to(dtype)
    k = base_kernel(dot, exponent, kind) * same
    k = k + (lone1[:, None] & lone2[None, :]).to(dtype) * same
    return k


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
