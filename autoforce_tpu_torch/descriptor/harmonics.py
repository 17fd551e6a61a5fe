"""Real solid spherical harmonics r^l * Ylm (torch port of
``autoforce_tpu/descriptor/harmonics.py``).

The azimuthal factor ``rxy^m * {cos,sin}(m*phi)`` comes from the recursion
on ``C_m = Re[(x+iy)^m]``, ``S_m = Im[(x+iy)^m]`` and the Legendre part is
recursed with the ``rxy^m`` prefactor divided out, so every intermediate is
a polynomial in (x, y, z) and autograd is exact everywhere except r = 0.

Layout: dense tensors ``Yr, Yi`` of shape (..., lmax+1, lmax+1) indexed
[l, m], zero for m > l.  ``Yr[l, m] + 1j*Yi[l, m] == r^l * Y_l^m``.
"""

import math

import numpy as np
import torch

_Y00 = math.sqrt(1.0 / (4.0 * math.pi))


def _coeff_tables(lmax):
    """Recursion constants (reference ylm.py:56-80)."""
    a = {}
    b = {}
    for l in range(2, lmax + 1):
        for m in range(l - 1):
            a[(l, m)] = math.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b[(l, m)] = -math.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
    c = {l: math.sqrt(2.0 * l + 1.0) for l in range(lmax + 1)}
    d = {l: -math.sqrt(1.0 + 1.0 / (2.0 * l)) for l in range(1, lmax + 1)}
    return a, b, c, d


def scaled_legendre(x, y, z, lmax):
    """P~[l][m] = alp[l][m] / rxy^m (lists of tensors) and C_m, S_m."""
    A, B, C, D = _coeff_tables(lmax)
    r2 = x * x + y * y + z * z
    L = lmax + 1
    one = torch.ones_like(x)
    P = [[_Y00 * one]]
    for l in range(1, L):
        row = []
        for m in range(l - 1):
            row.append(A[(l, m)] * (z * P[l - 1][m] + r2 * B[(l, m)] * P[l - 2][m]))
        row.append(C[l] * z * P[l - 1][l - 1])  # m = l-1
        row.append(D[l] * P[l - 1][l - 1])  # m = l  (rxy factor moved to C/S)
        P.append(row)
    Cm = [one]
    Sm = [torch.zeros_like(x)]
    for m in range(1, L):
        Cm.append(x * Cm[-1] - y * Sm[-1])
        Sm.append(y * Cm[-2] + x * Sm[-1])
    return P, Cm, Sm


def solid_harmonics(xyz, lmax):
    """r^l * Ylm for a tensor of vectors.

    Args:
        xyz: (..., 3) Cartesian vectors.
        lmax: int.
    Returns:
        (Yr, Yi): each (..., lmax+1, lmax+1), [l, m] layout, zeros for m > l.
    """
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    P, Cm, Sm = scaled_legendre(x, y, z, lmax)
    zero = torch.zeros_like(x)
    Yr_rows = []
    Yi_rows = []
    for l in range(lmax + 1):
        yr = [P[l][m] * Cm[m] for m in range(l + 1)] + [zero] * (lmax - l)
        yi = [P[l][m] * Sm[m] for m in range(l + 1)] + [zero] * (lmax - l)
        Yr_rows.append(torch.stack(yr, dim=-1))
        Yi_rows.append(torch.stack(yi, dim=-1))
    return torch.stack(Yr_rows, dim=-2), torch.stack(Yi_rows, dim=-2)


def m_weights(lmax, dtype=torch.float32, device=None):
    """Power-spectrum m-sum weights: w[l,m] = 1 (m=0), 2 (0<m<=l), 0 (m>l).

    Encodes the reference's packed-matrix contraction masks
    (sesoap.py:116-118, 203): 2*tril-eye for real, 2*triu(1) for imag.
    """
    L = lmax + 1
    w = np.zeros((L, L))
    for l in range(L):
        w[l, 0] = 1.0
        for m in range(1, l + 1):
            w[l, m] = 2.0
    return torch.as_tensor(w, dtype=dtype, device=device)
