"""Steinhardt bond-order parameters Q_l (port of
``autoforce_tpu/descriptor/ql.py``, the counterpart of
theforce/descriptor/ql.py), used as metadynamics collective variables.

    q_lm = sum_j w(r_j) Y_lm(r_j) / sum_j w(r_j)
    Q_l  = sqrt( 4 pi / (2l+1) * sum_m |q_lm|^2 )

with the PolyCut weight w.  Differentiable (torch autograd).
"""

import math

import torch

from .harmonics import m_weights, solid_harmonics


def steinhardt_ql(rvec, lmax, cutoff, cut_n=2):
    """Q_l for l=0..lmax from neighbor displacement vectors (k, 3)."""
    d = torch.sqrt((rvec * rvec).sum(-1))
    w = torch.where(d < cutoff, (1.0 - d / cutoff) ** cut_n,
                    torch.zeros_like(d))
    safe = torch.where(d > 0, d, torch.ones_like(d))
    r = torch.where(d[:, None] > 0, rvec / safe[:, None],
                    torch.zeros_like(rvec))
    Yr, Yi = solid_harmonics(r, lmax)  # unit vectors -> plain Ylm
    qr = (w[:, None, None] * Yr).sum(0) / w.sum()
    qi = (w[:, None, None] * Yi).sum(0) / w.sum()
    mw = m_weights(lmax, dtype=rvec.dtype, device=rvec.device)
    q2 = ((qr * qr + qi * qi) * mw).sum(-1)
    coeff = 4.0 * math.pi / (2.0 * torch.arange(
        lmax + 1, dtype=rvec.dtype, device=rvec.device) + 1.0)
    return torch.sqrt(coeff * q2)
