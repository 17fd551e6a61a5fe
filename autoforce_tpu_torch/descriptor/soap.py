"""SeSoap many-body descriptor, batched over all atoms (torch port of
``autoforce_tpu/descriptor/soap.py``).

    p[i; a, b, n, n', l] = nnl[n,n',l] * sum_m w_m *
        ( cR[i,a,n,l,m] cR[i,b,n',l,m] + cI[i,a,n,l,m] cI[i,b,n',l,m] )

    c[i, s, n, l, m] = sum_{j in nbrs(i), species(j)=s} f_n(d_ij) * Ylm(r_ij)

    f_n(d) = cut(|r|) * exp(-d^2/2) * d^(2n),   d = |r| / radius(species_j)

This module holds the plain batched-GEMM form of the coefficients.  The
main path computes them in the CUDA kernels of
:mod:`autoforce_tpu_torch.descriptor.soap_kernels`; the GEMM form is the
independent torch transcription of the JAX reference that the tests hold
the kernels' plain versions against.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .harmonics import m_weights, solid_harmonics


@dataclass(frozen=True)
class SoapParams:
    """Static (hashable) descriptor configuration."""

    lmax: int = 3
    nmax: int = 3
    rc: float = 6.0
    cut_n: int = 2  # PolyCut exponent
    normalize: bool = True

    @property
    def nnl_dim(self):
        return (self.nmax + 1) ** 2 * (self.lmax + 1)

    def dim(self, nspecies):
        return nspecies * nspecies * self.nnl_dim


@lru_cache(maxsize=None)
def _nnl_table(nmax, lmax):
    """nnl[n,n',l] = sqrt(a_n,l * a_n',l), a_n,l = 1/((2l+1) 2^(2n+l) n! (n+l)!)

    (reference sesoap.py:119-128)
    """
    a = np.array(
        [
            [
                1.0
                / ((2 * l + 1) * 2 ** (2 * n + l) * math.factorial(n) * math.factorial(n + l))
                for l in range(lmax + 1)
            ]
            for n in range(nmax + 1)
        ]
    )
    return np.sqrt(a[None, :, :] * a[:, None, :])  # (nmax+1, nmax+1, lmax+1)


def sesoap_coefficients(rvec, nbr_sidx, nbr_mask, radii, params: SoapParams):
    """Per-species radial-harmonic expansion coefficients (GEMM form).

    Args:
        rvec: (..., K, 3) neighbor displacement vectors (physical units).
        nbr_sidx: (..., K) int index of neighbor species in the model table.
        nbr_mask: (..., K) bool.
        radii: (S,) per-species length scales.
    Returns:
        (cR, cI): (..., S, nmax+1, L, L) with L = lmax+1.
    """
    S = radii.shape[0]
    dtype = rvec.dtype
    mask = nbr_mask.bool()
    # masked entries -> far outside the cutoff (numerically inert)
    dummy = torch.tensor([2.0 * params.rc, 0.0, 0.0], dtype=dtype,
                         device=rvec.device)
    safe = torch.where(mask[..., None], rvec, dummy)
    sidx = nbr_sidx.long().clamp(0, S - 1)
    unit = radii.to(dtype)[sidx]  # (..., K)
    xyz = safe / unit[..., None]
    d2 = (xyz * xyz).sum(-1)
    d = torch.sqrt(d2)
    dphys = d * unit
    t = 1.0 - dphys / params.rc
    cut = torch.where(dphys < params.rc, t**params.cut_n, torch.zeros_like(t))
    g = cut * torch.exp(-0.5 * d2) * mask.to(dtype)  # (..., K)
    n_expo = 2.0 * torch.arange(params.nmax + 1, dtype=dtype, device=rvec.device)
    f = g[..., None] * d[..., None] ** n_expo  # (..., K, nmax+1)
    Yr, Yi = solid_harmonics(xyz, params.lmax)  # (..., K, L, L)
    onehot = (sidx[..., None] == torch.arange(S, device=rvec.device)) & mask[..., None]
    onehot = onehot.to(dtype)  # (..., K, S)
    # one (P, K) @ (K, 2 L^2) matmul per atom
    L = params.lmax + 1
    nmax1 = params.nmax + 1
    batch = f.shape[:-2]
    K = f.shape[-2]
    WF = (onehot[..., :, None] * f[..., None, :]).reshape(*batch, K, S * nmax1)
    Y2 = torch.cat(
        [Yr.reshape(*batch, K, L * L), Yi.reshape(*batch, K, L * L)], dim=-1
    )
    C = torch.einsum("...kp,...kq->...pq", WF, Y2)  # (..., P, 2 L^2)
    cR = C[..., : L * L].reshape(*batch, S, nmax1, L, L)
    cI = C[..., L * L :].reshape(*batch, S, nmax1, L, L)
    return cR, cI


_CONSTANTS = {}


def _spectrum_constants(params: SoapParams, dtype, device):
    """(m weights, nnl table) as tensors on ``device``, made once: a fresh
    host-to-device copy on every call would wait for the device."""
    key = (params.lmax, params.nmax, dtype, str(device))
    if key not in _CONSTANTS:
        w = m_weights(params.lmax, dtype=dtype, device=device)
        nnl = torch.as_tensor(_nnl_table(params.nmax, params.lmax), dtype=dtype,
                              device=device)
        _CONSTANTS[key] = (w, nnl)
    return _CONSTANTS[key]


def power_spectrum(cR, cI, params: SoapParams):
    """Flattened (optionally normalized) power spectrum from coefficients
    of shape (..., S, nmax+1, L, L):

        p[..., a, b, u, v, l] = nnl[u, v, l] * sum_m w[l, m]
            (cR[..., a, u, l, m] cR[..., b, v, l, m] + cI[...] cI[...])

    computed as one batched product over l of (S nmax+1, 2L) blocks."""
    dtype = cR.dtype
    w, nnl = _spectrum_constants(params, dtype, cR.device)
    *batch, S, nf, L, _ = cR.shape
    c = torch.cat([cR, cI], dim=-1)  # (..., S, nf, L, 2L)
    cw = torch.cat([cR * w, cI * w], dim=-1)
    c = c.reshape(*batch, S * nf, L, 2 * L).transpose(-3, -2)  # (..., L, S nf, 2L)
    cw = cw.reshape(*batch, S * nf, L, 2 * L).transpose(-3, -2)
    p = cw @ c.transpose(-1, -2)  # (..., L, (a u), (b v))
    p = p.reshape(*batch, L, S, nf, S, nf)
    p = p.permute(*range(len(batch)), -4, -2, -3, -1, -5)  # (..., a, b, u, v, l)
    p = p * nnl  # broadcasts over (u, v, l)
    p = p.reshape(*batch, -1)
    if params.normalize:
        # sqrt(sum + eps^2): smooth at p = 0 (padded atoms)
        eps = torch.finfo(dtype).eps
        norm = torch.sqrt((p * p).sum(dim=-1, keepdim=True) + eps * eps)
        p = p / norm
    return p


def sesoap_descriptors(rvec, nbr_sidx, nbr_mask, radii, params: SoapParams):
    """Full SOAP power-spectrum descriptors from the GEMM-form coefficients.

    Returns p: (..., D) with D = S^2 (nmax+1)^2 (lmax+1).
    """
    cR, cI = sesoap_coefficients(rvec, nbr_sidx, nbr_mask, radii, params)
    return power_spectrum(cR, cI, params)
