"""The SeSoap descriptor from its definition, batched over environments.

For an environment with neighbors at r_k of species s_k:

    c[s, n, l, m] = sum_{k: s_k = s} f_n(d_k) r_k^l Y_lm(r_k)
    f_n(d) = (1 - d/rc)^2 exp(-d^2/2) d^(2n)        (d < rc, radii 1)
    p[a, b, n, n', l] = nnl[n, n', l] sum_{m=-l..l} c[a,n,l,m] conj(c[b,n',l,m])
    nnl[n, n', l] = sqrt(A[n, l] A[n', l]),
    A[n, l] = 1 / ((2l+1) 2^(2n+l) n! (n+l)!)

flattened in the order (a, b, n, n', l) and divided by its norm.  The
solid harmonics are orthonormal: r^l Y_lm = N_lm Q_lm(z, r^2) (x + iy)^m
with Q the homogeneous polynomial of the associated Legendre recurrence,
so the sum over m runs over m >= 0 with weight 2 for m > 0 (the m < 0
terms are the conjugates).
"""

from __future__ import annotations

import math

import torch


def dim(nspecies, lmax, nmax):
    return nspecies * nspecies * (nmax + 1) ** 2 * (lmax + 1)


def nnl_table(lmax, nmax, dtype, device):
    a = torch.tensor(
        [[1.0 / ((2 * l + 1) * 2 ** (2 * n + l) * math.factorial(n)
                 * math.factorial(n + l)) for l in range(lmax + 1)]
         for n in range(nmax + 1)], dtype=torch.float64)
    return torch.sqrt(a[:, None, :] * a[None, :, :]).to(dtype=dtype,
                                                        device=device)


def solid_harmonics(x, y, z, lmax):
    """[(l, m, Re, Im)] of r^l Y_lm for 0 <= m <= l <= lmax."""
    r2 = x * x + y * y + z * z
    one = torch.ones_like(x)
    cm, sm = [one], [torch.zeros_like(x)]  # (x + iy)^m
    for _ in range(lmax):
        cm.append(cm[-1] * x - sm[-1] * y)
        sm.append(cm[-2] * y + sm[-1] * x)
    out = []
    for m in range(lmax + 1):
        dfact = math.prod(range(1, 2 * m, 2))  # (2m - 1)!!
        q = {m: dfact * one}
        if m + 1 <= lmax:
            q[m + 1] = (2 * m + 1) * z * q[m]
        for l in range(m + 2, lmax + 1):
            q[l] = ((2 * l - 1) * z * q[l - 1] - (l + m - 1) * r2 * q[l - 2]) / (l - m)
        for l in range(m, lmax + 1):
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - m) / math.factorial(l + m))
            out.append((l, m, norm * q[l] * cm[m], norm * q[l] * sm[m]))
    return out


def descriptors(rvec, sidx, mask, nspecies, lmax, nmax, rc, dtype=None):
    """Normalized power spectra (B, D) of B environments.

    rvec: (B, K, 3) neighbor displacements; sidx: (B, K) species index of
    each neighbor; mask: (B, K) bool.  Computed in ``dtype`` (default
    ``rvec``'s)."""
    dtype = dtype or rvec.dtype
    rvec = rvec.to(dtype)
    B, K, _ = rvec.shape
    dummy = torch.tensor([2.0 * rc, 0.0, 0.0], dtype=dtype, device=rvec.device)
    r = torch.where(mask[..., None], rvec, dummy)
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    d2 = x * x + y * y + z * z
    d = torch.sqrt(d2)
    t = torch.clamp(1.0 - d / rc, min=0.0)
    g = t * t * torch.exp(-0.5 * d2) * mask.to(dtype)
    radial = torch.stack([g * d2**n for n in range(nmax + 1)], dim=-1)  # (B, K, nf)
    onehot = (sidx[..., None] == torch.arange(nspecies, device=rvec.device)).to(dtype)
    w = (onehot[..., :, None] * radial[..., None, :]).reshape(B, K, -1)  # (B, K, S nf)
    harm = solid_harmonics(x, y, z, lmax)
    Y = torch.stack([h[2] for h in harm] + [h[3] for h in harm], dim=-1)  # (B, K, 2Q)
    c = torch.einsum("bkp,bkq->bpq", w, Y)  # (B, S nf, 2Q)
    Q = len(harm)
    cre, cim = c[..., :Q], c[..., Q:]
    nf = nmax + 1
    nnl = nnl_table(lmax, nmax, dtype, rvec.device)
    blocks = []
    for l in range(lmax + 1):
        cols = [q for q, h in enumerate(harm) if h[0] == l]
        wt = torch.tensor([1.0 if harm[q][1] == 0 else 2.0 for q in cols],
                          dtype=dtype, device=rvec.device)
        cl = torch.cat([cre[..., cols] * wt.sqrt(), cim[..., cols] * wt.sqrt()], -1)
        pl = cl @ cl.transpose(1, 2)  # (B, (a n), (b n'))
        pl = pl.reshape(B, nspecies, nf, nspecies, nf).permute(0, 1, 3, 2, 4)
        blocks.append(pl * nnl[:, :, l])
    p = torch.stack(blocks, dim=-1).reshape(B, -1)  # (a, b, n, n', l)
    return p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)
