"""SOAP expansion coefficients through hand-written CUDA kernels.

The counterpart of ``autoforce_tpu/descriptor/pallas_soap.py``: the
forward kernel produces only the (N, CH) coefficient matrices

    cR[i, (s, n, l, m)] = sum_k 1[sidx=s] f_n(d_k) * Re[r^l Ylm](x_k)
    cI likewise,

and the backward kernel maps their cotangents to ``rvec_bar`` (N, K, 3)
through the closed-form derivatives of the polynomial recursion.  Both are
in ``csrc/soap_coeff.cu``, compiled at first use with ``nvcc`` into a
shared library with a plain C interface and loaded with ctypes.

Beside each kernel sits its plain torch version (``soap_coeff_fwd_plain``,
``soap_coeff_bwd_plain``): the direct transcription of the TPU kernel's
math.  The wrappers (``soap_coeff_fwd``, ``soap_coeff_bwd``) dispatch on
the tensor's device: a CPU tensor goes to the plain version, a CUDA tensor
to the kernel — there is no fallback from one to the other.  Each wrapper
counts its kernel launches in ``.launches``.

``sesoap_descriptors_k`` is the power spectrum, nnl and normalisation as
plain torch on top of :class:`SoapCoefficients` (the autograd Function
over the two wrappers).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading

import torch

from .. import BUILD_DIR
from .harmonics import _coeff_tables, scaled_legendre
from .soap import SoapParams, power_spectrum

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "soap_coeff.cu")
LIB_PATH = os.path.join(BUILD_DIR, "libsoapcoeff.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the last build (register/spill lines)


def channels(nspecies, params: SoapParams):
    return nspecies * (params.nmax + 1) * (params.lmax + 1) ** 2


# --------------------------------------------------------------------------
# plain torch versions (direct transcription of the Pallas kernels' math)
# --------------------------------------------------------------------------


def _slot_coords(rvec, sidx, mask, radii, rc):
    """Masked slots -> inert dummy at (2 rc, 0, 0), then per-species radius
    scaling; species outside [0, S) keep unit radius."""
    S = radii.shape[0]
    keep = mask.bool()
    xs0 = torch.where(keep, rvec[..., 0], torch.full_like(rvec[..., 0], 2.0 * rc))
    ys0 = torch.where(keep, rvec[..., 1], torch.zeros_like(rvec[..., 1]))
    zs0 = torch.where(keep, rvec[..., 2], torch.zeros_like(rvec[..., 2]))
    sidx = sidx.long()
    known = (sidx >= 0) & (sidx < S)
    unit = torch.where(known, radii.to(rvec.dtype)[sidx.clamp(0, S - 1)],
                       torch.ones_like(xs0))
    fmask = keep.to(rvec.dtype)
    return xs0 / unit, ys0 / unit, zs0 / unit, unit, fmask, sidx


def _radial_parts(xs, ys, zs, unit, fmask, rc, cut_n):
    d2 = xs * xs + ys * ys + zs * zs
    d = torch.sqrt(d2)
    dphys = d * unit
    t = 1.0 - dphys / rc
    inside = (dphys < rc).to(xs.dtype)
    cut = inside * t**cut_n
    dcut = inside * (-cut_n / rc) * t ** (cut_n - 1)  # d cut / d dphys
    expf = torch.exp(-0.5 * d2)
    g = cut * expf * fmask
    return d, d2, cut, dcut, expf, g


def _legendre_partials(xs, ys, zs, d2, P, lmax):
    """Closed-form partials dP[l][m] = (d/dx, d/dy, d/dz) P~[l][m]."""
    A, B, C, D = _coeff_tables(lmax)
    zero = torch.zeros_like(xs)
    dP = [[(zero, zero, zero)]]
    for l in range(1, lmax + 1):
        drow = []
        for m in range(l - 1):
            p1x, p1y, p1z = dP[l - 1][m]
            p2x, p2y, p2z = dP[l - 2][m]
            a, b = A[(l, m)], B[(l, m)]
            drow.append((
                a * (zs * p1x + b * (2 * xs * P[l - 2][m] + d2 * p2x)),
                a * (zs * p1y + b * (2 * ys * P[l - 2][m] + d2 * p2y)),
                a * (P[l - 1][m] + zs * p1z + b * (2 * zs * P[l - 2][m] + d2 * p2z)),
            ))
        px, py, pz = dP[l - 1][l - 1]
        drow.append((C[l] * zs * px, C[l] * zs * py,
                     C[l] * (P[l - 1][l - 1] + zs * pz)))
        drow.append((D[l] * px, D[l] * py, D[l] * pz))
        dP.append(drow)
    return dP


def soap_coeff_fwd_plain(rvec, sidx, mask, radii, params: SoapParams):
    """(cR, cI), each (N, CH): the math of ``pallas_soap._fwd_kernel``."""
    S = radii.shape[0]
    xs, ys, zs, unit, fmask, sidx = _slot_coords(rvec, sidx, mask, radii,
                                                 params.rc)
    d, d2, cut, dcut, expf, g = _radial_parts(xs, ys, zs, unit, fmask,
                                              params.rc, params.cut_n)
    P, Cm, Sm = scaled_legendre(xs, ys, zs, params.lmax)
    L = params.lmax + 1
    zero = torch.zeros_like(rvec[:, 0, 0])
    crs, cis = [], []
    for s in range(S):
        sm = (sidx == s).to(xs.dtype) * fmask
        for n in range(params.nmax + 1):
            base = g * d ** (2 * n) * sm
            for l in range(L):
                for m in range(L):
                    if m <= l:
                        crs.append((base * P[l][m] * Cm[m]).sum(dim=1))
                        cis.append((base * P[l][m] * Sm[m]).sum(dim=1))
                    else:
                        crs.append(zero)
                        cis.append(zero)
    return torch.stack(crs, dim=1), torch.stack(cis, dim=1)


def soap_coeff_bwd_plain(rvec, sidx, mask, radii, crb, cib, params: SoapParams):
    """rvec_bar (N, K, 3) from coefficient cotangents: the closed-form
    derivative of ``pallas_soap._bwd_kernel`` (not autograd)."""
    S = radii.shape[0]
    xs, ys, zs, unit, fmask, sidx = _slot_coords(rvec, sidx, mask, radii,
                                                 params.rc)
    d, d2, cut, dcut, expf, g = _radial_parts(xs, ys, zs, unit, fmask,
                                              params.rc, params.cut_n)
    P, Cm, Sm = scaled_legendre(xs, ys, zs, params.lmax)
    dP = _legendre_partials(xs, ys, zs, d2, P, params.lmax)
    L = params.lmax + 1
    gx = torch.zeros_like(xs)
    gy = torch.zeros_like(xs)
    gz = torch.zeros_like(xs)
    inv_d = 1.0 / torch.clamp(d, min=1e-30)
    # d g / d x_a = x_a * dg_common
    dg_common = (dcut * unit * inv_d) * expf - cut * expf
    zero = torch.zeros_like(xs)
    ch = 0
    for s in range(S):
        sm = (sidx == s).to(xs.dtype) * fmask
        for n in range(params.nmax + 1):
            dn = d ** (2 * n)
            dfn = dg_common * dn
            if n > 0:
                dfn = dfn + g * (2.0 * n) * d ** (2 * n - 2)
            fn = g * dn * sm
            dfn = dfn * sm
            for l in range(L):
                for m in range(L):
                    if m > l:
                        ch += 1
                        continue
                    cb = crb[:, ch][:, None]
                    ib = cib[:, ch][:, None]
                    ch += 1
                    Yr = P[l][m] * Cm[m]
                    Yi = P[l][m] * Sm[m]
                    w = cb * (dfn * Yr) + ib * (dfn * Yi)
                    gx = gx + w * xs
                    gy = gy + w * ys
                    gz = gz + w * zs
                    px, py, pz = dP[l][m]
                    if m > 0:
                        dCx, dCy = m * Cm[m - 1], -m * Sm[m - 1]
                        dSx, dSy = m * Sm[m - 1], m * Cm[m - 1]
                    else:
                        dCx = dCy = dSx = dSy = zero
                    p = P[l][m]
                    gx = gx + fn * (cb * (px * Cm[m] + p * dCx) + ib * (px * Sm[m] + p * dSx))
                    gy = gy + fn * (cb * (py * Cm[m] + p * dCy) + ib * (py * Sm[m] + p * dSy))
                    gz = gz + fn * (cb * (pz * Cm[m]) + ib * (pz * Sm[m]))
    # scaled coords -> physical rvec: d/d rvec = (1/unit) d/dx; kill padding
    scale = fmask / unit
    return torch.stack([gx * scale, gy * scale, gz * scale], dim=-1)


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def compile_library(src, lib_path, force=False):
    """Compile the CUDA source ``src`` for sm_90a into ``lib_path`` with
    ``NVCC_FLAGS`` (skipped while the library is newer than its source);
    returns nvcc's output (its ``-Xptxas -v`` report), "" when skipped."""
    fresh = (os.path.isfile(lib_path)
             and os.path.getmtime(lib_path) >= os.path.getmtime(src))
    if fresh and not force:
        return ""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{out}")
    os.replace(tmp, lib_path)
    return out


def build_library(force=False):
    """Compile ``csrc/soap_coeff.cu`` into the build directory
    (:func:`compile_library`); returns its path.  nvcc's report of a
    build lands in ``build_log``."""
    global build_log
    out = compile_library(_SRC, LIB_PATH, force)
    if out:
        build_log = out
    return LIB_PATH


def bind_entry_points(lib):
    """Argument types of the two launch entry points of a built library."""
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    lib.soap_coeff_fwd.restype = i32
    lib.soap_coeff_fwd.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr,  # is_f64, in x4, out x2
        i32, i32, i32, i32, i32, ctypes.c_double, i32, ptr,
    ]
    lib.soap_coeff_bwd.restype = i32
    lib.soap_coeff_bwd.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # is_f64, in x6, out
        i32, i32, i32, i32, i32, ctypes.c_double, i32, ptr,
    ]
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = bind_entry_points(ctypes.CDLL(build_library()))
            i32 = ctypes.c_int
            lib.soap_max_lmax.restype = i32
            lib.soap_max_lmax.argtypes = []
            lib.soap_smem_limit.restype = ctypes.c_longlong
            lib.soap_smem_limit.argtypes = []
            # (element size, S, lmax, nmax, K)
            lib.soap_fwd_smem_bytes.restype = ctypes.c_longlong
            lib.soap_fwd_smem_bytes.argtypes = [i32] * 5
            lib.soap_bwd_smem_bytes.restype = ctypes.c_longlong
            lib.soap_bwd_smem_bytes.argtypes = [i32] * 5
            lib.max_lmax = lib.soap_max_lmax()
            _lib = lib
    return _lib


def _check_inputs(rvec, sidx, mask, radii, params):
    if rvec.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rvec must be float32 or float64, got {rvec.dtype}")
    if rvec.dim() != 3 or rvec.shape[2] != 3:
        raise ValueError(f"rvec must be (N, K, 3), got {tuple(rvec.shape)}")
    N, K, _ = rvec.shape
    for name, t in (("sidx", sidx), ("mask", mask)):
        if tuple(t.shape) != (N, K):
            raise ValueError(f"{name} must be ({N}, {K}), got {tuple(t.shape)}")
    if radii.dim() != 1:
        raise ValueError("radii must be (S,)")
    for name, t in (("sidx", sidx), ("mask", mask), ("radii", radii)):
        if t.device != rvec.device:
            raise ValueError(f"{name} is on {t.device}, rvec on {rvec.device}")
    lib = _load()
    if params.lmax > lib.max_lmax:
        raise ValueError(f"lmax {params.lmax} > {lib.max_lmax}")
    return lib


@functools.lru_cache(maxsize=None)
def _smem_fits(kernel, esize, S, lmax, nmax, K):
    """Whether the shared rows of ``kernel`` ("fwd" or "bwd") fit in one
    block at these sizes; the library is asked once per shape."""
    lib = _load()
    need = getattr(lib, f"soap_{kernel}_smem_bytes")(esize, S, lmax, nmax, K)
    return need <= lib.soap_smem_limit()


def _fits(kernel, rvec, radii, params):
    return _smem_fits(kernel, rvec.element_size(), radii.shape[0], params.lmax,
                      params.nmax, rvec.shape[1])


def _kernel_args(rvec, sidx, mask, radii):
    """Contiguous device operands in the kernel's types (int32 species,
    one-byte mask, radii in the working type)."""
    if not rvec.is_contiguous():
        raise ValueError("rvec must be contiguous")
    return (rvec, sidx.to(torch.int32).contiguous(),
            mask.to(torch.bool).contiguous(),
            radii.to(rvec.dtype).contiguous())


def _raise_if_failed(code, what):
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed (cudaError {code})")


def launch_fwd(lib, rvec, sidx, mask, radii, params, cr, ci):
    """Launch ``lib``'s forward kernel on checked operands (the types of
    ``_kernel_args``) on the current stream; returns its cudaError code."""
    N, K, _ = rvec.shape
    with torch.cuda.device(rvec.device):
        return lib.soap_coeff_fwd(
            int(rvec.dtype == torch.float64), rvec.data_ptr(),
            sidx.data_ptr(), mask.data_ptr(), radii.data_ptr(),
            cr.data_ptr(), ci.data_ptr(), N, K, radii.shape[0], params.lmax,
            params.nmax, float(params.rc), int(params.cut_n),
            torch.cuda.current_stream().cuda_stream,
        )


def launch_bwd(lib, rvec, sidx, mask, radii, crb, cib, params, rbar):
    """Launch ``lib``'s backward kernel, as ``launch_fwd``."""
    N, K, _ = rvec.shape
    with torch.cuda.device(rvec.device):
        return lib.soap_coeff_bwd(
            int(rvec.dtype == torch.float64), rvec.data_ptr(),
            sidx.data_ptr(), mask.data_ptr(), radii.data_ptr(),
            crb.data_ptr(), cib.data_ptr(), rbar.data_ptr(), N, K,
            radii.shape[0], params.lmax, params.nmax, float(params.rc),
            int(params.cut_n), torch.cuda.current_stream().cuda_stream,
        )


def soap_coeff_fwd(rvec, sidx, mask, radii, params: SoapParams):
    """(cR, cI) (N, CH): CUDA kernel on a CUDA tensor, plain torch on a CPU
    tensor."""
    if rvec.device.type == "cpu":
        return soap_coeff_fwd_plain(rvec, sidx, mask, radii, params)
    if rvec.device.type != "cuda":
        raise ValueError(f"unsupported device {rvec.device}")
    lib = _check_inputs(rvec, sidx, mask, radii, params)
    rvec, sidx, mask, radii = _kernel_args(rvec, sidx, mask, radii)
    N = rvec.shape[0]
    S = radii.shape[0]
    CH = channels(S, params)
    if not _fits("fwd", rvec, radii, params):
        raise ValueError("species/nmax/lmax too large for the forward "
                         "kernel's shared rows")
    cr = torch.empty((N, CH), dtype=rvec.dtype, device=rvec.device)
    ci = torch.empty((N, CH), dtype=rvec.dtype, device=rvec.device)
    if N == 0:
        return cr, ci
    code = launch_fwd(lib, rvec, sidx, mask, radii, params, cr, ci)
    soap_coeff_fwd.launches += 1
    _raise_if_failed(code, "soap_coeff_fwd")
    return cr, ci


soap_coeff_fwd.launches = 0


def soap_coeff_bwd(rvec, sidx, mask, radii, crb, cib, params: SoapParams):
    """rvec_bar (N, K, 3): CUDA kernel on a CUDA tensor, plain torch (the
    closed form) on a CPU tensor."""
    if rvec.device.type == "cpu":
        return soap_coeff_bwd_plain(rvec, sidx, mask, radii, crb, cib, params)
    if rvec.device.type != "cuda":
        raise ValueError(f"unsupported device {rvec.device}")
    lib = _check_inputs(rvec, sidx, mask, radii, params)
    rvec, sidx, mask, radii = _kernel_args(rvec, sidx, mask, radii)
    N, K, _ = rvec.shape
    S = radii.shape[0]
    CH = channels(S, params)
    for name, t in (("crb", crb), ("cib", cib)):
        if tuple(t.shape) != (N, CH) or t.dtype != rvec.dtype:
            raise ValueError(f"{name} must be ({N}, {CH}) {rvec.dtype}")
        if t.device != rvec.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {rvec.device}")
    if not _fits("bwd", rvec, radii, params):
        raise ValueError("too many channels for the backward kernel")
    rbar = torch.empty((N, K, 3), dtype=rvec.dtype, device=rvec.device)
    if N == 0:
        return rbar
    code = launch_bwd(lib, rvec, sidx, mask, radii, crb, cib, params, rbar)
    soap_coeff_bwd.launches += 1
    _raise_if_failed(code, "soap_coeff_bwd")
    return rbar


soap_coeff_bwd.launches = 0


class SoapCoefficients(torch.autograd.Function):
    """(cR, cI) = forward kernel; gradient w.r.t. rvec = backward kernel
    (the counterpart of ``pallas_soap.sesoap_coefficients_pl``'s
    custom_vjp).  First order only; no gradient to sidx, mask or radii."""

    @staticmethod
    def forward(ctx, rvec, sidx, mask, radii, params):
        ctx.params = params
        ctx.save_for_backward(rvec, sidx, mask, radii)
        return soap_coeff_fwd(rvec, sidx, mask, radii, params)

    @staticmethod
    def backward(ctx, crb, cib):
        rvec, sidx, mask, radii = ctx.saved_tensors
        shape = (rvec.shape[0], channels(radii.shape[0], ctx.params))
        crb = rvec.new_zeros(shape) if crb is None else crb.contiguous()
        cib = rvec.new_zeros(shape) if cib is None else cib.contiguous()
        rbar = soap_coeff_bwd(rvec, sidx, mask, radii, crb, cib, ctx.params)
        return rbar, None, None, None, None


def sesoap_coefficients_k(rvec, sidx, mask, radii, params: SoapParams):
    """(cR, cI) of shape (N, CH) through the kernels, differentiable."""
    return SoapCoefficients.apply(rvec, sidx, mask, radii, params)


def sesoap_descriptors_k(rvec, sidx, mask, radii, params: SoapParams):
    """Descriptors (N, D) built on the coefficient kernels (the counterpart
    of ``pallas_soap.sesoap_descriptors_pl``)."""
    S = radii.shape[0]
    L = params.lmax + 1
    n = rvec.shape[0]
    cr, ci = sesoap_coefficients_k(rvec, sidx, mask, radii, params)
    cR = cr.reshape(n, S, params.nmax + 1, L, L)
    cI = ci.reshape(n, S, params.nmax + 1, L, L)
    return power_spectrum(cR, cI, params)
