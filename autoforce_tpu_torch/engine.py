"""Device engine: predict / descriptor functions on torch tensors (port of
``autoforce_tpu/engine.py``, SOAP dot kernel only).

The host state machine (:mod:`..calculator.active`, :mod:`..regression.sgpr`)
calls a small set of functions on padded, statically-shaped tensors:

  * ``predict_fn``        — descriptors → cov → energy, forces, virial, beta
                            (the per-MD-step hot path; one forward + one
                            backward pass)
  * ``descriptors_fn``    — per-LCE descriptors of a configuration
  * ``env_descriptors_fn``— descriptors of raw environments (inducing set)

The descriptor inside them goes through the SOAP coefficient kernels
(``descriptor.soap_kernels.sesoap_descriptors_k``).  Pair terms,
alchemical species mixing, kernel expressions and the device mesh are not
ported yet: the Engine refuses them.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from . import resolve_device
from .descriptor.radial import as_radii
from .descriptor.soap import SoapParams
from .descriptor.soap_kernels import sesoap_descriptors_k
from .kernels import covloss_beta, gram
from .neighbors import neighbor_table, reverse_slots_host, round_up


class ConfigArrays(NamedTuple):
    """Padded device-ready representation of one configuration."""

    positions: torch.Tensor  # (N, 3)
    cell: torch.Tensor  # (3, 3)
    numbers: torch.Tensor  # (N,) int32 atomic numbers (0 for padding)
    atom_mask: torch.Tensor  # (N,) bool
    nbr_idx: torch.Tensor  # (N, K) int32
    nbr_off: torch.Tensor  # (N, K, 3) int8 (int32 for very thin cells)
    nbr_sidx: torch.Tensor  # (N, K) int32 species-table index of neighbor
    nbr_mask: torch.Tensor  # (N, K) bool
    # flat reverse slot (i*K + k) of each table entry, -1 if masked
    # (neighbors_device.reverse_slots); None disables the gather backward
    nbr_rev: torch.Tensor = None  # (N, K) int32 or None

    @property
    def npad(self):
        return self.positions.shape[0]


class ModelArrays(NamedTuple):
    """Padded device-side SGPR model state."""

    X_desc: torch.Tensor  # (M, D)
    X_num: torch.Tensor  # (M,) int32
    X_lone: torch.Tensor  # (M,) bool
    m_mask: torch.Tensor  # (M,) bool
    mu: torch.Tensor  # (M,)
    choli: torch.Tensor  # (M, M), zero-padded


class EnvArrays(NamedTuple):
    """Raw local environments (for descriptor recomputation)."""

    rvec: torch.Tensor  # (B, K, 3)
    sidx: torch.Tensor  # (B, K) int32
    mask: torch.Tensor  # (B, K) bool


class _NbrGatherRev(torch.autograd.Function):
    """``positions[nbr_idx]`` whose backward is a reverse-slot GATHER
    instead of a scatter-add.

    Neighbor tables are symmetric, so the cotangent sum over all slots
    pointing at atom j equals the sum over row j's reverse slots
    (neighbors_device.reverse_slots) — a gather + row reduction.  Unlike
    the ``index_add`` that plain indexing backpropagates through, whose
    atomic order on CUDA changes from run to run, the sum order here is
    fixed: forces are deterministic.  Masked-slot cotangents are zeroed
    explicitly (they are analytically zero: every consumer masks before
    any nonlinearity).  First order only."""

    @staticmethod
    def forward(ctx, positions, nbr_idx, nbr_rev, nbr_mask):
        ctx.save_for_backward(nbr_rev, nbr_mask)
        return positions[nbr_idx]

    @staticmethod
    def backward(ctx, ct):
        nbr_rev, nbr_mask = ctx.saved_tensors
        ct = torch.where(nbr_mask[..., None], ct, torch.zeros_like(ct))
        flat = ct.reshape(-1, ct.shape[-1])
        good = nbr_rev >= 0
        taken = flat[nbr_rev.clamp(0, flat.shape[0] - 1)]
        dpos = torch.where(good[..., None], taken, torch.zeros_like(taken))
        return dpos.sum(dim=1), None, None, None


def _env_rvec(positions, cell, cfg: ConfigArrays, use_rev=False):
    """Neighbor displacement vectors (N, K, 3).

    ``use_rev``: route the neighbor gather through the reverse-slot
    backward (first-order callers only — the MD/predict hot paths)."""
    if use_rev and cfg.nbr_rev is not None:
        nbrs = _NbrGatherRev.apply(positions, cfg.nbr_idx, cfg.nbr_rev,
                                   cfg.nbr_mask)
    else:
        nbrs = positions[cfg.nbr_idx]
    # image shifts off @ cell, written out: a (N K, 3) x (3, 3) product is
    # a poor shape for a GEMM
    off = cfg.nbr_off.to(positions.dtype)
    shift = (off[..., 0, None] * cell[0] + off[..., 1, None] * cell[1]
             + off[..., 2, None] * cell[2])
    return nbrs - positions[:, None, :] + shift


def _config_descriptors(positions, cell, cfg, radii, params, use_rev=False):
    rvec = _env_rvec(positions, cell, cfg, use_rev=use_rev)
    mask = cfg.nbr_mask & cfg.atom_mask[:, None]
    p = sesoap_descriptors_k(rvec, cfg.nbr_sidx, mask, radii, params)
    # neighbor tables may carry skin-buffered pairs beyond rc (inert in the
    # descriptor); lone-atom detection must only count pairs within rc
    d2 = (rvec * rvec).sum(-1)
    within = mask & (d2 < params.rc**2)
    lone = cfg.atom_mask & ~within.any(dim=1)
    return p, lone


def _total_cov(posd, celld, cfg, X_desc, X_num, X_lone, radii, params,
               exponent, use_rev=False):
    """SOAP covariance block (n, M), lone flags and the per-LCE kernel
    diagonal alpha (1 for the normalized dot kernel)."""
    p, lone = _config_descriptors(posd, celld, cfg, radii, params,
                                  use_rev=use_rev)
    cov = gram(p, cfg.numbers, lone, X_desc, X_num, X_lone, exponent)
    alpha = torch.ones(cfg.nbr_mask.shape[0], dtype=posd.dtype,
                       device=posd.device)
    return cov, lone, alpha


def predict_fn(cfg: ConfigArrays, model: ModelArrays, radii, vscale_atom,
               params, exponent):
    """Energy, forces, virial, covariance and beta from one backward pass
    over (positions, strain) (reference hot path §3.1)."""
    pos = cfg.positions.detach().requires_grad_(True)
    eps = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device,
                      requires_grad=True)
    with torch.enable_grad():
        one = torch.eye(3, dtype=pos.dtype, device=pos.device) + eps
        posd = pos @ one
        celld = cfg.cell @ one
        cov, lone, alpha = _total_cov(
            posd, celld, cfg, model.X_desc, model.X_num, model.X_lone,
            radii, params, exponent, use_rev=True,
        )
        cov = cov * (cfg.atom_mask[:, None] & model.m_mask[None, :])
        e = (cov @ model.mu).sum()
        dpos, deps = torch.autograd.grad(e, (pos, eps))
    forces = -dpos * cfg.atom_mask[:, None]
    virial = 0.5 * (deps + deps.T)
    cov = cov.detach()
    beta = covloss_beta(model.choli, cov, vscale_atom, model.m_mask,
                        alpha=alpha)
    beta = torch.where(cfg.atom_mask, beta, torch.full_like(beta, -np.inf))
    return e.detach(), forces, virial, cov, beta


@torch.no_grad()
def descriptors_fn(cfg: ConfigArrays, radii, params):
    return _config_descriptors(cfg.positions, cfg.cell, cfg, radii, params)


@torch.no_grad()
def env_descriptors_fn(envs: EnvArrays, radii, params):
    """Descriptors for a batch of raw environments (inducing set staging)."""
    p = sesoap_descriptors_k(envs.rvec, envs.sidx, envs.mask, radii, params)
    lone = ~envs.mask.any(dim=-1)
    return p, lone


# --------------------------------------------------------------------------
# host-side engine
# --------------------------------------------------------------------------

VOIGT = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]


def device_fetch(*tensors):
    """Pull several device tensors to the host in ONE transfer: flatten and
    concatenate on the device (as float64, which holds every int32 value
    exactly), one copy, split on the host and cast back."""
    for t in tensors:
        if t.dtype == torch.int64:
            raise TypeError("device_fetch: int64 payloads do not survive the "
                            "float64 buffer; fetch them separately")
    if len(tensors) == 1:
        return [tensors[0].detach().cpu().numpy()]
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
    buf = flat.cpu().numpy()
    out = []
    o = 0
    for t in tensors:
        n = t.numel()
        dt = np.dtype(str(t.dtype).replace("torch.", ""))
        out.append(buf[o:o + n].astype(dt).reshape(tuple(t.shape)))
        o += n
    return out


def voigt6(t):
    """3x3 symmetric tensor -> Voigt [xx, yy, zz, yz, xz, xy]."""
    t = np.asarray(t)
    return np.array([t[i, j] for i, j in VOIGT])


class Engine:
    """Host wrapper: species table, buckets, device and working type."""

    def __init__(self, params: SoapParams = None, exponent=4, radii=None,
                 species=None, dtype=None, device="cuda", pair_terms=(),
                 chemical=None, mesh=None, kernel=None):
        if pair_terms:
            raise NotImplementedError("pair terms are not ported yet")
        if chemical:
            raise NotImplementedError("alchemical kernels are not ported yet")
        if mesh is not None:
            raise NotImplementedError("the device mesh is not ported yet")
        if kernel not in (None, "dot"):
            raise NotImplementedError(f"kernel {kernel!r} is not ported yet")
        self.params = params or SoapParams()
        self.exponent = int(exponent)
        self.radii = as_radii(radii if radii is not None else 1.0)
        self.species = sorted(int(z) for z in (species or []))
        self.env_kpad = 8  # sticky env-staging neighbor bucket (make_envs)
        self.device = resolve_device(device)
        # float32 is the working type of configurations and descriptors on
        # the card (as on the TPU).  The model state (inducing descriptors,
        # weights, choli) stays float64: the energy sum(cov @ mu) cancels
        # terms whose magnitudes add up to ~1e5 times |E| (bench model:
        # 3.5e7 eV against 190 eV), so the float32 rounding of each
        # inducing descriptor's norm, shared by every atom, moves the
        # energy by ~1e-4 eV/atom even for an exactly computed descriptor
        # stored in float32; float32 restaging adds a few times more.
        self.dtype = dtype if dtype is not None else torch.float32
        self.model_dtype = torch.float64

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def znum_table(self):
        table = self.species if self.species else [0]
        return self._tensor(np.asarray(table, dtype=np.int32))

    # -------------------------------------------------------------- species
    @property
    def nspecies(self):
        return len(self.species)

    @property
    def dim(self):
        return self.params.dim(max(self.nspecies, 1))

    def species_index(self, numbers):
        """Map atomic numbers to table indices; -1 if absent."""
        numbers = np.asarray(numbers)
        out = np.full(numbers.shape, -1, dtype=np.int32)
        for i, z in enumerate(self.species):
            out[numbers == z] = i
        return out

    def ensure_species(self, numbers):
        """Grow the species table; returns True if it changed."""
        new = sorted(set(int(z) for z in np.asarray(numbers).reshape(-1)) - set(self.species))
        if new:
            self.species = sorted(self.species + new)
            return True
        return False

    def radii_table(self):
        table = self.species if self.species else [0]
        return self._tensor(self.radii.table(table), self.dtype)

    # -------------------------------------------------------------- configs
    def make_config(self, system, npad=None, kpad=None, table=None) -> ConfigArrays:
        """Build padded device tensors for a System."""
        n = len(system)
        npad = npad or round_up(n, 16)
        if table is None:
            table = neighbor_table(
                system.positions, system.cell, system.pbc, self.params.rc
            )
        if kpad is not None:
            table = table.pad_to(kpad)
        sidx = self.species_index(system.numbers)  # (n,)
        nbr_sidx = sidx[table.idx]
        nbr_mask = table.mask & (nbr_sidx >= 0)

        def pad(a, fill=0):
            out = np.full((npad,) + a.shape[1:], fill, dtype=a.dtype)
            out[:n] = a
            return out

        positions = pad(system.positions.astype(np.float64))
        numbers = pad(system.numbers.astype(np.int32))
        atom_mask = np.zeros(npad, bool)
        atom_mask[:n] = True
        nbr_idx = pad(table.idx)
        nbr_off = pad(table.off)
        if np.abs(nbr_off).max(initial=0) <= 127:
            # PBC image offsets fit int8 except for pathologically thin
            # cells; the (N, K, 3) offsets are the largest upload
            nbr_off = nbr_off.astype(np.int8)
        nbr_sidx = pad(np.maximum(nbr_sidx, 0).astype(np.int32))
        nbr_mask = pad(nbr_mask)
        idx_t = self._tensor(nbr_idx)
        off_t = self._tensor(nbr_off)
        mask_t = self._tensor(nbr_mask)
        rev = reverse_slots_host(nbr_idx, nbr_off, nbr_mask)
        if rev is None:  # table too large for the host int64 key encoding
            from .neighbors_device import reverse_slots

            rev_t = reverse_slots(idx_t, off_t, mask_t)
            asym = bool(torch.any(mask_t & (rev_t < 0)))
        else:
            asym = bool((nbr_mask & (rev < 0)).any())
            rev_t = self._tensor(rev)
        # the reverse-slot backward silently drops a pair's cotangent if its
        # mirror entry is missing; both builders emit symmetric tables, but
        # guard against an asymmetric producer: use the plain indexing path
        if asym:
            logging.getLogger(__name__).warning(
                "asymmetric neighbor table: disabling the reverse-slot "
                "force backward (plain scatter path)"
            )
            rev_t = None
        return ConfigArrays(
            positions=self._tensor(positions, self.dtype),
            cell=self._tensor(system.cell, self.dtype),
            numbers=self._tensor(numbers),
            atom_mask=self._tensor(atom_mask),
            nbr_idx=idx_t,
            nbr_off=off_t,
            nbr_sidx=self._tensor(nbr_sidx),
            nbr_mask=mask_t,
            nbr_rev=rev_t,
        )

    def update_positions(self, cfg: ConfigArrays, system) -> ConfigArrays:
        """Refresh only positions/cell of a cached config (neighbor table
        unchanged thanks to the Verlet skin)."""
        pos = np.zeros((cfg.npad, 3))
        pos[: len(system)] = system.positions
        return cfg._replace(
            positions=self._tensor(pos, self.dtype),
            cell=self._tensor(system.cell, self.dtype),
        )

    def make_envs(self, env_list, kpad=None, dtype=None) -> EnvArrays:
        """Pad a list of raw (rvec, numbers) environments; the neighbor axis
        uses a sticky bucket (env_kpad).  ``dtype`` defaults to the working
        type."""
        kmax = max([len(e[1]) for e in env_list] + [1])
        if kpad is None:
            self.env_kpad = max(self.env_kpad, round_up(kmax, 8))
            kpad = self.env_kpad
        m = len(env_list)
        rvec = np.zeros((m, kpad, 3))
        sidx = np.zeros((m, kpad), dtype=np.int32)
        mask = np.zeros((m, kpad), bool)
        for i, (rv, nums) in enumerate(env_list):
            c = len(nums)
            rvec[i, :c] = rv
            si = self.species_index(nums)
            sidx[i, :c] = np.maximum(si, 0)
            mask[i, :c] = si >= 0
        return EnvArrays(
            rvec=self._tensor(rvec, dtype or self.dtype),
            sidx=self._tensor(sidx),
            mask=self._tensor(mask),
        )

    # ---------------------------------------------------------- computations
    def descriptors(self, cfg: ConfigArrays):
        return descriptors_fn(cfg, self.radii_table(), self.params)

    def env_descriptors(self, envs: EnvArrays):
        radii = self.radii_table().to(envs.rvec.dtype)
        return env_descriptors_fn(envs, radii, self.params)

    def predict(self, cfg: ConfigArrays, model: ModelArrays, vscale_atom):
        vs = self._tensor(np.asarray(vscale_atom, dtype=np.float64), self.dtype)
        return predict_fn(cfg, model, self.radii_table(), vs, self.params,
                          self.exponent)

    # ------------------------------------------------------------ model sync
    def model_arrays(self, X_desc, X_num, X_lone, mu, choli, mcap=None) -> ModelArrays:
        """Pad host model state to the inducing-capacity bucket, on the
        device in ``model_dtype``."""
        m = len(X_num)
        mcap = mcap or max(32, round_up(max(m, 1), 32))
        D = X_desc.shape[1] if m else self.dim
        Xd = np.zeros((mcap, D))
        Xn = np.zeros(mcap, dtype=np.int32)
        Xl = np.zeros(mcap, bool)
        mm = np.zeros(mcap, bool)
        muv = np.zeros(mcap)
        ch = np.zeros((mcap, mcap))
        if m:
            Xd[:m] = X_desc
            Xn[:m] = X_num
            Xl[:m] = X_lone
            mm[:m] = True
            muv[:m] = mu
            ch[:m, :m] = choli
        return ModelArrays(
            X_desc=self._tensor(Xd, self.model_dtype),
            X_num=self._tensor(Xn),
            X_lone=self._tensor(Xl),
            m_mask=self._tensor(mm),
            mu=self._tensor(muv, self.model_dtype),
            choli=self._tensor(ch, self.model_dtype),
        )
