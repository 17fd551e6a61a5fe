"""Carry model state and configurations across from the JAX package.

The JAX package's ``ModelArrays`` / ``ConfigArrays`` hold the same padded
fields as this package's; given them as numpy arrays (for example from
``SgprModel.full_model_arrays()`` and ``Engine.make_config``), these
functions build the torch counterparts, so both packages can compute on
identical inputs.  ``sgpr_model_from_jax`` carries a whole trained (or
learning) model, its kernel space (pair terms, chemical, kernel
expression) included.  Nothing here imports the JAX package: its objects are
read through their numpy fields.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import ConfigArrays, ModelArrays


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def model_arrays_from_numpy(X_desc, X_num, X_lone, mu, choli, device,
                            dtype, m_mask=None, pair_d=None, pair_mask=None):
    """Padded ``ModelArrays`` on ``device``; ``m_mask`` defaults to the
    rows with a central atomic number (padding rows carry 0); ``pair_d`` /
    ``pair_mask``: the staged pair distances (T, M, KX), if any."""
    if m_mask is None:
        m_mask = np.asarray(X_num) != 0
    return ModelArrays(
        X_desc=_t(X_desc, device, dtype),
        X_num=_t(np.asarray(X_num, dtype=np.int32), device),
        X_lone=_t(np.asarray(X_lone, dtype=bool), device),
        m_mask=_t(np.asarray(m_mask, dtype=bool), device),
        mu=_t(mu, device, dtype),
        choli=_t(choli, device, dtype),
        pair_d=None if pair_d is None else _t(pair_d, device, dtype),
        pair_mask=None if pair_mask is None else _t(
            np.asarray(pair_mask, dtype=bool), device),
    )


def pair_terms_from_jax(terms):
    """This package's ``PairTerm`` tuple from the JAX package's (read
    through their fields)."""
    from ..pairkernels import PairTerm

    return tuple(PairTerm(**vars(t)) for t in terms)


def kernel_from_jax(kind):
    """This package's base kernel from the JAX package's: string kinds as
    they are, a ``KernelExpr`` through its ``state`` string."""
    if isinstance(kind, str) or kind is None:
        return kind
    from ..kernelalgebra import from_state

    return from_state(kind.state)


def config_from_numpy(positions, cell, numbers, atom_mask, nbr_idx, nbr_off,
                      nbr_sidx, nbr_mask, nbr_rev, device, dtype):
    """``ConfigArrays`` on ``device`` from the fields of a JAX config."""
    return ConfigArrays(
        positions=_t(positions, device, dtype),
        cell=_t(cell, device, dtype),
        numbers=_t(np.asarray(numbers, dtype=np.int32), device),
        atom_mask=_t(np.asarray(atom_mask, dtype=bool), device),
        nbr_idx=_t(np.asarray(nbr_idx, dtype=np.int32), device),
        nbr_off=_t(nbr_off, device),
        nbr_sidx=_t(np.asarray(nbr_sidx, dtype=np.int32), device),
        nbr_mask=_t(np.asarray(nbr_mask, dtype=bool), device),
        nbr_rev=None if nbr_rev is None else _t(
            np.asarray(nbr_rev, dtype=np.int32), device),
    )


def sgpr_model_from_jax(jmodel, device, dtype=None):
    """A port :class:`SgprModel` holding the whole state of a JAX package
    ``SgprModel`` (passed as the object; only its numpy fields and plain
    attributes are read): inducing environments with their staged
    descriptors, data records (systems and targets; configs are rebuilt by
    this package's engine), M/Ke/Kf/Kv, mu, choli, noise, mean weights,
    vscale and stats.  Both packages can then continue learning from one
    state."""
    from ..descriptor.radial import DefaultRadii, RadiiFromDict, UniformRadii
    from ..descriptor.soap import SoapParams
    from ..engine import Engine
    from ..regression.sgpr import DataRecord, InducingEnv, SgprModel
    from ..system import System

    je = jmodel.engine
    radii = je.radii
    kind = type(radii).__name__
    if kind == "UniformRadii":
        radii = UniformRadii(radii.value)
    elif kind == "DefaultRadii":
        radii = DefaultRadii(radii.default, dict(radii.special))
    elif kind == "RadiiFromDict":
        radii = RadiiFromDict(dict(radii.d))
    else:
        raise TypeError(f"cannot carry radii {radii!r}")
    p = je.params
    engine = Engine(
        params=SoapParams(lmax=p.lmax, nmax=p.nmax, rc=p.rc, cut_n=p.cut_n,
                          normalize=p.normalize),
        exponent=je.exponent, radii=radii, species=list(je.species),
        dtype=dtype, device=device, pair_terms=pair_terms_from_jax(je.pair_terms),
        chemical=je.chemical, kernel=kernel_from_jax(je.kernel_kind),
    )
    engine.env_kpad = je.env_kpad
    engine.pair_kx = je.pair_kx
    model = SgprModel(engine)
    for x in jmodel.X:
        env = InducingEnv.from_arrays(x.number, np.array(x.rvec),
                                      np.array(x.numbers))
        env.desc = None if x.desc is None else np.array(x.desc, dtype=np.float64)
        env.lone = bool(x.lone)
        model.X.append(env)
    for rec in jmodel.data:
        s = rec.system
        system = System(numbers=np.array(s.numbers),
                        positions=np.array(s.positions),
                        cell=np.array(s.cell), pbc=np.array(s.pbc),
                        velocities=np.array(s.get_velocities()),
                        masses=np.array(s.get_masses()))
        r = DataRecord(system=system, e=float(rec.e), f=np.array(rec.f),
                       s=np.array(rec.s), natoms=int(rec.natoms))
        r.cfg = engine.make_config(system)
        model.data.append(r)
    for name in ("M", "Ke", "Kf", "Kv", "mu", "choli"):
        setattr(model, name, np.array(getattr(jmodel, name), dtype=np.float64))
    model.ridge = float(jmodel.ridge)
    model.noise_state = {k: float(v) for k, v in jmodel.noise_state.items()}
    model.scaled_noise = {k: float(v) for k, v in jmodel.scaled_noise.items()}
    model.mean_weights = {int(k): float(v) for k, v in jmodel.mean_weights.items()}
    model.vscale = {int(k): float(v) for k, v in jmodel.vscale.items()}
    model.indu_counts = {int(k): int(v)
                         for k, v in getattr(jmodel, "indu_counts", {}).items()}
    model.stats = None if jmodel.stats is None else dict(jmodel.stats)
    model.fast_trial_min_m = jmodel.fast_trial_min_m
    return model
