"""Carry model weights and configurations across from the JAX package.

The JAX package's ``ModelArrays`` / ``ConfigArrays`` hold the same padded
fields as this package's; given them as numpy arrays (for example from
``SgprModel.full_model_arrays()`` and ``Engine.make_config``), these
functions build the torch counterparts, so both packages can compute on
identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import ConfigArrays, ModelArrays


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def model_arrays_from_numpy(X_desc, X_num, X_lone, mu, choli, device,
                            dtype, m_mask=None):
    """Padded ``ModelArrays`` on ``device``; ``m_mask`` defaults to the
    rows with a central atomic number (padding rows carry 0)."""
    if m_mask is None:
        m_mask = np.asarray(X_num) != 0
    return ModelArrays(
        X_desc=_t(X_desc, device, dtype),
        X_num=_t(np.asarray(X_num, dtype=np.int32), device),
        X_lone=_t(np.asarray(X_lone, dtype=bool), device),
        m_mask=_t(np.asarray(m_mask, dtype=bool), device),
        mu=_t(mu, device, dtype),
        choli=_t(choli, device, dtype),
    )


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
