"""Model folder loading, serving subset (port of
``autoforce_tpu/io/model_io.py``).  The folder layout:

    folder/
      meta.json      descriptor/kernel config, species, noise, mean, stats
      arrays.npz     M, Ke, Kf, Kv, mu, choli
      inducing.npz   ragged inducing envs (concatenated + offsets)
      data.extxyz    training structures (read by the learning slice)
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..descriptor.radial import DefaultRadii, RadiiFromDict, UniformRadii
from ..descriptor.soap import SoapParams
from ..engine import Engine
from ..regression.sgpr import InducingEnv, SgprModel


def _radii_from_state(st):
    if st["type"] == "uniform":
        return UniformRadii(st["value"])
    if st["type"] == "default":
        return DefaultRadii(st["default"], {int(k): v for k, v in st["special"].items()})
    if st["type"] == "dict":
        return RadiiFromDict({int(k): v for k, v in st["d"].items()})
    raise ValueError(st)


def load_model(folder, device="cuda", dtype=None) -> SgprModel:
    """A servable SgprModel from a model folder; the inducing descriptors
    are restaged through this package's engine on ``device``."""
    with open(os.path.join(folder, "meta.json")) as f:
        meta = json.load(f)
    engine = Engine(
        params=SoapParams(**meta["params"]),
        exponent=meta["exponent"],
        radii=_radii_from_state(meta["radii"]),
        species=meta["species"],
        dtype=dtype,
        device=device,
        pair_terms=tuple(meta.get("pair_terms", [])),
        chemical=meta.get("chemical"),
        kernel=meta.get("kernel_kind"),
    )
    model = SgprModel(engine)
    with np.load(os.path.join(folder, "arrays.npz")) as arr:
        model.mu = arr["mu"]
        model.choli = arr["choli"]
    model.mean_weights = {int(k): float(v) for k, v in meta["mean_weights"].items()}
    model.vscale = {int(k): float(v) for k, v in meta["vscale"].items()}
    model.stats = meta.get("stats")
    ind_path = os.path.join(folder, "inducing.npz")
    if os.path.isfile(ind_path):
        with np.load(ind_path) as ind:
            ofs = np.concatenate([[0], np.cumsum(ind["counts"])]).astype(int)
            rvec, numbers = ind["rvec"], ind["numbers"]
            for i, z in enumerate(ind["central"]):
                model.X.append(InducingEnv.from_arrays(
                    int(z), rvec[ofs[i]:ofs[i + 1]], numbers[ofs[i]:ofs[i + 1]],
                ))
    model.restage()
    return model
