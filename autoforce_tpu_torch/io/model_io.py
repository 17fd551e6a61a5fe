"""Model folder persistence (port of ``autoforce_tpu/io/model_io.py``).

The folder layout, the same in both packages, so a model saved by one
loads into the other:

    folder/
      meta.json      descriptor/kernel config, species, noise, mean, stats
      arrays.npz     M, Ke, Kf, Kv, mu, choli
      inducing.npz   ragged inducing envs (concatenated + offsets)
      data.extxyz    training structures with energy/forces/stress targets
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..descriptor.radial import DefaultRadii, RadiiFromDict, UniformRadii
from ..descriptor.soap import SoapParams
from ..engine import Engine
from ..kernelalgebra import KernelExpr, from_state
from ..pairkernels import PairTerm
from ..regression.sgpr import DataRecord, InducingEnv, SgprModel
from ..system import SinglePointCalculator
from .xyz import read_xyz, write_xyz


def _kernel_state(kind):
    """Serialize the base kernel: plain string kinds as-is, a KernelExpr as
    its eval-able state string."""
    if isinstance(kind, KernelExpr):
        return {"expr": kind.state}
    return kind


def _kernel_from_state(st):
    if isinstance(st, dict) and "expr" in st:
        return from_state(st["expr"])
    return st if st is not None else "dot"


def _radii_state(radii):
    if isinstance(radii, UniformRadii):
        return {"type": "uniform", "value": radii.value}
    if isinstance(radii, DefaultRadii):
        return {"type": "default", "default": radii.default,
                "special": {str(k): v for k, v in radii.special.items()}}
    if isinstance(radii, RadiiFromDict):
        return {"type": "dict", "d": {str(k): v for k, v in radii.d.items()}}
    raise TypeError(f"cannot serialize radii {radii!r}")


def _radii_from_state(st):
    if st["type"] == "uniform":
        return UniformRadii(st["value"])
    if st["type"] == "default":
        return DefaultRadii(st["default"], {int(k): v for k, v in st["special"].items()})
    if st["type"] == "dict":
        return RadiiFromDict({int(k): v for k, v in st["d"].items()})
    raise ValueError(st)


def save_model(model: SgprModel, folder):
    os.makedirs(folder, exist_ok=True)
    eng = model.engine
    meta = {
        "version": 1,
        "params": {
            "lmax": eng.params.lmax,
            "nmax": eng.params.nmax,
            "rc": eng.params.rc,
            "cut_n": eng.params.cut_n,
            "normalize": eng.params.normalize,
        },
        "exponent": eng.exponent,
        "species": eng.species,
        "radii": _radii_state(eng.radii),
        "pair_terms": [vars(t) for t in eng.pair_terms],
        "chemical": eng.chemical,
        "kernel_kind": _kernel_state(eng.kernel_kind),
        "noise_state": {str(k): float(v) for k, v in model.noise_state.items()},
        "scaled_noise": {str(k): float(v) for k, v in model.scaled_noise.items()},
        "mean_weights": {str(k): float(v) for k, v in model.mean_weights.items()},
        "ridge": float(model.ridge),
        "stats": model.stats,
        "vscale": {str(k): float(v) for k, v in model.vscale.items()},
        "size": list(model.size),
    }
    with open(os.path.join(folder, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    # uncompressed: the model is saved after every update, and zlib of the
    # (3N ndata, m) force block would dominate the save
    np.savez(
        os.path.join(folder, "arrays.npz"),
        M=model.M, Ke=model.Ke, Kf=model.Kf, Kv=model.Kv,
        mu=model.mu, choli=model.choli,
    )
    if model.X:
        counts = np.array([len(x.numbers) for x in model.X])
        np.savez_compressed(
            os.path.join(folder, "inducing.npz"),
            central=np.array([x.number for x in model.X]),
            counts=counts,
            numbers=np.concatenate([x.numbers for x in model.X]) if counts.sum() else np.zeros(0, int),
            rvec=np.concatenate([x.rvec for x in model.X]).reshape(-1, 3) if counts.sum() else np.zeros((0, 3)),
        )
    systems = []
    for rec in model.data:
        s = rec.system.copy()
        s.calc = SinglePointCalculator(s, energy=rec.e, forces=rec.f, stress=rec.s)
        systems.append(s)
    write_xyz(os.path.join(folder, "data.extxyz"), systems)
    with open(os.path.join(folder, "info"), "w") as f:
        f.write("data: {}, inducing: {}\n".format(*model.size))
    if model.stats:
        with open(os.path.join(folder, "stats"), "w") as f:
            st = model.stats
            f.write(
                f"ediff -> mean: {st['e_mean']} std: {st['e_mae']}  "
                f"fdiff -> mean: {st['f_mean']} std: {st['f_mae']}  "
                f"R2: {st['r2']}\n"
            )


def load_model(folder, device="cuda", dtype=None) -> SgprModel:
    """The whole SgprModel of a model folder (serving and training state);
    the inducing descriptors and data configs are restaged through this
    package's engine on ``device``."""
    with open(os.path.join(folder, "meta.json")) as f:
        meta = json.load(f)
    engine = Engine(
        params=SoapParams(**meta["params"]),
        exponent=meta["exponent"],
        radii=_radii_from_state(meta["radii"]),
        species=meta["species"],
        dtype=dtype,
        device=device,
        pair_terms=tuple(PairTerm(**t) for t in meta.get("pair_terms", [])),
        chemical=meta.get("chemical"),
        kernel=_kernel_from_state(meta.get("kernel_kind")),
    )
    model = SgprModel(engine)
    with np.load(os.path.join(folder, "arrays.npz")) as arr:
        model.M = arr["M"]
        model.Ke = arr["Ke"]
        model.Kf = arr["Kf"]
        model.Kv = arr["Kv"]
        model.mu = arr["mu"]
        model.choli = arr["choli"]
    model.ridge = float(meta.get("ridge", 0.0))
    model.noise_state = {k: float(v) for k, v in meta["noise_state"].items()}
    model.scaled_noise = {k: float(v) for k, v in meta["scaled_noise"].items()}
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
    data_path = os.path.join(folder, "data.extxyz")
    if os.path.isfile(data_path):
        for s in read_xyz(data_path):
            model.data.append(DataRecord.from_system(s))
    model.restage()
    if model.m and model.ndata and len(model.mu):
        model.make_stats()
    return model
