"""SGPR calculator, inference subset (port of
``autoforce_tpu/calculator/active.py``).

An ASE-protocol calculator that serves the predictions of a frozen, trained
model from the device engine: energy, forces, stress and the per-atom
covloss uncertainty.  On-the-fly learning (an ab-initio oracle with its
sampling policy) arrives with the learning slice; passing an oracle
``calculator`` raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

import time

import numpy as np

from ..engine import Engine, device_fetch, voigt6
from ..neighbors import VerletNeighborCache, round_up
from ..regression.sgpr import SgprModel

inf = float("inf")
kcal_mol = 0.043


class ActiveCalculator:
    """Serves a trained SGPR model (``covariance``: a model folder, an
    :class:`SgprModel`) on ``device`` in ``dtype``.

    ``skin`` is the Verlet skin of the neighbor cache; ``kpad_min`` a floor
    for the sticky neighbor-slot bucket.  The covloss of the last step is
    logged and compared with ``ediff`` (DeviceMD's uncertainty trip)."""

    def __init__(self, covariance, calculator=None, logfile=None,
                 ediff=2 * kcal_mol, skin=0.3, kpad_min=0, device="cuda",
                 dtype=None, stdout=False):
        if calculator is not None:
            raise NotImplementedError(
                "on-the-fly learning with an oracle calculator is not ported "
                "yet; pass calculator=None to serve a trained model"
            )
        self._calc = None
        self.model = self._get_model(covariance, device, dtype)
        self.ediff = float(ediff)
        self.logfile = logfile
        self.stdout = stdout
        self.step = 0
        self.meta = None
        self.maximum_force = inf
        self._npad = 0
        # neighbor-slot bucket floor, on the 16-slot bucket grid
        self._kpad = round_up(int(kpad_min), 16) if kpad_min else 0
        self._nlcache = VerletNeighborCache(self.engine.params.rc, skin=skin)
        self.cfg = None
        self._cfg_key = None
        self.results = {}
        self._beta = None
        self.covlog = ""
        self.log("active calculator says Hello!", mode="w")
        self.log(f"kernel: params={self.engine.params} zeta={self.engine.exponent}")
        self.log("model size: {} {}".format(*self.size))

    # ----------------------------------------------------------- properties
    @property
    def active(self):
        return self._calc is not None

    @property
    def engine(self) -> Engine:
        return self.model.engine

    @property
    def size(self):
        return self.model.size

    @staticmethod
    def _get_model(covariance, device, dtype):
        if isinstance(covariance, SgprModel):
            return covariance
        if isinstance(covariance, str):
            from ..io.model_io import load_model

            return load_model(covariance, device=device, dtype=dtype)
        raise TypeError(f"covariance: {covariance!r}")

    # ------------------------------------------------------------- calculate
    def calculate(self, system) -> dict:
        if self.size[1] == 0:
            raise RuntimeError("the model has no inducing environments")
        if self.engine.ensure_species(system.numbers):
            self.model.restage()
        self.system = system
        self._make_cfg(system)
        self.maximum_force = inf
        self._predict()
        covloss_max = float(self._beta.max()) if len(self._beta) else 0.0
        self.covlog = f"{covloss_max}"
        self.log(
            "{} {} {}".format(
                self.results["energy"], system.get_temperature(), self.covlog
            )
        )
        self.step += 1
        self.results["free_energy"] = self.results["energy"]
        return self.results

    # ----------------------------------------------------------- prediction
    def _make_cfg(self, system):
        table, rebuilt = self._nlcache.update(
            system.positions, system.cell, system.pbc
        )
        self._nl = table
        key = (len(system), tuple(self.engine.species))
        if rebuilt or self.cfg is None or key != self._cfg_key:
            self._npad = max(self._npad, round_up(len(system), 16))
            # sticky neighbor bucket with +20% headroom, so thermal
            # fluctuations of kmax at rc + skin do not change the shapes
            self._kpad = max(self._kpad, round_up(int(table.kmax * 1.2) + 4, 16))
            self.cfg = self.engine.make_config(
                system,
                npad=self._npad,
                kpad=self._kpad,
                table=table.pad_to(self._kpad),
            )
            self._cfg_key = key
        else:
            self.cfg = self.engine.update_positions(self.cfg, system)

    def _predict(self):
        n = len(self.system)
        ma = self.model.full_model_arrays()
        vs = self.model.vscale_for(self.cfg.numbers.cpu().numpy())
        # vs is inf for species without a vscale: beta is then inf too,
        # above every threshold, as the host formula has it
        e, f, w, cov, beta = self.engine.predict(self.cfg, ma, vs)
        # one device->host transfer per step
        e, f, w, beta = device_fetch(e, f, w, beta)
        energy = float(e) + self.model.mean_energy(self.system.numbers)
        forces = f[:n].astype(np.float64)
        try:
            stress = voigt6(w) / self.system.volume
        except ValueError:
            stress = np.zeros(6)
        self.results = {"energy": energy, "forces": forces, "stress": stress}
        self.maximum_force = float(np.abs(forces).max()) if n else inf
        self._beta = beta[:n].astype(np.float64)
        return self.results

    # -------------------------------------------------------------- output
    def log(self, msg, mode="a"):
        if self.logfile:
            stamp = time.strftime("%Y-%m-%d %H:%M:%S")
            line = f"{stamp} {self.step} {msg}"
            with open(self.logfile, mode) as fh:
                fh.write(line + "\n")
            if self.stdout:
                print(line)
