"""Bayesian committee machine (BCM) of SGPR experts (port of
``autoforce_tpu/calculator/bcm.py``).

When a single sparse model saturates (``max_data`` / ``max_inducing``), it
is frozen as an expert and a fresh model keeps learning.  Predictions
combine all experts with the weights ``scale_k = -log(covmax_k) /
covmax_k``; sampling thresholds use the min covloss over the experts.
Experts are saved as ``<head>_k.pckl`` folders and found again on
restart.  On the card every expert's predict is dispatched before any
host read, so the experts' launches queue back to back.
"""

from __future__ import annotations

import os

import numpy as np

from ..engine import device_fetch, voigt6
from ..regression.sgpr import SgprModel
from .active import ActiveCalculator


def servable(models):
    """The solved, non-empty models of ``models``."""
    return [m for m in models if m.m > 0 and len(m.mu) == m.m]


class BCMActiveCalculator(ActiveCalculator):
    def __init__(self, covariance=None, pckl="model.pckl", tape=None,
                 max_data=8, max_inducing=256, **kw):
        self.pckl_head = pckl[:-5] if pckl and pckl.endswith(".pckl") else pckl
        self.experts: dict[str, SgprModel] = {}
        # restart: the expert folders <head>_1.pckl, <head>_2.pckl, ...;
        # the last one found is the live model
        self.pckl_id = 1
        used = []
        while self.pckl_head and os.path.isdir(self._pckl_path(self.pckl_id)):
            used.append(self.pckl_id)
            self.pckl_id += 1
        if used:
            from ..io.model_io import load_model

            for k in used[:-1]:
                self.experts[self._key(k)] = load_model(
                    self._pckl_path(k), device=kw.get("device", "cuda"),
                    dtype=kw.get("dtype"))
            self.pckl_id = used[-1]
        cur_pckl = self._pckl_path(self.pckl_id) if self.pckl_head else None
        cur_tape = (
            tape
            if tape is not None
            else (self._key(self.pckl_id) + ".sgpr" if self.pckl_head else None)
        )
        super().__init__(
            covariance=covariance if covariance is not None else "pckl",
            pckl=cur_pckl,
            tape=cur_tape,
            max_data=max_data,
            max_inducing=max_inducing,
            **kw,
        )
        # every expert shares the live engine's species table, neighbor
        # species included: an expert environment whose neighbors are
        # missing from the table would restage with them masked out
        for ex in self.experts.values():
            for x in ex.X:
                self.engine.ensure_species(
                    np.concatenate([[x.number], x.numbers])
                )

    def _untrained(self):
        """A committee with solved frozen experts serves even while the
        freshly spawned live model is still empty."""
        return self.size[1] == 0 and not servable(self.experts.values())

    def _key(self, k):
        return f"{self.pckl_head}_{k}"

    def _pckl_path(self, k):
        return self._key(k) + ".pckl"

    # ----------------------------------------------------------- prediction
    def _expert_dispatch(self, model):
        """Launch one expert's predict on the live engine's configuration;
        returns device tensors without waiting for them."""
        model.adopt_engine(self.engine)
        ma = model.full_model_arrays()
        vs = model.vscale_for(self._padded_numbers())
        return self.engine.predict(self.cfg, ma, vs)

    def _predict(self):
        n = len(self.system)
        models = servable([*self.experts.values(), self.model])
        if not models:
            return super()._predict()
        # phase 1: dispatch every expert; phase 2: one host read for all
        pending = [(m, self._expert_dispatch(m)) for m in models]
        arrays = []
        for model, (e, f, w, cov, beta) in pending:
            arrays += [e, f, w, beta]
            if model is self.model:
                arrays.append(cov[:n, : model.m])
        host = iter(device_fetch(*arrays))
        parts = []
        expert_floor = None
        for model, _ in pending:
            e, f, w, beta = (next(host) for _ in range(4))
            beta = beta[:n].astype(np.float64)
            covmax = float(beta.max()) if len(beta) else 1.0
            covmax = min(max(covmax, 1e-12), 1.0)
            scale = (-np.log(covmax) if covmax < 1.0 else 0.0) / covmax
            energy = float(e) + model.mean_energy(self.system.numbers)
            parts.append((scale, energy, f[:n].astype(np.float64),
                          w.astype(np.float64)))
            if model is self.model:
                self._cov = next(host).astype(np.float64)
                self._beta_dev = None
                self._desc = None
            else:
                expert_floor = (beta if expert_floor is None
                                else np.minimum(expert_floor, beta))
        # frozen experts never change inside a step: their beta floor is
        # kept, so the sampling loop re-evaluates only the live model
        self._expert_beta_floor = expert_floor
        tot = sum(p[0] for p in parts)
        if tot <= 0:
            tot = len(parts)
            parts = [(1.0, *p[1:]) for p in parts]
        self.weights = np.array([p[0] for p in parts]) / tot
        energy = sum(s * e for s, e, f, w in parts) / tot
        forces = sum(s * f for s, e, f, w in parts) / tot
        w = sum(s * w for s, e, f, w in parts) / tot
        try:
            stress = voigt6(w) / self.system.volume
        except ValueError:
            stress = np.zeros(6)
        self.results = {"energy": energy, "forces": forces, "stress": stress}
        self.maximum_force = float(np.abs(forces).max()) if n else np.inf
        return self.results

    def _host_beta(self):
        """The min covloss over the committee: the frozen experts' floor
        from the last predict, the live model's beta recomputed."""
        beta = super()._host_beta()
        floor = getattr(self, "_expert_beta_floor", None)
        if floor is not None:
            beta = np.minimum(beta, floor[: len(beta)])
        return beta

    def optimize_kernel(self):
        """Kernel HPO under a committee: the shared kernel moved, so every
        frozen expert's covariance blocks are rebuilt too."""
        moved = super().optimize_kernel()
        if moved:
            for ex in self.experts.values():
                ex.adopt_engine(self.engine)
                ex.rebuild_kernel_matrices(remake=True)
        return moved

    # ------------------------------------------------------------- spawning
    def update(self, inducing=True, data=True):
        m, n = super().update(inducing=inducing, data=data)
        if (
            self.model.ndata >= self.max_data
            or self.model.m >= self.max_inducing
        ):
            self.spawn_expert()
        return m, n

    def spawn_expert(self):
        """Freeze the current model as an expert, save it, and start a
        fresh one with the same kernel configuration."""
        if self.model.m == 0:
            return
        self.save_model()
        self.experts[self._key(self.pckl_id)] = self.model
        self.log(
            f"BCM: froze expert {self.pckl_id} "
            f"(size {self.model.ndata} {self.model.m}); starting fresh"
        )
        self.pckl_id += 1
        if self.pckl_head:
            self.pckl = self._pckl_path(self.pckl_id)
            from ..io.tape import SgprTape

            self.tape = SgprTape(self._key(self.pckl_id) + ".sgpr")
        # a full-configuration clone: pair terms, chemical similarity and
        # the base kernel survive the freeze
        self.model = SgprModel(self.engine.clone_config())
