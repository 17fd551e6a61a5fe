"""Sparse Gaussian process potential: host model state, serving subset
(port of ``autoforce_tpu/regression/sgpr.py``).

Holds what a frozen, trained model needs to serve predictions: the inducing
environments with their staged descriptors, the weights ``mu``, the
inverse Cholesky factor ``choli`` for the covloss uncertainty, the
per-species mean energy weights and predictive-variance scales.  Training
(data records, covariance blocks, solves) arrives with the learning slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..engine import Engine, ModelArrays


@dataclass
class InducingEnv:
    """A detached local environment (reference Local.detach, atoms.py:149-159)."""

    number: int  # central atomic number
    rvec: np.ndarray  # (k, 3) neighbor displacements
    numbers: np.ndarray  # (k,) neighbor atomic numbers
    desc: np.ndarray = None  # (D,) staged descriptor (current species table)
    lone: bool = False

    @classmethod
    def from_arrays(cls, number, rvec, numbers):
        rvec = np.asarray(rvec, dtype=np.float64).reshape(-1, 3)
        numbers = np.asarray(numbers, dtype=np.int32).reshape(-1)
        return cls(number=int(number), rvec=rvec, numbers=numbers,
                   lone=len(numbers) == 0)


class SgprModel:
    """Serving state of a trained SGPR model."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.X: list[InducingEnv] = []
        self.mu = np.zeros(0)
        self.choli = np.zeros((0, 0))
        self.mean_weights = {}
        self.vscale = {}
        self.stats = None
        self._model_arrays = None
        self._mcap = 0

    @property
    def m(self):
        return len(self.X)

    @property
    def ndata(self):
        return 0  # training data is not held by the serving model

    @property
    def size(self):
        return (self.ndata, self.m)

    def mean_energy(self, numbers):
        """Parametric per-species mean (AutoMean, gppotential.py:200-231)."""
        e = 0.0
        z, c = np.unique(np.asarray(numbers), return_counts=True)
        for zi, ci in zip(z, c):
            e += ci * self.mean_weights.get(int(zi), 0.0)
        return float(e)

    def restage(self):
        """Recompute the inducing descriptors through the engine (called when
        the species table grows, and at load), in float64 like the rest of
        the model state (Engine.model_dtype)."""
        if self.X:
            envs = self.engine.make_envs([(x.rvec, x.numbers) for x in self.X],
                                         dtype=self.engine.model_dtype)
            p, lone = self.engine.env_descriptors(envs)
            p = p.cpu().numpy().astype(np.float64)
            lone = lone.cpu().numpy()
            for i, x in enumerate(self.X):
                x.desc = p[i]
                x.lone = bool(lone[i])
        self._model_arrays = None

    def vscale_for(self, numbers):
        return np.array(
            [self.vscale.get(int(z), np.inf) for z in np.asarray(numbers)]
        )

    def full_model_arrays(self) -> ModelArrays:
        """Padded device model state (cached until the model changes); the
        inducing capacity grows in powers of two from 32."""
        if self._model_arrays is None:
            m = self.m
            D = self.engine.dim
            Xd = np.stack([x.desc for x in self.X]) if m else np.zeros((0, D))
            Xn = np.array([x.number for x in self.X], dtype=np.int32)
            Xl = np.array([x.lone for x in self.X], dtype=bool)
            mu = self.mu if len(self.mu) == m else np.zeros(m)
            ch = self.choli if self.choli.shape == (m, m) else np.zeros((m, m))
            mcap = max(self._mcap, 32)
            while mcap < m:
                mcap *= 2
            self._mcap = mcap
            self._model_arrays = self.engine.model_arrays(
                Xd, Xn, Xl, mu, ch, mcap=mcap
            )
        return self._model_arrays
