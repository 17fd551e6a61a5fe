"""Radial cutoff functions and per-species radii (torch port of
``autoforce_tpu/descriptor/radial.py``).

Mirrors the reference's PolyCut (theforce/descriptor/cutoff.py:33-48) and
the ``Radii`` family (theforce/descriptor/sesoap.py:14-99), reshaped for
array programming: radii are materialized as a dense per-species-table
vector before they reach the device.
"""

from __future__ import annotations

import numpy as np
import torch


class PolyCut:
    """f(d) = (1 - d/rc)^n for d < rc else 0."""

    def __init__(self, cutoff, n=2):
        self.rc = float(cutoff)
        self.n = int(n)

    def __call__(self, d):
        t = 1.0 - d / self.rc
        return torch.where(d < self.rc, t**self.n, torch.zeros_like(t))

    @property
    def state(self):
        return f"PolyCut({self.rc}, n={self.n})"

    def __repr__(self):
        return self.state


class Radii:
    def get(self, number):
        raise NotImplementedError

    def table(self, species):
        """Dense radii vector aligned with a species table (list of Z)."""
        return np.array([self.get(int(z)) for z in species], dtype=np.float64)

    def __repr__(self):
        return self.state

    @property
    def state(self):
        return f"{self.__class__.__name__}({self.state_args})"


class UniformRadii(Radii):
    def __init__(self, value=1.0):
        self.value = float(value)

    def get(self, number):
        return self.value

    @property
    def state_args(self):
        return str(self.value)


class RadiiFromDict(Radii):
    def __init__(self, d):
        self.d = dict(d)

    def get(self, number):
        return self.d[number]

    @property
    def state_args(self):
        return str({int(z): float(r) for z, r in self.d.items()})


class RadiiFromArray(Radii):
    """Radii indexed by atomic number (reference sesoap.py:55-64)."""

    def __init__(self, d):
        self.d = list(d)

    def get(self, number):
        return self.d[number]

    @property
    def state_args(self):
        return str([float(z) for z in self.d])


class SpecialRadii(Radii):
    """Dict with a default for unlisted species (sesoap.py:67-81)."""

    def __init__(self, dct, others=1.0):
        self.dct = dict(dct)
        self.others = float(others)

    def get(self, number):
        return self.dct.get(number, self.others)

    @property
    def state_args(self):
        return f"{self.dct}, {self.others}"


class DefaultRadii(Radii):
    """Default 1.0, hydrogen 0.5 (reference sesoap.py:84-99)."""

    def __init__(self, default=1.0, special=None):
        self.default = float(default)
        self.special = {1: 0.5} if special is None else dict(special)

    def get(self, number):
        return self.special.get(number, self.default)

    @property
    def state_args(self):
        return f"{self.default}, {self.special}"


def as_radii(radii):
    if isinstance(radii, Radii):
        return radii
    if isinstance(radii, (int, float)):
        return UniformRadii(radii)
    if isinstance(radii, dict):
        return RadiiFromDict(radii)
    if isinstance(radii, (list, tuple)):
        return RadiiFromArray(radii)
    raise TypeError(f"cannot interpret radii: {radii!r}")
