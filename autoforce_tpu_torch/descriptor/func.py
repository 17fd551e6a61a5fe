"""Composable scalar-function algebra (port of
``autoforce_tpu/descriptor/func.py``, the counterpart of
theforce/descriptor/func.py).

The reference builds radial terms like ``Exp(-0.5*I()**2/unit**2) *
PolyCut(rc)`` from ``Func`` objects that each return (value, gradient).
Here Funcs are callables on torch tensors — gradients come from torch
autograd — with named trainable parameters collected through the tree
(``params()``); positivity is enforced with a softplus reparametrization
like the reference's ``positive/free_form`` (regression/algebra.py:11-16).
A parameter's value may be a float or a tensor that carries a gradient.
"""

from __future__ import annotations

import numpy as np
import torch


def _float(d):
    """``d`` as a floating tensor (float64 unless it already floats)."""
    d = torch.as_tensor(d)
    return d if d.is_floating_point() else d.to(torch.float64)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y):
    return float(np.log(np.expm1(y)))


class Func:
    """f(d, params) with trainable parameters."""

    def params(self):
        """{name: initial_value} of free-form parameters."""
        return {}

    def __call__(self, d, params=None):
        raise NotImplementedError

    # algebra
    def __add__(self, other):
        return Add(self, _wrap(other))

    def __radd__(self, other):
        return Add(_wrap(other), self)

    def __mul__(self, other):
        return Mul(self, _wrap(other))

    def __rmul__(self, other):
        return Mul(_wrap(other), self)

    def __pow__(self, n):
        return Pow(self, n)

    def __neg__(self):
        return Negative(self)

    def value_and_grad(self, d, params=None):
        """(f, df/dd), matching the reference Func protocol (the Funcs are
        elementwise, so the gradient of the sum is df/dd)."""
        with torch.enable_grad():
            x = _float(d).detach().requires_grad_(True)
            f = self(x, params)
            (df,) = torch.autograd.grad(f.sum(), x)
        return f.detach(), df


class Const(Func):
    def __init__(self, value):
        self.value = float(value)

    def __call__(self, d, params=None):
        return torch.full_like(_float(d), self.value)


def _wrap(x):
    return x if isinstance(x, Func) else Const(x)


class I(Func):  # noqa: E742 - reference name
    def __call__(self, d, params=None):
        return torch.as_tensor(d)


class Param(Func):
    """Trainable positive or real scalar."""

    _count = 0

    def __init__(self, value=1.0, positive=True, name=None):
        Param._count += 1
        self.name = name or f"p{Param._count}"
        self.positive = positive
        self.init = float(value)

    def params(self):
        raw = inv_softplus(self.init) if self.positive else self.init
        return {self.name: raw}

    def __call__(self, d, params=None):
        d = _float(d)
        if params is None or self.name not in params:
            v = self.init
        else:
            v = torch.as_tensor(params[self.name], dtype=d.dtype,
                                device=d.device)
            if self.positive:
                v = softplus(v)
        return torch.ones_like(d) * v


class Add(Func):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def params(self):
        return {**self.a.params(), **self.b.params()}

    def __call__(self, d, params=None):
        return self.a(d, params) + self.b(d, params)


class Mul(Func):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def params(self):
        return {**self.a.params(), **self.b.params()}

    def __call__(self, d, params=None):
        return self.a(d, params) * self.b(d, params)


class Pow(Func):
    def __init__(self, a, n):
        self.a, self.n = a, n

    def params(self):
        return self.a.params()

    def __call__(self, d, params=None):
        return self.a(d, params) ** self.n


class Negative(Func):
    def __init__(self, a):
        self.a = a

    def params(self):
        return self.a.params()

    def __call__(self, d, params=None):
        return -self.a(d, params)


class Exp(Func):
    def __init__(self, a):
        self.a = _wrap(a)

    def params(self):
        return self.a.params()

    def __call__(self, d, params=None):
        return torch.exp(self.a(d, params))


class CutFunc(Func):
    """(1 - d/rc)^n * step(d < rc) as a Func (PolyCut)."""

    def __init__(self, rc, n=2):
        self.rc = float(rc)
        self.n = int(n)

    def __call__(self, d, params=None):
        d = _float(d)
        t = 1.0 - d / self.rc
        return torch.where(d < self.rc, t**self.n, torch.zeros_like(d))


class RepulsiveCore(Func):
    """1/d^eta (reference descriptor/radial.py:8-31)."""

    def __init__(self, eta=1):
        self.eta = eta

    def __call__(self, d, params=None):
        return _float(d) ** (-self.eta)


class ParamedRepulsiveCore(Func):
    """a * exp(b) / d^eta with trainable a, b (radial.py:34-75)."""

    def __init__(self, z=1.0, eta=1, name=None):
        self.eta = eta
        self.z = Param(z, positive=True, name=name)

    def params(self):
        return self.z.params()

    def __call__(self, d, params=None):
        return self.z(d, params) / _float(d) ** self.eta
