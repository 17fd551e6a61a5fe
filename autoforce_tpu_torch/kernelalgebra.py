"""Composable base-kernel algebra over descriptor similarities (torch port
of ``autoforce_tpu/kernelalgebra.py``).

Descriptors are unit-normalized, so every base kernel is a scalar function
of the dot product ``t = p·q`` in [-1, 1] (``SqD = ||p-q||² = 2 - 2t``,
``RBF = exp(-SqD/2l²) = exp((t-1)/l²)``).  A kernel expression is a small
immutable tree evaluated pointwise on the Gram ``dot`` matrix:

    expr = DotProd() ** 4 + 0.01 * White()
    expr = Exp(-(SqD() / Positive(0.5)))          # an RBF
    Engine(..., kernel=expr)

``value(t, xp=torch)`` evaluates on tensors; ``value_with_params`` takes
the flat parameter vector explicitly, so torch autograd gives the
gradients of the trainable ``Positive`` parameters (kernel HPO,
:mod:`.regression.hpo`).  Pass ``xp=np`` for host math.  ``White`` is a
same-environment (true diagonal) term only: cross covariances never see
it.

``expr.state`` is an eval-able constructor string, character for
character the JAX package's, so a model saved by either package loads in
the other; ``from_state`` rebuilds the expression.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "KernelExpr", "DotProd", "Normed", "SqD", "Positive", "Const",
    "Add", "Mul", "Pow", "Exp", "White", "RBF", "from_state",
]


def softplus(x, xp):
    if isinstance(x, torch.Tensor):
        return torch.logaddexp(x, torch.zeros_like(x))
    if xp is torch:
        return float(np.logaddexp(x, 0.0))
    return xp.logaddexp(x, 0.0)


def inv_softplus(y):
    y = float(y)
    if y <= 0:
        raise ValueError("Positive parameter must be > 0")
    return float(np.log(np.expm1(y))) if y < 30 else y


def _exp(x, xp):
    if isinstance(x, torch.Tensor):
        return torch.exp(x)
    return np.exp(x)


def _ones0(xp):
    """A 0-d one in float64 (torch's default type would be float32)."""
    if xp is torch:
        return torch.ones((), dtype=torch.float64)
    return xp.ones(())


def _wrap(x):
    if isinstance(x, KernelExpr):
        return x
    return Const(float(x))


@dataclass(frozen=True)
class KernelExpr:
    """Base node; subclasses define _value(t, params, xp)."""

    # ---------------------------------------------------------- evaluation
    def value(self, t, xp=torch):
        return self._value(t, self.params(), xp)

    def value_with_params(self, t, params, xp=torch):
        """Evaluate with an explicit flat parameter sequence
        (differentiable in it when it holds tensors)."""
        return self._value(t, list(params), xp)

    def _value(self, t, params, xp):
        raise NotImplementedError

    def white_diag(self, xp=torch):
        """Same-environment (i==i) additive variance of White terms."""
        return self._white(self.params(), xp)

    def _white(self, params, xp):
        # consume this subtree's parameters; no white contribution
        # (White composes through Add/Mul; inside Pow/Exp it is ignored)
        for _ in range(len(self.params())):
            params.pop(0)
        return 0.0

    # ---------------------------------------------------------- parameters
    def params(self):
        """Flat list of trainable parameter values (softplus free form)."""
        return []

    def with_params(self, params):
        """Rebuild the expression with a new flat parameter list."""
        expr, rest = self._rebuild(list(params))
        return expr

    def _rebuild(self, params):
        return self, params

    # ---------------------------------------------------------- operators
    def __add__(self, other):
        return Add(self, _wrap(other))

    __radd__ = __add__

    def __mul__(self, other):
        return Mul(self, _wrap(other))

    __rmul__ = __mul__

    def __pow__(self, n):
        return Pow(self, float(n))

    def __neg__(self):
        return Mul(Const(-1.0), self)

    def __sub__(self, other):
        return Add(self, -_wrap(other))

    def __truediv__(self, other):
        return Mul(self, Pow(_wrap(other), -1.0))

    # --------------------------------------------------------- persistence
    @property
    def state(self):
        raise NotImplementedError

    def __repr__(self):
        return self.state


def _ones_like(t, xp):
    if isinstance(t, torch.Tensor):
        return torch.ones_like(t)
    return np.ones_like(t)


def _zeros_like(t, xp):
    if isinstance(t, torch.Tensor):
        return torch.zeros_like(t)
    return np.zeros_like(t)


@dataclass(frozen=True)
class Const(KernelExpr):
    c: float = 1.0

    def _value(self, t, params, xp):
        return self.c * _ones_like(t, xp)

    @property
    def state(self):
        return f"Const({self.c!r})"


@dataclass(frozen=True)
class Positive(KernelExpr):
    """Trainable positive scalar, softplus-reparametrized."""

    v: float = 1.0

    def _value(self, t, params, xp):
        raw = params.pop(0)
        return softplus(raw, xp) * _ones_like(t, xp)

    def params(self):
        return [inv_softplus(self.v)]

    def _rebuild(self, params):
        raw = params.pop(0)
        return Positive(float(np.logaddexp(raw, 0.0))), params

    @property
    def state(self):
        return f"Positive({self.v!r})"


@dataclass(frozen=True)
class DotProd(KernelExpr):
    def _value(self, t, params, xp):
        return t

    @property
    def state(self):
        return "DotProd()"


class Normed(DotProd):
    """Alias of DotProd on pre-normalized descriptors."""

    @property
    def state(self):
        return "Normed()"


@dataclass(frozen=True)
class SqD(KernelExpr):
    """Squared descriptor distance ||p - q||^2 = 2 - 2 t on unit norms."""

    def _value(self, t, params, xp):
        return 2.0 - 2.0 * t

    @property
    def state(self):
        return "SqD()"


@dataclass(frozen=True)
class White(KernelExpr):
    """Same-environment noise: k(x, x') = signal^2 * delta(x is x')
    (cross covariances never include it)."""

    signal: float = 1.0
    trainable: bool = False

    def _value(self, t, params, xp):
        if self.trainable:
            params.pop(0)
        return _zeros_like(t, xp)

    def _white(self, params, xp):
        if self.trainable:
            return softplus(params.pop(0), xp) ** 2
        return self.signal**2

    def params(self):
        return [inv_softplus(self.signal)] if self.trainable else []

    def _rebuild(self, params):
        if self.trainable:
            raw = params.pop(0)
            return White(float(np.logaddexp(raw, 0.0)), True), params
        return self, params

    @property
    def state(self):
        return f"White({self.signal!r}, {self.trainable!r})"


@dataclass(frozen=True)
class Add(KernelExpr):
    a: KernelExpr = None
    b: KernelExpr = None

    def _value(self, t, params, xp):
        return self.a._value(t, params, xp) + self.b._value(t, params, xp)

    def _white(self, params, xp):
        return self.a._white(params, xp) + self.b._white(params, xp)

    def params(self):
        return self.a.params() + self.b.params()

    def _rebuild(self, params):
        a, params = self.a._rebuild(params)
        b, params = self.b._rebuild(params)
        return Add(a, b), params

    @property
    def state(self):
        return f"Add({self.a.state}, {self.b.state})"


@dataclass(frozen=True)
class Mul(KernelExpr):
    a: KernelExpr = None
    b: KernelExpr = None

    def _value(self, t, params, xp):
        return self.a._value(t, params, xp) * self.b._value(t, params, xp)

    def _white(self, params, xp):
        # (a + wa)(b + wb) diag extra: wa*b(1) + a(1)*wb + wa*wb
        pa = [params.pop(0) for _ in range(len(self.a.params()))]
        pb = [params.pop(0) for _ in range(len(self.b.params()))]
        wa = self.a._white(list(pa), xp)
        wb = self.b._white(list(pb), xp)
        a1 = self.a._value(_ones0(xp), list(pa), xp)
        b1 = self.b._value(_ones0(xp), list(pb), xp)
        return wa * (b1 + wb) + wb * a1

    def params(self):
        return self.a.params() + self.b.params()

    def _rebuild(self, params):
        a, params = self.a._rebuild(params)
        b, params = self.b._rebuild(params)
        return Mul(a, b), params

    @property
    def state(self):
        return f"Mul({self.a.state}, {self.b.state})"


@dataclass(frozen=True)
class Pow(KernelExpr):
    a: KernelExpr = None
    n: float = 1.0

    def _value(self, t, params, xp):
        return self.a._value(t, params, xp) ** self.n

    def params(self):
        return self.a.params()

    def _rebuild(self, params):
        a, params = self.a._rebuild(params)
        return Pow(a, self.n), params

    @property
    def state(self):
        return f"Pow({self.a.state}, {self.n!r})"


@dataclass(frozen=True)
class Exp(KernelExpr):
    a: KernelExpr = None

    def _value(self, t, params, xp):
        return _exp(self.a._value(t, params, xp), xp)

    def params(self):
        return self.a.params()

    def _rebuild(self, params):
        a, params = self.a._rebuild(params)
        return Exp(a), params

    @property
    def state(self):
        return f"Exp({self.a.state})"


def RBF(lengthscale=1.0, trainable=False):
    """Stationary RBF on unit-norm descriptors:
    exp(-||p-q||^2 / 2l^2) = exp((t-1)/l^2)."""
    if trainable:
        ell = Positive(lengthscale)
        return Exp(-(Mul(SqD(), Pow(Mul(Const(2.0), Mul(ell, ell)), -1.0))))
    c = 1.0 / (2.0 * lengthscale**2)
    return Exp(Mul(Const(-c), SqD()))


_NAMESPACE = {
    "Const": Const, "Positive": Positive, "DotProd": DotProd,
    "Normed": Normed, "SqD": SqD, "White": White, "Add": Add, "Mul": Mul,
    "Pow": Pow, "Exp": Exp, "RBF": RBF, "True": True, "False": False,
}


def from_state(state):
    """Rebuild an expression from its state string."""
    return eval(state, {"__builtins__": {}}, _NAMESPACE)  # noqa: S307
