"""Forward-mode dual numbers for batched local Jacobians.

The JAX package takes each device's local Jacobian with ``jax.jacfwd`` of the
model's scalar eval under ``jax.vmap``.  The port carries the tangents by
hand instead: a :class:`Dual` holds a value ``v`` of shape ``[B]`` (one entry
per device instance and lane) and the tangents ``d`` of shape ``[K, B]``
(one row per local unknown), so one walk of a model yields (S, Q) and their
full local Jacobians (G, C).

The derivative of every operation follows the JAX package's differentiation
rules, including the ones that are not the textbook derivative: ``min`` and
``max`` split the derivative 1/2-1/2 at a tie (``lax.max``'s balanced rule),
and the NaN-safe ``pow``/``sqrt``/``log`` of the Verilog-A math set give 0
where the textbook derivative is infinite (``cedarsim_tpu/va/codegen.py``'s
``custom_jvp`` rules).  The Newton iterates of the two packages then follow
the same path, down to rounding.

Plain Python floats and tensors pass through every function here; only a
:class:`Dual` argument makes a :class:`Dual` result.
"""

from __future__ import annotations

import math

import torch


class Dual:
    """Value ``v`` [B] and tangents ``d`` [K, B]."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v = v
        self.d = d

    def __add__(self, b):
        if isinstance(b, Dual):
            return Dual(self.v + b.v, self.d + b.d)
        return Dual(self.v + b, self.d)

    def __radd__(self, b):
        return Dual(b + self.v, self.d)

    def __sub__(self, b):
        if isinstance(b, Dual):
            return Dual(self.v - b.v, self.d - b.d)
        return Dual(self.v - b, self.d)

    def __rsub__(self, b):
        return Dual(b - self.v, -self.d)

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __mul__(self, b):
        if isinstance(b, Dual):
            return Dual(self.v * b.v,
                        torch.addcmul(self.d * b.v, b.d, self.v))
        return Dual(self.v * b, self.d * b)

    def __rmul__(self, b):
        return Dual(b * self.v, self.d * b)

    def __truediv__(self, b):
        if isinstance(b, Dual):
            # lax.div's rule: da/b + (−db·a)·b⁻²
            return Dual(self.v / b.v,
                        self.d / b.v - b.d * (self.v / (b.v * b.v)))
        return Dual(self.v / b, self.d / b)

    def __rtruediv__(self, b):
        return Dual(b / self.v, self.d * (-b / (self.v * self.v)))


def val(x):
    """The value of ``x`` (a Dual's primal, anything else as it is)."""
    return x.v if isinstance(x, Dual) else x


def _tan(x):
    return x.d if isinstance(x, Dual) else 0.0


def _chain(y, x, g):
    """Dual(y, g·dx) when x is a Dual, else y."""
    if isinstance(x, Dual):
        return Dual(y, x.d * g)
    return y


def where(cond, a, b):
    """``torch.where`` over values and tangents (tangents are selected, not
    blended, so a NaN in the branch not taken never leaks)."""
    if isinstance(a, Dual) or isinstance(b, Dual):
        return Dual(torch.where(cond, val(a), val(b)),
                    torch.where(cond, _tan(a), _tan(b)))
    return torch.where(cond, a, b)


def maximum(a, b):
    av, bv = val(a), val(b)
    if not isinstance(av, torch.Tensor):
        av, a, b, bv = bv, b, a, av           # tensor first
    y = torch.maximum(av, bv) if isinstance(bv, torch.Tensor) \
        else torch.clamp(av, min=bv)
    if not (isinstance(a, Dual) or isinstance(b, Dual)):
        return y
    wa = torch.where(av > bv, 1.0, torch.where(av == bv, 0.5, 0.0))
    d = 0.0
    if isinstance(a, Dual):
        d = a.d * wa
    if isinstance(b, Dual):
        d = d + b.d * (1.0 - wa)
    return Dual(y, d)


def minimum(a, b):
    av, bv = val(a), val(b)
    if not isinstance(av, torch.Tensor):
        av, a, b, bv = bv, b, a, av
    y = torch.minimum(av, bv) if isinstance(bv, torch.Tensor) \
        else torch.clamp(av, max=bv)
    if not (isinstance(a, Dual) or isinstance(b, Dual)):
        return y
    wa = torch.where(av < bv, 1.0, torch.where(av == bv, 0.5, 0.0))
    d = 0.0
    if isinstance(a, Dual):
        d = a.d * wa
    if isinstance(b, Dual):
        d = d + b.d * (1.0 - wa)
    return Dual(y, d)


def exp(x):
    y = torch.exp(val(x))
    return _chain(y, x, y)


def safe_log(x):
    v = val(x)
    y = torch.log(v)
    if not isinstance(x, Dual):
        return y
    pos = v > 0
    return Dual(y, x.d * torch.where(pos, 1.0 / torch.where(pos, v, 1.0),
                                     0.0))


def safe_log10(x):
    return safe_log(x) * (1.0 / math.log(10.0))


def safe_sqrt(x):
    v = val(x)
    y = torch.sqrt(v)
    if not isinstance(x, Dual):
        return y
    pos = v > 0
    return Dual(y, x.d * torch.where(pos, 0.5 / torch.where(pos, y, 1.0),
                                     0.0))


def safe_pow(a, b):
    av, bv = val(a), val(b)
    y = torch.pow(av, bv)
    if not (isinstance(a, Dual) or isinstance(b, Dual)):
        return y
    d = 0.0
    if isinstance(a, Dual):
        nz = av != 0
        ga = torch.where(nz, bv * torch.pow(torch.where(nz, av, 1.0),
                                            bv - 1.0), 0.0)
        d = a.d * ga
    if isinstance(b, Dual):
        pos = av > 0
        gb = torch.where(pos, torch.log(torch.where(pos, av, 1.0)) * y, 0.0)
        d = d + b.d * gb
    return Dual(y, d)


def absolute(x):
    v = val(x)
    return _chain(torch.abs(v), x, torch.sign(v))


def limexp(x, lim=80.0):
    """exp with a linear tail beyond ``lim`` (the f64 cap of the JAX
    package's ``_limexp``), written from the same primitives so its
    derivative follows theirs."""
    xe = exp(minimum(x, lim))
    return where(val(x) <= lim, xe, math.exp(lim) * (1.0 + (x - lim)))


def floor(x):
    return torch.floor(val(x)) if not isinstance(x, Dual) else \
        Dual(torch.floor(x.v), x.d * 0.0)


def ceil(x):
    return torch.ceil(val(x)) if not isinstance(x, Dual) else \
        Dual(torch.ceil(x.v), x.d * 0.0)


def _unary(f, df):
    def g(x):
        v = val(x)
        y = f(v)
        if not isinstance(x, Dual):
            return y
        return Dual(y, x.d * df(v, y))
    return g


sin = _unary(torch.sin, lambda v, y: torch.cos(v))
cos = _unary(torch.cos, lambda v, y: -torch.sin(v))
tan = _unary(torch.tan, lambda v, y: 1.0 + y * y)
asin = _unary(torch.asin, lambda v, y: torch.rsqrt(1.0 - v * v))
acos = _unary(torch.acos, lambda v, y: -torch.rsqrt(1.0 - v * v))
atan = _unary(torch.atan, lambda v, y: 1.0 / (1.0 + v * v))
sinh = _unary(torch.sinh, lambda v, y: torch.cosh(v))
cosh = _unary(torch.cosh, lambda v, y: torch.sinh(v))
tanh = _unary(torch.tanh, lambda v, y: 1.0 - y * y)
asinh = _unary(torch.asinh, lambda v, y: torch.rsqrt(v * v + 1.0))
acosh = _unary(torch.acosh, lambda v, y: torch.rsqrt((v - 1.0) * (v + 1.0)))
atanh = _unary(torch.atanh, lambda v, y: 1.0 / (1.0 - v * v))


def _as_tensor_like(x, like):
    return x if isinstance(x, torch.Tensor) else torch.full_like(like, x)


def atan2(a, b):
    av, bv = val(a), val(b)
    like = av if isinstance(av, torch.Tensor) else bv
    av, bv = _as_tensor_like(av, like), _as_tensor_like(bv, like)
    y = torch.atan2(av, bv)
    if not (isinstance(a, Dual) or isinstance(b, Dual)):
        return y
    den = av * av + bv * bv
    return Dual(y, _tan(a) * (bv / den) - _tan(b) * (av / den))


def hypot(a, b):
    av, bv = val(a), val(b)
    like = av if isinstance(av, torch.Tensor) else bv
    av, bv = _as_tensor_like(av, like), _as_tensor_like(bv, like)
    y = torch.hypot(av, bv)
    if not (isinstance(a, Dual) or isinstance(b, Dual)):
        return y
    return Dual(y, _tan(a) * (av / y) + _tan(b) * (bv / y))


def fmod(a, b):
    av, bv = val(a), val(b)
    like = av if isinstance(av, torch.Tensor) else bv
    av, bv = _as_tensor_like(av, like), _as_tensor_like(bv, like)
    y = torch.fmod(av, bv)
    if not (isinstance(a, Dual) or isinstance(b, Dual)):
        return y
    q = av / bv
    return Dual(y, _tan(a) - _tan(b) * (torch.sign(q) * torch.floor(
        torch.abs(q))))
