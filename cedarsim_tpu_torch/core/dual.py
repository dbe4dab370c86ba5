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
:class:`Dual` argument makes a :class:`Dual` result.  Where every argument
is a Python float (a built-in device's static params) the result is a
Python float, computed in float64 with NaN and infinity as numpy gives them.

Two sets of rules live here.  ``safe_sqrt``, ``safe_log`` and ``safe_pow``
are the Verilog-A math set of the interpreter (its ``abs`` is ``fabs``,
``absolute``).  ``sqrt``, ``log``, ``power``, ``fabs`` and the rounding
functions follow
``jax.numpy``'s own (``lax``) rules, which the JAX package's built-in
devices (``cedarsim_tpu/devices/``) and behavioral sources differentiate
with: √x's tangent is 0.5/√x, log's 1/x, xʸ's y·xʸ⁻¹ and log(x)·xʸ (x = 0
read as 1 in the log), |x|'s ±1 with +1 at 0, and the rounding functions'
and sign's 0.
"""

from __future__ import annotations

import math

import numpy as np
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
        return Dual(rdiv(b, self.v), self.d * rdiv(-b, self.v * self.v))


def rdiv(b, v):
    """``b / v``.  A number ``b`` over a float64 tensor ``v`` is one IEEE
    division, as ``lax.div`` and the emitted walk divide (a tensor's own
    ``b / v`` is ``v.reciprocal() * b``, two roundings: at the pass
    switch's tie that left OUT 1.4e-34 V off the JAX package's 0, ROADMAP
    C18).  Over float32 values it stays ``v.reciprocal() * b``, which the
    float32 tier's recorded counts and bounds follow (C18, open for
    float32); every other pair is ``b / v``."""
    if (isinstance(v, torch.Tensor) and v.dtype == torch.float64
            and not isinstance(b, (torch.Tensor, Dual))):
        return torch.div(b, v)
    return b / v


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


def is_scalar(x):
    """True for a Python number (no tensor, no Dual)."""
    return not isinstance(x, (torch.Tensor, Dual))


def scalar_op(f, *a):
    """``f`` of Python floats in float64 (numpy's NaN and infinity, no
    exception), as a Python float."""
    with np.errstate(all="ignore"):
        return float(f(*(np.float64(v) for v in a)))


def where(cond, a, b):
    """``torch.where`` over values and tangents (tangents are selected, not
    blended, so a NaN in the branch not taken never leaks).  A condition
    that is no tensor (a test on static params) picks its side on the
    host."""
    if not isinstance(cond, torch.Tensor):
        return a if cond else b
    if isinstance(a, Dual) or isinstance(b, Dual):
        return Dual(torch.where(cond, val(a), val(b)),
                    torch.where(cond, _tan(a), _tan(b)))
    return torch.where(cond, a, b)


def maximum(a, b):
    av, bv = val(a), val(b)
    if is_scalar(av) and is_scalar(bv):
        return scalar_op(np.maximum, av, bv)
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
    if is_scalar(av) and is_scalar(bv):
        return scalar_op(np.minimum, av, bv)
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
    if is_scalar(x):
        return scalar_op(np.exp, x)
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


def limexp_cap(x):
    """The Verilog-A ``limexp``'s cap for ``x``: 80, or 55 when ``x`` is
    float32, where e^80·(1 + x − 80) overflows once x passes ~6,000 (the
    JAX package's ``_limexp_cap``)."""
    v = val(x)
    return 55.0 if (isinstance(v, torch.Tensor)
                    and v.dtype == torch.float32) else 80.0


def limexp(x, lim=None):
    """exp with a linear tail beyond ``lim``, written from the same
    primitives as the JAX package's so its derivative follows theirs.  The
    default is the Verilog-A ``limexp``'s cap (:func:`limexp_cap`); the
    built-in devices' ``_limexp`` passes its own 40."""
    if lim is None:
        lim = limexp_cap(x)
    xe = exp(minimum(x, lim))
    return where(val(x) <= lim, xe, math.exp(lim) * (1.0 + (x - lim)))


def _flat(f, npf):
    """A piecewise-constant function: the value, and a zero tangent."""
    def g(x):
        if is_scalar(x):
            return scalar_op(npf, x)
        if not isinstance(x, Dual):
            return f(x)
        return Dual(f(x.v), x.d * 0.0)
    return g


floor = _flat(torch.floor, np.floor)
ceil = _flat(torch.ceil, np.ceil)
trunc = _flat(torch.trunc, np.trunc)
rint = _flat(torch.round, np.rint)       # ties to even, as jnp.round
sign = _flat(torch.sign, np.sign)


# ------------------------------------------------ jax.numpy's (lax) rules

def sqrt(x):
    """√x with lax's tangent 0.5/√x (infinite at 0, NaN below)."""
    if is_scalar(x):
        return scalar_op(np.sqrt, x)
    y = torch.sqrt(val(x))
    return _chain(y, x, 0.5 / y) if isinstance(x, Dual) else y


def log(x):
    """log x with lax's tangent dx/x."""
    if is_scalar(x):
        return scalar_op(np.log, x)
    v = val(x)
    y = torch.log(v)
    return Dual(y, x.d / v) if isinstance(x, Dual) else y


def power(a, b):
    """aᵇ (``lax.pow``) with its tangents: b·aᵇ⁻¹ for a, and log(a)·aᵇ
    for b with a = 0 read as 1 in the log."""
    av, bv = val(a), val(b)
    if is_scalar(av) and is_scalar(bv):
        return scalar_op(np.power, av, bv)
    y = torch.pow(av, bv)
    if not (isinstance(a, Dual) or isinstance(b, Dual)):
        return y
    d = 0.0
    if isinstance(a, Dual):
        d = a.d * (bv * torch.pow(av, bv - 1.0))
    if isinstance(b, Dual):
        az = torch.where(av == 0, 1.0, av) if isinstance(av, torch.Tensor) \
            else (1.0 if av == 0 else av)
        lg = torch.log(az) if isinstance(az, torch.Tensor) else \
            scalar_op(np.log, az)
        d = d + b.d * (lg * y)
    return Dual(y, d)


def fabs(x):
    """|x| with lax's tangent: +dx where x >= 0, else -dx, so +1 at 0 in
    every dtype (``jnp.abs``'s ``select(x >= 0, g, -g)``)."""
    if is_scalar(x):
        return abs(float(x))
    v = val(x)
    y = torch.abs(v)
    if not isinstance(x, Dual):
        return y
    return Dual(y, torch.where(v >= 0, x.d, -x.d))


#: the Verilog-A ``abs``, ``fabs``'s rule (ROADMAP C17): BSIM4 takes ``vds
#: = abs(vds_r)``, so at a drain exactly on its source (a closed switch at
#: zero bias, a DC from zeros) sign(0) = 0 would drop the device's output
#: conductance
absolute = fabs


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
