"""Behavioral (B-element) arbitrary-expression sources — counterpart of
``cedarsim_tpu/frontend/behavioral.py``.

The expression AST (``frontend/expr.py``) is evaluated on every model walk
with PyTorch operations on tensors and :class:`~cedarsim_tpu_torch.core.
dual.Dual` numbers, each taking ``jax.numpy``'s differentiation rule, as the
JAX package's ``_eval_jax`` does under ``jacfwd``.  ``V(a[,b])`` and
``I(Vsrc)`` probes become control unknowns resolved by the compiler, so a
behavioral source enters the Jacobian like any device.  A subexpression of
constants only is a Python float, computed in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cedarsim_tpu_torch.core import dual as D
from cedarsim_tpu_torch.core.dual import val
from cedarsim_tpu_torch.devices.base import DeviceModel


def _f1(dual_fn, np_fn):
    """A function of one argument: numpy on a Python float, else the
    dual-number function."""
    def f(x):
        return D.scalar_op(np_fn, x) if D.is_scalar(x) else dual_fn(x)
    return f


def _log10(x):
    return D.log(x) / math.log(10.0)


_FUNCS1 = {
    "sin": _f1(D.sin, np.sin), "cos": _f1(D.cos, np.cos),
    "tan": _f1(D.tan, np.tan), "asin": _f1(D.asin, np.arcsin),
    "acos": _f1(D.acos, np.arccos), "atan": _f1(D.atan, np.arctan),
    "arctan": _f1(D.atan, np.arctan), "sinh": _f1(D.sinh, np.sinh),
    "cosh": _f1(D.cosh, np.cosh), "tanh": _f1(D.tanh, np.tanh),
    "exp": D.exp, "ln": D.log, "log": D.log,
    "log10": _f1(_log10, np.log10), "sqrt": D.sqrt, "abs": D.fabs,
    "int": D.trunc, "floor": D.floor, "ceil": D.ceil, "sgn": D.sign,
    "nint": D.rint,
}


def _pwr(a, b):
    return _mul(D.sign(a), D.power(D.fabs(a), b))


def _fmod(a, b):
    if D.is_scalar(a) and D.is_scalar(b):
        return D.scalar_op(np.fmod, a, b)
    return D.fmod(a, b)


def _atan2(a, b):
    if D.is_scalar(a) and D.is_scalar(b):
        return D.scalar_op(np.arctan2, a, b)
    return D.atan2(a, b)


_FUNCS2 = {"pow": D.power, "pwr": _pwr, "min": D.minimum, "max": D.maximum,
           "atan2": _atan2}

_ARITH = {"+": (lambda a, b: a + b, np.add),
          "-": (lambda a, b: a - b, np.subtract),
          "*": (lambda a, b: a * b, np.multiply),
          "/": (lambda a, b: a / b, np.divide)}


def _mul(a, b):
    return _ARITH["*"][0](a, b) if not (D.is_scalar(a) and D.is_scalar(b)) \
        else D.scalar_op(np.multiply, a, b)


_CMP = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b,
        "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
        ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
        "&&": lambda a, b: (a != 0) & (b != 0),
        "||": lambda a, b: (a != 0) | (b != 0)}


def _truth(x, *operands):
    """1.0 / 0.0 for a test on values (no tangent), a float for floats: in
    the floating dtype of the tensor ``operands`` (float64 without one),
    as the JAX package's ``result_type(a, b, 1.0)``."""
    if isinstance(x, torch.Tensor):
        dts = [o.dtype for o in operands
               if isinstance(o, torch.Tensor) and o.is_floating_point()]
        dt = torch.float64
        if dts:
            dt = dts[0]
            for d in dts[1:]:
                dt = torch.promote_types(dt, d)
        return x.to(dt)
    return 1.0 if x else 0.0


def collect_probes(ast):
    """Ordered unique probe list [("v", a, b|None) | ("i", name)] from a
    behavioral expression AST."""
    probes = []

    def walk(e):
        if not isinstance(e, tuple):
            return
        k = e[0]
        if k == "call":
            name = e[1].lower()
            if name == "v" and e[2]:
                args = []
                for a in e[2]:
                    if a[0] != "ref":
                        raise ValueError("V() probe arguments must be node "
                                         "names")
                    args.append(a[1].lower())
                key = ("v", args[0], args[1] if len(args) > 1 else None)
                if key not in probes:
                    probes.append(key)
                return
            if name == "i" and e[2]:
                a = e[2][0]
                if a[0] != "ref":
                    raise ValueError("I() probe argument must be a source "
                                     "name")
                key = ("i", a[1].lower())
                if key not in probes:
                    probes.append(key)
                return
            for a in e[2]:
                walk(a)
        elif k == "bin":
            walk(e[2])
            walk(e[3])
        elif k in ("neg", "not"):
            walk(e[1])
        elif k == "cond":
            walk(e[1])
            walk(e[2])
            walk(e[3])

    walk(ast)
    return probes


def eval_expr(ast, probe_vals, env, ctx):
    """A behavioral expression on tensors and Duals (the counterpart of
    the JAX package's ``_eval_jax``): ``probe_vals`` maps each probe to
    its value, ``env`` holds the parameters resolved at elaboration."""

    def ev(e):
        k = e[0]
        if k == "num":
            return float(e[1])
        if k == "ref":
            n = e[1].lower()
            if n in env:
                return float(env[n])
            if n == "time":
                return ctx.time
            if n in ("temper", "temp"):
                return ctx.temp - 273.15
            if n in ("pi", "m_pi"):
                return math.pi
            raise ValueError(f"behavioral expression: undefined {e[1]!r}")
        if k == "neg":
            x = ev(e[1])
            return -float(x) if D.is_scalar(x) else -x
        if k == "not":
            x = val(ev(e[1]))
            return _truth(x == 0, x)
        if k == "bin":
            op = e[1]
            a, b = ev(e[2]), ev(e[3])
            if op in _ARITH:
                t_op, n_op = _ARITH[op]
                if D.is_scalar(a) and D.is_scalar(b):
                    return D.scalar_op(n_op, a, b)
                return t_op(a, b)
            if op == "%":
                return _fmod(a, b)
            if op in ("**", "^"):
                return D.power(a, b)
            return _truth(_CMP[op](val(a), val(b)), val(a), val(b))
        if k == "cond":
            c = val(ev(e[1]))
            return D.where(c != 0, ev(e[2]), ev(e[3]))
        if k == "call":
            name = e[1].lower()
            if name == "v":
                args = [a[1].lower() for a in e[2]]
                key = ("v", args[0], args[1] if len(args) > 1 else None)
                return probe_vals[key]
            if name == "i":
                return probe_vals[("i", e[2][0][1].lower())]
            vals = [ev(a) for a in e[2]]
            if name in _FUNCS1:
                return _FUNCS1[name](*vals)
            if name in _FUNCS2:
                return _FUNCS2[name](*vals)
            raise ValueError(f"behavioral expression: unknown function "
                             f"{e[1]!r}")
        raise ValueError(f"bad behavioral AST node {e!r}")

    return ev(ast)


def make_bsource(kind: str, ast, probes, const_env: dict, label: str):
    """Build a DeviceModel class for one behavioral source.

    ``kind``: 'v' or 'i'.  ``probes``: from collect_probes (its order defines
    the control-slot layout).  ``const_env``: parameter name -> float values
    resolved at elaboration.
    """
    n_ctrl = sum(2 if p[0] == "v" and p[2] is not None else 1
                 for p in probes)
    is_v = kind == "v"

    class BSource(DeviceModel):
        terminals = ("p", "n")
        n_branch = 1 if is_v else 0
        n_control = n_ctrl
        params = {}

        @classmethod
        def group_key(cls, inst_params):
            return f"BSource[{label}]"

        @staticmethod
        def eval(lv, p, ctx, eps):
            off = 2 + (1 if is_v else 0)
            probe_vals = {}
            for pr in probes:
                if pr[0] == "v" and pr[2] is not None:
                    probe_vals[pr] = lv[off] - lv[off + 1]
                    off += 2
                else:
                    probe_vals[pr] = lv[off]
                    off += 1
            v = eval_expr(ast, probe_vals, const_env, ctx)
            v = _mul(v, ctx.sourcefac)
            if is_v:
                return [lv[2], -lv[2], lv[0] - lv[1] - v], [0.0] * 3
            return [v, -v if not D.is_scalar(v) else -float(v)], [0.0, 0.0]

    BSource.__name__ = f"BSource_{label}"
    return BSource


def probe_extras(probes, net_fn, prefix):
    """Probes as the compiler's control refs, through the elaborator's net
    resolver."""
    extras = []
    for p in probes:
        if p[0] == "v":
            extras.append(("net", net_fn(p[1])))
            if p[2] is not None:
                extras.append(("net", net_fn(p[2])))
        else:
            extras.append(("branch", prefix + p[1]))
    return extras
