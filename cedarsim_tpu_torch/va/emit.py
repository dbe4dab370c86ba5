"""Verilog-A → CUDA C++ emitter: one nonlinear device group's ``eval`` as a
straight-line function.

The fused chord kernel (``ops/fused_chord.py``, ``csrc/fused_chord.cu``)
evaluates the nonlinear models inside its Newton loop, the way the Pallas
kernel runs ``model.eval`` under ``jax.jvp`` inside the kernel
(``cedarsim_tpu/ops/fused_chord.py:496-524``).  This module writes that walk
as device code, cut in two::

    __host__ __device__ void <name>_pre(const double* dyn, double t,
        double* h)
    __host__ __device__ void <name>(const double* lv, const double* lvd,
        const double* h, double* s, double* q, double* qd)

``dyn``: the instance's dynamic params in :func:`dyn_names` order; ``t``:
the time; ``lv``/``lvd``: its local unknowns and their tangent.
``<name>_pre`` computes every node that depends on no local unknown or
tangent (for BSIM4, the size- and temperature-dependent parameter
algebra) and writes the values the rest reads into ``h``; ``<name>``
computes the rest from ``lv``, ``lvd`` and ``h``.  A chord loop runs the
first once and the second at every evaluation.  Together they are the
same operations in the same order as one walk, so they give the same
bits.  Outputs: the static rows ``s``, the charge rows ``q`` and the
tangent of the charge rows along ``lvd`` (``qd``), exactly what
``CompiledCircuit.evaluate(..., v=...)`` gives per instance before the
scatter.

The emitter does not restate any model: it runs the model's own ``eval``
(for a Verilog-A device, the port's interpreter ``va/codegen.py``) once on
placeholder tensors (:class:`_Sym`) that record every torch call made on
them, with each local unknown a single-tangent
:class:`~cedarsim_tpu_torch.core.dual.Dual`.  So the derivative rules, the
NaN-safe ``pow``/``sqrt``/``log``, ``limexp`` and the select-not-blend
``where`` are those of the eager path.  Host constant folding is unchanged:
static params and the context (temperature, gmin, mode) are Python floats
and fold into literals; a branch on a dynamic value is recorded as a select
``c ? a : b`` of two computed sides, never as arithmetic.

The recording is hash-consed (equal operations on equal operands are one
node), pruned to what the outputs need and numbered in depth-first order
from the outputs, so the text, and its hash, do not depend on the order the
walk visited the model's variables in.

Integer and bitwise Verilog-A arithmetic take the JAX interpreter's meaning
(``cedarsim_tpu/va/codegen.py:1532-1546``): a cast to ``int32`` (``int``
in C, saturating, NaN to 0, as XLA converts), ``& | ^ ~ << >>`` on the
``int32`` values (a shift by 32 or more, or by a negative count, gives 0,
or the sign for ``>>``, as XLA's shifts), and the result back to the
model's float type; ``%`` is ``fmod``.  A constant tensor whose entries
differ (a point-list param, such as a piecewise-linear table) becomes a
``static const double`` table in the walk, named by the hash of its
values; the walk reads it through ``searchsorted`` and indexing.  Headers
that use none of these are the bytes they were before they were taken
(their helper block is emitted only where one is used).

Float32: ``emit_group(..., dtype=torch.float32)`` records the walk on
float32 placeholders (so the interpreter makes its constants, its
``limexp`` cap and its casts as it does for a float32 evaluation) and
writes it over ``float``: ``float`` inputs, outputs and locals, every
literal the float32 value the walk's Python float rounds to (``0.1f``:
the shortest decimal that reads back as that float), the ``f`` forms of
the math functions (``expf``, ``logf``, ``powf``, ``sqrtf``, ...) and
float overloads of the ``cs_*`` helpers (:data:`PREAMBLE_F32`).  Integer
and bitwise nodes stay ``int``, and a hoisted ``int`` travels through
``h`` as its bits (``cs_ibits``/``cs_bitsi``), so it is exact at any
value; a table is ``static const float``, its values rounded to float32,
searched by ``cs_search`` over ``float`` (:data:`INT_HELPERS_F32`; a
translation unit holds headers of one scalar type).  The float64 text is
unchanged.
"""

from __future__ import annotations

import hashlib
import math
import re
from typing import NamedTuple

import numpy as np
import torch

from cedarsim_tpu_torch.core.dual import Dual


#: C preamble of every emitted header: ``__host__ __device__`` compile away
#: off nvcc (the host build of the tests), and NaN-propagating min/max
#: with ``torch.maximum``/``torch.clamp`` semantics
PREAMBLE = """\
#pragma once
#include <math.h>
#ifndef __CUDACC__
#define __host__
#define __device__
#endif
#ifndef CS_EMIT_HELPERS
#define CS_EMIT_HELPERS
__host__ __device__ static inline double cs_max(double a, double b) {
  return (a > b || a != a) ? a : b; }
__host__ __device__ static inline double cs_min(double a, double b) {
  return (a < b || a != a) ? a : b; }
__host__ __device__ static inline double cs_sign(double a) {
  return (double)((a > 0.0) - (a < 0.0)); }
#endif
"""

#: :data:`PREAMBLE` of a float32 header: the helpers' float overloads
PREAMBLE_F32 = """\
#pragma once
#include <math.h>
#ifndef __CUDACC__
#define __host__
#define __device__
#endif
#ifndef CS_EMIT_HELPERS_F32
#define CS_EMIT_HELPERS_F32
__host__ __device__ static inline float cs_max(float a, float b) {
  return (a > b || a != a) ? a : b; }
__host__ __device__ static inline float cs_min(float a, float b) {
  return (a < b || a != a) ? a : b; }
__host__ __device__ static inline float cs_sign(float a) {
  return (float)((a > 0.0f) - (a < 0.0f)); }
#endif
"""

#: C helpers of the integer, bitwise and table nodes, emitted (once a
#: translation unit) only in a header that uses one
INT_HELPERS = """\
#ifndef CS_EMIT_INT_HELPERS
#define CS_EMIT_INT_HELPERS
__host__ __device__ static inline int cs_i32(double a) {
  return a != a ? 0 : a >= 2147483647.0 ? 2147483647
       : a <= -2147483648.0 ? (-2147483647 - 1) : (int)a; }
__host__ __device__ static inline int cs_shl(int a, int b) {
  return (b < 0 || b >= 32) ? 0 : (int)((unsigned)a << b); }
__host__ __device__ static inline int cs_shr(int a, int b) {
  return (b < 0 || b >= 32) ? (a < 0 ? -1 : 0) : (a >> b); }
__host__ __device__ static inline int cs_imax(int a, int b) {
  return a > b ? a : b; }
__host__ __device__ static inline int cs_imin(int a, int b) {
  return a < b ? a : b; }
__host__ __device__ static inline int cs_search(const double* t, int n,
                                                double x, bool right) {
  int i = 0;
  while (i < n && (right ? t[i] <= x : t[i] < x)) ++i;
  return i; }
#endif
"""

#: :data:`INT_HELPERS` of a float32 header: the same integer helpers over
#: ``float``, and the bit moves of a hoisted ``int`` through a float32
#: ``h`` slot
INT_HELPERS_F32 = """\
#ifndef CS_EMIT_INT_HELPERS_F32
#define CS_EMIT_INT_HELPERS_F32
#include <string.h>
__host__ __device__ static inline int cs_i32(float a) {
  return a != a ? 0 : a >= 2147483648.0f ? 2147483647
       : a <= -2147483648.0f ? (-2147483647 - 1) : (int)a; }
__host__ __device__ static inline int cs_shl(int a, int b) {
  return (b < 0 || b >= 32) ? 0 : (int)((unsigned)a << b); }
__host__ __device__ static inline int cs_shr(int a, int b) {
  return (b < 0 || b >= 32) ? (a < 0 ? -1 : 0) : (a >> b); }
__host__ __device__ static inline int cs_imax(int a, int b) {
  return a > b ? a : b; }
__host__ __device__ static inline int cs_imin(int a, int b) {
  return a < b ? a : b; }
__host__ __device__ static inline int cs_search(const float* t, int n,
                                                float x, bool right) {
  int i = 0;
  while (i < n && (right ? t[i] <= x : t[i] < x)) ++i;
  return i; }
__host__ __device__ static inline float cs_ibits(int a) {
  float f;
  memcpy(&f, &a, sizeof f);
  return f; }
__host__ __device__ static inline int cs_bitsi(float f) {
  int a;
  memcpy(&a, &f, sizeof a);
  return a; }
#endif
"""

_BIN = {"add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
        "div": "({0} / {1})", "lt": "({0} < {1})", "le": "({0} <= {1})",
        "gt": "({0} > {1})", "ge": "({0} >= {1})", "eq": "({0} == {1})",
        "ne": "({0} != {1})", "and": "({0} && {1})", "or": "({0} || {1})",
        "max": "cs_max({0}, {1})", "min": "cs_min({0}, {1})",
        "atan2": "atan2({0}, {1})", "hypot": "hypot({0}, {1})",
        "fmod": "fmod({0}, {1})", "pow": "pow({0}, {1})"}
#: integer nodes (kind "i"): operands are ``int``
_IBIN = {"add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
         "iand": "({0} & {1})", "ior": "({0} | {1})", "ixor": "({0} ^ {1})",
         "ishl": "cs_shl({0}, {1})", "ishr": "cs_shr({0}, {1})",
         "max": "cs_imax({0}, {1})", "min": "cs_imin({0}, {1})"}
_IUN = {"neg": "(-{0})", "inot": "(~{0})", "toint": "cs_i32({0})"}
_UN = {"neg": "(-{0})", "not": "(!{0})", "exp": "exp({0})",
       "log": "log({0})", "sqrt": "sqrt({0})", "abs": "fabs({0})",
       "sign": "cs_sign({0})", "floor": "floor({0})", "ceil": "ceil({0})",
       "rsqrt": "(1.0 / sqrt({0}))", "sin": "sin({0})", "cos": "cos({0})",
       "tan": "tan({0})", "asin": "asin({0})", "acos": "acos({0})",
       "atan": "atan({0})", "sinh": "sinh({0})", "cosh": "cosh({0})",
       "tanh": "tanh({0})", "asinh": "asinh({0})", "acosh": "acosh({0})",
       "atanh": "atanh({0})", "tobool": "({0} != 0.0)",
       "todouble": "({0} ? 1.0 : 0.0)", "itodouble": "((double){0})",
       "itobool": "({0} != 0)", "trunc": "trunc({0})",
       "round": "rint({0})"}
_BOOL_OPS = frozenset(("lt", "le", "gt", "ge", "eq", "ne", "and", "or",
                       "not", "tobool"))
#: torch names → recorded op (reflected forms swap their operands)
_TORCH_BIN = {"add": "add", "__add__": "add", "__radd__": "radd",
              "sub": "sub", "__sub__": "sub", "__rsub__": "rsub",
              "mul": "mul", "__mul__": "mul", "__rmul__": "rmul",
              "div": "div", "__truediv__": "div", "true_divide": "div",
              "__rdiv__": "rdiv", "__rtruediv__": "rdiv",
              "lt": "lt", "__lt__": "lt", "le": "le", "__le__": "le",
              "gt": "gt", "__gt__": "gt", "ge": "ge", "__ge__": "ge",
              "eq": "eq", "__eq__": "eq", "ne": "ne", "__ne__": "ne",
              "__and__": "and", "bitwise_and": "and", "logical_and": "and",
              "__rand__": "rand", "__or__": "or", "bitwise_or": "or",
              "logical_or": "or", "__ror__": "ror", "maximum": "max",
              "minimum": "min", "atan2": "atan2", "hypot": "hypot",
              "fmod": "fmod", "pow": "pow", "__pow__": "pow",
              "__rpow__": "rpow", "__xor__": "xor", "bitwise_xor": "xor",
              "__rxor__": "rxor", "__lshift__": "shl",
              "bitwise_left_shift": "shl", "__rlshift__": "rshl",
              "__rshift__": "shr", "bitwise_right_shift": "shr",
              "__rrshift__": "rshr"}
_TORCH_UN = {"neg": "neg", "__neg__": "neg", "negative": "neg",
             "exp": "exp", "log": "log", "sqrt": "sqrt", "abs": "abs",
             "__abs__": "abs", "sign": "sign", "floor": "floor",
             "ceil": "ceil", "rsqrt": "rsqrt", "sin": "sin", "cos": "cos",
             "tan": "tan", "asin": "asin", "acos": "acos", "atan": "atan",
             "sinh": "sinh", "cosh": "cosh", "tanh": "tanh",
             "asinh": "asinh", "acosh": "acosh", "atanh": "atanh",
             "__invert__": "not", "bitwise_not": "not",
             "logical_not": "not", "trunc": "trunc", "round": "round"}
_IDENTITY = frozenset(("as_tensor", "expand", "expand_as", "clone",
                       "contiguous", "reshape", "view", "detach",
                       "squeeze", "unsqueeze"))
#: ``torch.pow`` with these literal exponents takes another path in
#: PyTorch's kernels (a product, a square root, a reciprocal); the emitted
#: code follows it
_POW_SPECIAL = {2.0: "({0} * {0})", 3.0: "({0} * {0} * {0})",
                0.5: "sqrt({0})", -0.5: "(1.0 / sqrt({0}))",
                -1.0: "(1.0 / {0})", -2.0: "(1.0 / ({0} * {0}))"}


_MATH_FNS = ("exp", "log", "sqrt", "fabs", "floor", "ceil", "sin", "cos",
             "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh",
             "acosh", "atanh", "trunc", "rint", "atan2", "hypot", "fmod",
             "pow")
_MATH_RE = re.compile(r"\b(" + "|".join(_MATH_FNS) + r")\(")


def _f32_form(template):
    """A C template of a float64 node in its float32 form: the math
    functions' ``f`` names, float literals and casts."""
    t = _MATH_RE.sub(lambda m: m.group(1) + "f(", template)
    t = re.sub(r"\b([01])\.0\b", r"\1.0f", t)
    return t.replace("(double)", "(float)")


_BIN_F32 = {k: _f32_form(v) for k, v in _BIN.items()}
_UN_F32 = {k: _f32_form(v) for k, v in _UN.items()}
_POW_SPECIAL_F32 = {k: _f32_form(v) for k, v in _POW_SPECIAL.items()}


class _Recorder:
    def __init__(self, real=torch.float64):
        self.nodes = []          # (op, args, kind): kind "d", "b" or "i"
        self.cse = {}
        self.tables = {}         # name → float values
        #: the dtype of the "d" nodes: float64, or float32
        self.real = real

    def node(self, op, args, kind):
        key = (op, tuple(_akey(a) for a in args))
        hit = self.cse.get(key)
        if hit is not None:
            return hit
        nid = len(self.nodes)
        self.nodes.append((op, tuple(args), kind))
        sym = _Sym._new(self, nid, kind)
        self.cse[key] = sym
        return sym

    def table(self, t):
        """The name of constant tensor ``t``'s table (by the hash of its
        float64 values, so it does not depend on the walk's order)."""
        vals = [float(v) for v in t.detach().double().reshape(-1).tolist()]
        tag = hashlib.sha256(repr(vals).encode()).hexdigest()[:12]
        name = f"cs_tab_{tag}"
        self.tables[name] = vals
        return name


def _akey(a):
    if isinstance(a, _Sym):
        return ("n", a._nid)
    if isinstance(a, (bool, str)):
        return (type(a).__name__, a)
    return ("c", float(a).hex())


_DTYPES = {"b": torch.bool, "i": torch.int32, "d": torch.float64}


class _Sym(torch.Tensor):
    """A placeholder [1] tensor standing for one node of the recording.
    Every torch function or operator applied to it records a node and
    returns a new placeholder; nothing is computed."""

    @staticmethod
    def _new(rec, nid, kind):
        s = torch.Tensor._make_subclass(_Sym, torch.zeros(
            1, dtype=rec.real if kind == "d" else _DTYPES[kind]))
        s._rec, s._nid, s._kind = rec, nid, kind
        return s

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if name == "__get__" or name in ("dim", "size", "numel",
                                         "is_floating_point"):
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, Dual):
                return NotImplemented      # Dual's reflected operator
        rec = next((a._rec for a in list(args) + list(kwargs.values())
                    if isinstance(a, _Sym)), None)
        if rec is None:
            raise NotImplementedError(f"emit: torch.{name} on nested "
                                      "operands")
        return _record(rec, name, args, kwargs)


def _lit(a):
    """An operand as a node or a Python literal (a constant real tensor
    whose entries are equal, as the walk's ``torch.full`` makes, becomes
    its value)."""
    if isinstance(a, _Sym):
        return a
    if isinstance(a, torch.Tensor):
        flat = a.detach().reshape(-1)
        if flat.numel() == 0 or not bool((flat == flat[0]).all()):
            raise NotImplementedError(
                "emit: a constant tensor with distinct entries meets a "
                "walk value elementwise (a vector-valued walk); a point "
                "list is read through searchsorted and indexing")
        v = flat[0].item()
        return bool(v) if a.dtype == torch.bool else float(v)
    if isinstance(a, bool):
        return a
    if isinstance(a, (int, float)):
        return float(a)
    raise NotImplementedError(f"emit: operand of type {type(a).__name__}")


def _kind(a):
    """"b", "i" or "d": a node's kind, or a literal's (a Python int, or
    an integer tensor, is "i")."""
    if isinstance(a, _Sym):
        return a._kind
    if isinstance(a, bool):
        return "b"
    if isinstance(a, int) or (isinstance(a, torch.Tensor)
                              and not a.is_floating_point()
                              and a.dtype != torch.bool):
        return "i"
    return "d"


def _table_read(rec, t, idx):
    """``t[idx]`` of a constant tensor ``t``: a literal for a literal
    index, else a table read."""
    if not isinstance(idx, _Sym):
        return float(t.detach().reshape(-1)[int(idx)])
    if idx._kind != "i":
        raise NotImplementedError("emit: a table indexed by a float")
    if t.dim() != 1:
        raise NotImplementedError("emit: a table of more than one axis")
    n = t.shape[0]
    # a negative index counts from the end, as torch indexes
    j = rec.node("where", (rec.node("lt", (idx, 0.0), "b"),
                           rec.node("add", (idx, float(n)), "i"), idx), "i")
    return rec.node("tab", (rec.table(t), j), "d")


def _record(rec, name, args, kwargs):
    if name in _IDENTITY:
        return args[0]
    if name == "to":
        dt = kwargs.get("dtype", args[1] if len(args) > 1 else None)
        x = args[0]
        if dt == rec.real:
            return {"b": lambda: rec.node("todouble", (x,), "d"),
                    "i": lambda: rec.node("itodouble", (x,), "d"),
                    "d": lambda: x}[x._kind]()
        if dt == torch.bool:
            return {"b": lambda: x,
                    "i": lambda: rec.node("itobool", (x,), "b"),
                    "d": lambda: rec.node("tobool", (x,), "b")}[x._kind]()
        if dt == torch.int32:
            if x._kind == "i":
                return x
            if x._kind == "b":
                x = rec.node("todouble", (x,), "d")
            return rec.node("toint", (x,), "i")
        raise NotImplementedError(f"emit: cast to {dt}")
    if name in ("full_like", "ones_like", "zeros_like"):
        dt = kwargs.get("dtype") or args[0].dtype
        v = {"ones_like": 1.0, "zeros_like": 0.0}.get(name)
        if v is None:
            v = float(_lit(args[1] if len(args) > 1 else kwargs["fill_value"]))
        return bool(v) if dt == torch.bool else v
    if name == "__getitem__" and not isinstance(args[0], _Sym):
        return _table_read(rec, args[0], args[1])
    if name == "searchsorted":
        t, x = args[0], _lit(args[1])
        if isinstance(t, _Sym) or t.dim() != 1:
            raise NotImplementedError("emit: searchsorted needs a constant "
                                      "one-axis table")
        side = kwargs.get("side")
        right = bool(kwargs.get("right", False)) or side == "right"
        return rec.node("search", (rec.table(t), float(t.shape[0]), x,
                                   right), "i")
    if name == "where":
        c, a, b = (_lit(x) for x in args)
        ka, kb = _kind(args[1]), _kind(args[2])
        kind = "b" if ka == kb == "b" else "d"
        if ka == kb == "i" and "i" in (_kind(a), _kind(b)):
            kind = "i"          # an integer node on one side at least
        elif "i" in (_kind(a), _kind(b)):
            a, b = (rec.node("itodouble", (v,), "d")
                    if _kind(v) == "i" else v for v in (a, b))
        return rec.node("where", (c, a, b), kind)
    if name == "clamp":
        x = _lit(args[0])
        kind = "i" if _kind(args[0]) == "i" else "d"
        lo = kwargs.get("min", args[1] if len(args) > 1 else None)
        hi = kwargs.get("max", args[2] if len(args) > 2 else None)
        if lo is not None:
            x = rec.node("max", (x, _lit(lo)), kind)
        if hi is not None:
            x = rec.node("min", (x, _lit(hi)), kind)
        return x
    if name == "addcmul":
        if kwargs.get("value", 1) != 1:
            raise NotImplementedError("emit: addcmul with value != 1")
        a, b, c = (_lit(x) for x in args)
        return rec.node("add", (a, rec.node("mul", (b, c), "d")), "d")
    if name in _TORCH_UN and len(args) == 1 and not kwargs:
        op = _TORCH_UN[name]
        k = _kind(args[0])
        if op == "not" and k == "i":
            return rec.node("inot", (_lit(args[0]),), "i")
        if op == "not" and k != "b":
            raise NotImplementedError("emit: bitwise not of a float")
        if op == "neg" and k == "i":
            return rec.node("neg", (_lit(args[0]),), "i")
        return rec.node(op, (_lit(args[0]),), "b" if op == "not" else "d")
    if name in _TORCH_BIN and len(args) == 2 and not kwargs:
        op = _TORCH_BIN[name]
        (a, ka), (b, kb) = ((_lit(x), _kind(x)) for x in args)
        if op in ("radd", "rsub", "rmul", "rdiv", "rand", "ror", "rpow",
                  "rxor", "rshl", "rshr"):
            op, a, b, ka, kb = op[1:], b, a, kb, ka
        if ka == kb == "i" and op in ("and", "or", "xor", "shl", "shr",
                                      "add", "sub", "mul", "max", "min"):
            op = {"and": "iand", "or": "ior", "xor": "ixor",
                  "shl": "ishl", "shr": "ishr"}.get(op, op)
            return rec.node(op, (a, b), "i")
        if op in ("and", "or") and not (ka == kb == "b"):
            raise NotImplementedError(
                f"emit: '{op}' of a float and a non-float operand")
        if op in ("xor", "shl", "shr"):
            raise NotImplementedError(
                f"emit: bitwise '{op}' needs two integer operands")
        if "i" in (ka, kb):
            # an integer met a float: promoted to double, as torch does
            a, b = (rec.node("itodouble", (v,), "d")
                    if isinstance(v, _Sym) and v._kind == "i" else v
                    for v in (a, b))
        kind = "b" if op in _BOOL_OPS else "d"
        return rec.node(op, (a, b), kind)
    raise NotImplementedError(
        f"emit: torch.{name} in a model walk has no device-code form")


def _c_lit(v, f32=False):
    """A literal: a bool, or a real as float64 (``repr``) or, with
    ``f32``, as the float32 value it rounds to (``0.1f``)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if f32:
        with np.errstate(over="ignore"):
            v = float(np.float32(v))
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    r = str(np.float32(v)) + "f" if f32 else repr(float(v))
    return f"({r})" if r.startswith("-") else r


def dyn_names(compiled, key):
    """The dynamic params of group ``key`` (per-instance values, in the
    compiled params' order; ``$mult`` is applied by the scatter)."""
    return [pn for pn in compiled.params0[key] if pn != "$mult"]


class Emitted(NamedTuple):
    """One group's emitted model: the walk function's ``name`` (the
    hoisted part is ``<name>_pre``), the header ``text`` (preamble
    included), the ``hash`` (sha256 of the text), ``n_hoist`` (the values
    the walk reads from ``h``), and the arithmetic nodes of the two parts,
    ``n_pre`` and ``n_walk``."""
    name: str
    text: str
    hash: str
    n_hoist: int
    n_pre: int
    n_walk: int


def emit_group(compiled, key, ctx, dtype=None):
    """Emit group ``key``'s model as C++: the hoisted part
    ``<name>_pre(dyn, t, h)`` and the walk ``<name>(lv, lvd, h, s, q, qd)``
    (module docstring), over ``double`` or, for ``dtype=torch.float32``,
    ``float`` (default: the circuit's eval dtype).  Returns an
    :class:`Emitted`."""
    dtype = compiled.eval_dtype if dtype is None else dtype
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"emit: no C form for {dtype}")
    f32 = dtype == torch.float32
    real = "float" if f32 else "double"
    g = compiled.groups[key]
    model = g.model
    nlv, nlr = model.n_lvar(), model.n_lrow()
    rec = _Recorder(dtype)
    lv = [Dual(rec.node("in", ("lv", k), "d"), rec.node("in", ("lvd", k), "d"))
          for k in range(nlv)]
    # a point-list static param stays a constant tensor: the walk reads
    # it as a table
    p = dict(g.static_params)
    for k, pn in enumerate(dyn_names(compiled, key)):
        p[pn] = rec.node("in", ("dyn", k), "d")
    ctx_e = ctx.at_time(rec.node("in", ("t",), "d"))
    s_rows, q_rows = model.eval(lv, p, ctx_e, None)
    if len(s_rows) != nlr or len(q_rows) != nlr:
        raise ValueError(f"emit: {key!r} returned {len(s_rows)}/"
                         f"{len(q_rows)} rows, expected {nlr}")
    outs = []
    for k, r in enumerate(s_rows):
        outs.append((f"s[{k}]", _lit(r.v if isinstance(r, Dual) else r)))
    for k, r in enumerate(q_rows):
        outs.append((f"q[{k}]", _lit(r.v if isinstance(r, Dual) else r)))
    for k, r in enumerate(q_rows):
        d = r.d if isinstance(r, Dual) else 0.0
        outs.append((f"qd[{k}]", _lit(d)))
    pre, walk, n_hoist, n_pre, n_walk, ints = _emit_bodies(rec, outs, f32)
    safe = "".join(ch if ch.isalnum() else "_" for ch in key)
    sig_pre = ("__host__ __device__ static inline void {name}_pre("
               "const double* dyn, double t, double* h)")
    sig = ("__host__ __device__ static inline void {name}(const double* lv, "
           "const double* lvd, const double* h, double* s, double* q, "
           "double* qd)")
    if f32:
        sig_pre, sig = (x.replace("double", real) for x in (sig_pre, sig))
    probe = (sig_pre.format(name="MODEL") + " {\n" + pre + "}\n"
             + sig.format(name="MODEL") + " {\n" + walk + "}\n")
    tag = hashlib.sha256(probe.encode()).hexdigest()
    name = f"cs_{safe}_{tag[:12]}"
    text = ((PREAMBLE_F32 if f32 else PREAMBLE)
            + ((INT_HELPERS_F32 if f32 else INT_HELPERS) if ints else "")
            + f"// {key}: {nlv} local unknowns, {nlr} rows, "
            f"{len(dyn_names(compiled, key))} dynamic params, {n_hoist} "
            "hoisted values\n"
            + sig_pre.format(name=name) + " {\n" + pre + "}\n"
            + sig.format(name=name) + " {\n" + walk + "}\n")
    return Emitted(name, text, hashlib.sha256(text.encode()).hexdigest(),
                   n_hoist, n_pre, n_walk)


def _emit_bodies(rec, outs, f32=False):
    """Straight-line C for ``outs`` [(lvalue, node or literal)], cut in
    two: only the nodes the outputs need, in depth-first post-order from
    the outputs, the nodes that depend on no ``lv``/``lvd`` input in the
    hoisted part and the rest in the walk.  The hoisted values the walk
    (or an output) reads go through ``h``, numbered in the order the walk
    first reads them; each is read right before its first use.  Each part
    declares the tables it reads first.  Returns (hoisted body, walk body,
    values in ``h``, arithmetic nodes of each part, whether an integer or
    table node is used).  ``f32``: over ``float``."""
    real = "float" if f32 else "double"
    binf, unf, powf = ((_BIN_F32, _UN_F32, _POW_SPECIAL_F32) if f32
                       else (_BIN, _UN, _POW_SPECIAL))
    zero, one = ("0.0f", "1.0f") if f32 else ("0.0", "1.0")
    order, seen = [], set()
    for _, v in outs:
        if not isinstance(v, _Sym) or v._nid in seen:
            continue
        stack = [(v._nid, False)]
        while stack:
            nid, expanded = stack.pop()
            if expanded:
                order.append(nid)
                continue
            if nid in seen:
                continue
            seen.add(nid)
            stack.append((nid, True))
            op, args, _ = rec.nodes[nid]
            if op == "in":
                continue
            for a in reversed(args):
                if isinstance(a, _Sym) and a._nid not in seen:
                    stack.append((a._nid, False))
    local = {nid: f"v{i}" for i, nid in enumerate(order)}
    varying = set()
    for nid in order:          # post-order: every operand comes first
        op, args, _ = rec.nodes[nid]
        if (args[0] in ("lv", "lvd") if op == "in" else any(
                isinstance(a, _Sym) and a._nid in varying for a in args)):
            varying.add(nid)

    def ref(a, kind="d"):
        if isinstance(a, _Sym):
            return local[a._nid]
        if kind == "i" and not isinstance(a, bool):
            v = int(a)
            return f"({v})" if v < 0 else str(v)
        return _c_lit(a, f32)

    def define(nid):
        op, args, kind = rec.nodes[nid]
        if op == "in":
            expr = args[0] if args[0] == "t" else f"{args[0]}[{args[1]}]"
        elif op == "tab":
            expr = f"{args[0]}[{ref(args[1])}]"
        elif op == "search":
            expr = (f"cs_search({args[0]}, {int(args[1])}, {ref(args[2])}, "
                    f"{_c_lit(args[3])})")
        elif op == "where":
            expr = "({0} ? {1} : {2})".format(
                ref(args[0]), ref(args[1], kind), ref(args[2], kind))
        elif kind == "i" and op in _IBIN:
            expr = _IBIN[op].format(ref(args[0], "i"), ref(args[1], "i"))
        elif kind == "i" and op in _IUN:
            expr = _IUN[op].format(ref(args[0], "i" if op != "toint"
                                       else "d"))
        elif op == "pow" and not isinstance(args[1], _Sym) \
                and args[1] in powf:
            expr = powf[args[1]].format(ref(args[0]))
        elif op in binf:
            expr = binf[op].format(ref(args[0]), ref(args[1]))
        else:
            expr = unf[op].format(ref(args[0]))
        ty = {"b": "bool", "i": "int"}.get(kind, real)
        return f"  const {ty} {local[nid]} = {expr};\n"

    hoist = {}                 # hoisted node → its slot in h
    walk = []

    def read(a):
        if (isinstance(a, _Sym) and a._nid not in varying
                and a._nid not in hoist):
            j = hoist[a._nid] = len(hoist)
            if a._kind == "b":
                walk.append(f"  const bool {local[a._nid]} = h[{j}] != "
                            f"{zero};\n")
            elif a._kind == "i":
                walk.append(f"  const int {local[a._nid]} = "
                            + (f"cs_bitsi(h[{j}]);\n" if f32
                               else f"(int)h[{j}];\n"))
            else:
                walk.append(f"  const {real} {local[a._nid]} = h[{j}];\n")

    for nid in order:
        if nid in varying:
            for a in rec.nodes[nid][1]:
                read(a)
            walk.append(define(nid))
    for lhs, v in outs:
        read(v)
        val = ref(v)
        if isinstance(v, _Sym) and v._kind == "b":
            val = f"({val} ? {one} : {zero})"
        elif isinstance(v, _Sym) and v._kind == "i":
            val = f"(({real}){val})"
        walk.append(f"  {lhs} = {val};\n")
    pre = [define(nid) for nid in order if nid not in varying]
    for nid, j in hoist.items():
        val = local[nid]
        if rec.nodes[nid][2] == "b":
            val = f"({val} ? {one} : {zero})"
        elif rec.nodes[nid][2] == "i":
            val = f"cs_ibits({val})" if f32 else f"(({real}){val})"
        pre.append(f"  h[{j}] = {val};\n")

    def tables(nids):
        names = sorted({rec.nodes[n][1][0] for n in nids
                        if rec.nodes[n][0] in ("tab", "search")})
        return "".join(
            f"  static const {real} {t}[{len(rec.tables[t])}] = "
            f"{{{', '.join(_c_lit(v, f32) for v in rec.tables[t])}}};\n"
            for t in names)

    def arith(nids):
        return sum(1 for nid in nids if rec.nodes[nid][0] != "in")

    ints = any(rec.nodes[n][2] == "i" or rec.nodes[n][0] in ("tab", "search")
               for n in order)
    return (tables(n for n in order if n not in varying) + "".join(pre),
            tables(varying) + "".join(walk), len(hoist),
            arith(n for n in order if n not in varying), arith(varying),
            ints)
