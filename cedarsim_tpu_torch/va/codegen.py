"""Verilog-A → PyTorch device compiler (counterpart of
``cedarsim_tpu/va/codegen.py``).

``make_device`` turns a parsed VA module into a ``DeviceModel`` subclass
whose ``eval`` walks the analog block with an environment of values.  The
walk is the JAX package's interpreter, evaluated eagerly over a batch: every
value is a Python float (folded on the host), a ``[B]`` tensor (one entry per
instance and lane) or a :class:`~cedarsim_tpu_torch.core.dual.Dual` that
carries the local-Jacobian tangents.

Semantics kept from the JAX interpreter:

- ``I(a,b) <+`` accumulates (resistive, ddt-charge) pairs; ``V(a,b) <+``
  allocates a branch-current unknown with constraint V(a,b) − expr = 0.
- ``ddt()`` splits expressions into (static, dynamic) parts.
- Host constant folding: an expression whose operands are all Python
  floats is computed on the host in f64 (the JAX package keys this on
  "not a jax Tracer"; here it is "not a tensor").  A conditional on a
  tensor evaluates both branches and merges every assigned variable with
  ``torch.where`` (``_merge``); nothing calls ``.item()`` or a Python
  ``if`` on a tensor inside ``eval``.
- The NaN-safe ``pow``/``sqrt``/``log`` derivatives (the JAX
  ``custom_jvp`` rules) are the derivative rules of the Dual functions.
- ``$param_given``, ``$temperature``, ``$vt``, ``analysis()``,
  ``$simparam``, analog functions with output arguments.
- The noise channel: ``white_noise``/``flicker_noise`` site k (its lexical
  AST node, stable when both branches of a conditional are walked)
  returns ``eps[k]``, and ``noise()`` collects each site's (power,
  exponent), zero where no walk reached it; ``noise_table`` is a site that
  returns zero.  Without ``eps`` (every analysis but noise) a site returns
  zero and its power is not evaluated, so the walk (and the CUDA source
  ``va/emit.py`` records from it) is exactly the one without noise.

- Runtime-switched V/I branches: a branch with both kinds of contribution
  keeps a current unknown; each contribution sets its mode and discards
  the other kind's accumulation, and its row is (va − vb) − v_expr in V
  mode, i_br − i_expr in I mode, selected per evaluation (a mode that
  folds on the host picks its row there).
- ``ddx(expr, V(node))``: a third value channel carries the tangent along
  each probed node through the arithmetic (the partial derivative with
  the other nodes held), so its local Jacobian, a second derivative,
  follows from the Dual arithmetic on those expressions.
- ``idt(arg, ic)``: one state unknown per site after the branch currents;
  its row pins the state to ``ic`` at the operating point and is
  −arg + d/dt(y) otherwise.
- The analog filters and event operators (``laplace_nd/np/zd/zp``,
  ``absdelay`` in "pade" mode, ``transition`` in "smooth" mode, ``slew``,
  ``idtmod``): a block of state unknowns per site after the idt states,
  whose rows the call site writes (``("LFROW", site, i)``), so that every
  analysis takes them as ordinary rows.  ``absdelay`` is a Padé(3,3)
  all-pass, ``transition`` an exponential follower (behind a Padé block
  when its delay is not zero).
- The aux channel (``eps`` after the noise inputs): ``absdelay`` in
  "history" mode reads its delayed value from a ring slot (``delays``
  gives what the transient's ring stores); ``transition`` in "latch" mode
  (the LRM's linear ramp) and ``zi_nd/np/zd/zp`` (sampled IIR filters on
  the clock t0 + n·T, which ``breakpoints`` schedules) keep their state in
  latch slots that change only at accepted steps (``latch0``,
  ``latch``).  The AC analysis stamps them exactly (``analysis/ac.py``).
"""

from __future__ import annotations

import math
import operator

import numpy as np
import torch

from cedarsim_tpu_torch.core.context import Modes
from cedarsim_tpu_torch.core import dual as D
from cedarsim_tpu_torch.core.dual import Dual, val
from cedarsim_tpu_torch.devices.base import DeviceModel
from cedarsim_tpu_torch.va.ast import Module, AnalogFunction
from cedarsim_tpu_torch.va.parser import parse_va


class VACodegenError(ValueError):
    pass



# ------------------------------------------- (static, charge, ddx) values
# Every interpreter value is (static, charge, dtangents): the resistive
# value, the coefficient of ddt() (None = zero) and, for ``ddx``, a dict
# probe-node name -> d(static)/dV(probe) (None = no dependence), carried as
# explicit arithmetic as the JAX interpreter carries it.  The dict keeps
# the order its keys were made in, so the walk's operations do not depend
# on the process.  A module without ``ddx`` has no tangents, and then no
# operation here differs from the two-channel walk.

def _flatten_muldiv(e, num, den):
    """Flatten a */ expression tree into numerator/denominator factor lists
    (AST nodes, unevaluated)."""
    if isinstance(e, tuple) and e[0] == "bin" and e[1] == "*":
        _flatten_muldiv(e[2], num, den)
        _flatten_muldiv(e[3], num, den)
    elif isinstance(e, tuple) and e[0] == "bin" and e[1] == "/":
        _flatten_muldiv(e[2], num, den)
        _flatten_muldiv(e[3], den, num)
    else:
        num.append(e)


def _pair(v):
    return v if isinstance(v, tuple) else (v, None, None)


def _dmerge(da, db, f):
    if da is None and db is None:
        return None
    da, db = da or {}, db or {}
    return {k: f(da.get(k, 0.0), db.get(k, 0.0))
            for k in dict.fromkeys([*da, *db])}


def _dscale(d, c):
    if d is None:
        return None
    return {k: v * c for k, v in d.items()}


def _padd(a, b):
    a, b = _pair(a), _pair(b)
    q = a[1] if b[1] is None else (b[1] if a[1] is None else a[1] + b[1])
    return (a[0] + b[0], q, _dmerge(a[2], b[2], lambda x, y: x + y))


def _psub(a, b):
    a, b = _pair(a), _pair(b)
    if b[1] is None:
        q = a[1]
    elif a[1] is None:
        q = -b[1]
    else:
        q = a[1] - b[1]
    return (a[0] - b[0], q, _dmerge(a[2], b[2], lambda x, y: x - y))


def _pneg(a):
    a = _pair(a)
    return (-a[0], None if a[1] is None else -a[1], _dscale(a[2], -1.0))


def _pmul(a, b):
    a, b = _pair(a), _pair(b)
    if a[1] is not None and b[1] is not None:
        raise VACodegenError("product of two ddt() expressions is not a "
                             "valid charge formulation")
    if a[1] is not None:
        q = a[1] * b[0]
    elif b[1] is not None:
        q = b[1] * a[0]
    else:
        q = None
    d = _dmerge(_dscale(a[2], b[0]), _dscale(b[2], a[0]),
                lambda x, y: x + y)
    return (a[0] * b[0], q, d)


def _pdiv(a, b):
    a, b = _pair(a), _pair(b)
    if b[1] is not None:
        raise VACodegenError("division by a ddt() expression")
    q = None if a[1] is None else D.rdiv(a[1], b[0])
    d = None
    if a[2] is not None or b[2] is not None:
        # d(a/b) = da/b − a·db/b² (formed only where a tangent exists: the
        # walk runs eagerly, so an unused tangent would still cost its ops)
        d = _dmerge(_dscale(a[2], 1.0 / b[0]),
                    _dscale(b[2], D.rdiv(-a[0], b[0] * b[0])),
                    lambda x, y: x + y)
    return (D.rdiv(a[0], b[0]), q, d)


def _scalar(a, what="expression"):
    a = _pair(a)
    if a[1] is not None:
        raise VACodegenError(f"ddt() result used inside nonlinear {what}")
    return a[0]


def _dual(a):
    """(value, dtangents) view of a value."""
    a = _pair(a)
    return a[0], a[2]


def _concrete(*vs):
    """True if no value is a tensor: parameter-only arithmetic then folds on
    the host in f64, as the JAX interpreter folds everything that is not a
    jax Tracer."""
    return not any(isinstance(v, (torch.Tensor, Dual)) for v in vs)


def _ieee(pyf, npf):
    """IEEE-semantics host fold: out-of-domain/overflow give inf/nan like the
    tensor path instead of raising."""
    def g(*a):
        try:
            return pyf(*a)
        except (OverflowError, ZeroDivisionError, ValueError):
            with np.errstate(all="ignore"):
                return float(npf(*map(np.float64, a)))
    return g


_HOST_MATH1 = {
    "exp": _ieee(math.exp, np.exp), "ln": _ieee(math.log, np.log),
    "log": _ieee(math.log10, np.log10), "log10": _ieee(math.log10, np.log10),
    "sqrt": _ieee(math.sqrt, np.sqrt), "abs": abs,
    "limexp": lambda x: math.exp(x) if x <= 80 else math.exp(80.0)*(1+x-80),
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "asin": _ieee(math.asin, np.arcsin), "acos": _ieee(math.acos, np.arccos),
    "atan": math.atan,
    "sinh": _ieee(math.sinh, np.sinh), "cosh": _ieee(math.cosh, np.cosh),
    "tanh": math.tanh,
    "asinh": math.asinh, "acosh": _ieee(math.acosh, np.arccosh),
    "atanh": _ieee(math.atanh, np.arctanh),
    "floor": math.floor, "ceil": math.ceil,
}
_HOST_MATH2 = {
    # math.pow (not **): neg**frac raises (→ np nan) instead of going complex
    "pow": _ieee(math.pow, np.power), "min": min, "max": max,
    "atan2": math.atan2, "hypot": math.hypot,
    "fmod": _ieee(math.fmod, np.fmod),
}

_MATH1 = {
    "exp": D.exp, "ln": D.safe_log, "log": D.safe_log10,
    "log10": D.safe_log10, "sqrt": D.safe_sqrt, "abs": D.absolute,
    "limexp": D.limexp,
    "sin": D.sin, "cos": D.cos, "tan": D.tan,
    "asin": D.asin, "acos": D.acos, "atan": D.atan,
    "sinh": D.sinh, "cosh": D.cosh, "tanh": D.tanh,
    "asinh": D.asinh, "acosh": D.acosh, "atanh": D.atanh,
    "floor": D.floor, "ceil": D.ceil,
}
_MATH2 = {
    "pow": D.safe_pow, "min": D.minimum, "max": D.maximum,
    "atan2": D.atan2, "hypot": D.hypot, "fmod": D.fmod,
}

#: f -> f' for the ddx tangent's chain rule (the JAX interpreter's
#: ``_DMATH1``, on values that may be Duals)
_DMATH1 = {
    "exp": D.exp,
    "ln": lambda x: 1.0 / x,
    "log": lambda x: 1.0 / (x * math.log(10.0)),
    "log10": lambda x: 1.0 / (x * math.log(10.0)),
    "sqrt": lambda x: 0.5 / D.sqrt(D.maximum(x, 1e-300)),
    "abs": D.sign,
    "limexp": lambda x: D.where(
        val(x) <= D.limexp_cap(x), D.exp(D.minimum(x, D.limexp_cap(x))),
        math.exp(D.limexp_cap(x))),
    "sin": D.cos, "cos": lambda x: -D.sin(x),
    "tan": lambda x: 1.0 + D.tan(x) * D.tan(x),
    "asin": lambda x: 1.0 / D.sqrt(D.maximum(1 - x * x, 1e-300)),
    "acos": lambda x: -1.0 / D.sqrt(D.maximum(1 - x * x, 1e-300)),
    "atan": lambda x: 1.0 / (1 + x * x),
    "sinh": D.cosh, "cosh": D.sinh,
    "tanh": lambda x: 1.0 - D.tanh(x) * D.tanh(x),
    "asinh": lambda x: 1.0 / D.sqrt(x * x + 1),
    "acosh": lambda x: 1.0 / D.sqrt(D.maximum(x * x - 1, 1e-300)),
    "atanh": lambda x: 1.0 / D.maximum(1 - x * x, 1e-300),
    "floor": lambda x: 0.0, "ceil": lambda x: 0.0,
}


def _where(cond, a, b, dtype):
    """Select between two interpreter values on a tensor condition; two
    host floats become a tensor of ``dtype`` (``torch.where`` of two Python
    scalars would give float32).  A condition that is no tensor picks its
    side on the host."""
    if not isinstance(cond, torch.Tensor):
        return a if cond else b
    if _concrete(a, b):
        a = torch.full(cond.shape, a, dtype=dtype, device=cond.device)
    return D.where(cond, a, b)


def _clip(x, lo, hi):
    """``jnp.clip``: max(lo, x) then min(hi, ·), with ``lax``'s tie rule."""
    return D.minimum(hi, D.maximum(lo, x))


# -------------------------------------------------------------- static prepass

def _walk_stmts(stmts):
    for st in stmts:
        yield st
        k = st[0]
        if k == "block":
            yield from _walk_stmts(st[1])
        elif k == "if":
            yield from _walk_stmts([st[2]])
            if st[3] is not None:
                yield from _walk_stmts([st[3]])
        elif k in ("for",):
            yield from _walk_stmts([st[4]])
        elif k in ("while", "repeat", "event"):
            yield from _walk_stmts([st[2]])
        elif k == "case":
            for _, s2 in st[2]:
                yield from _walk_stmts([s2])


def _walk_exprs(e, out):
    if not isinstance(e, tuple):
        return
    k = e[0]
    out.append(e)
    if k in ("bin",):
        _walk_exprs(e[2], out); _walk_exprs(e[3], out)
    elif k in ("un",):
        _walk_exprs(e[2], out)
    elif k == "cond":
        _walk_exprs(e[1], out); _walk_exprs(e[2], out); _walk_exprs(e[3], out)
    elif k == "call":
        for a in e[2]:
            _walk_exprs(a, out)
    elif k == "array":
        for a in e[1]:
            _walk_exprs(a, out)


def _all_exprs(module):
    out = []
    for st in _walk_stmts(module.analog):
        k = st[0]
        if k == "assign":
            _walk_exprs(st[2], out)
        elif k == "contrib":
            _walk_exprs(st[2], out)
        elif k == "if":
            _walk_exprs(st[1], out)
        elif k == "for":
            _walk_exprs(st[2], out)
        elif k in ("while", "repeat"):
            _walk_exprs(st[1], out)
        elif k == "case":
            _walk_exprs(st[1], out)
            for labels, _ in st[2]:
                if labels:
                    for l in labels:
                        _walk_exprs(l, out)
        elif k in ("sys", "call"):
            for a in st[2]:
                _walk_exprs(a, out)
    for fn in module.functions.values():
        for st in _walk_stmts(fn.body):
            if st[0] == "assign":
                _walk_exprs(st[2], out)
            elif st[0] == "if":
                _walk_exprs(st[1], out)
    return out


# ------------------------------------------------- filter and event operators

#: analog filter and event operators lowered to a block of state unknowns
#: per site (LRM 4.5.13 laplace_*, 4.5.14 absdelay, 4.5.16 transition,
#: 4.5.17 slew, 4.5.10 idtmod), as in the JAX interpreter
_LF_OPS = frozenset(("laplace_nd", "laplace_np", "laplace_zd", "laplace_zp",
                     "absdelay", "transition", "slew", "idtmod"))
_ZI_OPS = frozenset(("zi_nd", "zi_np", "zi_zd", "zi_zp"))

#: order of the Padé(N, N) all-pass standing for e^{−s·td}
_PADE_ORDER = 3


def _arr_elems(module, e, what):
    if not (isinstance(e, tuple) and e[0] == "array"):
        raise VACodegenError(
            f"module {module.name}: {what} must be an array literal "
            "{c0, c1, ...}")
    return e[1]


def _try_const(e, module):
    """The host value of a constant expression, else None."""
    try:
        return _const_expr(e, module)
    except Exception:
        return None


def _zi_coeff_counts(module, e):
    """(nb, na): the z⁻¹-ascending numerator and denominator coefficient
    counts of a zi_* site (static; the values may be parameter
    expressions)."""
    name, args = e[1], e[2]
    if len(args) < 4:
        raise VACodegenError(
            f"module {module.name}: {name}(expr, num, den, T[, tau[, t0]])")

    def arr_len(a, what):
        if not (isinstance(a, tuple) and a[0] in ("arr", "array")):
            raise VACodegenError(
                f"module {module.name}: {name}() {what} must be a "
                "{...} coefficient array")
        return len(a[1])

    if name in ("zi_nd", "zi_np"):
        nb = arr_len(args[1], "numerator")
    else:
        z = arr_len(args[1], "zeros")
        if z % 2:
            raise VACodegenError(
                f"module {module.name}: {name}() zeros must be (re, im) "
                "pairs")
        nb = z // 2 + 1
    if name in ("zi_nd", "zi_zd"):
        na = arr_len(args[2], "denominator")
    else:
        pz = arr_len(args[2], "poles")
        if pz % 2:
            raise VACodegenError(
                f"module {module.name}: {name}() poles must be (re, im) "
                "pairs")
        na = pz // 2 + 1
    if name in ("zi_zd", "zi_zp"):
        if nb > na:
            raise VACodegenError(
                f"module {module.name}: {name}() has more zeros than the "
                "denominator order")
        nb = na      # the zero-root numerator is padded to the pole count
    if na < 1:
        raise VACodegenError(
            f"module {module.name}: {name}() needs a denominator")
    return nb, na


def _host_eval(e, module, params):
    """The host value of a parameter expression (the zi_* sample clock,
    which the LRM makes independent of the unknowns)."""
    if isinstance(e, (int, float)):
        return float(e)
    if e[0] == "num":
        return float(e[1])
    if e[0] == "ref":
        if e[1] in params:
            return float(params[e[1]])
        return float(_const_expr(e, module))
    if e[0] == "un":
        v = _host_eval(e[2], module, params)
        return {"-": -v, "+": v}[e[1]]
    if e[0] == "bin":
        a = _host_eval(e[2], module, params)
        b = _host_eval(e[3], module, params)
        return {"+": a + b, "-": a - b, "*": a * b, "/": a / b,
                "**": a ** b}[e[1]]
    raise VACodegenError(
        f"module {module.name}: zi_* sample period/offset must be a "
        "constant or parameter expression")


def _lf_n_states(module, e):
    """The static state count of a filter or event operator site."""
    name, args = e[1], e[2]
    if name in ("laplace_nd", "laplace_np", "laplace_zd", "laplace_zp"):
        if len(args) != 3:
            raise VACodegenError(
                f"module {module.name}: {name}() takes (expr, num, den)")
        if name in ("laplace_nd", "laplace_zd"):
            nd = len(_arr_elems(module, args[2],
                                f"{name}() denominator")) - 1
        else:
            pl = len(_arr_elems(module, args[2], f"{name}() poles"))
            if pl % 2:
                raise VACodegenError(
                    f"module {module.name}: {name}() poles must be "
                    "(re, im) pairs (conjugates listed explicitly, LRM)")
            nd = pl // 2
        if name in ("laplace_nd", "laplace_np"):
            dn = len(_arr_elems(module, args[1],
                                f"{name}() numerator")) - 1
        else:
            zl = len(_arr_elems(module, args[1], f"{name}() zeros"))
            if zl % 2:
                raise VACodegenError(
                    f"module {module.name}: {name}() zeros must be "
                    "(re, im) pairs")
            dn = zl // 2
        if nd < 1:
            raise VACodegenError(
                f"module {module.name}: {name}() needs at least one pole")
        if dn > nd:
            raise VACodegenError(
                f"module {module.name}: {name}() transfer function is "
                f"improper (numerator degree {dn} > denominator {nd})")
        return nd
    if name == "absdelay":
        if not 2 <= len(args) <= 3:
            raise VACodegenError(
                f"module {module.name}: absdelay(expr, td[, maxdelay])")
        return 0 if _try_const(args[1], module) == 0.0 else _PADE_ORDER
    if name == "transition":
        extra = 0
        if len(args) >= 2 and _try_const(args[1], module) != 0.0:
            extra = _PADE_ORDER
        return 1 + extra
    if name == "slew":
        return 1 if len(args) >= 2 else 0      # no rate bound: identity
    if name == "idtmod":
        return 1
    raise VACodegenError(f"unknown filter operator {name}")


def _poly_from_pairs(roots):
    """Real polynomial coefficients (ascending powers) from a flat (re, im,
    re, im, ...) root list, conjugates listed explicitly as the LRM asks;
    the imaginary residue is dropped."""
    cr, ci = [1.0], [0.0]
    for j in range(0, len(roots), 2):
        a, b = roots[j], roots[j + 1]          # root = a + i·b
        nr = [0.0] * (len(cr) + 1)
        ni = [0.0] * (len(cr) + 1)
        for t in range(len(cr)):
            nr[t + 1] = nr[t + 1] + cr[t]      # s · c_t
            ni[t + 1] = ni[t + 1] + ci[t]
            nr[t] = nr[t] - (a * cr[t] - b * ci[t])   # −root · c_t
            ni[t] = ni[t] - (a * ci[t] + b * cr[t])
        cr, ci = nr, ni
    return cr


def _degen_td(td):
    """td == 0 for a Padé delay block: True for a host zero, None for a
    host nonzero (no masking), else a bool tensor."""
    if isinstance(td, float):
        return True if td == 0.0 else None
    return val(td) == 0


def _pade_coeffs(td):
    """Padé(3,3) of e^{−s·td}: P(−s·td)/P(s·td), P(u) = 1 + u/2 + u²/10 +
    u³/120 (all-pass, exact DC gain)."""
    c = (1.0, 0.5, 0.1, 1.0 / 120.0)
    den = [c[i] * td ** i if i else 1.0 for i in range(4)]
    num = [den[0], -den[1], den[2], -den[3]]
    return num, den


# ------------------------------------------------------------------ the device

def make_device(module: Module, strict_ranges=False, delay_mode=None,
                transition_mode=None):
    """Compile a parsed VA Module into a DeviceModel subclass.

    ``delay_mode`` (default ``config.va_delay_mode``): "pade" lowers
    ``absdelay`` to a Padé(3,3) all-pass block of states (every analysis);
    "history" reads u(t − td) from the transient's ring of accepted samples
    (exact in the transient; AC stamps e^{−jωtd}).  ``transition_mode``
    (default ``config.va_transition_mode``): "smooth", an exponential edge
    through one state (every analysis), or "latch", the LRM's linear ramps
    re-latched at accepted steps (a nonzero delay keeps its Padé block
    ahead of the latch; AC reads it as unity gain)."""
    from cedarsim_tpu_torch import config as _cfg
    if delay_mode is None:
        delay_mode = _cfg.va_delay_mode
    if delay_mode not in ("pade", "history"):
        raise VACodegenError(f"unknown delay_mode {delay_mode!r}")
    if transition_mode is None:
        transition_mode = _cfg.va_transition_mode
    if transition_mode not in ("smooth", "latch"):
        raise VACodegenError(f"unknown transition_mode {transition_mode!r}")
    ports = list(module.ports)
    grounds = set(module.ground_nets)
    internal = [n for n in module.nets if n not in ports and n not in grounds]
    named_branch = {b.name: (b.pos, b.neg) for b in module.branches}

    ddx_probes = []        # node names probed by ddx(expr, V(node))
    for e in _all_exprs(module):
        if e[0] == "call" and e[1] == "ddx" and len(e[2]) == 2:
            acc = e[2][1]
            if acc[0] == "call" and acc[1] == "V" and len(acc[2]) == 1 \
                    and acc[2][0][0] == "ref":
                if acc[2][0][1] not in ddx_probes:
                    ddx_probes.append(acc[2][0][1])
            else:
                raise VACodegenError(
                    f"module {module.name}: ddx() supports single-node "
                    "V(node) probes")
    v_branches = []        # ordered (a, b) pairs with any V contribution
    i_branches = set()
    noise_sites = []
    idt_sites = []
    lf_sites = []        # (expr, kind, n_states): state blocks, in order
    dly_sites = []       # history-mode absdelay sites (ring slots)
    lat_sites = []       # (expr, kind, n_slots): latch-mode transition, zi_*
    for st in _walk_stmts(module.analog):
        if st[0] == "contrib":
            kind, a, b = st[1]
            if a in named_branch:
                a, b = named_branch[a]
            key = (a, b)
            if kind == "V":
                if key not in v_branches:
                    v_branches.append(key)
            else:
                i_branches.add(key)
    # a branch with both kinds of contribution is runtime-switched: it
    # keeps a current unknown and its row selects the active constraint
    switch_branches = frozenset(k for k in v_branches if k in i_branches)
    for e in _all_exprs(module):
        if e[0] == "call" and e[1] in ("white_noise", "flicker_noise",
                                        "noise_table"):
            if not any(x is e for x in noise_sites):
                noise_sites.append(e)
        if e[0] == "call" and e[1] == "idt":
            if not any(x is e for x in idt_sites):
                idt_sites.append(e)
        if e[0] == "call" and e[1] in _LF_OPS:
            if (e[1] == "absdelay" and delay_mode == "history"
                    and 2 <= len(e[2]) <= 3
                    and _try_const(e[2][1], module) != 0.0):
                # the exact history: a delayed-value input, no states
                if not any(x is e for x in dly_sites):
                    dly_sites.append(e)
            elif e[1] == "transition" and transition_mode == "latch":
                # the LRM ramp in latch slots; a nonzero delay keeps its
                # Padé block
                if not any(x is e for x, _, _ in lat_sites):
                    lat_sites.append((e, "transition", 3))
                    if (len(e[2]) >= 2
                            and _try_const(e[2][1], module) != 0.0):
                        lf_sites.append((e, "transition", _PADE_ORDER))
            elif not any(x is e for x, _, _ in lf_sites):
                lf_sites.append((e, e[1], _lf_n_states(module, e)))
        if e[0] == "call" and e[1] in _ZI_OPS:
            if not any(x is e for x, _, _ in lat_sites):
                nb, na = _zi_coeff_counts(module, e)
                # [y_held, t_next, u_hist(nb − 1), y_hist(max(0, na − 2))]
                lat_sites.append((e, e[1], 2 + (nb - 1) + max(0, na - 2)))

    pdefaults = {}
    porder = []
    lower_map = {}
    for p in module.parameters:
        pdefaults[p.name] = p
        porder.append(p.name)
        lower_map.setdefault(p.name.lower(), p.name)
        for al in p.aliases:
            lower_map.setdefault(al.lower(), p.name)

    node_index = {}
    for i, n in enumerate(ports):
        node_index[n] = i
    for i, n in enumerate(internal):
        node_index[n] = len(ports) + i
    for g in grounds:
        node_index[g] = -1
    n_nodes_local = len(ports) + len(internal)
    branch_index = {key: n_nodes_local + i for i, key in
                    enumerate(v_branches)}

    interp = _Interp(module, node_index, branch_index, named_branch,
                     n_nodes_local, len(v_branches), noise_sites,
                     ddx_probes, idt_sites, switch_branches, lf_sites,
                     dly_sites, lat_sites)

    class VADevice(DeviceModel):
        terminals = tuple(ports)
        n_internal = len(internal)
        #: a current unknown per V branch, a state per idt site, then the
        #: filter and event operators' state blocks
        n_branch = (len(v_branches) + len(idt_sites)
                    + sum(n for _, _, n in lf_sites))
        n_noise = len(noise_sites)
        #: ring-filled delayed values (history-mode absdelay sites)
        n_delay = len(dly_sites)
        #: latched-state slots (latch-mode transition, zi_*)
        n_latch = interp.n_lat_slots
        params = {}
        given_params = ()
        va_module = module
        param_order = tuple(porder)
        param_lower = dict(lower_map)

        @classmethod
        def prepare(cls, raw: dict) -> dict:
            """Evaluate parameter defaults (which may reference other params)
            with instance overrides, host-side."""
            raws = {}
            for k, v in (raw or {}).items():
                actual = cls.param_lower.get(str(k).lower())
                if actual is None:
                    raise ValueError(
                        f"{module.name}: unknown parameter {k!r}")
                raws[actual] = v
            env = _HostParamEnv(pdefaults, raws, module)
            out = {}
            for name in cls.param_order:
                v = env[name]
                _check_range(module, pdefaults[name], v, strict_ranges)
                out[name] = float(v)
                out[name + "$given"] = float(name in raws)
            return out

        @staticmethod
        def eval(lv, p, ctx, eps):
            return interp.run(lv, p, ctx, eps)

        @classmethod
        def noise(cls, lv, p, ctx):
            return interp.run(lv, p, ctx, cls._aux0(), collect_noise=True)

        @classmethod
        def delays(cls, lv, p, ctx):
            """(u_now, td) of every history-mode absdelay site: what the
            transient's ring stores, and the delay of its lookups."""
            return interp.run(lv, p, ctx, cls._aux0(), collect_delay=True)

        @classmethod
        def latch0(cls, lv, p, ctx):
            """The latch slots settled at the operating point."""
            return interp.run(lv, p, ctx, cls._aux0(), collect_latch="init")

        @classmethod
        def latch(cls, lv, p, ctx, lat):
            """The latch slots after an accepted step at ``ctx.time``, from
            their state ``lat`` (a list of n_latch entries): transition
            sites re-latch their ramp when the input moved, zi_* sites
            fire on their clock."""
            return interp.run(lv, p, ctx,
                              [0.0] * (cls.n_noise + cls.n_delay) + list(lat),
                              collect_latch="update")

        @classmethod
        def _aux0(cls):
            return [0.0] * (cls.n_noise + cls.n_delay + cls.n_latch)

    VADevice.params = {n: None for n in porder}
    VADevice.__name__ = f"VA_{module.name}"
    VADevice.__qualname__ = VADevice.__name__
    #: each latch site's (kind, slot offset, n_slots), and each zi_* site's
    #: (nb, na) by slot offset: the AC analysis's sampled-system stamps
    VADevice.lat_sites = [tuple(x) for x in interp.lat_sites]
    VADevice.zi_meta = {
        loff: _zi_coeff_counts(module, e)
        for (e, kind, _n), (_k, loff, _n2) in zip(lat_sites,
                                                  interp.lat_sites)
        if kind.startswith("zi")}
    zi_clock = [e for (e, kind, _n) in lat_sites if kind.startswith("zi")]
    if zi_clock:
        def _zi_breakpoints(params, tstop):
            """The sample clock t0 + n·T of every zi_* site, so that
            accepted steps land on the samples."""
            pts = []
            for e in zi_clock:
                T = _host_eval(e[2][3], module, params)
                t0a = (_host_eval(e[2][5], module, params)
                       if len(e[2]) > 5 else 0.0)
                if T <= 0.0:
                    raise VACodegenError(
                        f"module {module.name}: zi_* sample period must "
                        f"be positive (got {T})")
                n = int(np.floor((tstop - t0a) / T))
                if n > 200_000:
                    raise VACodegenError(
                        f"module {module.name}: zi_* clock would need {n} "
                        f"sample breakpoints in ({t0a}, {tstop}): period "
                        "too small for this time span")
                if n > 0:
                    pts.append(t0a + T * np.arange(1, n + 1))
            return np.concatenate(pts) if pts else np.zeros(0, np.float64)
        VADevice.breakpoints = staticmethod(_zi_breakpoints)
    return VADevice


def _check_range(module, param, v, strict):
    import warnings
    for r in param.ranges:
        if r.kind == "from":
            try:
                lo = _const_expr(r.lo, module)
                hi = _const_expr(r.hi, module)
            except Exception:
                continue
            ok = (v > lo or (r.lo_incl and v == lo)) and \
                 (v < hi or (r.hi_incl and v == hi))
            if not ok:
                msg = (f"{module.name}.{param.name}={v} outside range "
                       f"{'[' if r.lo_incl else '('}{lo}:{hi}"
                       f"{']' if r.hi_incl else ')'}")
                if strict:
                    raise ValueError(msg)
                warnings.warn(msg, stacklevel=3)


def _const_expr(e, module):
    if e is None:
        raise ValueError("no bound")
    if e[0] == "num":
        return e[1]
    if e[0] == "un" and e[1] == "-":
        return -_const_expr(e[2], module)
    if e[0] == "ref" and e[1] == "inf":
        return math.inf
    raise ValueError("non-constant bound")


class _HostParamEnv:
    """Lazy host-side evaluation of parameter defaults (may reference other
    params); instance overrides win."""

    def __init__(self, pdefaults, overrides, module):
        self.pdefaults = pdefaults
        self.overrides = overrides
        self.module = module
        self.cache = {}
        self._stack = set()

    def __getitem__(self, name):
        if name in self.cache:
            return self.cache[name]
        if name in self.overrides:
            v = float(self.overrides[name])
        elif name in self.pdefaults:
            if name in self._stack:
                raise ValueError(f"circular parameter default {name!r}")
            self._stack.add(name)
            try:
                v = self._eval(self.pdefaults[name].default)
            finally:
                self._stack.discard(name)
        else:
            raise ValueError(
                f"{self.module.name}: undefined identifier {name!r} in "
                "parameter default")
        self.cache[name] = v
        return v

    def _eval(self, e):
        k = e[0]
        if k == "num":
            return e[1]
        if k == "str":
            return e[1]
        if k == "ref":
            if e[1] == "inf":
                return math.inf
            return self[e[1]]
        if k == "un":
            v = self._eval(e[2])
            return {"-": lambda x: -x, "!": lambda x: float(not x),
                    "~": lambda x: float(~int(x))}[e[1]](v)
        if k == "bin":
            a, b = self._eval(e[2]), self._eval(e[3])
            return _host_binop(e[1], a, b)
        if k == "cond":
            return self._eval(e[2]) if self._eval(e[1]) else self._eval(e[3])
        if k == "call":
            name, args = e[1], [self._eval(a) for a in e[2]]
            if name in _HOST_MATH1:
                return float(_HOST_MATH1[name](float(args[0])))
            if name in _HOST_MATH2:
                return float(_HOST_MATH2[name](float(args[0]),
                                               float(args[1])))
            if name == "$temperature":
                return 300.15
            if name == "$vt":
                return 1.380649e-23 * (args[0] if args else 300.15) \
                    / 1.602176634e-19
            raise ValueError(f"cannot evaluate {name}() in parameter default")
        raise ValueError(f"bad default expression {e!r}")


_HOST_OPS = {
    "+": operator.add, "-": operator.sub, "*": operator.mul,
    "/": operator.truediv, "%": math.fmod, "**": math.pow,
    "==": lambda x, y: float(x == y), "!=": lambda x, y: float(x != y),
    "<": lambda x, y: float(x < y), "<=": lambda x, y: float(x <= y),
    ">": lambda x, y: float(x > y), ">=": lambda x, y: float(x >= y),
    "&&": lambda x, y: float(bool(x) and bool(y)),
    "||": lambda x, y: float(bool(x) or bool(y)),
    "&": lambda x, y: float(int(x) & int(y)),
    "|": lambda x, y: float(int(x) | int(y)),
    "^": lambda x, y: float(int(x) ^ int(y)),
    "<<": lambda x, y: float(int(x) << int(y)),
    ">>": lambda x, y: float(int(x) >> int(y))}


def _host_binop(op, a, b):
    try:
        return _HOST_OPS[op](a, b)
    except (OverflowError, ZeroDivisionError, ValueError):
        # IEEE semantics like the tensor path (Python floats raise)
        npops = {"/": np.divide, "*": np.multiply, "+": np.add,
                 "-": np.subtract, "%": np.fmod, "**": np.power}
        with np.errstate(all="ignore"):
            return float(npops[op](np.float64(a), np.float64(b)))


_CONSTS = {"M_PI": math.pi, "M_E": math.e, "M_SQRT2": math.sqrt(2),
           "M_LN2": math.log(2), "M_LN10": math.log(10),
           "M_LOG2E": 1/math.log(2), "M_LOG10E": 1/math.log(10),
           "M_PI_2": math.pi/2, "M_PI_4": math.pi/4,
           "M_1_PI": 1/math.pi, "M_2_PI": 2/math.pi,
           "M_SQRT1_2": math.sqrt(0.5), "M_TWO_PI": 2*math.pi,
           "P_Q": 1.602176634e-19, "P_K": 1.380649e-23,
           "P_EPS0": 8.8541878128e-12, "P_H": 6.62607015e-34,
           "P_CELSIUS0": 273.15, "P_C": 299792458.0,
           "P_U0": 1.25663706212e-6}


# ---------------------------------------------------------------- interpreter

class _Interp:
    def __init__(self, module, node_index, branch_index, named_branch,
                 n_nodes_local, n_vbranch, noise_sites, ddx_probes=(),
                 idt_sites=(), switch_branches=frozenset(), lf_sites=(),
                 dly_sites=(), lat_sites=()):
        self.module = module
        # history-mode absdelay site k reads aux input n_noise + k
        self.dly_site_ids = {id(e): k for k, e in enumerate(dly_sites)}
        self.n_dly = len(dly_sites)
        # latch sites: id(expr) → index, and per site (kind, slot offset,
        # n_slots) into the latch block at n_noise + n_dly
        self.lat_site_ids = {}
        self.lat_sites = []
        loff = 0
        for k, (e, kind, n_sl) in enumerate(lat_sites):
            self.lat_site_ids[id(e)] = k
            self.lat_sites.append((kind, loff, n_sl))
            loff += n_sl
        self.n_lat_slots = loff
        # filter and event operator sites: id(expr) → index, and per site
        # (kind, state offset after the idt states, n_states)
        self.lf_site_ids = {}
        self.lf_sites = []
        off = 0
        for k, (e, kind, n_st) in enumerate(lf_sites):
            self.lf_site_ids[id(e)] = k
            self.lf_sites.append((kind, off, n_st))
            off += n_st
        self.n_lf = off
        self.noise_site_ids = {id(e): k for k, e in enumerate(noise_sites)}
        self.ddx_probes = tuple(ddx_probes)
        self.idt_site_ids = {id(e): k for k, e in enumerate(idt_sites)}
        self.n_idt = len(idt_sites)
        self.switch_branches = switch_branches
        self.node_index = node_index
        self.branch_index = branch_index
        self.named_branch = named_branch
        self.n_nodes = n_nodes_local
        self.n_vbranch = n_vbranch
        self.n_noise = len(noise_sites)

    def run(self, lv, p, ctx, eps=None, collect_noise=False,
            collect_delay=False, collect_latch=None):
        """(static, dynamic): two lists of ``n_rows`` row contributions;
        with ``collect_noise`` instead (power, exponent), two lists of
        ``n_noise`` entries; with ``collect_delay`` (u_now, td) of the
        history-mode absdelay sites; with ``collect_latch`` ("init" or
        "update") the ``n_lat_slots`` latch slots."""
        st = _State(self, lv, p, ctx, eps, collect_noise, collect_delay,
                    collect_latch)
        env = {}
        for stmt in self.module.analog:
            st.stmt(stmt, env)
        if collect_delay:
            u, td = [0.0] * self.n_dly, [0.0] * self.n_dly
            for k, (uv, tv) in st.dly_rec.items():
                u[k], td[k] = uv, tv
            return u, td
        if collect_latch is not None:
            out = [0.0] * self.n_lat_slots
            for k, vals in st.lat_rec.items():
                off = self.lat_sites[k][1]
                for i, v in enumerate(vals):
                    out[off + i] = v
            return out
        n_rows = self.n_nodes + self.n_vbranch + self.n_idt + self.n_lf
        static = [0.0] * n_rows
        dynamic = [0.0] * n_rows

        def add_row(idx, s, q):
            if idx < 0:
                return
            static[idx] = static[idx] + s
            if q is not None:
                dynamic[idx] = dynamic[idx] + q

        # the operators' state rows, as their call sites wrote them; a
        # site no walk reached pins its states to zero
        lf_base = self.n_nodes + self.n_vbranch + self.n_idt
        for k, (_kind, off, n_st) in enumerate(self.lf_sites):
            for i in range(n_st):
                row = lf_base + off + i
                v = env.get(("LFROW", k, i))
                if v is None:
                    add_row(row, lv[row], None)
                else:
                    add_row(row, v[0], v[1])

        for key, value in env.items():
            if not isinstance(key, tuple) or key[0] == "LFROW":
                continue
            if key[0] == "IDT":
                # idt state y: pinned to its ic at the operating point (an
                # integrator has no DC solution otherwise), else the row
                # −arg + d/dt(y)
                row = self.n_nodes + self.n_vbranch + key[1]
                arg, icval = value
                if ctx.mode in (Modes.DCOP, Modes.TRANOP):
                    add_row(row, lv[row] - icval, None)
                else:
                    add_row(row, -_pair(arg)[0], lv[row])
                continue
            kind, a, b = key
            if kind == "Vact" or (kind == "I"
                                  and (a, b) in self.switch_branches):
                continue          # a switched branch's I: with its V below
            s, q, _ = _pair(value)
            ia = self.node_index[a]
            ib = self.node_index[b] if b is not None else -1
            if kind == "V" and (a, b) in self.switch_branches:
                # V mode: (va − vb) − v_expr = 0, I mode: i_br − i_expr = 0
                bidx = self.branch_index[(a, b)]
                ibr = lv[bidx]
                add_row(ia, ibr, None)
                add_row(ib, -ibr, None)
                va = lv[ia] if ia >= 0 else 0.0
                vb = lv[ib] if ib >= 0 else 0.0
                act = _pair(env.get(("Vact", a, b), 0.0))[0]
                i_s, i_q, _ = _pair(env.get(("I", a, b), 0.0))
                qv = 0.0 if q is None else -q
                qi = 0.0 if i_q is None else -i_q
                if _concrete(act):
                    # the mode folded on the host (a test on static params)
                    v_mode = float(act) != 0.0
                    add_row(bidx, (va - vb) - s if v_mode else ibr - i_s,
                            qv if v_mode else qi)
                else:
                    on = val(act) != 0
                    add_row(bidx, _where(on, (va - vb) - s, ibr - i_s,
                                         st.dtype),
                            _where(on, qv, qi, st.dtype))
                continue
            if kind == "I":
                add_row(ia, s, q)
                add_row(ib, -s, None if q is None else -q)
            else:  # V contribution: branch row
                bidx = self.branch_index[(a, b)]
                ibr = lv[bidx]
                add_row(ia, ibr, None)
                add_row(ib, -ibr, None)
                va = lv[ia] if ia >= 0 else 0.0
                vb = lv[ib] if ib >= 0 else 0.0
                add_row(bidx, (va - vb) - s, None if q is None else -q)
        if collect_noise:
            pad = [0.0] * (self.n_noise - len(st.noise_pwr))
            return st.noise_pwr + pad, st.noise_exp + list(pad)
        return static, dynamic


class _State:
    def __init__(self, interp, lv, p, ctx, eps=None, collect_noise=False,
                 collect_delay=False, collect_latch=None):
        self.it = interp
        self.lv = lv
        self.dtype = val(lv[0]).dtype
        self.p = p
        self.ctx = ctx
        self.eps = eps
        self.collect = collect_noise
        self.collect_delay = collect_delay
        self.collect_latch = collect_latch     # None | "init" | "update"
        self.dly_rec = {}          # site k -> (u_now, td)
        self.lat_rec = {}          # site k -> its latch slots
        self.noise_pwr = []
        self.noise_exp = []
        self.zero = 0.0

    # ------------------------------------------------------------ statements

    def stmt(self, st, env):
        k = st[0]
        if k == "null":
            return
        if k == "block":
            for name, (ty, init) in st[2].items():
                if ty == "param" and init is not None:
                    env[name] = self.expr(init, env)
                elif name not in env:
                    env[name] = self.zero
            for s2 in st[1]:
                self.stmt(s2, env)
            return
        if k == "assign":
            env[st[1]] = self.expr(st[2], env)
            return
        if k == "contrib":
            kind, a, b = st[1]
            if a in self.it.named_branch:
                a, b = self.it.named_branch[a]
            s_, q_, _ = _pair(self.expr(st[2], env))
            v = (s_, q_, None)         # contributions drop ddx tangents
            if (a, b) in self.it.switch_branches:
                # a contribution of one kind discards the other kind's
                # accumulation, and sets the branch's mode
                vk, ik = ("V", a, b), ("I", a, b)
                if kind == "V":
                    env[vk] = _padd(env.get(vk, (self.zero, None, None)), v)
                    env[ik] = (self.zero, None, None)
                    env[("Vact", a, b)] = 1.0
                else:
                    env[ik] = _padd(env.get(ik, (self.zero, None, None)), v)
                    env[vk] = (self.zero, None, None)
                    env[("Vact", a, b)] = 0.0
                return
            key = (kind, a, b)
            env[key] = _padd(env.get(key, (self.zero, None, None)), v)
            return
        if k == "if":
            cond = _scalar(self.expr(st[1], env), "condition")
            if _concrete(cond):
                if float(cond) != 0.0:
                    self.stmt(st[2], env)
                elif st[3] is not None:
                    self.stmt(st[3], env)
                return
            env_t = dict(env)
            self.stmt(st[2], env_t)
            env_f = dict(env)
            if st[3] is not None:
                self.stmt(st[3], env_f)
            self._merge(env, val(cond) != 0, env_t, env_f)
            return
        if k == "case":
            sel = _scalar(self.expr(st[1], env), "case selector")
            labels_concrete = _concrete(sel)
            if labels_concrete:
                default_body = None
                for labels, body in st[2]:
                    if labels is None:
                        default_body = body
                        continue
                    lvs = [self.expr(l, env) for l in labels]
                    if not _concrete(*[_pair(lv_)[0] for lv_ in lvs]):
                        labels_concrete = False
                        break
                    if any(float(_pair(lv_)[0]) == float(sel) for lv_ in lvs):
                        self.stmt(body, env)
                        return
                if labels_concrete:
                    if default_body is not None:
                        self.stmt(default_body, env)
                    return
            # tensor selector: desugar to a where-merged if-chain
            sv = val(sel)
            matched = None
            branches = []
            for labels, body in st[2]:
                if labels is None:
                    cond = (torch.ones_like(sv, dtype=torch.bool)
                            if matched is None else ~matched)
                else:
                    c = None
                    for l in labels:
                        hit = torch.as_tensor(
                            sv == val(_scalar(self.expr(l, env))))
                        c = hit if c is None else (c | hit)
                    cond = c if matched is None else (c & ~matched)
                    matched = c if matched is None else (matched | c)
                branches.append((cond, body))
            for cond, body in branches:
                env_t = dict(env)
                self.stmt(body, env_t)
                self._merge(env, cond, env_t, dict(env))
            return
        if k == "for":
            init, cond, step, body = st[1], st[2], st[3], st[4]
            self.stmt(init, env)
            guard = 0
            while True:
                cc = self._static_bool(_pair(self.expr(cond, env))[0])
                if cc is None:
                    raise VACodegenError(
                        f"{self.it.module.name}: for-loop condition is not "
                        "statically evaluable (tensor loop bounds)")
                if not cc:
                    break
                self.stmt(body, env)
                self.stmt(step, env)
                guard += 1
                if guard > 10000:
                    raise VACodegenError("for-loop unroll limit exceeded")
            return
        if k == "repeat":
            cnt = self._static_bool(self.expr(st[1], env), want_val=True)
            if cnt is None:
                raise VACodegenError("repeat count must be static")
            for _ in range(int(cnt)):
                self.stmt(st[2], env)
            return
        if k == "while":
            guard = 0
            while True:
                c = self._static_bool(_pair(self.expr(st[1], env))[0])
                if c is None:
                    raise VACodegenError(
                        f"{self.it.module.name}: while-loop with tensor "
                        "condition not supported")
                if not c:
                    break
                self.stmt(st[2], env)
                guard += 1
                if guard > 10000:
                    raise VACodegenError("while-loop unroll limit exceeded")
            return
        if k == "event":
            # initial_step blocks typically precompute operating parameters
            # — execute unconditionally; other events are ignored
            if any("initial_step" in n for n in st[1]):
                self.stmt(st[2], env)
            return
        if k == "sys":
            return  # $strobe/$display/$finish → no-op
        if k == "call":
            self._call_function(st[1], st[2], env)
            return
        raise VACodegenError(f"unhandled statement {k!r}")

    def _static_bool(self, v, want_val=False):
        if not _concrete(v):
            return None
        try:
            return float(v) if want_val else bool(v)
        except (TypeError, ValueError):
            return None

    def _merge(self, env, cond, env_t, env_f):
        """``cond``: a bool tensor.  Every key either branch touched becomes
        a ``where`` of the two branch values.  Keys are merged in the order
        the walk made them (not a set's order, which follows the process's
        string-hash seed): a new contribution key's place in ``env`` fixes
        the order in which ``run`` sums it into its rows, so the bits of a
        model evaluation do not depend on the process."""
        for k in dict.fromkeys([*env_t, *env_f]):
            base = env.get(k, (self.zero, None, None))
            tv = env_t.get(k, base)
            fv = env_f.get(k, base)
            if tv is fv:
                env[k] = tv
                continue
            if isinstance(k, tuple) and k[0] == "IDT":
                raise VACodegenError(
                    f"{self.it.module.name}: idt() under a condition on "
                    "an unknown")
            a, b = _pair(tv), _pair(fv)
            s = a[0] if a[0] is b[0] else _where(cond, a[0], b[0],
                                                 self.dtype)
            if a[1] is None and b[1] is None:
                q = None
            elif a[1] is b[1]:
                q = a[1]
            else:
                qa = self.zero if a[1] is None else a[1]
                qb = self.zero if b[1] is None else b[1]
                q = _where(cond, qa, qb, self.dtype)
            d = _dmerge(a[2], b[2], lambda x, y: x if x is y else
                        _where(cond, x, y, self.dtype))
            env[k] = (s, q, d)

    # ----------------------------------------------------------- expressions

    def expr(self, e, env):
        k = e[0]
        if k == "num":
            return float(e[1])
        if k == "str":
            return e[1]
        if k == "ref":
            return self._ref(e[1], env)
        if k == "un":
            v = self.expr(e[2], env)
            if e[1] == "-":
                return _pneg(v)
            sv = _scalar(v)
            if e[1] == "!":
                if _concrete(sv):
                    return float(sv == 0)
                return (val(sv) == 0).to(self.dtype)
            if e[1] == "~":
                if _concrete(sv):
                    return float(~int(sv))
                return (~(val(sv).to(torch.int32))).to(self.dtype)
            if e[1] == "+":
                return v
        if k == "bin":
            return self._binop(e[1], e[2], e[3], env)
        if k == "cond":
            c = _scalar(self.expr(e[1], env))
            if _concrete(c):
                return self.expr(e[2] if float(c) != 0 else e[3], env)
            cb = val(c) != 0
            a = _pair(self.expr(e[2], env))
            b = _pair(self.expr(e[3], env))
            s = _where(cb, a[0], b[0], self.dtype)
            if a[1] is None and b[1] is None:
                q = None
            else:
                qa = self.zero if a[1] is None else a[1]
                qb = self.zero if b[1] is None else b[1]
                q = _where(cb, qa, qb, self.dtype)
            d = _dmerge(a[2], b[2],
                        lambda x, y: _where(cb, x, y, self.dtype))
            return (s, q, d)
        if k == "call":
            return self._callexpr(e[1], e[2], env, node=e)
        raise VACodegenError(f"unhandled expression {e!r}")

    def _ref(self, name, env):
        if name in env:
            return env[name]
        if name in self.p:
            return self.p[name]
        if name.startswith("$"):
            return self._callexpr(name, [], env)
        if name == "inf":
            return math.inf
        if name in self.it.module.variables:
            return self.zero
        if name in _CONSTS:
            return _CONSTS[name]
        raise VACodegenError(
            f"{self.it.module.name}: undefined identifier {name!r}")

    def _binop(self, op, ea, eb, env):
        if op == "/":
            # balanced quotient evaluation, as in the JAX interpreter:
            # a*b/(c*d) evaluates as (a/c)*(b/d) — same rounding path
            num, den = [], []
            _flatten_muldiv(ea, num, den)
            _flatten_muldiv(eb, den, num)
            if len(num) >= 2 and len(den) >= 2:
                vn = [self.expr(e, env) for e in num]
                vd = [self.expr(e, env) for e in den]
                out = _pdiv(vn[0], vd[0])
                i = 1
                for j in range(1, len(vd)):
                    if i < len(vn):
                        out = _pmul(out, vn[i])
                        i += 1
                    out = _pdiv(out, vd[j])
                for k in range(i, len(vn)):
                    out = _pmul(out, vn[k])
                return out
        a = self.expr(ea, env)
        b = self.expr(eb, env)
        if op == "+":
            return _padd(a, b)
        if op == "-":
            return _psub(a, b)
        if op == "*":
            return _pmul(a, b)
        if op == "/":
            return _pdiv(a, b)
        if op == "**":
            (va, da), (vb, db) = _dual(a), _dual(b)
            _scalar(a, "'**'"), _scalar(b, "'**'")
            if _concrete(va, vb) and da is None and db is None:
                return _host_binop(op, float(va), float(vb))
            out = D.safe_pow(va, vb)
            if da is None and db is None:
                return out
            d1 = _dscale(da, vb * D.safe_pow(va, vb - 1.0))
            d2 = None
            if db is not None:
                pos = val(va) > 0
                d2 = _dscale(db, D.where(pos, D.log(D.where(pos, va, 1.0))
                                         * out, 0.0))
            return (out, None, _dmerge(d1, d2, lambda x, y: x + y))
        sa, sb = _scalar(a, f"'{op}'"), _scalar(b, f"'{op}'")
        if _concrete(sa, sb):
            return _host_binop(op, float(sa), float(sb))
        if op == "%":
            return D.fmod(sa, sb)
        sa, sb = val(sa), val(sb)
        cmp = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
               "<=": operator.le, ">": operator.gt, ">=": operator.ge}
        if op in cmp:
            r = cmp[op](sa, sb)
            if not isinstance(r, torch.Tensor):
                # a float operand against a 0-dim tensor compares to bool
                r = torch.as_tensor(r)
            return r.to(self.dtype)
        if op in ("&&", "||"):
            na = sa != 0
            nb = sb != 0
            r = (na & nb) if op == "&&" else (na | nb)
            return torch.as_tensor(r).to(self.dtype)

        def i32(x):
            return x.to(torch.int32) if isinstance(x, torch.Tensor) \
                else int(x)
        ia, ib = i32(sa), i32(sb)
        bit = {"&": operator.and_, "|": operator.or_, "^": operator.xor,
               "<<": operator.lshift, ">>": operator.rshift}
        if op in bit:
            return torch.as_tensor(bit[op](ia, ib)).to(self.dtype)
        raise VACodegenError(f"unhandled operator {op!r}")

    def _node_v(self, name):
        idx = self.it.node_index.get(name)
        if idx is None:
            raise VACodegenError(
                f"{self.it.module.name}: unknown node {name!r}")
        return self.lv[idx] if idx >= 0 else self.zero

    # ------------------------------------------- filter and event operators

    def _lf_laplace(self, k, base, n_st, x, num, den, env, degen=None):
        """y = N(s)/D(s)·x through phase variables z_i = w⁽ⁱ⁾, D(s)·w = x,
        y = N(s)·w: rows ż_i − z_{i+1} (i < n − 1) and d_n·ż_{n−1} + Σ d_i
        z_i − x, which at DC leave z_0 = x/d_0.  ``degen`` (host or tensor
        td == 0 of a Padé delay): pin the higher states instead, so that
        the last row makes z_0 = x algebraically."""
        z = [self.lv[base + i] for i in range(n_st)]
        for i in range(n_st - 1):
            if degen is None:
                env[("LFROW", k, i)] = (-z[i + 1], z[i], None)
            else:
                env[("LFROW", k, i)] = (
                    _where(degen, z[i + 1], -z[i + 1], self.dtype),
                    _where(degen, 0.0, z[i], self.dtype), None)
        acc = self.zero
        for i in range(n_st):
            acc = acc + den[i] * z[i]
        env[("LFROW", k, n_st - 1)] = (acc - x, den[n_st] * z[n_st - 1],
                                       None)
        w = list(z)
        if len(num) - 1 == n_st:
            # w⁽ⁿ⁾ = ż_{n−1} = (x − Σ d_i z_i)/d_n; a zero d_n (a delay of
            # td = 0 at run time) has a zero numerator term too
            dn = den[n_st]
            if _concrete(dn):
                w.append((x - acc) / dn if dn != 0.0 else self.zero)
            else:
                nz = val(dn) != 0
                w.append(_where(nz, (x - acc) / _where(nz, dn, 1.0,
                                                        self.dtype),
                                0.0, self.dtype))
        y = self.zero
        for i, c in enumerate(num):
            y = y + c * w[i]
        return y

    def _transition_latch(self, kl, args, env, node):
        """The LRM's transition() ramp: the latch slots hold (target,
        y_start, t_start), re-latched at accepted steps when the (possibly
        Padé-delayed) input moved; the output is y_start + (target −
        y_start)·min(1, (t − t_start)/rise_or_fall)."""
        it = self.it

        def ev(e_, what):
            return _scalar(self.expr(e_, env), what)

        x = ev(args[0], "transition")
        xd = x
        k = it.lf_site_ids.get(id(node))
        if k is not None:          # a nonzero delay: the Padé block first
            _kind, off, _n_st = it.lf_sites[k]
            base = it.n_nodes + it.n_vbranch + it.n_idt + off
            td = ev(args[1], "transition delay")
            num, den = _pade_coeffs(td)
            xd = self._lf_laplace(k, base, _PADE_ORDER, x, num, den, env,
                                  degen=_degen_td(td))
        mode = self.ctx.mode
        if self.collect_latch is None and mode in (Modes.DCOP, Modes.TRANOP,
                                                   Modes.AC):
            return xd              # settled at the input; unity in AC
        rise = ev(args[2], "transition rise") if len(args) > 2 else 1e-9
        fall = ev(args[3], "transition fall") if len(args) > 3 else rise
        t = self.ctx.time
        if self.collect_latch == "init":
            # settled at the op: the ramp finished well before t0
            t0i = t - D.maximum(D.maximum(rise, fall), 0.0) - 1.0
            self.lat_rec[kl] = (xd, xd, t0i)
            return xd
        a0 = it.n_noise + it.n_dly + it.lat_sites[kl][1]
        target, y0, t0 = self.eps[a0], self.eps[a0 + 1], self.eps[a0 + 2]
        dur = _where(val(target) >= val(y0), D.maximum(rise, 1e-15),
                     D.maximum(fall, 1e-15), self.dtype)
        frac = _clip((t - t0) / dur, 0.0, 1.0)
        y = y0 + (target - y0) * frac
        if self.collect_latch == "update":
            # the input moved: the running ramp's value is the new start
            # (the LRM's interrupted-ramp rule)
            tol = 1e-12 + 1e-9 * abs(val(xd))
            changed = abs(val(xd) - val(target)) > tol
            self.lat_rec[kl] = (_where(changed, xd, target, self.dtype),
                                _where(changed, y, y0, self.dtype),
                                _where(changed, t, t0, self.dtype))
        return y

    def _zi_coeffs(self, name, args, env):
        """(b, a): z⁻¹-ascending numerator and denominator coefficients
        (root forms expanded in z and reversed, the numerator zero-padded
        to the pole count)."""
        def ev(e_):
            return _scalar(self.expr(e_, env), name)

        if name in ("zi_nd", "zi_np"):
            b = [ev(c) for c in args[1][1]]
        else:
            b = list(reversed(_poly_from_pairs([ev(c)
                                                for c in args[1][1]])))
        if name in ("zi_nd", "zi_zd"):
            a = [ev(c) for c in args[2][1]]
        else:
            a = list(reversed(_poly_from_pairs([ev(c)
                                                for c in args[2][1]])))
        if name in ("zi_zd", "zi_zp"):
            b = [0.0] * (len(a) - len(b)) + b
        return b, a

    def _zi_latch(self, name, args, env, node):
        """A z-domain IIR filter (LRM 4.5.15): the input sampled on the
        clock t0 + n·T (scheduled as breakpoints, so accepted steps land
        on the samples), the difference equation updated in the latch
        slots [y_held, t_next, u_hist, y_hist], the output the zero-order
        hold of y_n; DC gives the steady gain H(1)·u, AC reads the held
        output as an aux input (``analysis/ac.py`` stamps H(e^{jωT}))."""
        it = self.it
        kl = it.lat_site_ids.get(id(node))
        if kl is None:
            raise VACodegenError(f"{name}() site not registered")
        loff = it.lat_sites[kl][1]

        def ev(e_, what):
            return _scalar(self.expr(e_, env), what)

        x = ev(args[0], name)
        b, a = self._zi_coeffs(name, args, env)
        nb, na = len(b), len(a)
        mode = self.ctx.mode
        if self.collect_latch is None and mode in (Modes.DCOP, Modes.TRANOP):
            return x * sum(b) / sum(a)
        a0v = it.n_noise + it.n_dly + loff
        if self.collect_latch is None:
            return self.eps[a0v]          # the zero-order hold (and AC)
        t = self.ctx.time
        if self.collect_latch == "init":
            T = ev(args[3], "zi sample period")
            t0a = ev(args[5], "zi t0") if len(args) > 5 else 0.0
            y = x * sum(b) / sum(a)
            tn = t0a + T * (D.floor((t - t0a) / T + 1e-9) + 1.0)
            self.lat_rec[kl] = tuple([y, tn] + [x] * (nb - 1)
                                     + [y] * max(0, na - 2))
            return y
        y_held = self.eps[a0v]
        T = ev(args[3], "zi sample period")
        t_next = self.eps[a0v + 1]
        u_hist = [self.eps[a0v + 2 + i] for i in range(nb - 1)]
        y_hist = [self.eps[a0v + 2 + (nb - 1) + i]
                  for i in range(max(0, na - 2))]
        yfull = [y_held] + y_hist        # y_n, y_{n−1}, ...
        u_all = [x] + u_hist             # u_{n+1}, u_n, ...
        fire = val(t) >= val(t_next) - 1e-9 * T
        y_new = (sum(b[i] * u_all[i] for i in range(nb))
                 - sum(a[i + 1] * yfull[i] for i in range(na - 1))) / a[0]

        def sel(nv, ov):
            return _where(fire, nv, ov, self.dtype)

        self.lat_rec[kl] = tuple(
            [sel(y_new, y_held), sel(t_next + T, t_next)]
            + [sel(u_all[i], u_hist[i]) for i in range(nb - 1)]
            + [sel(yfull[i], y_hist[i]) for i in range(max(0, na - 2))])
        return sel(y_new, y_held)

    def _lf_call(self, name, args, env, node):
        """The analog filter and event operators (LRM 4.5.10-17): the
        history-mode absdelay's ring slot, the latch-mode transition, or
        the site's state rows."""
        it = self.it
        kd = it.dly_site_ids.get(id(node))
        if kd is not None:
            x = _scalar(self.expr(args[0], env), name)
            td = _scalar(self.expr(args[1], env), "absdelay delay")
            if self.collect_delay:
                self.dly_rec[kd] = (x, td)
                return x
            if self.ctx.mode in (Modes.DCOP, Modes.TRANOP):
                return x            # steady state: u(t − td) = u
            # the transient fills the slot from its ring; AC holds it at
            # the op and stamps e^{−jωtd}
            return self.eps[it.n_noise + kd]
        kl = it.lat_site_ids.get(id(node))
        if kl is not None:
            return self._transition_latch(kl, args, env, node)
        k = it.lf_site_ids.get(id(node))
        if k is None:
            raise VACodegenError(f"{name}() site not registered")
        _kind, off, n_st = it.lf_sites[k]
        base = it.n_nodes + it.n_vbranch + it.n_idt + off
        x = _scalar(self.expr(args[0], env), name)
        dc = self.ctx.mode in (Modes.DCOP, Modes.TRANOP)

        def ev(e_, what):
            return _scalar(self.expr(e_, env), what)

        if name in ("laplace_nd", "laplace_np", "laplace_zd", "laplace_zp"):
            if name in ("laplace_nd", "laplace_np"):
                num = [ev(c, name) for c in args[1][1]]
            else:
                num = _poly_from_pairs([ev(c, name) for c in args[1][1]])
            if name in ("laplace_nd", "laplace_zd"):
                den = [ev(c, name) for c in args[2][1]]
            else:
                den = _poly_from_pairs([ev(c, name) for c in args[2][1]])
            return self._lf_laplace(k, base, n_st, x, num, den, env)
        if name == "absdelay":
            if n_st == 0:            # a static zero delay: identity
                return x
            td = ev(args[1], "absdelay delay")
            num, den = _pade_coeffs(td)
            return self._lf_laplace(k, base, n_st, x, num, den, env,
                                    degen=_degen_td(td))
        if name == "transition":
            i0, xd = 0, x
            if n_st > 1:             # the Padé-delayed input block first
                td = ev(args[1], "transition delay")
                num, den = _pade_coeffs(td)
                xd = self._lf_laplace(k, base, _PADE_ORDER, x, num, den,
                                      env, degen=_degen_td(td))
                i0 = _PADE_ORDER
            rise = (ev(args[2], "transition rise") if len(args) > 2
                    else 1e-9)
            fall = (ev(args[3], "transition fall") if len(args) > 3
                    else rise)
            y = self.lv[base + i0]
            if dc:
                env[("LFROW", k, i0)] = (y - xd, None, None)
            else:
                # exponential edge: τ = t_edge/ln(100), within 1 % of the
                # target after the rise or fall time
                tau = _where(val(xd) > val(y), D.maximum(rise, 1e-15),
                             D.maximum(fall, 1e-15), self.dtype) / 4.6051702
                env[("LFROW", k, i0)] = (-(xd - y) / tau, y, None)
            return y
        if name == "slew":
            if n_st == 0:            # no rate bounds: identity
                return x
            rp = ev(args[1], "slew rate")
            rn = ev(args[2], "slew rate") if len(args) > 2 else -rp
            y = self.lv[base]
            if dc:
                env[("LFROW", k, 0)] = (y - x, None, None)
            else:
                # a bounded follower: tracks x within ~1 µV, slews at the
                # rate bound otherwise
                kgain = D.maximum(rp, -rn) * 1e6
                rate = _clip(kgain * (x - y), rn, rp)
                env[("LFROW", k, 0)] = (-rate, y, None)
            return y
        if name == "idtmod":
            icval = ev(args[1], "idtmod ic") if len(args) > 1 else self.zero
            y = self.lv[base]
            if dc:
                env[("LFROW", k, 0)] = (y - icval, None, None)
            else:
                env[("LFROW", k, 0)] = (-x, y, None)
            if len(args) > 2:
                modulus = ev(args[2], "idtmod modulus")
                offset = (ev(args[3], "idtmod offset") if len(args) > 3
                          else self.zero)
                return y - modulus * D.floor((y - offset) / modulus)
            return y
        raise VACodegenError(f"unhandled filter operator {name}")

    def _callexpr(self, name, args, env, node=None):
        it = self.it
        if name == "V":
            a = self._node_v(args[0][1])
            if len(args) > 1:
                return a - self._node_v(args[1][1])
            if args[0][1] in it.ddx_probes:
                return (a, None, {args[0][1]: 1.0})
            return a
        if name == "I":
            nm = args[0][1] if args[0][0] == "ref" else None
            if nm in it.named_branch:
                pair = it.named_branch[nm]
                if pair in it.branch_index:
                    return self.lv[it.branch_index[pair]]
            raise VACodegenError(
                f"{it.module.name}: I() probe supported only on branches "
                "with V<+ contributions")
        if name == "ddt":
            v = _scalar(self.expr(args[0], env), "ddt argument")
            return (self.zero, v, None)
        if name == "ddx":
            # the partial derivative along V(probe), the other nodes held:
            # the probe tangent carried through the expression
            _, d = _dual(self.expr(args[0], env))
            probe = args[1][2][0][1]
            if d is None or probe not in d:
                return self.zero
            return d[probe]
        if name == "idt":
            # one state unknown per site (its row is written by ``run``)
            k = it.idt_site_ids[id(node)]
            arg = self.expr(args[0], env)
            icval = (_scalar(self.expr(args[1], env)) if len(args) > 1
                     else self.zero)
            env[("IDT", k)] = (arg, icval)
            return self.lv[it.n_nodes + it.n_vbranch + k]
        if name in ("white_noise", "flicker_noise"):
            if self.eps is None:
                # no noise analysis: the input is zero and its power unused
                return self.zero
            k = it.noise_site_ids.get(id(node), 0)
            pwr = _scalar(self.expr(args[0], env))
            if self.collect:
                while len(self.noise_pwr) <= k:
                    self.noise_pwr.append(self.zero)
                    self.noise_exp.append(self.zero)
                self.noise_pwr[k] = pwr
                if name == "flicker_noise" and len(args) > 1:
                    self.noise_exp[k] = _scalar(self.expr(args[1], env))
            if k < len(self.eps):
                return self.eps[k]
            return self.zero
        if name in _LF_OPS:
            return self._lf_call(name, args, env, node)
        if name in _ZI_OPS:
            return self._zi_latch(name, args, env, node)
        if name == "noise_table":
            return self.zero
        if name == "analysis":
            mode = self.ctx.mode
            wanted = args[0][1] if args and args[0][0] == "str" else ""
            v = {
                "ic": mode in (Modes.DCOP, Modes.TRANOP),
                "dc": mode in (Modes.DCOP, Modes.TRANOP),
                "static": mode in (Modes.DCOP, Modes.TRANOP),
                "tran": mode == Modes.TRAN,
                "ac": mode == Modes.AC,
                "noise": mode == Modes.AC,
                "nodeset": False,
            }.get(wanted, False)
            return 1.0 if v else 0.0
        if name == "$temperature":
            return self.ctx.temp
        if name == "$vt":
            if args:
                t = _scalar(self.expr(args[0], env))
                return t * (1.380649e-23 / 1.602176634e-19)
            return self.ctx.vt
        if name == "$param_given":
            key = args[0][1] + "$given"
            if key in self.p:
                return self.p[key]
            return 0.0
        if name == "$simparam":
            pname = args[0][1] if args and args[0][0] == "str" else ""
            if pname == "gmin":
                return self.ctx.gmin
            if pname in ("temp", "tnom"):
                return self.ctx.temp - 273.15
            if pname == "scale":
                return self.ctx.scale
            if pname == "sourceScaleFactor":
                return self.ctx.sourcefac
            if len(args) > 1:
                return _scalar(self.expr(args[1], env))
            return self.zero
        if name in ("$limit",):
            return self.expr(args[0], env)
        if name == "$abstime":
            return self.ctx.time
        if name in ("$port_connected",):
            return 1.0
        if name in _MATH1:
            raw = self.expr(args[0], env)
            v, d = _dual(raw)
            _scalar(raw, name)
            if _concrete(v) and d is None:
                return _HOST_MATH1[name](float(v))
            out = _MATH1[name](v)
            if d is not None:
                return (out, None, _dscale(d, _DMATH1[name](v)))
            return out
        if name in _MATH2:
            v1 = _scalar(self.expr(args[0], env), name)
            v2 = _scalar(self.expr(args[1], env), name)
            if _concrete(v1, v2):
                return _HOST_MATH2[name](float(v1), float(v2))
            return _MATH2[name](v1, v2)
        if name in it.module.functions:
            return self._call_function(name, args, env)
        raise VACodegenError(
            f"{it.module.name}: unknown function {name!r}")

    def _call_function(self, name, args, env):
        fn: AnalogFunction = self.it.module.functions[name]
        fenv = {}
        for pname, a in zip(fn.inputs, args):
            fenv[pname] = self.expr(a, env)
        for ln in fn.locals_:
            fenv.setdefault(ln, self.zero)
        fenv.setdefault(fn.name, self.zero)
        for on in fn.outputs:
            fenv.setdefault(on, self.zero)
        for st in fn.body:
            self.stmt(st, fenv)
        # write back output args (must be plain variable refs at call site)
        n_in = len(fn.inputs)
        for k2, on in enumerate(fn.outputs):
            ai = n_in + k2
            if ai < len(args) and args[ai][0] == "ref":
                env[args[ai][1]] = fenv[on]
        return fenv[fn.name]


def load_va(text: str, file="<va>", include_paths=(), defines=(),
            **make_kwargs):
    """Parse + compile VA source → dict module-name → DeviceModel subclass."""
    mods = parse_va(text, file, include_paths, defines=defines)
    return {m.name: make_device(m, **make_kwargs) for m in mods}
