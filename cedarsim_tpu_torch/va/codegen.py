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
  ``$simparam``, analog functions with output arguments, ``white_noise``/
  ``flicker_noise`` (zero in ``eval``: the slice runs no noise analysis).

Constructs that ``bsim4.va`` does not use — ``ddx``, ``idt``, the analog
filters and event operators (laplace, absdelay, transition, slew, idtmod,
zi), runtime-switched V/I branches, and noise collection — raise
``NotImplementedError`` naming ROADMAP item A14.
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


_A14 = "ROADMAP A14 (VA analog operators, noise and delay channels)"

#: VA calls the port does not interpret yet
_UNPORTED_CALLS = frozenset((
    "ddx", "idt", "laplace_nd", "laplace_np", "laplace_zd", "laplace_zp",
    "absdelay", "transition", "slew", "idtmod", "zi_nd", "zi_np", "zi_zd",
    "zi_zp"))


# -------------------------------------------------- (static, charge) values
# Every interpreter value is a (static, charge) pair; charge None = zero.

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
    return v if isinstance(v, tuple) else (v, None)


def _padd(a, b):
    a, b = _pair(a), _pair(b)
    q = a[1] if b[1] is None else (b[1] if a[1] is None else a[1] + b[1])
    return (a[0] + b[0], q)


def _psub(a, b):
    a, b = _pair(a), _pair(b)
    if b[1] is None:
        q = a[1]
    elif a[1] is None:
        q = -b[1]
    else:
        q = a[1] - b[1]
    return (a[0] - b[0], q)


def _pneg(a):
    a = _pair(a)
    return (-a[0], None if a[1] is None else -a[1])


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
    return (a[0] * b[0], q)


def _pdiv(a, b):
    a, b = _pair(a), _pair(b)
    if b[1] is not None:
        raise VACodegenError("division by a ddt() expression")
    q = None if a[1] is None else a[1] / b[0]
    return (a[0] / b[0], q)


def _scalar(a, what="expression"):
    a = _pair(a)
    if a[1] is not None:
        raise VACodegenError(f"ddt() result used inside nonlinear {what}")
    return a[0]


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


def _where(cond, a, b, dtype):
    """Select between two interpreter values on a tensor condition; two
    host floats become a tensor of ``dtype`` (``torch.where`` of two Python
    scalars would give float32)."""
    if _concrete(a, b):
        a = torch.full(cond.shape, a, dtype=dtype, device=cond.device)
    return D.where(cond, a, b)


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


# ------------------------------------------------------------------ the device

def make_device(module: Module, strict_ranges=False):
    """Compile a parsed VA Module into a DeviceModel subclass."""
    ports = list(module.ports)
    grounds = set(module.ground_nets)
    internal = [n for n in module.nets if n not in ports and n not in grounds]
    named_branch = {b.name: (b.pos, b.neg) for b in module.branches}

    for e in _all_exprs(module):
        if e[0] == "call" and e[1] in _UNPORTED_CALLS:
            raise NotImplementedError(
                f"module {module.name}: {e[1]}() is not ported to the "
                f"PyTorch VA interpreter yet — {_A14}")

    v_branches = []        # ordered (a, b) pairs with any V contribution
    i_branches = set()
    noise_sites = []
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
    if any(key in i_branches for key in v_branches):
        raise NotImplementedError(
            f"module {module.name}: runtime-switched V/I branches are not "
            f"ported yet — {_A14}")
    for e in _all_exprs(module):
        if e[0] == "call" and e[1] in ("white_noise", "flicker_noise",
                                        "noise_table"):
            if not any(x is e for x in noise_sites):
                noise_sites.append(e)

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
                     n_nodes_local, len(v_branches), noise_sites)

    class VADevice(DeviceModel):
        terminals = tuple(ports)
        n_internal = len(internal)
        n_branch = len(v_branches)
        n_noise = len(noise_sites)
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
            return interp.run(lv, p, ctx)

        @classmethod
        def noise(cls, lv, p, ctx):
            raise NotImplementedError(
                f"{module.name}: noise analysis is not ported yet — {_A14}")

    VADevice.params = {n: None for n in porder}
    VADevice.__name__ = f"VA_{module.name}"
    VADevice.__qualname__ = VADevice.__name__
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
                 n_nodes_local, n_vbranch, noise_sites):
        self.module = module
        self.noise_site_ids = {id(e): k for k, e in enumerate(noise_sites)}
        self.node_index = node_index
        self.branch_index = branch_index
        self.named_branch = named_branch
        self.n_nodes = n_nodes_local
        self.n_vbranch = n_vbranch

    def run(self, lv, p, ctx):
        """(static, dynamic): two lists of ``n_rows`` row contributions."""
        st = _State(self, lv, p, ctx)
        env = {}
        for stmt in self.module.analog:
            st.stmt(stmt, env)
        n_rows = self.n_nodes + self.n_vbranch
        static = [0.0] * n_rows
        dynamic = [0.0] * n_rows

        def add_row(idx, s, q):
            if idx < 0:
                return
            static[idx] = static[idx] + s
            if q is not None:
                dynamic[idx] = dynamic[idx] + q

        for key, value in env.items():
            if not isinstance(key, tuple):
                continue
            kind, a, b = key
            s, q = _pair(value)
            ia = self.node_index[a]
            ib = self.node_index[b] if b is not None else -1
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
        return static, dynamic


class _State:
    def __init__(self, interp, lv, p, ctx):
        self.it = interp
        self.lv = lv
        self.dtype = val(lv[0]).dtype
        self.p = p
        self.ctx = ctx
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
            v = _pair(self.expr(st[2], env))
            key = (kind, a, b)
            env[key] = _padd(env.get(key, (self.zero, None)), v)
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
        a ``where`` of the two branch values."""
        for k in set(env_t) | set(env_f):
            base = env.get(k, (self.zero, None))
            tv = env_t.get(k, base)
            fv = env_f.get(k, base)
            if tv is fv:
                env[k] = tv
                continue
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
            env[k] = (s, q)

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
            return (s, q)
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
            va, vb = _scalar(a, "'**'"), _scalar(b, "'**'")
            if _concrete(va, vb):
                return _host_binop(op, float(va), float(vb))
            return D.safe_pow(va, vb)
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

    def _callexpr(self, name, args, env, node=None):
        it = self.it
        if name == "V":
            a = self._node_v(args[0][1])
            if len(args) > 1:
                return a - self._node_v(args[1][1])
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
            return (self.zero, v)
        if name in ("white_noise", "flicker_noise", "noise_table"):
            # the slice runs no noise analysis: every noise input is zero,
            # so the power expression is never needed
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
            v = _scalar(self.expr(args[0], env), name)
            if _concrete(v):
                return _HOST_MATH1[name](float(v))
            return _MATH1[name](v)
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
