"""SPICE/Spectre parameter-expression engine: tokenizer, Pratt parser, and
evaluator.

Covers the expression surface the reference lowers in ``SpcScope``
(reference/src/spectre.jl:474-554): arithmetic, comparisons, boolean and
ternary operators, the SPICE math function set
(reference/src/spectre_env.jl:79-206), SI-suffixed literals (exact
decimal, numbers.py), and Monte-Carlo ``agauss``/``gauss`` sampled from a
seeded RNG (reference samples from ``spec[].rng``, spectre_env.jl:178-187).

Expressions are parsed to small tuple ASTs that can be re-evaluated under a
new parameter environment — this is what makes netlist ``.param`` overrides
re-elaborate quickly (the ParamSim "params are data" contract,
reference/src/circuitodesystem.jl:41-65).

Copy of ``cedarsim_tpu/frontend/expr.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import math
import re

from cedarsim_tpu_torch.frontend.numbers import parse_number

_TOK = re.compile(r"""
    \s*(?:
      (?P<num>(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?[a-zA-Z%_]*)
    | (?P<name>[a-zA-Z_$][\w$.!]*)
    | (?P<op>\*\*|&&|\|\||~\^|\^~|<<|>>|==|!=|<=|>=|<|>|[-+*/%^(),?:!~&|])
    )""", re.VERBOSE)


class ExprError(ValueError):
    pass


def tokenize_expr(s: str, dialect="spice"):
    toks, pos = [], 0
    while pos < len(s):
        m = _TOK.match(s, pos)
        if not m:
            if s[pos:].strip() == "":
                break
            raise ExprError(f"bad token in expression at {s[pos:]!r}")
        pos = m.end()
        if m.group("num"):
            v = parse_number(m.group("num"), dialect)
            if v is None:
                raise ExprError(f"bad number {m.group('num')!r}")
            toks.append(("num", v))
        elif m.group("name"):
            toks.append(("name", m.group("name")))
        else:
            toks.append(("op", m.group("op")))
    toks.append(("end", None))
    return toks


# binding powers, C-like order for the bitwise tier (Spectre follows C:
# `a & b == c` is `a & (b == c)`; the reference evaluates `1&2~^3` as
# ~((1&2) xor 3), reference/test/spectre_expr.jl:13,33)
_BINOPS = {
    "||": 2, "&&": 3,
    "|": 4, "xor": 5, "xnor": 5, "&": 6,
    "==": 7, "!=": 7, "<": 8, "<=": 8, ">": 8, ">=": 8,
    "<<": 9, ">>": 9,
    "+": 10, "-": 10, "*": 20, "/": 20, "%": 20,
    "**": 30, "^": 30,
}
_RIGHT = {"**", "^"}


class _Parser:
    def __init__(self, toks, dialect="spice"):
        self.toks = toks
        self.i = 0
        self.dialect = dialect

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, op):
        t = self.next()
        if t != ("op", op):
            raise ExprError(f"expected {op!r}, got {t!r}")

    def parse(self, rbp=0):
        left = self.nud()
        while True:
            kind, val = self.peek()
            if kind == "op" and val == "?" and rbp <= 1:
                self.next()
                a = self.parse(0)
                self.expect(":")
                b = self.parse(1)
                left = ("cond", left, a, b)
                continue
            # dialect split: `^` is XOR in Spectre, power in SPICE/hspice;
            # `~^`/`^~` is XNOR in both
            if val == "^" and self.dialect == "spectre":
                val = "xor"
            elif val in ("~^", "^~"):
                val = "xnor"
            if kind != "op" or val not in _BINOPS:
                break
            bp = _BINOPS[val]
            if bp <= rbp:
                break
            self.next()
            right = self.parse(bp - 1 if val in _RIGHT else bp)
            left = ("bin", val, left, right)
        return left

    def nud(self):
        kind, val = self.next()
        if kind == "num":
            return ("num", val)
        if kind == "name":
            if self.peek() == ("op", "("):
                self.next()
                args = []
                if self.peek() != ("op", ")"):
                    args.append(self.parse(0))
                    while self.peek() == ("op", ","):
                        self.next()
                        args.append(self.parse(0))
                self.expect(")")
                return ("call", val.lower(), tuple(args))
            return ("ref", val)
        if kind == "op":
            if val == "(":
                e = self.parse(0)
                self.expect(")")
                return e
            if val == "-":
                return ("neg", self.parse(25))
            if val == "+":
                return self.parse(25)
            if val == "!":
                return ("not", self.parse(25))
            if val == "~":
                return ("inv", self.parse(25))
        raise ExprError(f"unexpected token {val!r}")


def parse_expr(s: str, dialect="spice"):
    p = _Parser(tokenize_expr(s, dialect), dialect)
    ast = p.parse(0)
    if p.peek()[0] != "end":
        raise ExprError(f"trailing tokens in expression {s!r}")
    return ast


def _sgn(x):
    return (x > 0) - (x < 0)


def _int(x):
    """Bitwise-operand conversion: round-to-nearest like VA's vaconvert
    (ties away from zero)."""
    return int(math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5))


#: predefined constants (Spectre UG set; the reference exports M_1_PI from
#: its SpectreEnvironment, reference/src/spectre_env.jl:142,204)
_CONSTS = {
    "pi": math.pi, "m_pi": math.pi, "m_pi_2": math.pi / 2,
    "m_pi_4": math.pi / 4, "m_1_pi": 1.0 / math.pi,
    "m_2_pi": 2.0 / math.pi, "m_two_pi": 2.0 * math.pi,
    "m_e": math.e, "m_log2e": 1.0 / math.log(2.0),
    "m_log10e": 1.0 / math.log(10.0), "m_ln2": math.log(2.0),
    "m_ln10": math.log(10.0), "m_sqrt2": math.sqrt(2.0),
    "m_sqrt1_2": math.sqrt(0.5), "m_degperrad": 180.0 / math.pi,
    "e": math.e,
    "p_q": 1.602176634e-19, "p_k": 1.380649e-23, "p_c": 2.99792458e8,
    "p_h": 6.62607015e-34, "p_eps0": 8.8541878128e-12,
    "p_u0": 4e-7 * math.pi, "p_celsius0": 273.15,
    "true": 1.0, "false": 0.0,
}


_FUNCS = {
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "asin": math.asin, "acos": math.acos, "atan": math.atan,
    "arctan": math.atan, "atan2": math.atan2,
    "sinh": math.sinh, "cosh": math.cosh, "tanh": math.tanh,
    "exp": math.exp, "ln": math.log, "log": math.log, "log10": math.log10,
    "sqrt": math.sqrt, "abs": math.fabs,
    "pow": lambda x, y: math.copysign(abs(x) ** y, 1.0) if x >= 0 else x ** y,
    "pwr": lambda x, y: _sgn(x) * abs(x) ** y,
    "min": min, "max": max,
    "int": lambda x: float(int(x)),
    "nint": lambda x: float(math.floor(x + 0.5) if x >= 0
                            else math.ceil(x - 0.5)),
    "floor": math.floor, "ceil": math.ceil, "sgn": _sgn,
}


class _FuncScope:
    """Local argument bindings over a parent env (user-defined functions)."""

    def __init__(self, parent, local):
        self.parent = parent
        self.local = local

    def __contains__(self, k):
        return k in self.local or k in self.parent

    def __getitem__(self, k):
        if k in self.local:
            return self.local[k]
        return self.parent[k]

    def get(self, k, default=None):
        if k in self.local:
            return self.local[k]
        g = getattr(self.parent, "get", None)
        return g(k, default) if g else default


def eval_expr(ast, env, rng=None):
    """Evaluate a parsed expression AST. ``env`` maps lowercase names to
    values; ``rng`` is a numpy Generator for Monte-Carlo functions."""
    kind = ast[0]
    if kind == "num":
        return ast[1]
    if kind == "ref":
        name = ast[1].lower()
        if name in env:
            v = env[name]
            return v() if callable(v) else v
        if name in _CONSTS:
            return _CONSTS[name]
        if name in ("temper", "temp"):
            return env.get("$temp", 27.0)
        if name == "time":
            return env.get("$time", 0.0)
        raise ExprError(f"undefined parameter {ast[1]!r}")
    if kind == "neg":
        return -eval_expr(ast[1], env, rng)
    if kind == "not":
        return float(not eval_expr(ast[1], env, rng))
    if kind == "inv":
        return float(~_int(eval_expr(ast[1], env, rng)))
    if kind == "bin":
        op = ast[1]
        a = eval_expr(ast[2], env, rng)
        if op == "&&":
            return float(bool(a) and bool(eval_expr(ast[3], env, rng)))
        if op == "||":
            return float(bool(a) or bool(eval_expr(ast[3], env, rng)))
        b = eval_expr(ast[3], env, rng)
        if op == "+": return a + b
        if op == "-": return a - b
        if op == "*": return a * b
        if op == "/": return a / b
        if op == "%": return math.fmod(a, b)
        if op in ("**", "^"): return a ** b
        if op == "&": return float(_int(a) & _int(b))
        if op == "|": return float(_int(a) | _int(b))
        if op == "xor": return float(_int(a) ^ _int(b))
        if op == "xnor": return float(~(_int(a) ^ _int(b)))
        if op == "<<": return float(_int(a) << _int(b))
        if op == ">>": return float(_int(a) >> _int(b))
        if op == "==": return float(a == b)
        if op == "!=": return float(a != b)
        if op == "<": return float(a < b)
        if op == "<=": return float(a <= b)
        if op == ">": return float(a > b)
        if op == ">=": return float(a >= b)
    if kind == "cond":
        return (eval_expr(ast[2], env, rng) if eval_expr(ast[1], env, rng)
                else eval_expr(ast[3], env, rng))
    if kind == "call":
        name, args = ast[1], [eval_expr(a, env, rng) for a in ast[2]]
        fkey = name + "()"
        if fkey in env:
            fd = env[fkey]
            if isinstance(fd, tuple) and fd and fd[0] == "funcdef":
                _, anames, body = fd
                if len(args) != len(anames):
                    raise ExprError(
                        f"{name}() takes {len(anames)} args, got {len(args)}")
                return eval_expr(body, _FuncScope(env, dict(zip(anames,
                                                                args))), rng)
        if name in _FUNCS:
            return _FUNCS[name](*args)
        # Monte-Carlo sampling functions (reference agauss:
        # reference/src/spectre_env.jl:178-187)
        if name in ("agauss", "gauss", "aunif", "unif"):
            if rng is None:
                return args[0]  # nominal value when MC disabled
            nom, var = args[0], args[1]
            sigma = args[2] if len(args) > 2 else 1.0
            if name == "agauss":
                return nom + rng.normal(0.0, var / sigma)
            if name == "gauss":
                return nom + nom * rng.normal(0.0, var / sigma)
            if name == "aunif":
                return nom + rng.uniform(-var, var)
            return nom + nom * rng.uniform(-var, var)
        raise ExprError(f"unknown function {ast[1]!r}")
    raise ExprError(f"bad AST node {ast!r}")


def expr_refs(ast, out=None):
    """Names referenced by an expression (for dependency ordering)."""
    if out is None:
        out = set()
    kind = ast[0]
    if kind == "ref":
        out.add(ast[1].lower())
    elif kind == "num":
        pass
    elif kind in ("neg", "not", "inv"):
        expr_refs(ast[1], out)
    elif kind == "bin":
        expr_refs(ast[2], out); expr_refs(ast[3], out)
    elif kind == "cond":
        for a in ast[1:]:
            expr_refs(a, out)
    elif kind == "call":
        for a in ast[2]:
            expr_refs(a, out)
    return out
