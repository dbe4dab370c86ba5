"""Verilog-A AST node definitions (subset for compact modeling).

Shape mirrors the reference CST forms (reference/VerilogAParser.jl/src/
parse/forms.jl:1-461): module/port/net/branch decls, parameter declarations
with value ranges, analog blocks, conditionals/loops/case, contribution
statements, analog functions with input/output arguments, attributes.

Copy of ``cedarsim_tpu/va/ast.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Range:
    # from (a:b] / exclude v — inclusive flags per side
    kind: str                  # 'from' | 'exclude'
    lo: object = None          # expr or None
    hi: object = None
    lo_incl: bool = True
    hi_incl: bool = True
    exclude_val: object = None


@dataclasses.dataclass
class Parameter:
    name: str
    ptype: str                 # 'real' | 'integer' | 'string'
    default: object            # expr
    ranges: list = dataclasses.field(default_factory=list)
    aliases: list = dataclasses.field(default_factory=list)
    desc: str = ""
    units: str = ""


@dataclasses.dataclass
class Branch:
    name: str
    pos: str
    neg: Optional[str]


@dataclasses.dataclass
class AnalogFunction:
    name: str
    rtype: str                 # 'real' | 'integer'
    inputs: list = dataclasses.field(default_factory=list)
    outputs: list = dataclasses.field(default_factory=list)
    locals_: dict = dataclasses.field(default_factory=dict)  # name->type
    body: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Module:
    name: str
    ports: list                # ordered port names
    port_dirs: dict            # name -> 'inout'|'input'|'output'
    nets: list                 # electrical net names (incl. ports)
    ground_nets: list
    branches: list             # [Branch]
    parameters: list           # [Parameter]
    variables: dict            # name -> 'real'|'integer' (module-level)
    var_attrs: dict            # name -> dict of attributes (desc/units)
    functions: dict            # name -> AnalogFunction
    analog: list               # statements


# ---- statements (tuples keep the interpreter simple) ----
# ('block', [stmts], local_vars_dict)
# ('assign', name_or_(name,index), expr)
# ('contrib', access('I'|'V', p, n_or_None), expr)
# ('if', cond, then_stmt, else_stmt_or_None)
# ('for', init_stmt, cond, step_stmt, body)
# ('while', cond, body)
# ('repeat', count_expr, body)
# ('case', expr, [(labels_or_None, stmt)])   None = default
# ('event', event_name, stmt)                 @(initial_step) etc.
# ('sys', name, [args])                       $strobe etc.
# ('call', name, [args])                      user fn as statement
# ('null',)

# ---- expressions ----
# ('num', v) ('str', s) ('ref', name)
# ('bin', op, a, b) ('un', op, a) ('cond', c, a, b)
# ('call', name, [args])      also V(), I(), ddt(), builtins
