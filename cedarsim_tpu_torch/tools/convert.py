"""Netlist dialect conversion — the SpiceArmyKnife equivalent.

The reference ships ``spak-convert`` (SpiceArmyKnife.jl/src/Convert.jl:26-60)
with per-simulator emitters over the shared CST
(``CodeGenScope{Sim}``, src/codegen.jl:24-63; SPICE->Spectre in
cg_spectre.jl, SPICE->SPICE in cg_spice.jl, SPICE->Verilog-A in
cg_veriloga.jl).  Here both dialect parsers already normalize to one
statement AST (frontend/parser.py dataclasses), so conversion is an emitter
per output dialect over that AST plus a model-type mapping table.  The
Verilog-A emitter additionally lowers primitive elements to analog
contributions, so a converted subckt of primitives is a self-contained VA
module that compiles back through this framework's own VA pipeline
(round-trip gated in tests/test_convert.py).

Magnitude suffixes are never emitted — numbers print in exponent form, which
sidesteps the SPICE ``M``=milli vs Spectre ``M``=mega trap the reference's
converter handles with suffix tables (cg_veriloga.jl:6-50).

CLI (mirrors spak-convert):

    python -m cedarsim_tpu.tools.convert in.cir out.scs \
        --input-simulator auto --output-simulator spectre

Model-database extraction (the Generate.jl role, SpiceArmyKnife.jl/src/
Generate.jl:14-60): ``--extract-models db.json`` writes every .model card
(incl. inside subckts/libs) as JSON.

Copy of ``cedarsim_tpu/tools/convert.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
In the port the CLI runs as ``python -m cedarsim_tpu_torch.tools.convert``.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from cedarsim_tpu_torch.frontend import parser as P


class ConvertError(ValueError):
    pass


# ------------------------------------------------------------------ numbers

def fmt_num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    if math.isinf(f):
        return "1e30" if f > 0 else "-1e30"
    return repr(f)


# -------------------------------------------------------------- expressions

_PREC = {"||": 1, "&&": 2, "==": 3, "!=": 3, "<": 4, "<=": 4, ">": 4,
         ">=": 4, "+": 5, "-": 5, "*": 6, "/": 6, "%": 6, "**": 7}


def emit_expr(ast, dialect="spectre") -> str:
    """Expression AST -> source text (parenthesized conservatively)."""
    if isinstance(ast, (int, float)):
        return fmt_num(ast)
    if isinstance(ast, str):
        return ast
    kind = ast[0]
    if kind == "num":
        return fmt_num(ast[1])
    if kind == "ref":
        return str(ast[1])
    if kind == "un":
        return f"(-{emit_expr(ast[2], dialect)})" if ast[1] == "-" \
            else f"({ast[1]}{emit_expr(ast[2], dialect)})"
    if kind == "bin":
        return (f"({emit_expr(ast[2], dialect)}{ast[1]}"
                f"{emit_expr(ast[3], dialect)})")
    if kind == "cond":
        return (f"({emit_expr(ast[1], dialect)}?"
                f"{emit_expr(ast[2], dialect)}:"
                f"{emit_expr(ast[3], dialect)})")
    if kind == "call":
        args = ",".join(emit_expr(a, dialect) for a in ast[2])
        return f"{ast[1]}({args})"
    raise ConvertError(f"cannot emit expression node {ast!r}")


def emit_val(v, dialect, top=True):
    """A parameter value: number stays bare; an expression gets the
    dialect's quoting ({...} for SPICE, bare for Spectre)."""
    if isinstance(v, (int, float)):
        return fmt_num(v)
    if isinstance(v, tuple) and v and v[0] == "ref" and dialect == "spice":
        return str(v[1])
    s = emit_expr(v, dialect)
    if dialect == "spice" and top:
        return "{" + s + "}"
    return s


# ------------------------------------------------------- model-type mapping

#: SPICE (mtype, level) -> Spectre master
def _spice_model_to_spectre(mtype, params):
    lvl = params.get("level")
    lvl = float(lvl) if isinstance(lvl, (int, float)) else None
    if mtype in ("nmos", "pmos"):
        ty = "n" if mtype == "nmos" else "p"
        if lvl in (8.0, 49.0, 53.0):
            return "bsim3v3", {"type": ("ref", ty)}
        if lvl in (17.0, 72.0):
            return "bsimcmg", {"type": ("ref", ty)}
        if lvl in (14.0, 54.0) or lvl is None:
            return "bsim4", {"type": ("ref", ty)}
        return "mos1", {"type": ("ref", ty)}
    table = {"d": "diode", "diode": "diode", "npn": "bjt", "pnp": "bjt",
             "r": "resistor", "res": "resistor", "resistor": "resistor",
             "c": "capacitor", "capacitor": "capacitor", "sw": "relay",
             "csw": "relay", "l": "inductor", "inductor": "inductor"}
    extra = {}
    if mtype in ("npn", "pnp"):
        extra["type"] = ("ref", mtype)
        if lvl in (4.0, 9.0):
            return "vbic", extra       # BJT level 4/9 selects VBIC
    return table.get(mtype, mtype), extra


#: Spectre master -> SPICE (mtype, extra params)
def _spectre_model_to_spice(mtype, params):
    ty = params.get("type")
    if isinstance(ty, tuple) and ty and ty[0] == "ref":
        ty = ty[1]
    ty = str(ty).lower() if ty is not None else "n"
    if mtype in ("bsim4", "bsim3v3", "bsimcmg", "mos1", "bsim3", "mos902"):
        lvl = {"bsim4": 54.0, "bsim3v3": 49.0, "bsim3": 49.0,
               "bsimcmg": 72.0, "mos1": 1.0, "mos902": 1.0}[mtype]
        return ("nmos" if ty != "p" else "pmos"), {"level": lvl}
    if mtype == "vbic":
        return ("pnp" if ty == "pnp" else "npn"), {"level": 4.0}
    table = {"diode": "d", "resistor": "r", "capacitor": "c",
             "inductor": "l", "bjt": ("pnp" if ty == "pnp" else "npn"),
             "relay": "sw"}
    return table.get(mtype, mtype), {}


def _scan_source_tokens(el):
    """SPICE V/I positional token stream -> {dc, ac, acphase} (the same scan
    as elaborate._instantiate_source: the model slot and values may hold the
    'dc'/'ac' marker words)."""
    pending = []
    if el.model is not None:
        pending.append(("ref", el.model))
    pending += list(el.values)
    out = {}
    positional = []
    i = 0
    while i < len(pending):
        v = pending[i]
        if isinstance(v, tuple) and v and v[0] == "ref" \
                and isinstance(v[1], str):
            w = v[1].lower()
            if w == "dc":
                if i + 1 < len(pending):
                    out["dc"] = pending[i + 1]
                i += 2
                continue
            if w == "ac":
                if i + 1 < len(pending):
                    out["ac"] = pending[i + 1]
                    i += 2
                    if i < len(pending) and not (
                            isinstance(pending[i], tuple)
                            and pending[i][0] == "ref"):
                        out["acphase"] = pending[i]
                        i += 1
                else:
                    i += 1
                continue
        positional.append(v)
        i += 1
    if positional and "dc" not in out:
        out["dc"] = positional[0]
    return out


# ----------------------------------------------------------- Spectre output

_WAVE_TO_SPECTRE = {
    "pulse": ("pulse", ["val0", "val1", "delay", "rise", "fall", "width",
                        "period"]),
    "sin": ("sine", ["sinedc", "ampl", "freq", "delay", "damp"]),
    "sine": ("sine", ["sinedc", "ampl", "freq", "delay", "damp"]),
    "exp": ("exp", ["val0", "val1", "td1", "tau1", "td2", "tau2"]),
}


class SpectreEmitter:
    dialect = "spectre"

    def __init__(self, in_dialect="spice"):
        self.lines = []
        self.n_analysis = 0
        self.in_dialect = in_dialect

    def num_tok(self, a):
        """Directive tokens arrive as raw strings; SI suffixes must be
        re-based on the *input* dialect (SPICE M=milli vs Spectre M=mega —
        the trap the reference handles with suffix tables,
        cg_veriloga.jl:6-50)."""
        if isinstance(a, str):
            from cedarsim_tpu_torch.frontend.numbers import parse_number
            v = parse_number(a, self.in_dialect)
            if v is not None:
                return fmt_num(v)
            return a
        return emit_val(a, self.dialect)

    def emit(self, netlist: P.SpiceNetlist) -> str:
        self.lines = ["// converted by cedarsim_tpu.tools.convert"]
        if netlist.title:
            self.lines.append("// " + netlist.title)
        self.lines.append("simulator lang=spectre")
        self.stmts(netlist.statements)
        return "\n".join(self.lines) + "\n"

    def stmts(self, stmts):
        for st in stmts:
            self.stmt(st)

    def kw(self, params, skip=()):
        out = []
        for k, v in params.items():
            if k in skip or v is None:
                continue
            out.append(f"{k}={emit_val(v, self.dialect)}")
        return out

    def stmt(self, st):
        L = self.lines
        if isinstance(st, P.Param):
            if st.assignments:
                L.append("parameters " + " ".join(
                    f"{k}={emit_val(v, self.dialect)}"
                    for k, v in st.assignments))
        elif isinstance(st, P.Model):
            master, extra = _spice_model_to_spectre(st.mtype, st.params)
            parts = [f"model {st.name} {master}"]
            parts += self.kw(extra)
            parts += self.kw(st.params, skip=("level",))
            L.append(" ".join(parts))
        elif isinstance(st, P.Subckt):
            L.append(f"subckt {st.name} ({' '.join(st.nodes)})")
            if st.params:
                L.append("parameters " + " ".join(
                    f"{k}={emit_val(v, self.dialect)}"
                    for k, v in st.params.items()))
            body = [s for s in st.body
                    if not (isinstance(s, P.Param)
                            and all(k in st.params
                                    for k, _ in s.assignments))]
            self.stmts(body)
            L.append(f"ends {st.name}")
        elif isinstance(st, P.Include):
            if st.section:
                L.append(f'include "{st.path}" section={st.section}')
            else:
                L.append(f'include "{st.path}"')
        elif isinstance(st, P.LibSection):
            L.append(f"section {st.name}")
            self.stmts(st.body)
            L.append("endsection")
        elif isinstance(st, P.Element):
            self.element(st)
        elif isinstance(st, P.Control):
            self.control(st)
        elif isinstance(st, P.IfBlock):
            # Spectre has no .if; emit every branch commented except none —
            # conservative: refuse rather than silently drop
            raise ConvertError(
                f"{st.loc.file}:{st.loc.line}: .if blocks cannot be "
                "represented in Spectre output; resolve them first")
        elif isinstance(st, P.ErrorNode):
            L.append(f"// PARSE ERROR preserved: {st.message}")
        else:
            raise ConvertError(f"cannot convert {type(st).__name__}")

    _MASTER = {"r": "resistor", "c": "capacitor", "l": "inductor",
               "v": "vsource", "i": "isource", "e": "vcvs", "g": "vccs",
               "f": "cccs", "h": "ccvs"}

    def element(self, el: P.Element):
        L = self.lines
        nodes = f"({' '.join(el.nodes)})"
        letter = el.letter
        if letter in ("r", "c", "l"):
            params = dict(el.params)
            key = letter
            if el.values and key not in params:
                params = {key: el.values[0], **params}
            parts = [f"{el.name} {nodes} {self._MASTER[letter]}"]
            parts += self.kw(params)
            L.append(" ".join(parts))
            return
        if letter in ("v", "i"):
            parts = [f"{el.name} {nodes} {self._MASTER[letter]}"]
            p = dict(el.params)
            p.update(_scan_source_tokens(el))
            acmag = p.pop("ac", None)
            if acmag is not None:
                p["mag"] = acmag
            p.pop("acphase", None)
            parts += self.kw(p)
            for kind, args in el.waves:
                if kind == "pwl":
                    pts = " ".join(emit_val(a, self.dialect, top=False)
                                   for a in args)
                    parts.append(f"type=pwl wave=[{pts}]")
                elif kind in _WAVE_TO_SPECTRE:
                    sname, names = _WAVE_TO_SPECTRE[kind]
                    parts.append(f"type={sname}")
                    for pname, a in zip(names, args):
                        parts.append(
                            f"{pname}={emit_val(a, self.dialect)}")
                else:
                    raise ConvertError(f"{el.name}: waveform {kind!r} not "
                                       "convertible")
            L.append(" ".join(parts))
            return
        if letter in ("e", "g"):
            gain = el.values[0] if el.values else el.params.get(
                "gain", el.params.get("gm", 1.0))
            gname = "gain" if letter == "e" else "gm"
            L.append(f"{el.name} {nodes} {self._MASTER[letter]} "
                     f"{gname}={emit_val(gain, self.dialect)}")
            return
        if letter in ("f", "h"):
            gain = el.values[0] if el.values else 1.0
            gname = "gain" if letter == "f" else "rm"
            L.append(f"{el.name} {nodes} {self._MASTER[letter]} "
                     f"probe={el.model} {gname}="
                     f"{emit_val(gain, self.dialect)}")
            return
        if letter == "b":
            parts = [f"{el.name} {nodes} bsource"]
            for k, v in el.params.items():
                parts.append(f"{k}={emit_expr(v, self.dialect)}")
            L.append(" ".join(parts))
            return
        if letter == "k":
            names = list(el.nodes)
            if el.model:
                names.append(el.model)
            kval = el.values[0] if el.values else el.params.get("k", 1.0)
            L.append(f"{el.name} mutual_inductor coupling="
                     f"{emit_val(kval, self.dialect)} "
                     f"ind1={names[0]} ind2={names[1]}")
            return
        if letter in ("d", "m", "q", "j", "x", "s", "w", "z"):
            parts = [f"{el.name} {nodes} {el.model}"]
            for i, v in enumerate(el.values):
                if letter in ("d", "q") and i == 0:
                    parts.append(f"area={emit_val(v, self.dialect)}")
            parts += self.kw(el.params)
            L.append(" ".join(parts))
            return
        raise ConvertError(f"{el.name}: device letter {letter!r} not "
                           "convertible")

    def control(self, st: P.Control):
        L = self.lines
        cmd = st.cmd

        def aname(kind):
            self.n_analysis += 1
            return f"{kind}{self.n_analysis}"

        def num(a):
            return self.num_tok(a)

        if cmd == "tran":
            args = [a for a in st.args]
            # .tran tstep tstop [tstart [hmax]]
            parts = [f"{aname('tran')} tran"]
            if len(args) >= 2:
                parts.append(f"stop={num(args[1])}")
                parts.append(f"step={num(args[0])}")
            elif args:
                parts.append(f"stop={num(args[0])}")
            parts += self.kw(st.kwargs)
            L.append(" ".join(parts))
        elif cmd == "op":
            L.append(f"{aname('dcop')} dc")
        elif cmd == "dc":
            parts = [f"{aname('dc')} dc"]
            if len(st.args) >= 4:
                parts += [f"dev={st.args[0]}", "param=dc",
                          f"start={num(st.args[1])}",
                          f"stop={num(st.args[2])}",
                          f"step={num(st.args[3])}"]
            L.append(" ".join(parts))
        elif cmd == "ac":
            # .ac dec|lin|oct n fstart fstop
            parts = [f"{aname('ac')} ac"]
            if len(st.args) >= 4:
                mode = str(st.args[0]).lower()
                parts.append(f"start={num(st.args[2])}")
                parts.append(f"stop={num(st.args[3])}")
                if mode == "dec":
                    parts.append(f"dec={num(st.args[1])}")
                elif mode == "lin":
                    parts.append(f"lin={num(st.args[1])}")
                elif mode == "oct":
                    parts.append(f"oct={num(st.args[1])}")
            L.append(" ".join(parts))
        elif cmd == "noise":
            parts = [f"{aname('noise')} noise"]
            parts += [str(a) for a in st.args if isinstance(a, str)]
            L.append(" ".join(parts))
        elif cmd in ("ic", "nodeset"):
            L.append(cmd + " " + " ".join(
                f"{k}={emit_val(v, self.dialect)}"
                for k, v in st.kwargs.items()))
        elif cmd == "global":
            L.append("global " + " ".join(st.args))
        elif cmd == "option":
            L.append("opts1 options " + " ".join(
                f"{k}={emit_val(v, self.dialect)}"
                for k, v in st.kwargs.items()))
        elif cmd == "temp":
            L.append(f"opts_temp options temp={st.args[0]}")
        elif cmd in ("hdl", "va"):
            L.append(f'ahdl_include "{st.args[0]}"')
        elif cmd == "funcdecl":
            name, args, body = st.args
            argl = ", ".join(f"real {a}" for a in args)
            L.append(f"real {name}({argl}) {{ return "
                     f"{emit_expr(body, self.dialect)}; }}")
        elif cmd in ("meas", "measure"):
            L.append("// (no Spectre equivalent) " + st.loc.src.strip())
        elif cmd in ("print", "plot", "save", "probe", "width", "end",
                     "backanno", "data", "four", "tf", "alterstmt",
                     "altergroup"):
            if st.loc is not None and st.loc.src:
                L.append("// " + st.loc.src.strip())
        else:
            L.append("// unconverted: " +
                     (st.loc.src.strip() if st.loc else cmd))


# ------------------------------------------------------------- SPICE output

_WAVE_ORDER = {"pulse": 7, "sin": 6, "sine": 6, "exp": 6, "pwl": None}


class SpiceEmitter:
    dialect = "spice"

    def __init__(self, in_dialect="spectre"):
        self.lines = []
        self.in_dialect = in_dialect

    def emit(self, netlist: P.SpiceNetlist) -> str:
        self.lines = [netlist.title or
                      "* converted by cedarsim_tpu.tools.convert"]
        self.stmts(netlist.statements)
        self.lines.append(".end")
        return "\n".join(self.lines) + "\n"

    def stmts(self, stmts):
        for st in stmts:
            self.stmt(st)

    def kw(self, params, skip=()):
        return [f"{k}={emit_val(v, self.dialect)}"
                for k, v in params.items() if k not in skip and v is not None]

    def stmt(self, st):
        L = self.lines
        if isinstance(st, P.Param):
            for k, v in st.assignments:
                L.append(f".param {k}={emit_val(v, self.dialect)}")
        elif isinstance(st, P.Model):
            mtype, extra = _spectre_model_to_spice(st.mtype, st.params)
            parts = [f".model {st.name} {mtype}"]
            parts += self.kw(extra)
            parts += self.kw(st.params, skip=("type",))
            L.append(" ".join(parts))
        elif isinstance(st, P.Subckt):
            head = [f".subckt {st.name}"] + list(st.nodes)
            head += self.kw(st.params)
            L.append(" ".join(head))
            body = [s for s in st.body
                    if not (isinstance(s, P.Param)
                            and all(k in st.params
                                    for k, _ in s.assignments))]
            self.stmts(body)
            L.append(".ends " + st.name)
        elif isinstance(st, P.Include):
            if st.section:
                L.append(f'.lib "{st.path}" {st.section}')
            else:
                L.append(f'.include "{st.path}"')
        elif isinstance(st, P.LibSection):
            L.append(f".lib {st.name}")
            self.stmts(st.body)
            L.append(f".endl {st.name}")
        elif isinstance(st, P.Element):
            self.element(st)
        elif isinstance(st, P.Control):
            self.control(st)
        elif isinstance(st, P.IfBlock):
            for i, (cond, body) in enumerate(st.branches):
                if cond is None:
                    L.append(".else")
                else:
                    k = ".if" if i == 0 else ".elseif"
                    L.append(f"{k} ({emit_expr(cond, self.dialect)})")
                self.stmts(body)
            L.append(".endif")
        elif isinstance(st, P.ErrorNode):
            L.append(f"* PARSE ERROR preserved: {st.message}")
        else:
            raise ConvertError(f"cannot convert {type(st).__name__}")

    def element(self, el: P.Element):
        L = self.lines
        name = el.name
        if not name.lower().startswith(el.letter):
            name = el.letter + name
        parts = [name] + list(el.nodes)
        if el.model is not None:
            # for f/h the model slot is the control source; emit positionally
            parts.append(el.model)
        for v in el.values:
            parts.append(emit_val(v, self.dialect))
        for kind, args in el.waves:
            a = " ".join(emit_val(x, self.dialect, top=False) for x in args)
            parts.append(f"{kind.upper()}({a})")
        parts += self.kw(el.params)
        L.append(" ".join(parts))

    def control(self, st: P.Control):
        L = self.lines
        cmd = st.cmd
        if cmd == "funcdecl":
            name, args, body = st.args
            L.append(f".param {name}({','.join(args)})="
                     f"{{{emit_expr(body, self.dialect)}}}")
            return
        if cmd in ("ic", "nodeset"):
            L.append(f".{cmd} " + " ".join(
                f"v({k})={emit_val(v, self.dialect)}"
                for k, v in st.kwargs.items()))
            return
        if cmd in ("hdl", "va"):
            L.append(f'.hdl "{st.args[0]}"')
            return
        if cmd == "op":
            L.append(".op")
            return
        def tok(a):
            if isinstance(a, str):
                from cedarsim_tpu_torch.frontend.numbers import parse_number
                v = parse_number(a, self.in_dialect)
                return fmt_num(v) if v is not None else a
            return fmt_num(a)

        parts = [f".{cmd}"]
        parts += [tok(a) for a in st.args
                  if not isinstance(a, (list, tuple, dict))]
        parts += self.kw(st.kwargs)
        L.append(" ".join(parts))


# --------------------------------------------------------- Verilog-A output

_VA_KEYWORDS = {
    "module", "endmodule", "analog", "begin", "end", "parameter", "real",
    "integer", "electrical", "ground", "branch", "inout", "input", "output",
    "if", "else", "for", "while", "case", "endcase", "function", "endfunction",
    "paramset", "endparamset", "from", "exclude", "string",
}


def _va_id(name: str) -> str:
    """Sanitize a SPICE name into a legal Verilog-A identifier (lowercased —
    the reference lowercases everything SPICE, cg_veriloga.jl:262)."""
    out = []
    for ch in str(name).lower():
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out)
    if not s or not (s[0].isalpha() or s[0] == "_"):
        s = "n_" + s
    if s in _VA_KEYWORDS:
        s += "_"
    return s


def emit_expr_va(ast, ref=None) -> str:
    """Expression AST -> Verilog-A source.  ``ref(name)`` maps identifier
    references (used for global-\\`define prefixing and lowercasing, the
    reference's Identifier handler, cg_veriloga.jl:261-291).  ``**`` becomes
    ``pow()`` — VA has no power operator."""
    r = ref or _va_id
    if isinstance(ast, (int, float)):
        return fmt_num(ast)
    if isinstance(ast, str):
        return r(ast)
    kind = ast[0]
    if kind == "num":
        return fmt_num(ast[1])
    if kind == "ref":
        return r(ast[1])
    if kind == "un":
        return f"({ast[1]}{emit_expr_va(ast[2], r)})"
    if kind == "bin":
        if ast[1] in ("**", "^"):
            return (f"pow({emit_expr_va(ast[2], r)},"
                    f"{emit_expr_va(ast[3], r)})")
        return (f"({emit_expr_va(ast[2], r)}{ast[1]}"
                f"{emit_expr_va(ast[3], r)})")
    if kind == "cond":
        return (f"({emit_expr_va(ast[1], r)}?"
                f"{emit_expr_va(ast[2], r)}:"
                f"{emit_expr_va(ast[3], r)})")
    if kind == "call":
        fn = str(ast[1]).lower()
        args = [emit_expr_va(a, r) for a in ast[2]]
        # SPICE spellings -> VA LRM spellings
        fn = {"atan": "atan", "arctan": "atan", "log": "ln", "log10": "log",
              "pwr": "pow", "int": "floor"}.get(fn, fn)
        return f"{fn}({','.join(args)})"
    raise ConvertError(f"cannot emit VA expression node {ast!r}")


#: SPICE .model type -> Verilog-A master module the paramset specializes
#: (the reference resolves these against its model DB and emits
#: ``paramset <name> <module>;``, cg_veriloga.jl:446-482).
def _spice_model_to_va_master(mtype, params):
    master, extra = _spice_model_to_spectre(mtype, params)
    ty = extra.get("type")
    ty = ty[1] if isinstance(ty, tuple) else None
    return {"bsim3v3": "bsim3"}.get(master, master), ty


class VerilogAEmitter:
    """SPICE/Spectre netlist -> Verilog-A (the cg_veriloga.jl role,
    SpiceArmyKnife.jl/src/cg_veriloga.jl).

    Reference-shaped output:
      - top-level ``.param`` -> \\`define macros (module-scope params stay
        ``parameter real``), cg_veriloga.jl:229-259;
      - ``.model`` -> ``paramset`` specializing a VA master module,
        cg_veriloga.jl:427-537;
      - ``.subckt`` -> ``module`` with electrical ports, cg_veriloga.jl:538+;
        subckt instances (X) and modeled devices (D/M/Q/...) become
        structural module instantiations;
      - primitive elements (R C L V I E G F H B) lower to analog
        *contributions* in the containing module — a module with only
        primitives is self-contained Verilog-A that compiles straight back
        through this framework's own VA pipeline (round-trip tested).

    Waveform sources (SIN/PULSE/EXP/PWL) become closed-form ``$abstime``
    expressions with SPICE semantics (hold before delay, periodic pulse via
    ``floor()``, PWL as nested ternary interpolation).
    """

    dialect = "veriloga"

    def __init__(self, in_dialect="spice"):
        self.lines = []
        self.globals = set()       # lowercased `define'd top-level params
        self.paramsets = {}        # model name -> master
        self.modules = set()       # emitted module names
        self.in_dialect = in_dialect

    # ---- identifier/ref helpers

    def _ref_factory(self, local):
        globals_ = self.globals

        def ref(name):
            s = _va_id(name)
            if s in local:
                return s
            if s in globals_:
                return "`" + s
            return s
        return ref

    def ev(self, v, local=frozenset()):
        return emit_expr_va(v, self._ref_factory(local))

    # ---- top level

    def emit(self, netlist: P.SpiceNetlist) -> str:
        L = self.lines = ["// converted by cedarsim_tpu.tools.convert"]
        if netlist.title:
            L.append("// " + netlist.title)
        L.append('`include "disciplines.vams"')
        L.append("")
        top_elements = []
        for st in netlist.statements:
            if isinstance(st, P.Param):
                for k, v in st.assignments:
                    name = _va_id(k)
                    self.globals.add(name)
                    L.append(f"`define {name} ({self.ev(v)})")
            elif isinstance(st, P.Model):
                self.paramset(st)
            elif isinstance(st, P.Subckt):
                self.module(st.name, st.nodes, st.params, st.body, st.loc)
            elif isinstance(st, P.Element):
                top_elements.append(st)
            elif isinstance(st, P.Include):
                L.append(f"// include not converted inline — convert "
                         f"separately: {st.path}"
                         + (f" section={st.section}" if st.section else ""))
            elif isinstance(st, P.LibSection):
                # the reference wraps .lib sections in `ifdef blocks
                # (cg_veriloga.jl:120-137)
                tag = "SECTION_" + _va_id(st.name).upper()
                L.append(f"`ifdef {tag}")
                for s in st.body:
                    if isinstance(s, P.Model):
                        self.paramset(s)
                    elif isinstance(s, P.Subckt):
                        self.module(s.name, s.nodes, s.params, s.body, s.loc)
                    else:
                        L.append("// unconverted in section: " +
                                 (s.loc.src.strip() if s.loc else ""))
                L.append("`endif")
            elif isinstance(st, P.Control):
                if st.loc is not None and st.loc.src:
                    L.append("// " + st.loc.src.strip())
            elif isinstance(st, P.ErrorNode):
                L.append(f"// PARSE ERROR preserved: {st.message}")
            else:
                raise ConvertError(
                    f"cannot convert {type(st).__name__} to Verilog-A")
        if top_elements:
            L.append("")
            self.module("testbench", [], {}, top_elements, None)
        return "\n".join(self.lines) + "\n"

    def paramset(self, st: P.Model):
        master, ty = _spice_model_to_va_master(st.mtype, st.params)
        name = _va_id(st.name)
        self.paramsets[name] = master
        L = self.lines
        L.append(f"// master module '{master}' must be provided by the "
                 "model library (e.g. an `include of its .va source)")
        L.append(f"paramset {name} {master};")
        if ty is not None:
            L.append(f'  .type = "{ty}";')
        for k, v in st.params.items():
            if str(k).lower() == "level":
                continue
            L.append(f"  .{_va_id(k)} = {self.ev(v)};")
        L.append("endparamset")
        L.append("")

    # ---- modules

    def module(self, name, ports, params, body, loc):
        L = self.lines
        mname = _va_id(name)
        self.modules.add(mname)
        pmap = {}                       # original node -> VA net
        ground_used = [False]

        def net(n):
            s = str(n)
            if s == "0" or s.lower() in ("gnd", "gnd!", "0!"):
                ground_used[0] = True
                return "gnd"
            return pmap.setdefault(s, _va_id(s))

        vports = [net(p) for p in ports]
        local = set(vports) | {_va_id(k) for k in params}
        decls, insts, analog = [], [], []
        branches = {}                   # element name -> branch id

        # two passes: first collect every net/branch, then emit elements
        elements = [st for st in body if isinstance(st, P.Element)]
        for el in elements:
            for n in el.nodes:
                net(n)
        for st in body:
            if isinstance(st, P.Element):
                self.element(st, net, local, decls, insts, analog, branches)
            elif isinstance(st, P.Param):
                for k, v in st.assignments:
                    kk = _va_id(k)
                    if kk not in local:
                        local.add(kk)
                        decls.append(
                            f"  parameter real {kk} = {self.ev(v, local)};")
            elif isinstance(st, P.Model):
                # module-scoped models hoist to top-level paramsets (the
                # reference stores them in a local DB; a hoisted paramset is
                # equivalent for uniquely-named models)
                self.paramset(st)
            elif isinstance(st, P.Control):
                if st.loc is not None and st.loc.src:
                    analog.append("    // " + st.loc.src.strip())
            elif isinstance(st, P.ErrorNode):
                analog.append(f"    // PARSE ERROR preserved: {st.message}")
            else:
                raise ConvertError(
                    f"cannot convert {type(st).__name__} inside "
                    f"subckt {name}")

        L.append(f"module {mname}({', '.join(vports)});")
        if vports:
            L.append(f"  inout {', '.join(vports)};")
        allnets = list(dict.fromkeys(
            vports + [v for v in pmap.values() if v not in vports]))
        if ground_used[0]:
            allnets = ["gnd"] + [n for n in allnets if n != "gnd"]
        if allnets:
            L.append(f"  electrical {', '.join(allnets)};")
        if ground_used[0]:
            L.append("  ground gnd;")
        for k, v in params.items():
            L.append(f"  parameter real {_va_id(k)} = "
                     f"{self.ev(v, local)};")
        L.extend(decls)
        L.extend(insts)
        if analog:
            L.append("  analog begin")
            L.extend(analog)
            L.append("  end")
        L.append("endmodule")
        L.append("")

    # ---- elements -> contributions / instances

    def _wave_expr(self, kind, args, local):
        """SPICE source waveform -> $abstime expression (SPICE semantics:
        hold before delay; PULSE periodic; PWL held at both ends)."""
        def a(i, default=0.0):
            if i < len(args):
                return self.ev(args[i], local)
            return fmt_num(default)

        def anum(i, default=None):
            if i < len(args) and isinstance(args[i], (int, float)):
                return float(args[i])
            return default

        t = "$abstime"
        if kind in ("sin", "sine"):
            vo, va, fr, td, th = a(0), a(1), a(2, 1.0), a(3), a(4)
            w = f"(6.283185307179586*{fr})"
            base = f"({vo}+{va}*sin({w}*({t}-{td})))"
            if anum(4) not in (None, 0.0):
                base = (f"({vo}+{va}*exp(-({t}-{td})*{th})"
                        f"*sin({w}*({t}-{td})))")
            return f"(({t})<({td})?({vo}):{base})"
        if kind == "pulse":
            v1, v2 = a(0), a(1)
            td, tr, tf, pw = a(2), a(3, 1e-12), a(4, 1e-12), a(5, 1e30)
            if anum(3) == 0.0:
                tr = fmt_num(1e-12)
            if anum(4) == 0.0:
                tf = fmt_num(1e-12)
            per = anum(6)
            tt = f"(({t})-({td}))"
            if per is not None and per > 0:
                tt = f"({tt}-({a(6)})*floor({tt}/({a(6)})))"
            ramp_up = f"(({v1})+(({v2})-({v1}))*{tt}/({tr}))"
            ramp_dn = (f"(({v2})-(({v2})-({v1}))*"
                       f"({tt}-({tr})-({pw}))/({tf}))")
            return (f"(({t})<({td})?({v1}):"
                    f"({tt}<({tr})?{ramp_up}:"
                    f"({tt}<(({tr})+({pw}))?({v2}):"
                    f"({tt}<(({tr})+({pw})+({tf}))?{ramp_dn}:({v1})))))")
        if kind == "exp":
            v1, v2 = a(0), a(1)
            td1, tau1, td2, tau2 = a(2), a(3, 1e-9), a(4, 1e30), a(5, 1e-9)
            rise = (f"(({v1})+(({v2})-({v1}))*"
                    f"(1.0-exp(-(({t})-({td1}))/({tau1}))))")
            both = (f"({rise}+(({v1})-({v2}))*"
                    f"(1.0-exp(-(({t})-({td2}))/({tau2}))))")
            return (f"(({t})<({td1})?({v1}):"
                    f"(({t})<({td2})?{rise}:{both}))")
        if kind == "pwl":
            pts = [self.ev(x, local) for x in args]
            if len(pts) < 2:
                raise ConvertError("PWL needs at least one (t, v) pair")
            tv = list(zip(pts[0::2], pts[1::2]))
            expr = f"({tv[-1][1]})"      # hold last value
            for (t0, v0), (t1, v1) in reversed(list(zip(tv[:-1], tv[1:]))):
                seg = (f"(({v0})+(({v1})-({v0}))*(({t})-({t0}))"
                       f"/(({t1})-({t0})))")
                expr = f"(({t})<({t1})?{seg}:{expr})"
            return f"(({t})<({tv[0][0]})?({tv[0][1]}):{expr})"
        raise ConvertError(f"waveform {kind!r} not convertible to VA")

    def _behavioral(self, ast, net, local, branches):
        """B-source expression: rewrite v(a[,b]) / i(vsrc) probe calls into
        VA probes, then emit."""
        def rw(e):
            if isinstance(e, tuple) and e and e[0] == "call":
                fn = str(e[1]).lower()
                args = [rw(x) for x in e[2]]
                if fn == "v":
                    nodes = [x[1] if isinstance(x, tuple) and x[0] == "ref"
                             else x for x in e[2]]
                    probes = ",".join(net(n) for n in nodes)
                    return ("ref", f"V({probes})")
                if fn == "i":
                    src = e[2][0]
                    src = src[1] if isinstance(src, tuple) \
                        and src[0] == "ref" else src
                    b = branches.get(str(src).lower())
                    if b is None:
                        raise ConvertError(
                            f"behavioral i({src}) probes a source not in "
                            "this subckt — cannot convert")
                    return ("ref", f"I({b})")
                return ("call", e[1], args)
            if isinstance(e, tuple) and e:
                return tuple([e[0]] + [rw(x) if isinstance(x, tuple)
                                       or isinstance(x, str)
                                       else x for x in e[1:]])
            return e

        ref = self._ref_factory(local)

        def ref2(name):
            s = str(name)
            if s.startswith(("V(", "I(")):
                return s
            return ref(s)
        return emit_expr_va(rw(ast), ref2)

    def element(self, el: P.Element, net, local, decls, insts, analog,
                branches):
        letter, name = el.letter, _va_id(el.name)
        nn = [net(n) for n in el.nodes]
        ev = lambda v: self.ev(v, local)  # noqa: E731
        mfac = el.params.get("m")
        mul = f"({ev(mfac)})*" if mfac is not None else ""

        if letter == "r":
            r = el.values[0] if el.values else el.params.get("r")
            if r is None:
                raise ConvertError(f"{el.name}: no resistance")
            analog.append(f"    I({nn[0]},{nn[1]}) <+ "
                          f"{mul}V({nn[0]},{nn[1]})/({ev(r)});  // {name}")
            return
        if letter == "c":
            c = el.values[0] if el.values else el.params.get("c")
            analog.append(f"    I({nn[0]},{nn[1]}) <+ "
                          f"{mul}ddt(({ev(c)})*V({nn[0]},{nn[1]}));"
                          f"  // {name}")
            return
        if letter == "l":
            lval = el.values[0] if el.values else el.params.get("l")
            b = f"b_{name}"
            branches[el.name.lower()] = b
            decls.append(f"  branch ({nn[0]},{nn[1]}) {b};")
            analog.append(f"    V({b}) <+ ({ev(lval)})*ddt(I({b}));"
                          f"  // {name}")
            return
        if letter in ("v", "i"):
            toks = _scan_source_tokens(el)
            parts = []
            if "dc" in toks:
                parts.append(f"({ev(toks['dc'])})")
            for kind, args in el.waves:
                parts.append(self._wave_expr(kind, args, local))
            if not parts:
                parts = ["0.0"]
            expr = parts[-1]         # tran wave overrides dc, SPICE rule
            if "ac" in toks:
                analog.append(f"    // {name}: AC stimulus "
                              f"mag={ev(toks['ac'])} dropped (no ac_stim "
                              "in target pipeline)")
            if letter == "v":
                b = f"b_{name}"
                branches[el.name.lower()] = b
                decls.append(f"  branch ({nn[0]},{nn[1]}) {b};")
                analog.append(f"    V({b}) <+ {expr};  // {name}")
            else:
                analog.append(f"    I({nn[0]},{nn[1]}) <+ {mul}{expr};"
                              f"  // {name}")
            return
        if letter in ("e", "g"):
            gain = el.values[0] if el.values else el.params.get(
                "gain", el.params.get("gm", 1.0))
            ctrl = f"V({nn[2]},{nn[3]})"
            if letter == "e":
                b = f"b_{name}"
                branches[el.name.lower()] = b
                decls.append(f"  branch ({nn[0]},{nn[1]}) {b};")
                analog.append(f"    V({b}) <+ ({ev(gain)})*{ctrl};"
                              f"  // {name}")
            else:
                analog.append(f"    I({nn[0]},{nn[1]}) <+ "
                              f"{mul}({ev(gain)})*{ctrl};  // {name}")
            return
        if letter in ("f", "h"):
            gain = el.values[0] if el.values else el.params.get("gain", 1.0)
            b = branches.get(str(el.model).lower()) if el.model else None
            if b is None:
                raise ConvertError(
                    f"{el.name}: controlling source {el.model!r} not in "
                    "this subckt — cannot convert")
            if letter == "f":
                analog.append(f"    I({nn[0]},{nn[1]}) <+ "
                              f"{mul}({ev(gain)})*I({b});  // {name}")
            else:
                bo = f"b_{name}"
                branches[el.name.lower()] = bo
                decls.append(f"  branch ({nn[0]},{nn[1]}) {bo};")
                analog.append(f"    V({bo}) <+ ({ev(gain)})*I({b});"
                              f"  // {name}")
            return
        if letter == "b":
            vexpr = el.params.get("v")
            iexpr = el.params.get("i")
            if vexpr is not None:
                b = f"b_{name}"
                branches[el.name.lower()] = b
                decls.append(f"  branch ({nn[0]},{nn[1]}) {b};")
                analog.append(
                    f"    V({b}) <+ "
                    f"{self._behavioral(vexpr, net, local, branches)};"
                    f"  // {name}")
            elif iexpr is not None:
                analog.append(
                    f"    I({nn[0]},{nn[1]}) <+ {mul}"
                    f"{self._behavioral(iexpr, net, local, branches)};"
                    f"  // {name}")
            else:
                raise ConvertError(f"{el.name}: B source without v=/i=")
            return
        if letter in ("d", "m", "q", "j", "z", "x"):
            master = _va_id(el.model) if el.model else None
            if master is None:
                raise ConvertError(f"{el.name}: no model/subckt name")
            ov = dict(el.params)
            if letter in ("d", "q") and el.values:
                ov = {"area": el.values[0], **ov}
            ps = ",".join(f".{_va_id(k)}({ev(v)})"
                          for k, v in ov.items() if v is not None)
            pstr = f" #({ps})" if ps else ""
            insts.append(f"  {master}{pstr} {name}"
                         f"({', '.join(nn)});")
            return
        raise ConvertError(
            f"{el.name}: device letter {letter!r} not convertible to "
            "Verilog-A")


# ------------------------------------------------------------ model DB

def extract_models(netlist: P.SpiceNetlist, source="<netlist>"):
    """Collect every .model card (recursing into subckts/lib sections) —
    the reference's extract_model_definitions
    (SpiceArmyKnife.jl/src/va_models.jl)."""
    out = []

    def walk(stmts, scope):
        for st in stmts:
            if isinstance(st, P.Model):
                params = {}
                for k, v in st.params.items():
                    try:
                        params[k] = (float(v) if isinstance(v, (int, float))
                                     else emit_expr(v, "spice"))
                    except ConvertError:
                        params[k] = repr(v)
                out.append(dict(name=st.name, kind=st.mtype, scope=scope,
                                source=source, params=params))
            body = getattr(st, "body", None)
            if isinstance(body, list):
                nm = getattr(st, "name", None)
                walk(body, scope + [nm] if nm else scope)
            if isinstance(st, P.IfBlock):
                for _, b in st.branches:
                    walk(b, scope)

    walk(netlist.statements, [])
    return out


# ------------------------------------------------------------------ driver

def detect_dialect(text: str) -> str:
    for line in text.splitlines()[:50]:
        ls = line.strip().lower()
        if ls.startswith("simulator") and "lang=spectre" in ls.replace(
                " ", ""):
            return "spectre"
        if ls.startswith("//"):
            return "spectre"
    return "spice"


def parse_any(text: str, dialect="auto", file="<netlist>"):
    if dialect == "auto":
        dialect = detect_dialect(text)
    if dialect == "spectre":
        from cedarsim_tpu_torch.frontend.spectre import parse_spectre
        return parse_spectre(text, file=file), "spectre"
    return P.parse_spice(text, file=file), "spice"


def convert_text(text: str, input_dialect="auto", output_dialect="spectre",
                 file="<netlist>") -> str:
    nl, ind = parse_any(text, input_dialect, file)
    if output_dialect == "spectre":
        return SpectreEmitter(in_dialect=ind).emit(nl)
    if output_dialect in ("spice", "ngspice", "hspice"):
        return SpiceEmitter(in_dialect=ind).emit(nl)
    if output_dialect in ("veriloga", "va"):
        return VerilogAEmitter(in_dialect=ind).emit(nl)
    raise ConvertError(f"unknown output dialect {output_dialect!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="cedarsim-convert",
        description="Convert netlists between SPICE and Spectre dialects "
                    "(spak-convert equivalent)")
    ap.add_argument("input")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--input-simulator", default="auto",
                    choices=["auto", "spice", "ngspice", "hspice",
                             "spectre"])
    ap.add_argument("--output-simulator", default="spectre",
                    choices=["spice", "ngspice", "hspice", "spectre",
                             "veriloga"])
    ap.add_argument("--extract-models", metavar="DB_JSON",
                    help="also write all .model cards as a JSON model DB")
    a = ap.parse_args(argv)
    with open(a.input) as f:
        text = f.read()
    ind = a.input_simulator
    if ind in ("ngspice", "hspice"):
        ind = "spice"
    nl, ind = parse_any(text, ind, file=a.input)
    if a.extract_models:
        with open(a.extract_models, "w") as f:
            json.dump(extract_models(nl, source=a.input), f, indent=1)
    if a.output:
        emitters = {"spectre": SpectreEmitter, "veriloga": VerilogAEmitter}
        cls = emitters.get(a.output_simulator, SpiceEmitter)
        out = cls(in_dialect=ind).emit(nl)
        with open(a.output, "w") as f:
            f.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
