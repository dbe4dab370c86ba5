"""Verilog-A parser (recursive descent over preprocessed tokens).

Coverage: the compact-modeling subset — module header (both port-list
styles), electrical/ground declarations, named branches, parameter
declarations with from/exclude ranges and (* attributes *), real/integer
variables, analog functions with input/output arguments, and the full
analog-block statement set (begin/end with named blocks and local decls,
if/else, for, while, repeat, case, contributions, @(events)).

Reference grammar: reference/VerilogAParser.jl/src/parse/parse.jl.

Copy of ``cedarsim_tpu/va/parser.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import re

from cedarsim_tpu_torch.va.ast import (Module, Parameter, Branch, AnalogFunction,
                                 Range)
from cedarsim_tpu_torch.va.preproc import preprocess


class VAParseError(ValueError):
    def __init__(self, msg, tok=None, file="<va>"):
        self.tok = tok
        self.raw_message = msg
        if tok is not None:
            msg = f"{file}:{tok.line}:{tok.col}: {msg} (at {tok.text!r})"
        super().__init__(msg)

    def render(self, sources=None, color=False):
        """Caret/highlight rendering with macro backtrace
        (va/diagnostics.py); falls back to str() without a token."""
        if self.tok is None:
            return str(self)
        from cedarsim_tpu_torch.va.diagnostics import render
        return render(self.raw_message, self.tok, sources, color)


_BIN_PREC = {
    "||": 2, "&&": 3, "|": 4, "^": 5, "&": 6,
    "==": 7, "!=": 7, "<": 8, "<=": 8, ">": 8, ">=": 8,
    "<<": 9, ">>": 9,
    "+": 10, "-": 10, "*": 20, "/": 20, "%": 20, "**": 30,
}
_RIGHT = {"**"}


class VAParser:
    def __init__(self, tokens, file="<va>"):
        self.toks = tokens
        self.i = 0
        self.file = file

    # ------------------------------------------------------------- plumbing

    def peek(self, k=0):
        j = min(self.i + k, len(self.toks) - 1)
        return self.toks[j]

    def next(self):
        t = self.toks[self.i]
        if self.i < len(self.toks) - 1:
            self.i += 1
        return t

    def at(self, text):
        t = self.peek()
        return t.text == text

    def accept(self, text):
        if self.at(text):
            return self.next()
        return None

    def expect(self, text):
        t = self.next()
        if t.text != text:
            raise VAParseError(f"expected {text!r}", t, self.file)
        return t

    def expect_id(self):
        t = self.next()
        if t.kind != "id":
            raise VAParseError("expected identifier", t, self.file)
        return t.text

    def skip_attrs(self):
        attrs = {}
        while self.peek().kind == "attr":
            attrs.update(_parse_attr(self.next().text))
        return attrs

    # -------------------------------------------------------------- module

    def parse_modules(self):
        mods = []
        while self.peek().kind != "eof":
            self.skip_attrs()
            t = self.peek()
            if t.text in ("module", "macromodule"):
                mods.append(self.parse_module())
            elif t.text in ("nature", "discipline"):
                self._skip_until({"endnature", "enddiscipline"})
                self.next()
            else:
                self.next()   # tolerate stray tokens between modules
        return mods

    def _skip_until(self, stops):
        while self.peek().kind != "eof" and self.peek().text not in stops:
            self.next()

    def parse_module(self) -> Module:
        self.next()  # module
        name = self.expect_id()
        ports = []
        port_dirs = {}
        if self.accept("("):
            # either just names, or full ANSI decls `inout electrical a, b`
            cur_dir = None
            while not self.at(")"):
                t = self.peek()
                if t.text in ("inout", "input", "output"):
                    cur_dir = self.next().text
                    continue
                if t.text == "electrical":
                    self.next()
                    continue
                if t.text == ",":
                    self.next()
                    continue
                pname = self.expect_id()
                ports.append(pname)
                if cur_dir:
                    port_dirs[pname] = cur_dir
            self.expect(")")
        self.expect(";")

        mod = Module(name=name, ports=ports, port_dirs=port_dirs, nets=[],
                     ground_nets=[], branches=[], parameters=[],
                     variables={}, var_attrs={}, functions={}, analog=[])

        while True:
            attrs = self.skip_attrs()
            t = self.peek()
            if t.kind == "eof":
                raise VAParseError("missing endmodule", t, self.file)
            if t.text == "endmodule":
                self.next()
                break
            if t.text in ("inout", "input", "output"):
                d = self.next().text
                self.accept("electrical")
                for n in self._id_list():
                    port_dirs[n] = d
                    if n not in ports:
                        ports.append(n)
                self.expect(";")
            elif t.text == "electrical":
                self.next()
                for n in self._id_list():
                    if n not in mod.nets:
                        mod.nets.append(n)
                self.expect(";")
            elif t.text == "ground":
                self.next()
                self.accept("electrical")
                for n in self._id_list():
                    mod.ground_nets.append(n)
                self.expect(";")
            elif t.text == "branch":
                self.next()
                self.expect("(")
                p = self.expect_id()
                q = None
                if self.accept(","):
                    q = self.expect_id()
                self.expect(")")
                for bn in self._id_list():
                    mod.branches.append(Branch(bn, p, q))
                self.expect(";")
            elif t.text in ("parameter", "localparam"):
                self._parse_parameter(mod, attrs)
            elif t.text == "aliasparam":
                self.next()
                alias = self.expect_id()
                self.expect("=")
                target = self.expect_id()
                self.expect(";")
                for p in mod.parameters:
                    if p.name == target:
                        p.aliases.append(alias)
                        break
            elif t.text in ("real", "integer", "genvar", "string"):
                ty = self.next().text
                names = []
                while True:
                    n = self.expect_id()
                    names.append(n)
                    # optional array dimension — unsupported, skip
                    if self.accept("["):
                        self._skip_until({"]"})
                        self.expect("]")
                    if not self.accept(","):
                        break
                self.expect(";")
                for n in names:
                    mod.variables[n] = "real" if ty == "genvar" else ty
                    if attrs:
                        mod.var_attrs[n] = attrs
            elif t.text == "analog":
                self.next()
                if self.at("function"):
                    self._parse_function(mod)
                else:
                    if self.accept("initial"):
                        pass
                    mod.analog.append(self.parse_statement())
            else:
                raise VAParseError("unexpected token in module body", t,
                                   self.file)
        return mod

    def _id_list(self):
        out = [self.expect_id()]
        while self.accept(","):
            out.append(self.expect_id())
        return out

    def _parse_parameter(self, mod, attrs):
        self.next()  # parameter/localparam
        ptype = "real"
        if self.peek().text in ("real", "integer", "string"):
            ptype = self.next().text
        while True:
            name = self.expect_id()
            self.expect("=")
            default = self.parse_expr()
            ranges = []
            while self.peek().text in ("from", "exclude"):
                kw = self.next().text
                if kw == "from":
                    lo_incl = bool(self.accept("["))
                    if not lo_incl:
                        self.expect("(")
                    lo = self.parse_expr()
                    self.expect(":")
                    hi = self.parse_expr()
                    hi_incl = bool(self.accept("]"))
                    if not hi_incl:
                        self.expect(")")
                    ranges.append(Range("from", lo, hi, lo_incl, hi_incl))
                else:
                    if self.accept("[") or self.accept("("):
                        v = self.parse_expr()
                        self.accept("]") or self.accept(")")
                    else:
                        v = self.parse_expr()
                    ranges.append(Range("exclude", exclude_val=v))
            p = Parameter(name, ptype, default, ranges,
                          desc=attrs.get("desc", ""),
                          units=attrs.get("units", ""))
            mod.parameters.append(p)
            if not self.accept(","):
                break
        self.expect(";")

    def _parse_function(self, mod):
        self.expect("function")
        rtype = "real"
        if self.peek().text in ("real", "integer"):
            rtype = self.next().text
        name = self.expect_id()
        self.expect(";")
        fn = AnalogFunction(name, rtype)
        while not self.at("endfunction"):
            t = self.peek()
            if t.kind == "eof":
                raise VAParseError("missing endfunction", t, self.file)
            if t.text in ("input", "output", "inout"):
                d = self.next().text
                names = self._id_list()
                self.expect(";")
                if d in ("input", "inout"):
                    fn.inputs.extend(names)
                if d in ("output", "inout"):
                    fn.outputs.extend(names)
            elif t.text in ("real", "integer"):
                ty = self.next().text
                for n in self._id_list():
                    fn.locals_[n] = ty
                self.expect(";")
            else:
                fn.body.append(self.parse_statement())
        self.expect("endfunction")
        mod.functions[name] = fn

    # ----------------------------------------------------------- statements

    def parse_statement(self):
        self.skip_attrs()
        t = self.peek()
        if t.text == ";":
            # Verilog-A has no null statement: a stray semicolon (e.g.
            # after `end`) is an error, matching the reference's VAS46
            # (VerilogAParser.jl/test/errors/extra_semi2.out)
            raise VAParseError("unexpected semicolon", t, self.file)
        if t.text == "begin":
            self.next()
            local_vars = {}
            if self.accept(":"):
                self.expect_id()   # block name
                while self.peek().text in ("real", "integer", "parameter"):
                    if self.peek().text == "parameter":
                        # local parameter in named block — treat as variable
                        self.next()
                        if self.peek().text in ("real", "integer"):
                            self.next()
                        n = self.expect_id()
                        self.expect("=")
                        e = self.parse_expr()
                        self.expect(";")
                        local_vars[n] = ("param", e)
                        continue
                    ty = self.next().text
                    for n in self._id_list():
                        local_vars[n] = (ty, None)
                    self.expect(";")
            body = []
            while not self.at("end"):
                if self.peek().kind == "eof":
                    raise VAParseError("missing end", self.peek(), self.file)
                body.append(self.parse_statement())
            self.expect("end")
            return ("block", body, local_vars)
        if t.text == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_statement()
            els = None
            if self.accept("else"):
                els = self.parse_statement()
            return ("if", cond, then, els)
        if t.text == "for":
            self.next()
            self.expect("(")
            init = self._parse_assign_nosemi()
            self.expect(";")
            cond = self.parse_expr()
            self.expect(";")
            step = self._parse_assign_nosemi()
            self.expect(")")
            body = self.parse_statement()
            return ("for", init, cond, step, body)
        if t.text == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            return ("while", cond, self.parse_statement())
        if t.text == "repeat":
            self.next()
            self.expect("(")
            cnt = self.parse_expr()
            self.expect(")")
            return ("repeat", cnt, self.parse_statement())
        if t.text in ("case", "casex", "casez"):
            self.next()
            self.expect("(")
            sel = self.parse_expr()
            self.expect(")")
            items = []
            while not self.at("endcase"):
                if self.accept("default"):
                    self.accept(":")
                    items.append((None, self.parse_statement()))
                else:
                    labels = [self.parse_expr()]
                    while self.accept(","):
                        labels.append(self.parse_expr())
                    self.expect(":")
                    items.append((labels, self.parse_statement()))
            self.expect("endcase")
            return ("case", sel, items)
        if t.text == "@":
            self.next()
            self.expect("(")
            depth = 1
            names = []
            while depth:
                tt = self.next()
                if tt.text == "(":
                    depth += 1
                elif tt.text == ")":
                    depth -= 1
                elif tt.kind == "id":
                    names.append(tt.text)
            return ("event", tuple(names), self.parse_statement())
        if t.kind == "id" and t.text.startswith("$"):
            name = self.next().text
            args = []
            if self.accept("("):
                if not self.at(")"):
                    args.append(self.parse_expr())
                    while self.accept(","):
                        args.append(self.parse_expr())
                self.expect(")")
            self.expect(";")
            return ("sys", name, args)
        # contribution or assignment or function-call statement
        if t.kind == "id" and self.peek(1).text == "(" \
                and t.text in ("I", "V", "Pwr"):
            # contribution:  I(a[,b]) <+ expr;
            save = self.i
            acc = self._parse_access()
            if self.at("<+"):
                self.next()
                rhs = self.parse_expr()
                self.expect(";")
                return ("contrib", acc, rhs)
            if self.at(":"):
                # indirect assignment  V(x): expr == expr — unsupported
                raise VAParseError("indirect branch assignment unsupported",
                                   t, self.file)
            self.i = save
        if t.kind == "id":
            # assignment  name = expr;   or call stmt  fn(...)
            if self.peek(1).text == "=":
                st = self._parse_assign_nosemi()
                self.expect(";")
                return st
            if self.peek(1).text == "(":
                # a bare function call is a statement without an
                # assignment — illegal in Verilog-A (LRM: analog functions
                # are expression constructs); the reference's VAS14
                # (VerilogAParser.jl/test/errors/missing_assignment.out)
                raise VAParseError(
                    "statement without assignment is illegal in Verilog-A "
                    f"(assign the result: x = {t.text}(...))", t, self.file)
        raise VAParseError("cannot parse statement", t, self.file)

    def _parse_assign_nosemi(self):
        name = self.expect_id()
        self.expect("=")
        return ("assign", name, self.parse_expr())

    def _parse_access(self):
        kind = self.next().text       # I or V
        self.expect("(")
        a = self.expect_id()
        b = None
        if self.accept(","):
            b = self.expect_id()
        self.expect(")")
        return (kind, a, b)

    # ---------------------------------------------------------- expressions

    def parse_expr(self, rbp=0):
        left = self._nud()
        while True:
            t = self.peek()
            if t.text == "?" and rbp <= 1:
                self.next()
                a = self.parse_expr(0)
                self.expect(":")
                b = self.parse_expr(1)
                left = ("cond", left, a, b)
                continue
            if t.kind != "op" or t.text not in _BIN_PREC:
                break
            bp = _BIN_PREC[t.text]
            if bp <= rbp:
                break
            op = self.next().text
            right = self.parse_expr(bp - 1 if op in _RIGHT else bp)
            left = ("bin", op, left, right)
        return left

    def _nud(self):
        t = self.next()
        if t.kind == "num":
            return ("num", t.value)
        if t.kind == "str":
            return ("str", t.text)
        if t.kind == "op":
            if t.text == "(":
                e = self.parse_expr(0)
                self.expect(")")
                return e
            if t.text == "-":
                return ("un", "-", self.parse_expr(25))
            if t.text == "+":
                return self.parse_expr(25)
            if t.text == "!":
                return ("un", "!", self.parse_expr(25))
            if t.text == "~":
                return ("un", "~", self.parse_expr(25))
            if t.text == "{":
                # array literal / concatenation: coefficient vectors of the
                # laplace_*/zi_* analog filter operators (LRM 4.5.13)
                elems = []
                if not self.at("}"):
                    elems.append(self.parse_expr(0))
                    while self.accept(","):
                        elems.append(self.parse_expr(0))
                self.expect("}")
                return ("array", elems)
        if t.kind == "id":
            name = t.text
            if self.at("("):
                self.next()
                args = []
                if not self.at(")"):
                    args.append(self.parse_expr(0))
                    while self.accept(","):
                        args.append(self.parse_expr(0))
                self.expect(")")
                return ("call", name, args)
            return ("ref", name)
        raise VAParseError("cannot parse expression", t, self.file)


def _parse_attr(text):
    """(* desc="...", units="V" *) → dict"""
    inner = text[2:-2]
    out = {}
    for m in re.finditer(r'(\w+)\s*=\s*("(?:[^"\\]|\\.)*"|[^,]+)', inner):
        k, v = m.group(1), m.group(2).strip()
        if v.startswith('"'):
            v = v[1:-1]
        out[k] = v
    return out


def parse_va(text: str, file="<va>", include_paths=(), defines=()):
    """Preprocess + parse Verilog-A source → list of Modules.

    ``defines``: iterable of macro names predefined empty (the ``-D`` role)
    — used e.g. to select compile-time model variants (`ifdef blocks)."""
    from cedarsim_tpu_torch.va.preproc import Macro
    macros = {n: Macro(n, None, []) for n in defines}
    toks = preprocess(text, file, include_paths, defines=macros)
    return VAParser(toks, file).parse_modules()
