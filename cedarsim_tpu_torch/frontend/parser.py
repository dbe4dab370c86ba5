"""SPICE netlist parser: logical-line lexer + card parser → netlist AST.

Models the dialect surface of the reference's SPICE parser
(reference/SpectreNetlistParser.jl/src/SPICE/parse/parse.jl and
forms.jl:2-523): element cards (R C L V I E F G H D M Q X B), dot commands
(.param .subckt .model .tran .dc .ac .op .ic .nodeset .option .temp .include
.lib .global .if/.elseif/.else/.endif .meas .print/.save .end), continuation
lines, all three expression quote forms (``'...'``, ``{...}``, ``=``), and
case-insensitivity.  Numbers use exact-decimal SI suffix parsing (numbers.py).

The AST keeps per-statement source locations (file, line) so elaboration
errors point at the netlist — matching the reference's netlist-located
diagnostics (reference/src/spectre.jl:606-628).

Copy of ``cedarsim_tpu/frontend/parser.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from cedarsim_tpu_torch.frontend.expr import parse_expr, ExprError
from cedarsim_tpu_torch.frontend.numbers import parse_number


class SpiceParseError(ValueError):
    def __init__(self, msg, file="<netlist>", line=0, src=""):
        self.file, self.line, self.src = file, line, src
        super().__init__(f"{file}:{line}: {msg}\n    {src.strip()}")


@dataclasses.dataclass
class Loc:
    file: str
    line: int
    src: str = ""
    span: tuple = None   # (lo, hi) byte range into SpiceNetlist.source


@dataclasses.dataclass
class Element:
    letter: str          # device letter, lowercase (r, c, v, m, x, ...)
    name: str            # full instance name as written
    nodes: list          # node name strings (count depends on device)
    model: Optional[str]  # model/subckt name if present
    values: list         # positional value tokens (floats or expr ASTs)
    params: dict         # keyword params name->float|ast
    waves: list          # [(kind, [args])] source waveform specs
    loc: Loc = None


@dataclasses.dataclass
class Param:
    assignments: list    # [(name, ast|float)]
    loc: Loc = None


@dataclasses.dataclass
class Subckt:
    name: str
    nodes: list
    params: dict
    body: list           # statements
    loc: Loc = None


@dataclasses.dataclass
class Model:
    name: str
    mtype: str           # resistor/capacitor/d/nmos/pmos/npn/pnp/sw...
    params: dict
    loc: Loc = None


@dataclasses.dataclass
class Control:
    cmd: str             # tran/dc/ac/op/ic/nodeset/option/temp/global/...
    args: list           # raw tokens
    kwargs: dict
    loc: Loc = None


@dataclasses.dataclass
class Include:
    path: str
    section: Optional[str] = None   # .lib "file" section form
    loc: Loc = None


@dataclasses.dataclass
class LibSection:
    name: str
    body: list
    loc: Loc = None


@dataclasses.dataclass
class IfBlock:
    branches: list       # [(cond_ast|None, [statements])], None = else
    loc: Loc = None


@dataclasses.dataclass
class SpiceNetlist:
    title: str
    statements: list
    path: str = "<string>"
    source: str = None   # lexed text (title line blanked; spans index it)

    def source_of(self, stmt) -> str:
        """Exact original bytes of ``stmt`` (continuation lines and inline
        comments included) — the reference red-tree ``String(node)`` role
        (SpectreNetlistParser.jl/src/RedTree.jl:89-102).  Spans index
        ``self.source``; raises for statements without one (synthetic or
        pre-span ASTs)."""
        loc = getattr(stmt, "loc", None)
        if self.source is None or loc is None or loc.span is None:
            raise ValueError("statement has no source span")
        lo, hi = loc.span
        return self.source[lo:hi]


@dataclasses.dataclass
class ErrorNode:
    """A statement that failed to parse, kept in the statement list so
    parsing continues — the reference's error nodes + ``visit_errors``
    (reference/SpectreNetlistParser.jl/src/SpectreNetlistParser.jl:35).
    """
    message: str
    loc: "Loc"


def visit_errors(netlist, visit=None):
    """Walk every statement (incl. subckt/.if bodies) and collect/visit the
    ErrorNodes.  Returns the list of (message, loc)."""
    out = []

    def walk(stmts):
        for st in stmts:
            if isinstance(st, ErrorNode):
                out.append(st)
                if visit is not None:
                    visit(st)
            body = getattr(st, "body", None)
            if isinstance(body, list):
                walk(body)
            branches = getattr(st, "branches", None)
            if branches:
                for _, b in branches:
                    walk(b)
    walk(netlist.statements)
    return out


# --------------------------------------------------------------------- lexer

def logical_lines(text: str, file="<netlist>", spans=False):
    """Yield (lineno, line) after joining '+' continuations and stripping
    comments.  Comment rules: '*' in column 0; '$' and ';' start an inline
    comment; '//' also accepted (ngspice).

    ``spans=True`` yields (lineno, line, (lo, hi)) where text[lo:hi] is the
    statement's exact original bytes, continuations included — the lossless
    handle behind ``SpiceNetlist.source_of`` (the reference's red-tree
    ``String(node)`` role, SpectreNetlistParser.jl/src/RedTree.jl:89-102)."""
    out = []
    off = 0
    for i, raw in enumerate(text.splitlines(True), start=1):
        lo, hi = off, off + len(raw.rstrip("\r\n"))
        off += len(raw)
        line = raw.rstrip()
        if not line.strip():
            continue
        stripped = line.lstrip()
        if stripped.startswith("*") or stripped.startswith("//"):
            continue
        # inline comments ('//' only at line start — URLs contain '//')
        for marker in (" $", "\t$", ";"):
            p = line.find(marker)
            if p >= 0:
                line = line[:p]
        if not line.strip():
            continue
        if line.lstrip().startswith("+"):
            if not out:
                raise SpiceParseError("continuation with no previous line",
                                      file, i, raw)
            out[-1][1].append(line.lstrip()[1:])
            out[-1][2][1] = hi
        else:
            out.append([i, [line], [lo, hi]])
    for lineno, parts, sp in out:
        if spans:
            yield lineno, " ".join(parts), (sp[0], sp[1])
        else:
            yield lineno, " ".join(parts)


_CARD_TOK = re.compile(r"""\s*(?:
    (?P<q>'[^']*'|\{[^}]*\})
  | (?P<p>[(),=])
  | (?P<w>[^\s(),='{}]+)
)""", re.X)


def tokenize_card(line: str, file="<f>", lineno=0):
    toks, pos = [], 0
    while pos < len(line):
        m = _CARD_TOK.match(line, pos)
        if not m:
            if line[pos:].strip() == "":
                break
            raise SpiceParseError(f"bad character {line[pos]!r}",
                                  file, lineno, line)
        pos = m.end()
        if m.group("q"):
            toks.append(("expr", m.group("q")[1:-1]))
        elif m.group("p"):
            toks.append(("p", m.group("p")))
        else:
            toks.append(("w", m.group("w")))
    return toks


# -------------------------------------------------------------------- parser

_WAVE_KINDS = {"pulse", "pwl", "sin", "sine", "exp", "sffm", "am"}


def _val(tok, loc, dialect="spice"):
    """Token → float (plain number) or expression AST."""
    kind, s = tok
    if kind == "expr":
        try:
            return parse_expr(s, dialect)
        except ExprError as e:
            raise SpiceParseError(str(e), loc.file, loc.line, loc.src)
    v = parse_number(s, dialect)
    if v is not None:
        return v
    try:
        return parse_expr(s, dialect)
    except ExprError:
        return ("ref", s)


class SpiceParser:
    def __init__(self, text: str, file="<netlist>", title_line=True,
                 dialect="spice", errors="raise", spice_dialect="ngspice"):
        self.file = file
        self.dialect = dialect
        #: SPICE sub-dialect for letter disambiguation (ngspice/hspice/xyce)
        self.spice_dialect = spice_dialect
        #: "raise": first error throws; "collect": bad statements become
        #: ErrorNodes and parsing continues with the next logical line
        self.errors = errors
        # SPICE semantics: the first line is ALWAYS the title (even if it
        # looks like a comment or an element card) — except when it is a dot
        # command, a common modern-netlist deviation we accept.
        self.title = ""
        if title_line:
            raw = text.splitlines()
            first = raw[0].strip() if raw else ""
            if first and not first.startswith("."):
                self.title = first
                # keep a blank placeholder so line numbers stay 1-based
                # against the original file
                text = "\n".join([""] + raw[1:])
        self.lines = list(logical_lines(text, file, spans=True))
        self.source = text
        self.i = 0

    def parse(self) -> SpiceNetlist:
        stmts = self._parse_block(end_tokens=(".end",))
        return SpiceNetlist(self.title, stmts, self.file,
                            source=self.source)

    def _parse_block(self, end_tokens):
        stmts = []
        while self.i < len(self.lines):
            lineno, line, span = self.lines[self.i]
            head = line.split()[0].lower()
            if head in end_tokens:
                return stmts
            self.i += 1
            loc = Loc(self.file, lineno, line, span=span)
            if self.errors == "collect":
                try:
                    s = self._parse_statement(head, line, loc)
                except SpiceParseError as e:
                    s = ErrorNode(str(e), loc)
            else:
                s = self._parse_statement(head, line, loc)
            if s is not None:
                stmts.append(s)
        if ".end" not in end_tokens:
            raise SpiceParseError(f"missing {end_tokens[0]}", self.file,
                                  self.lines[-1][0] if self.lines else 0, "")
        return stmts

    def _parse_statement(self, head, line, loc):
        if head.startswith("."):
            return self._parse_dot(head, line, loc)
        return self._parse_element(line, loc)

    # ------------------------------------------------------------- elements

    def _parse_element(self, line, loc):
        toks = tokenize_card(line, loc.file, loc.line)
        if not toks or toks[0][0] != "w":
            raise SpiceParseError("expected element card", loc.file, loc.line,
                                  line)
        name = toks[0][1]
        letter = name[0].lower()
        rest = toks[1:]

        # split into positional tokens / kwargs / wave functions
        nodes_vals = []   # raw positional tokens
        kwargs = {}
        waves = []
        j = 0
        while j < len(rest):
            t = rest[j]
            if (t[0] == "w" and j + 1 < len(rest) and rest[j + 1] == ("p", "=")):
                key = t[1].lower()
                if j + 2 >= len(rest):
                    raise SpiceParseError(f"missing value for {key}=",
                                          loc.file, loc.line, line)
                kwargs[key] = _val(rest[j + 2], loc, self.dialect)
                j += 3
                continue
            if (t[0] == "w" and t[1].lower() in _WAVE_KINDS
                    and j + 1 < len(rest) and rest[j + 1] == ("p", "(")):
                kind = t[1].lower()
                j += 2
                args = []
                while j < len(rest) and rest[j] != ("p", ")"):
                    if rest[j][0] == "p" and rest[j][1] == ",":
                        j += 1
                        continue
                    args.append(_val(rest[j], loc, self.dialect))
                    j += 1
                if j >= len(rest):
                    raise SpiceParseError(f"unterminated {kind}(", loc.file,
                                          loc.line, line)
                j += 1
                waves.append((kind, args))
                continue
            if t[0] == "p":
                j += 1
                continue
            nodes_vals.append(t)
            j += 1

        # dialect-dependent letters (reference lexer.jl:578-612): N is the
        # ngspice OSDI device, Y the xyce one; S is the hspice S-parameter
        # element but the ngspice voltage switch
        if letter == "n" and self.spice_dialect == "ngspice" or \
                letter == "y" and self.spice_dialect == "xyce":
            letter = "osdi"
        elif letter == "s" and self.spice_dialect == "hspice":
            letter = "sparam"
        n_nodes, has_model = _ELEMENT_SHAPE.get(letter, (2, False))
        if letter == "q":
            # BJT: 3 or 4 nodes — 4th positional is substrate if followed by
            # a model token
            n_nodes = 4 if len(nodes_vals) >= 5 else 3
        if letter in ("x", "osdi", "sparam"):
            # variable node count with trailing model name (the reference
            # parses OSDI "kinda a subckt call", parse.jl:867; the
            # S-element's port count comes from its touchstone data)
            if not nodes_vals:
                raise SpiceParseError("subckt call without name", loc.file,
                                      loc.line, line)
            nodes = [t[1] for t in nodes_vals[:-1]]
            model = nodes_vals[-1][1]
            values = []
        else:
            if len(nodes_vals) < n_nodes:
                raise SpiceParseError(
                    f"{name}: expected {n_nodes} nodes", loc.file, loc.line,
                    line)
            nodes = [t[1] for t in nodes_vals[:n_nodes]]
            tail = nodes_vals[n_nodes:]
            model = None
            values = []
            for t in tail:
                if (has_model and model is None and t[0] == "w"
                        and parse_number(t[1], self.dialect) is None):
                    model = t[1]
                else:
                    values.append(_val(t, loc, self.dialect))
        return Element(letter, name, nodes, model, values, kwargs, waves, loc)

    # ------------------------------------------------------------ dot cards

    def _parse_dot(self, head, line, loc):
        cmd = head[1:]
        toks = tokenize_card(line, loc.file, loc.line)[1:]
        if cmd == "param":
            return Param(self._parse_assignments(toks, loc), loc)
        if cmd == "subckt":
            return self._parse_subckt(toks, loc)
        if cmd == "model":
            return self._parse_model(toks, loc)
        if cmd == "data":
            # .data name p1 p2 ... v11 v12 ... v21 v22 ... .enddata
            words = [t[1] for t in toks if t[0] == "w"]
            name = words[0] if words else ""
            # column names = following non-numeric words; then numbers flow
            from cedarsim_tpu_torch.frontend.numbers import parse_number
            cols, vals = [], []
            for w2 in words[1:]:
                n2 = parse_number(w2, self.dialect)
                if n2 is None and not vals:
                    cols.append(w2.lower())
                elif n2 is not None:
                    vals.append(n2)
            # consume lines until .enddata collecting numbers
            while self.i < len(self.lines):
                lineno2, line2 = self.lines[self.i][:2]
                head2 = line2.split()[0].lower()
                if head2 in (".enddata", ".endd"):
                    self.i += 1
                    break
                self.i += 1
                for w2 in line2.split():
                    n2 = parse_number(w2, self.dialect)
                    if n2 is not None:
                        vals.append(n2)
            return Control("data", [name, cols, vals], {}, loc)
        if cmd in ("include", "inc"):
            path = toks[0][1].strip('"') if toks else ""
            return Include(path, None, loc)
        if cmd == "lib":
            words = [t for t in toks if t[0] == "w"]
            if len(words) >= 2:
                return Include(words[0][1].strip('"'), words[1][1], loc)
            # .lib name ... .endl definition
            name = words[0][1] if words else ""
            body = self._parse_block(end_tokens=(".endl",))
            self.i += 1  # consume .endl
            return LibSection(name, body, loc)
        if cmd in ("if", "elseif"):
            return self._parse_if(toks, loc)
        if cmd in ("ic", "nodeset"):
            return Control(cmd, toks, self._parse_vnode_assignments(toks, loc),
                           loc)
        if cmd in ("option", "options"):
            kw = {}
            j = 0
            while j < len(toks):
                if (toks[j][0] == "w" and j + 2 < len(toks) + 1
                        and j + 1 < len(toks) and toks[j + 1] == ("p", "=")):
                    kw[toks[j][1].lower()] = _val(toks[j + 2], loc,
                                                  self.dialect)
                    j += 3
                elif toks[j][0] == "w":
                    kw[toks[j][1].lower()] = 1.0
                    j += 1
                else:
                    j += 1
            return Control("option", toks, kw, loc)
        # generic: tran/dc/ac/op/temp/global/save/print/plot/probe/meas/width
        args, kwargs = [], {}
        j = 0
        while j < len(toks):
            if (toks[j][0] == "w" and j + 1 < len(toks)
                    and toks[j + 1] == ("p", "=")):
                kwargs[toks[j][1].lower()] = _val(toks[j + 2], loc,
                                                  self.dialect)
                j += 3
            else:
                if toks[j][0] != "p":
                    args.append(toks[j][1])
                j += 1
        return Control(cmd, args, kwargs, loc)

    def _parse_assignments(self, toks, loc):
        out = []
        j = 0
        while j < len(toks):
            if (toks[j][0] == "w" and j + 1 < len(toks)
                    and toks[j + 1] == ("p", "=")):
                out.append((toks[j][1].lower(),
                            _val(toks[j + 2], loc, self.dialect)))
                j += 3
            else:
                j += 1
        return out

    def _parse_vnode_assignments(self, toks, loc):
        # v(node)=val  [v(node2)=val2 ...]
        out = {}
        j = 0
        while j < len(toks):
            if (toks[j][0] == "w" and toks[j][1].lower() == "v"
                    and j + 2 < len(toks) and toks[j + 1] == ("p", "(")):
                node = toks[j + 2][1]
                # skip to '=' then value
                k = j + 3
                while k < len(toks) and toks[k] != ("p", "="):
                    k += 1
                if k + 1 < len(toks):
                    out[node] = _val(toks[k + 1], loc, self.dialect)
                j = k + 2
            else:
                j += 1
        return out

    def _parse_subckt(self, toks, loc):
        words = []
        j = 0
        params = {}
        saw_params_kw = False
        while j < len(toks):
            t = toks[j]
            if (t[0] == "w" and j + 1 < len(toks)
                    and toks[j + 1] == ("p", "=")):
                params[t[1].lower()] = _val(toks[j + 2], loc, self.dialect)
                j += 3
            elif t[0] == "w" and t[1].lower() == "params:":
                saw_params_kw = True
                j += 1
            elif t[0] == "w":
                words.append(t[1])
                j += 1
            else:
                j += 1
        del saw_params_kw
        if not words:
            raise SpiceParseError(".subckt without name", loc.file, loc.line,
                                  loc.src)
        name, nodes = words[0], words[1:]
        body = self._parse_block(end_tokens=(".ends",))
        self.i += 1  # consume .ends
        return Subckt(name.lower(), nodes, params, body, loc)

    def _parse_model(self, toks, loc):
        words = [t[1] for t in toks if t[0] == "w"]
        if len(words) < 2:
            raise SpiceParseError(".model needs name and type", loc.file,
                                  loc.line, loc.src)
        name, mtype = words[0].lower(), words[1].lower()
        params = {}
        j = 0
        while j < len(toks):
            if (toks[j][0] == "w" and j + 1 < len(toks)
                    and toks[j + 1] == ("p", "=")):
                params[toks[j][1].lower()] = _val(toks[j + 2], loc,
                                                  self.dialect)
                j += 3
            else:
                j += 1
        return Model(name, mtype, params, loc)

    def _parse_if(self, toks, loc):
        # condition is the parenthesized/quoted rest of the line
        cond_src = loc.src.split(None, 1)[1] if len(loc.src.split(None, 1)) > 1 else "0"
        cond = parse_expr(cond_src.strip("()' "), self.dialect)
        branches = []
        body = self._parse_block(end_tokens=(".elseif", ".else", ".endif"))
        branches.append((cond, body))
        while self.i < len(self.lines):
            lineno, line, span2 = self.lines[self.i]
            head = line.split()[0].lower()
            self.i += 1
            if head == ".endif":
                break
            loc2 = Loc(self.file, lineno, line, span=span2)
            if head == ".elseif":
                cond_src = line.split(None, 1)[1]
                cond2 = parse_expr(cond_src.strip("()' "), self.dialect)
                body2 = self._parse_block(
                    end_tokens=(".elseif", ".else", ".endif"))
                branches.append((cond2, body2))
            elif head == ".else":
                body2 = self._parse_block(end_tokens=(".endif",))
                branches.append((None, body2))
            else:
                raise SpiceParseError("expected .elseif/.else/.endif",
                                      loc2.file, loc2.line, line)
        return IfBlock(branches, loc)


#: element letter -> (positional node count, may have a model name)
_ELEMENT_SHAPE = {
    "r": (2, True), "c": (2, True), "l": (2, True),
    "v": (2, False), "i": (2, False),
    "d": (2, True),
    "m": (4, True), "j": (3, True), "z": (3, True),
    "q": (3, True),
    "e": (4, False), "g": (4, False),
    "f": (2, True), "h": (2, True),   # model slot holds the Vctrl name
    "b": (2, False),
    "s": (4, True), "w": (2, True),
    "k": (0, False),
    "t": (4, False),
    "o": (4, True),   # lossy transmission line (LTRA model)
    "u": (3, True),   # uniform distributed RC line (URC model)
}


def parse_spice(text: str, file="<netlist>", title_line=True,
                errors="raise", spice_dialect="ngspice") -> SpiceNetlist:
    """Parse SPICE netlist text to an AST.  ``errors="collect"`` keeps
    parsing past bad statements (ErrorNodes in the statement list; gather
    them with ``visit_errors``).  ``spice_dialect`` resolves the
    dialect-dependent element letters (reference tokenize/lexer.jl:578-612):
    ngspice N→OSDI / S,W→switches; hspice S→S-parameter element;
    xyce Y→OSDI."""
    return SpiceParser(text, file, title_line, errors=errors,
                       spice_dialect=spice_dialect).parse()
