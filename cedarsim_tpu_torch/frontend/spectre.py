"""Spectre netlist dialect parser → the same statement AST as the SPICE
parser, so elaboration is shared.

Reference grammar: reference/SpectreNetlistParser.jl/src/parse/
(forms.jl:26-401 — Subckt incl. inline, Instance, Parameters, Model,
Analysis, Global, Simulator lang switch) with case-sensitive lexing and
``//`` comments (src/tokenize/lexer.jl).  ``simulator lang=spice`` re-enters
the SPICE parser mid-file and vice versa (parse.jl), which we implement by
segmenting the source text on ``simulator lang=`` lines.

Master-name instances (``x1 (a b) mymaster p=1``) resolve at elaboration
time against subckts, Verilog-A modules, and models — matching the
reference's macro-expansion-time resolution (``@isckt_or``,
reference/src/spectre.jl:753-762).

Copy of ``cedarsim_tpu/frontend/spectre.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import re

from cedarsim_tpu_torch.frontend import parser as P
from cedarsim_tpu_torch.frontend.expr import parse_expr, ExprError
from cedarsim_tpu_torch.frontend.numbers import parse_number


class SpectreParseError(P.SpiceParseError):
    pass


def _logical_lines(text, file):
    """Spectre logical lines: '//' comments stripped, both backslash and
    leading-'+' continuations joined (PDK decks use '+' freely)."""
    out = []
    cont = False
    for i, raw in enumerate(text.splitlines(), start=1):
        line = raw
        p = line.find("//")
        if p >= 0:
            line = line[:p]
        if not line.strip():
            continue
        stripped = line.strip()
        if stripped.startswith("+") and out:
            out[-1][1].append(stripped[1:])
            cont = out[-1][1][-1].rstrip().endswith("\\")
            if cont:
                out[-1][1][-1] = out[-1][1][-1].rstrip("\\").rstrip()
            continue
        if cont and out:
            out[-1][1].append(stripped)
        else:
            out.append([i, [stripped]])
        cont = stripped.endswith("\\")
        if cont:
            out[-1][1][-1] = out[-1][1][-1].rstrip("\\").rstrip()
    return [(n, " ".join(parts)) for n, parts in out]


_TOK = re.compile(r"""\s*(?:
    (?P<q>"[^"]*")
  | (?P<p>[()\[\]=,])
  | (?P<w>[^\s()\[\]=,"]+)
)""", re.X)


def _tokens(line, file, lineno):
    toks, pos = [], 0
    while pos < len(line):
        m = _TOK.match(line, pos)
        if not m:
            if line[pos:].strip() == "":
                break
            raise SpectreParseError(f"bad character {line[pos]!r}", file,
                                    lineno, line)
        pos = m.end()
        if m.group("q"):
            toks.append(("q", m.group("q")[1:-1]))
        elif m.group("p"):
            toks.append(("p", m.group("p")))
        else:
            toks.append(("w", m.group("w")))
    return toks


def _val(tok, loc):
    kind, s = tok
    if kind == "q":
        return s
    v = parse_number(s, "spectre")
    if v is not None:
        return v
    try:
        return parse_expr(s, "spectre")
    except ExprError:
        return ("ref", s)


#: spectre built-in primitive masters → (SPICE letter, param renames)
_PRIMITIVES = {
    "resistor": ("r", {}),
    "capacitor": ("c", {}),
    "inductor": ("l", {}),
    "vsource": ("v", {}),
    "isource": ("i", {}),
    "vcvs": ("e", {}),
    "vccs": ("g", {}),
    "cccs": ("f", {}),
    "ccvs": ("h", {}),
    "diode": ("d", {}),
    "bjt": ("q", {}),
    "mos1": ("m", {}),
}

_ANALYSES = {"tran", "dc", "ac", "noise", "sp", "xf", "pss", "mc", "op"}


class SpectreParser:
    def __init__(self, text, file="<spectre>", errors="raise"):
        self.file = file
        self.errors = errors
        self.lines = _logical_lines(text, file)
        self.i = 0

    def parse(self):
        stmts = self._block(end=None)
        return P.SpiceNetlist("", stmts, self.file)

    def _block(self, end):
        out = []
        while self.i < len(self.lines):
            lineno, line = self.lines[self.i]
            head = line.split()[0]
            if end is not None and head == end:
                return out
            self.i += 1
            loc = P.Loc(self.file, lineno, line)
            if self.errors == "collect":
                try:
                    st = self._statement(head, line, loc)
                except P.SpiceParseError as e:
                    st = P.ErrorNode(str(e), loc)
            else:
                st = self._statement(head, line, loc)
            if st is not None:
                out.append(st)
        if end is not None:
            raise SpectreParseError(f"missing {end!r}", self.file,
                                    self.lines[-1][0] if self.lines else 0,
                                    "")
        return out

    def _statement(self, head, line, loc):
        toks = _tokens(line, loc.file, loc.line)
        hl = head.lower()
        if hl == "simulator":
            return None   # handled by segmentation
        if hl == "parameters":
            return P.Param(self._assignments(toks[1:], loc), loc)
        if hl in ("include",):
            words = [t[1] for t in toks[1:]]
            sect = None
            if "section" in [w.lower() for w in words]:
                ix = [w.lower() for w in words].index("section")
                sect = words[ix + 1] if ix + 1 < len(words) else None
                words = words[:ix]
            return P.Include(words[0].strip('"'), sect, loc)
        if hl == "ahdl_include":
            return P.Control("hdl", [toks[1][1].strip('"')], {}, loc)
        if hl == "global":
            return P.Control("global", [t[1] for t in toks[1:]], {}, loc)
        if hl == "subckt":
            return self._subckt(toks, loc)
        if hl == "inline" and len(toks) >= 2 and \
                toks[1][1].lower() == "subckt":
            # inline subckt (reference forms.jl:26-120): same scoping as a
            # subckt; the body instance named like the subckt is the device
            # the instance name binds to
            return self._subckt(toks[1:], loc)
        if hl == "real" and "(" in line:
            return self._funcdecl(line, loc)
        if hl == "model":
            words = [t for t in toks if t[0] == "w"]
            name, mtype = words[1][1].lower(), words[2][1].lower()
            params = dict(self._assignments(toks[3:], loc))
            return P.Model(name, mtype, params, loc)
        if hl in ("ic", "nodeset"):
            kw = {k: v for k, v in self._assignments(toks[1:], loc)}
            return P.Control(hl, toks[1:], kw, loc)
        # named altergroup blocks: "<name> altergroup { ... }" — the body is
        # regular statements (parameters/model) applied at this point in the
        # analysis sequence (reference forms.jl AlterGroup; spectre.jl
        # re-emits byte-exactly, we re-elaborate per segment — see
        # api.simulate)
        if len(toks) >= 2 and toks[1] == ("w", "altergroup"):
            name = toks[0][1]
            body_lines = []
            depth = line.count("{") - line.count("}")
            while depth > 0 and self.i < len(self.lines):
                n2, l2 = self.lines[self.i]
                depth += l2.count("{") - l2.count("}")
                self.i += 1
                stripped = l2.strip()
                if depth <= 0:
                    stripped = stripped.rstrip("}").strip()
                if stripped:
                    body_lines.append((n2, stripped))
            sub = SpectreParser("", self.file)
            sub.lines = body_lines
            body = sub._block(end=None)
            return P.Control("altergroup", [name, body], {}, loc)
        if len(toks) >= 2 and toks[1][0] == "w" \
                and toks[1][1].lower() == "alter":
            # "a1 alter dev=x1 param=r value=2k" or "a1 alter param=..
            # value=.." (reference AlterStatement) — applied per segment
            kw = dict(self._assignments(toks[2:], loc))
            return P.Control("alterstmt", [toks[0][1]], kw, loc)
        if hl in ("statistics", "statistics{"):
            return self._statistics(line, loc)
        if hl in ("save", "options", "set", "info", "shell", "check",
                  "alter", "altergroup", "real", "}"):
            if hl == "options":
                return P.Control("option",  [],
                                 dict(self._assignments(toks[1:], loc)), loc)
            return None
        # named options statement: "<name> options temp=27 reltol=..."
        if len(toks) >= 2 and toks[1][0] == "w" \
                and toks[1][1].lower() == "options":
            return P.Control("option", [],
                             dict(self._assignments(toks[2:], loc)), loc)
        # analysis statement: <name> <type> param=val ...
        if len(toks) >= 2 and toks[1][0] == "w" \
                and toks[1][1].lower() in _ANALYSES:
            atype = toks[1][1].lower()
            kw = dict(self._assignments(toks[2:], loc))
            args = []
            if atype == "tran":
                args = [kw.pop("step", None) or 0.0, kw.get("stop", 0.0)]
                if "stop" in kw:
                    args[1] = kw.pop("stop")
            elif atype == "ac":
                sweep = "dec"
                n = kw.pop("dec", None)
                if n is None:
                    n = kw.pop("lin", 50)
                    sweep = "lin"
                args = [sweep, n, kw.pop("start", 1.0), kw.pop("stop", 1e9)]
            return P.Control(atype, args, kw, loc)
        # instance: name (nodes) master param=val ...
        return self._instance(toks, loc)

    def _statistics(self, line, loc):
        """``statistics { process { vary p dist=gauss std=s } mismatch
        { ... } }`` — Monte-Carlo variation specs.  Beyond the reference:
        SpectreNetlistParser has no statistics form (no hit in its
        parse/forms.jl) and this repo previously skipped the header line,
        leaving the body to mis-parse as instances.  Entries are applied by
        the elaborator when an ``mc_seed`` is given; nominal elaboration
        ignores them."""
        body_lines = []
        depth = line.count("{") - line.count("}")
        if depth == 0 and "{" in line:
            # whole block on one line: statistics { process { vary ... } }
            inner = line.split("{", 1)[1].rstrip()
            if inner.endswith("}"):
                inner = inner[:-1].strip()
            if inner:
                body_lines.append((loc.line, inner))
        # the opening brace may sit on the next line
        while depth == 0 and "{" not in line and self.i < len(self.lines):
            n2, l2 = self.lines[self.i]
            self.i += 1
            line = l2
            depth = l2.count("{") - l2.count("}")
            if "{" in l2:
                break
        while depth > 0 and self.i < len(self.lines):
            n2, l2 = self.lines[self.i]
            depth += l2.count("{") - l2.count("}")
            self.i += 1
            stripped = l2.strip()
            if depth <= 0:
                stripped = stripped.rstrip("}").strip()
            if stripped:
                body_lines.append((n2, stripped))
        entries = []
        kind = "process"
        queue = list(body_lines)
        while queue:
            n2, bl = queue.pop(0)
            w = bl.split()
            h = w[0].lower().rstrip("{")
            if h in ("process", "mismatch"):
                kind = h
                # single-line form: "process { vary ... }"
                rest = bl.split("{", 1)
                rest = rest[1] if len(rest) == 2 else ""
                rest = rest.rstrip().rstrip("}").strip()
                if rest:
                    queue.insert(0, (n2, rest))
                continue
            if h == "}" or bl == "}":
                continue
            if h == "vary" and len(w) >= 2:
                toks = _tokens(bl, loc.file, n2)
                kw = dict(self._assignments(toks[2:], loc))
                ent = {"kind": kind, "param": w[1]}
                for k, v in kw.items():
                    if isinstance(v, tuple) and v and v[0] == "ref":
                        v = v[1]
                    ent[k.lower()] = v
                entries.append(ent)
                continue
            entries.append({"kind": "unsupported", "src": bl})
        return P.Control("statistics", [entries], {}, loc)

    def _funcdecl(self, line, loc):
        """``real NAME([real] a, [real] b) { return EXPR; }`` — user-defined
        function (reference FunctionDecl,
        SpectreNetlistParser.jl/src/parse/forms.jl:145)."""
        text = line
        depth = text.count("{") - text.count("}")
        while (depth > 0 or "{" not in text) and self.i < len(self.lines):
            _, l2 = self.lines[self.i]
            self.i += 1
            text += " " + l2
            depth = text.count("{") - text.count("}")
        m = re.match(
            r"real\s+(\w+)\s*\(([^)]*)\)\s*\{\s*return\s+(.*?);?\s*\}\s*$",
            text, re.IGNORECASE | re.DOTALL)
        if not m:
            raise SpectreParseError(
                f"cannot parse function declaration: {text!r}",
                loc.file, loc.line, loc.src)
        name = m.group(1)
        args = [a.strip().split()[-1].lower()
                for a in m.group(2).split(",") if a.strip()]
        body = parse_expr(m.group(3), "spectre")
        return P.Control("funcdecl", [name, args, body], {}, loc)

    def _assignments(self, toks, loc):
        out = []
        j = 0
        while j < len(toks):
            if (toks[j][0] == "w" and j + 1 < len(toks)
                    and toks[j + 1] == ("p", "=")):
                name = toks[j][1].lower()
                # vector value [a b c ...]
                if j + 2 < len(toks) and toks[j + 2] == ("p", "["):
                    vec = []
                    j += 3
                    while j < len(toks) and toks[j] != ("p", "]"):
                        if toks[j][0] != "p":
                            vec.append(_val(toks[j], loc))
                        j += 1
                    j += 1
                    out.append((name, tuple(vec)))
                    continue
                # expression value spanning several tokens: a parenthesized
                # group, a function call f(a,b), and operator-continued
                # tails like (a+b)*c — rebuild source text through matching
                # parens and parse as one expression (real Spectre decks put
                # bare expressions after '=')
                starts_group = toks[j + 2] == ("p", "(")
                starts_call = (toks[j + 2][0] == "w" and j + 3 < len(toks)
                               and toks[j + 3] == ("p", "("))
                if starts_group or starts_call:
                    parts = []
                    depth = 0
                    j2 = j + 2
                    while j2 < len(toks):
                        kind, s = toks[j2]
                        if (kind, s) == ("p", "("):
                            depth += 1
                        elif (kind, s) == ("p", ")"):
                            if depth == 0:
                                break
                            depth -= 1
                        elif depth == 0 and parts and kind == "w" \
                                and s[0] not in "+-*/%?:^<>!&|," \
                                and not (j2 + 1 < len(toks)
                                         and toks[j2 + 1] == ("p", "(")):
                            break
                        elif depth == 0 and kind == "p" and s in ("=", "["):
                            break
                        parts.append(s)
                        j2 += 1
                    # don't swallow the next assignment's name
                    if (parts and j2 - 1 >= 0 and toks[j2 - 1][0] == "w"
                            and j2 < len(toks) and toks[j2] == ("p", "=")):
                        parts.pop()
                        j2 -= 1
                    try:
                        out.append((name,
                                    parse_expr("".join(parts), "spectre")))
                        j = j2
                        continue
                    except ExprError:
                        pass
                out.append((name, _val(toks[j + 2], loc)))
                j += 3
            else:
                j += 1
        return out

    def _subckt(self, toks, loc):
        words = [t[1] for t in toks[1:] if t[0] == "w"]
        if not words:
            raise SpectreParseError("subckt without name", loc.file,
                                    loc.line, loc.src)
        name, nodes = words[0], words[1:]
        body = self._block(end="ends")
        # consume 'ends [name]'
        self.i += 1
        params = {}
        # 'parameters' line inside body defines subckt params (keep as
        # defaults; also leave it in the body so inner scoping still works)
        for st in body:
            if isinstance(st, P.Param):
                for k, v in st.assignments:
                    params.setdefault(k, v)
        return P.Subckt(name.lower(), nodes, params, body, loc)

    def _instance(self, toks, loc):
        if not toks or toks[0][0] != "w":
            raise SpectreParseError("cannot parse statement", loc.file,
                                    loc.line, loc.src)
        name = toks[0][1]
        j = 1
        nodes = []
        if j < len(toks) and toks[j] == ("p", "("):
            j += 1
            while j < len(toks) and toks[j] != ("p", ")"):
                if toks[j][0] == "w":
                    nodes.append(toks[j][1])
                j += 1
            j += 1
        else:
            # nodes without parens: collect words until the master (the last
            # bare word before params)
            bare = []
            while j < len(toks) and toks[j][0] == "w" and not (
                    j + 1 < len(toks) and toks[j + 1] == ("p", "=")):
                bare.append(toks[j][1])
                j += 1
            nodes = bare[:-1] if len(bare) > 1 else []
            master = bare[-1] if bare else None
            kw = dict(self._assignments(toks[j:], loc))
            return self._make_element(name, nodes, master, kw, loc)
        master = None
        if j < len(toks) and toks[j][0] == "w":
            master = toks[j][1]
            j += 1
        kw = dict(self._assignments(toks[j:], loc))
        return self._make_element(name, nodes, master, kw, loc)

    def _make_element(self, name, nodes, master, kw, loc):
        if master is None:
            raise SpectreParseError(f"{name}: no master", loc.file, loc.line,
                                    loc.src)
        ml = master.lower()
        if ml in _PRIMITIVES:
            letter, renames = _PRIMITIVES[ml]
            waves = []
            if letter in ("v", "i"):
                kw, waves = _source_kw(kw)
            values = []
            if letter in ("e", "g") and "gain" in kw:
                values = [kw.pop("gain")]
                kw = {("gm" if letter == "g" else "gain"): values[0], **kw} \
                    if False else kw
                if letter == "e":
                    kw["gain"] = values[0]
                else:
                    kw["gm"] = values[0]
                values = []
            return P.Element(letter, name, nodes, None, values, kw, waves,
                             loc)
        # model/subckt/VA master → X-style resolution at elaboration
        return P.Element("x", name, nodes, ml, [], kw, [], loc)


def _source_kw(kw):
    """Map spectre vsource/isource params → our source params/waves."""
    out = {}
    waves = []
    ty = kw.pop("type", "dc")
    if isinstance(ty, tuple) and ty and ty[0] == "ref":
        ty = ty[1]
    ty = str(ty).lower()
    if "dc" in kw:
        out["dc"] = kw.pop("dc")
    if "mag" in kw:
        out["ac"] = kw.pop("mag")
    if "phase" in kw:
        out["acphase"] = kw.pop("phase")
    if ty == "pulse":
        waves.append(("pulse", [
            kw.pop("val0", 0.0), kw.pop("val1", 0.0), kw.pop("delay", 0.0),
            kw.pop("rise", 1e-12), kw.pop("fall", 1e-12),
            kw.pop("width", float("inf")), kw.pop("period", float("inf"))]))
    elif ty in ("sine", "sin"):
        waves.append(("sin", [
            kw.pop("sinedc", out.get("dc", 0.0)), kw.pop("ampl", 0.0),
            kw.pop("freq", 0.0), kw.pop("delay", 0.0),
            kw.pop("damp", 0.0), kw.pop("sinephase", 0.0)]))
    elif ty == "pwl":
        wave = kw.pop("wave", ())
        waves.append(("pwl", list(wave)))
    elif ty == "exp":
        waves.append(("exp", [
            kw.pop("val0", 0.0), kw.pop("val1", 0.0), kw.pop("td1", 0.0),
            kw.pop("tau1", 1e-9), kw.pop("td2", 1e30),
            kw.pop("tau2", 1e-9)]))
    out.update(kw)
    return out, waves


_LANG_RE = re.compile(r"^[ \t]*simulator[ \t]+lang[ \t]*=[ \t]*(\w+)[^\n]*",
                      re.M | re.I)


def parse_spectre(text: str, file="<spectre>",
                  errors="raise") -> P.SpiceNetlist:
    return SpectreParser(text, file, errors=errors).parse()


def parse_mixed(text: str, file="<netlist>", start_lang="spectre",
                errors="raise"):
    """Parse source with ``simulator lang=`` switching — the reference's
    mixed-dialect entry (SpectreNetlistParser.parse(io; start_lang),
    reference/SpectreNetlistParser.jl/src/SpectreNetlistParser.jl:35).
    """
    segments = []
    lang = start_lang
    pos = 0
    for m in _LANG_RE.finditer(text):
        seg = text[pos:m.start()]
        if seg.strip():
            segments.append((lang, seg))
        lang = m.group(1).lower()
        pos = m.end()
    seg = text[pos:]
    if seg.strip():
        segments.append((lang, seg))
    stmts = []
    title = ""
    for k, (lg, seg) in enumerate(segments):
        if lg == "spice":
            nl = P.SpiceParser(seg, file, title_line=(k == 0),
                               errors=errors).parse()
            title = title or nl.title
            stmts.extend(nl.statements)
        else:
            stmts.extend(SpectreParser(seg, file,
                                       errors=errors).parse().statements)
    return P.SpiceNetlist(title, stmts, file)
