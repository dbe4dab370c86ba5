"""Verilog-A lexer.

Token surface modeled on the reference's VerilogAParser tokenizer
(reference/VerilogAParser.jl/src/tokenize/): identifiers (incl. escaped
``\\name``), numbers with VA scale-factor suffixes (case-sensitive: ``M`` is
mega, ``m`` is milli — unlike SPICE), string literals, operators, compiler
directives (backtick), attributes ``(* ... *)``, and both comment styles.
Tokens carry (line, col) for diagnostics through macro expansion.

Copy of ``cedarsim_tpu/va/lexer.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import dataclasses
import re

_SCALE = {"T": 1e12, "G": 1e9, "M": 1e6, "K": 1e3, "k": 1e3,
          "m": 1e-3, "u": 1e-6, "n": 1e-9, "p": 1e-12, "f": 1e-15,
          "a": 1e-18}

_TOKEN_RE = re.compile(r"""
    (?P<cont>\\[ \t]*\r?\n)
  | (?P<ws>[ \t]+)
  | (?P<nl>\r?\n)
  | (?P<lcom>//[^\n]*)
  | (?P<bcom>/\*.*?\*/)
  | (?P<attr>\(\*.*?\*\))
  | (?P<str>"(?:[^"\\\n]|\\.)*")
  | (?P<based>(\d[\d_]*[ \t]*)?'[sS]?[bBoOdDhH][ \t]*[0-9a-fA-FxXzZ?_]+)
  | (?P<num>(\d[\d_]*\.?[\d_]*|\.\d[\d_]*)([eE][+-]?[\d_]+)?[TGMKkmunpfa]?)
  | (?P<paste>``)
  | (?P<directive>`[a-zA-Z_][a-zA-Z0-9_]*)
  | (?P<id>[a-zA-Z_][a-zA-Z0-9_$]*|\\[^ \t\n]+|\$[a-zA-Z_][a-zA-Z0-9_]*)
  | (?P<op><\+|<<<|>>>|<<|>>|<=|>=|==|!=|&&|\|\||\*\*|[-+*/%<>!&|^~=(){}\[\];:,.?@#'])
""", re.VERBOSE | re.DOTALL)


@dataclasses.dataclass
class Tok:
    kind: str        # 'id', 'num', 'str', 'op', 'directive', 'attr'
    text: str
    line: int
    col: int
    value: float = None   # for numbers
    file: str = "<va>"
    #: macro-expansion backtrace, outermost first: tuples of
    #: (macro_name, use_file, use_line, use_col, def_file, def_line) —
    #: the reference's virtual positions (VerilogAParser preproc.jl:6-60)
    origin: tuple = None

    def __repr__(self):
        return f"{self.kind}:{self.text!r}@{self.line}"


class VALexError(ValueError):
    pass


def lex_va(text: str, file="<va>"):
    """Tokenize Verilog-A source; newlines kept as 'nl' tokens (the
    preprocessor needs them for `define bodies)."""
    toks = []
    pos = 0
    line, col = 1, 1
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise VALexError(f"{file}:{line}:{col}: bad character "
                             f"{text[pos]!r}")
        kind = m.lastgroup
        s = m.group(0)
        if kind in ("ws", "cont"):
            pass
        elif kind in ("nl",):
            toks.append(Tok("nl", "\n", line, col))
        elif kind in ("lcom",):
            pass
        elif kind == "bcom":
            nl = s.count("\n")
            if nl:
                toks.append(Tok("nl", "\n", line, col))
        elif kind == "attr":
            toks.append(Tok("attr", s, line, col))
        elif kind == "num":
            body = s.replace("_", "")   # 1_000_000 (IEEE 1364 §3.5.1)
            scale = 1.0
            if body and body[-1] in _SCALE:
                scale = _SCALE[body[-1]]
                body = body[:-1]
            toks.append(Tok("num", s, line, col, value=float(body) * scale))
        elif kind == "based":
            # sized/based integer literal (IEEE 1364 §3.5.1): [size]'[s]base
            # digits, with x/z/? unknown bits and _ separators.  Verilog-AMS
            # inherits the full Verilog number syntax; analog expressions
            # only ever see fully-known values, so x/z lex to value=None
            # (a parse-time constant the analog codegen rejects if used).
            base_m = re.search(r"'[sS]?([bBoOdDhH])", s)
            digits = s[base_m.end():].strip().replace("_", "")
            radix = {"b": 2, "o": 8, "d": 10, "h": 16}[
                base_m.group(1).lower()]
            try:
                val = float(int(digits, radix))
            except ValueError:      # x/z/? unknown bits
                val = None
            toks.append(Tok("num", s, line, col, value=val))
        elif kind == "paste":
            # `` token-paste operator (meaningful inside `define bodies;
            # resolved by the preprocessor's macro expansion)
            toks.append(Tok("paste", s, line, col))
        elif kind == "directive":
            toks.append(Tok("directive", s[1:], line, col))
        elif kind == "id":
            toks.append(Tok("id", s, line, col))
        elif kind == "str":
            toks.append(Tok("str", s[1:-1], line, col))
        else:
            toks.append(Tok("op", s, line, col))
        # update position
        nl = s.count("\n")
        if nl:
            line += nl
            col = len(s) - s.rfind("\n")
        else:
            col += len(s)
        pos = m.end()
    toks.append(Tok("eof", "", line, col))
    for t in toks:
        t.file = file
    return toks
