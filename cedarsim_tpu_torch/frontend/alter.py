"""``alter``: re-emit netlist source with substituted parameter values.

Reference: ``alter(io, ast; params...)`` prints the original netlist
byte-exactly with parameter values substituted, using red-tree offsets
(reference/src/spectre.jl:1773-1829; round-trip test
test/params.jl:60-140).

Here the netlist text itself is the lossless representation: an
offset-exact tokenizer scans the raw bytes once, understanding SPICE and
Spectre lexical structure — line/inline comments, ``'...'``/``"..."``
quotes, ``{...}`` expression braces, ``+`` continuations, and
``.subckt``/``subckt`` scope nesting — and records the exact byte span of
every top-level ``name=value`` assignment.  ``alter`` then splices
replacement values into those spans; every other byte of the source is
preserved verbatim.  Unlike the round-2 regex implementation, a parameter
name appearing *inside* a quoted expression or a comment can never be
mis-edited: assignments are only recognized between tokens at statement
level.

Copy of ``cedarsim_tpu/frontend/alter.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations


class AlterError(ValueError):
    pass


_WS = " \t\r"
_PUNCT = "(),"


def _scan_assignments(text: str):
    """Yield (scope_tuple, stmt_name, param_lower, value_lo, value_hi) for
    every top-level ``name=value`` assignment in the source.

    ``scope_tuple``: lowercased names of the enclosing .subckt bodies
    (SPICE ``.subckt``/``.ends`` and Spectre ``subckt``/``ends``).
    ``stmt_name``: lowercased first word of the statement (instance name,
    ``.param``, ``parameters``, ...).
    """
    n = len(text)
    i = 0
    scopes = []                     # enclosing subckt names (lowered)
    stmt_toks = []                  # tokens of the current statement
    line_start = True               # at start of a physical line
    stmt_open = False               # a statement is being accumulated

    # tokens accumulate as (lo, hi, kind): "w" word, "q" quoted/braced,
    # "=" equals
    results = []

    def end_statement():
        nonlocal stmt_toks, stmt_open
        toks = stmt_toks
        stmt_toks = []
        stmt_open = False
        if not toks:
            return
        first = text[toks[0][0]:toks[0][1]].lower()
        if first in (".subckt", "subckt") and len(toks) > 1:
            # push BEFORE capturing scope_now: default-parameter
            # assignments on the header line itself (``.subckt inv a b
            # wn=2u``) belong to the subckt's scope, so
            # scoped={'inv.wn': ...} reaches them
            scopes.append(text[toks[1][0]:toks[1][1]].lower())
        elif first in (".ends", "ends", ".eom"):
            if scopes:
                scopes.pop()
        scope_now = tuple(scopes)
        k = 0
        while k + 2 < len(toks):
            if (toks[k][2] == "w" and toks[k + 1][2] == "="
                    and toks[k + 2][2] in ("w", "q")):
                results.append((scope_now, first,
                                text[toks[k][0]:toks[k][1]].lower(),
                                toks[k + 2][0], toks[k + 2][1]))
                k += 3
            else:
                k += 1

    while i < n:
        c = text[i]
        if c == "\n":
            # statement ends unless the next line continues with '+'
            j = i + 1
            while j < n and text[j] in _WS:
                j += 1
            if j < n and text[j] == "+" and stmt_open:
                i = j + 1           # swallow the continuation marker
                line_start = False
                continue
            end_statement()
            i += 1
            line_start = True
            continue
        if c in _WS:
            i += 1
            continue
        if line_start and c in "*":
            # SPICE full-line comment
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c in ";$" and not line_start:
            # inline comment to end of line (ngspice $ / ; convention)
            while i < n and text[i] != "\n":
                i += 1
            continue
        line_start = False
        if not stmt_open:
            stmt_open = True
        if c in "'\"":
            q = c
            j = i + 1
            while j < n and text[j] != q and text[j] != "\n":
                j += 1
            stmt_toks.append((i, min(j + 1, n), "q"))
            i = min(j + 1, n)
            continue
        if c == "{":
            depth = 1
            j = i + 1
            while j < n and depth:
                if text[j] == "{":
                    depth += 1
                elif text[j] == "}":
                    depth -= 1
                j += 1
            stmt_toks.append((i, j, "q"))
            i = j
            continue
        if c == "=":
            stmt_toks.append((i, i + 1, "="))
            i += 1
            continue
        if c in _PUNCT:
            i += 1
            continue
        # word token: runs to whitespace/eq/quote/brace/punct/comment
        j = i
        while j < n:
            d = text[j]
            if (d in _WS or d == "\n" or d == "=" or d in "'\"{"
                    or d in _PUNCT):
                break
            if d == "/" and j + 1 < n and text[j + 1] == "/":
                break
            if d in ";$" and j > i:
                break
            j += 1
        stmt_toks.append((i, j, "w"))
        i = j
    end_statement()
    return results


def alter(text: str, scoped: dict = None, **params) -> str:
    """Return netlist source with the given parameter values substituted.

    ``params`` (bare names) substitute every top-level ``name=<value>``
    assignment in the file.  ``scoped`` narrows the edit, matching the
    reference's offset-targeted substitution
    (reference/src/spectre.jl:1773-1829): keys are
    ``"<subckt>.<param>"`` (edits only assignments inside that subckt
    body) or ``"<instname>.<param>"`` (edits only that instance card).
    Unmatched names raise.  All other bytes — comments, spacing,
    continuations, quoted expressions — are preserved verbatim.
    """
    asn = _scan_assignments(text)
    edits = []                       # (lo, hi, replacement)

    def collect(pname, value, scope=None):
        pl = pname.lower()
        hits = []
        for scopes, stmt, name, lo, hi in asn:
            if name != pl:
                continue
            if scope is not None:
                sl = scope.lower()
                if sl not in scopes and stmt != sl:
                    continue
            hits.append((lo, hi))
        for lo, hi in hits:
            edits.append((lo, hi, _fmt(value)))
        return len(hits)

    for name, value in (params or {}).items():
        if collect(name, value) == 0:
            raise AlterError(f"alter: parameter {name!r} not found in source")
    for key, value in (scoped or {}).items():
        if "." not in key:
            if collect(key, value) == 0:
                raise AlterError(f"alter: parameter {key!r} not found")
            continue
        scope, pname = key.rsplit(".", 1)
        if collect(pname, value, scope=scope) == 0:
            raise AlterError(
                f"alter: parameter {pname!r} not found in scope {scope!r}")

    # apply right-to-left so earlier spans stay valid
    out = text
    for lo, hi, rep in sorted(edits, key=lambda e: -e[0]):
        out = out[:lo] + rep + out[hi:]
    return out


def _fmt(v):
    if isinstance(v, str):
        return v
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)
