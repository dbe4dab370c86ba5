"""Caret/highlight diagnostics for Verilog-A parse errors, rendered through
macro expansions.

The reference renders errors with source excerpts, carets, and the full
macro-expansion backtrace, golden-file tested
(reference/VerilogAParser.jl/src/parse/errors.jl:1-1142,
test/errors.jl:1-30).  This renderer produces the rustc-style equivalent:

    error: unexpected token in module body
      --> model.va:54:9
       |
    54 |         `DIMOD(cbs,S)
       |         ^
       = in expansion of `DIMOD (used at model.va:54:9)
       |    defined at model.va:4
     4 | `define DIMOD(cb, SD)                                          \\

Tokens carry (file, line, col) of where their text physically lives (macro
bodies point into the ``define) plus an ``origin`` chain of use-site frames
(va/preproc.py), so the primary caret lands on the real text and the notes
walk out to the top-level use site.

Copy of ``cedarsim_tpu/va/diagnostics.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import os


def _line_of(sources, file, lineno):
    text = sources.get(file)
    if text is None:
        try:
            with open(file, "r", errors="replace") as f:
                text = f.read()
            sources[file] = text
        except OSError:
            return None
    lines = text.split("\n")
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1]
    return None


def render(message: str, tok, sources: dict = None, color: bool = False):
    """Render a diagnostic for a token (with optional macro backtrace).

    ``sources``: {filename: text} for in-memory sources; files are read from
    disk otherwise.  Returns the formatted multi-line string."""
    sources = dict(sources or {})
    red, bold, dim, reset = (
        ("\x1b[31m", "\x1b[1m", "\x1b[90m", "\x1b[0m") if color
        else ("", "", "", ""))
    file = getattr(tok, "file", "<va>")
    line = getattr(tok, "line", 0)
    col = getattr(tok, "col", 1)
    width = len(str(line))
    out = [f"{red}{bold}error:{reset} {message}"]
    out.append(f"{' ' * width}{dim}-->{reset} "
               f"{os.path.basename(str(file))}:{line}:{col}")
    src = _line_of(sources, file, line)
    gut = f"{dim}|{reset}"
    if src is not None:
        out.append(f"{' ' * width} {gut}")
        out.append(f"{dim}{line}{reset} {gut} {src}")
        n = max(len(getattr(tok, 'text', '') or ' '), 1)
        out.append(f"{' ' * width} {gut} {' ' * (col - 1)}{red}{'^' * n}"
                   f"{reset}")
    for frame in (getattr(tok, "origin", None) or ()):
        name, use_file, use_line, use_col, def_file, def_line = frame
        out.append(f"{' ' * width} {dim}={reset} in expansion of "
                   f"`{name} (used at "
                   f"{os.path.basename(str(use_file))}:{use_line}:{use_col})")
        use_src = _line_of(sources, use_file, use_line)
        if use_src is not None:
            w2 = len(str(use_line))
            out.append(f"{dim}{use_line}{reset} {gut} {use_src}")
        out.append(f"{' ' * width} {gut}    defined at "
                   f"{os.path.basename(str(def_file))}:{def_line}")
        def_src = _line_of(sources, def_file, def_line)
        if def_src is not None:
            out.append(f"{dim}{def_line}{reset} {gut} {def_src}")
    return "\n".join(out)
