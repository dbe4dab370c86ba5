"""Verilog-A preprocessor: ``define / ``include / ``ifdef / macro expansion.

The reference implements a full preprocessor with *virtual positions* mapping
expanded tokens back through expansion chains for exact diagnostics
(reference/VerilogAParser.jl/src/parse/preproc.jl:6-60).  Here each
expanded token keeps the (file, line) of the macro *use site* plus the macro
name in ``origin`` — enough to render "expanded from" notes.

Copy of ``cedarsim_tpu/va/preproc.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import os

from cedarsim_tpu_torch.va.lexer import lex_va, Tok


class VAPreprocError(ValueError):
    """Preprocessor diagnostic.  Carries the offending token (when one
    exists) so golden-file caret rendering works identically to
    VAParseError — the reference renders preprocessor errors through the
    same machinery (VerilogAParser.jl/src/parse/errors.jl)."""

    def __init__(self, msg, tok=None, file="<va>"):
        self.tok = tok
        self.raw_message = msg
        if tok is not None:
            msg = f"{file}:{tok.line}:{tok.col}: {msg}"
        super().__init__(msg)

    def render(self, sources=None, color=False):
        if self.tok is None:
            return str(self)
        from cedarsim_tpu_torch.va.diagnostics import render
        return render(self.raw_message, self.tok, sources, color)


_BUILTIN_DEFINES = {
    "__VAMS_ENABLE__": [],
    "__VAMS_COMPACT_MODELING__": [],
}


class Macro:
    def __init__(self, name, params, body, def_file="<va>", def_line=0):
        self.name = name
        self.params = params      # None = object-like, list = function-like
        self.body = body          # list[Tok] (no trailing nl)
        self.def_file = def_file
        self.def_line = def_line


def preprocess(text: str, file="<va>", include_paths=(), defines=None,
               _depth=0):
    """Returns a flat token list (no 'nl' tokens) after directive processing."""
    if _depth > 40:
        raise VAPreprocError(f"{file}: include depth exceeded")
    # the macro table is SHARED with includes (`define inside an included
    # file is visible to the includer afterwards, like cpp)
    macros: dict = defines if defines is not None else {}
    for k, v in _BUILTIN_DEFINES.items():
        macros.setdefault(k, Macro(k, None, list(v) if v else []))
    toks = lex_va(text, file)
    out = []
    i = 0
    # conditional-compilation stack: list of bool (currently active?)
    active_stack = []

    def active():
        return all(active_stack)

    while i < len(toks):
        t = toks[i]
        if t.kind == "eof":
            break
        if t.kind == "directive":
            d = t.text
            if d == "ifdef" or d == "ifndef":
                name = toks[i + 1].text
                cond = name in macros
                if d == "ifndef":
                    cond = not cond
                active_stack.append(cond)
                i += 2
                continue
            if d == "else":
                if not active_stack:
                    raise VAPreprocError(f"{file}:{t.line}: `else without "
                                         "`ifdef")
                active_stack[-1] = not active_stack[-1]
                i += 1
                continue
            if d == "endif":
                if not active_stack:
                    raise VAPreprocError(f"{file}:{t.line}: `endif without "
                                         "`ifdef")
                active_stack.pop()
                i += 1
                continue
            if not active():
                i += 1
                continue
            if d == "define":
                i += 1
                name_tok = toks[i]
                name = name_tok.text
                i += 1
                params = None
                # function-like iff '(' immediately follows (lexer drops
                # spaces, so approximate: '(' next and matching ids+commas)
                if (toks[i].kind == "op" and toks[i].text == "("
                        and toks[i].col == name_tok.col + len(name)):
                    params = []
                    i += 1
                    while toks[i].text != ")":
                        if toks[i].kind == "id":
                            params.append(toks[i].text)
                        i += 1
                    i += 1
                body = []
                while i < len(toks) and toks[i].kind != "nl" \
                        and toks[i].kind != "eof":
                    body.append(toks[i])
                    i += 1
                macros[name] = Macro(name, params, body,
                                     def_file=file, def_line=name_tok.line)
                continue
            if d == "undef":
                macros.pop(toks[i + 1].text, None)
                i += 2
                continue
            if d == "include":
                fname = toks[i + 1]
                if fname.kind != "str":
                    raise VAPreprocError(
                        f"{file}:{t.line}: `include expects a string")
                path = _find_include(fname.text, file, include_paths)
                with open(path, "r", errors="replace") as f:
                    sub = preprocess(f.read(), path, include_paths,
                                     defines=macros, _depth=_depth + 1)
                out.extend(sub)
                i += 2
                continue
            if d in ("default_nettype", "timescale", "resetall",
                     "celldefine", "endcelldefine"):
                while i < len(toks) and toks[i].kind != "nl":
                    i += 1
                continue
            # macro use
            if d in macros:
                exp, i = _expand_macro(macros[d], toks, i + 1, t, macros,
                                       file)
                out.extend(exp)
                continue
            raise VAPreprocError(f"undefined macro `{d}", t, file)
        if t.kind == "nl":
            i += 1
            continue
        if active():
            out.append(t)
        i += 1
    if active_stack:
        raise VAPreprocError(f"{file}: unterminated `ifdef")
    if _depth == 0:
        out.append(Tok("eof", "", toks[-1].line, toks[-1].col))
    return out


#: bundled standard headers (constants.vams / disciplines.vams)
STDLIB = os.path.join(os.path.dirname(__file__), "stdlib")


def _find_include(name, cur_file, include_paths):
    cands = []
    d = os.path.dirname(cur_file)
    if d:
        cands.append(os.path.join(d, name))
    cands.append(name)
    for p in include_paths:
        cands.append(os.path.join(p, name))
    cands.append(os.path.join(STDLIB, name))
    for c in cands:
        if os.path.isfile(c):
            return c
    raise VAPreprocError(f"include file {name!r} not found "
                         f"(from {cur_file}, paths {list(include_paths)})")


def _expand_macro(macro: Macro, toks, i, use_tok, macros, file, _depth=0,
                  _stack=()):
    """Expand one macro use.  Returns (expanded_tokens, next_index).

    ``_stack``: names of macros currently being expanded — a macro whose
    expansion uses itself (directly or through another macro) is an
    immediate error, matching the reference's VAS04 "Macro Evaluation
    recursed" (VerilogAParser.jl/test/errors/recursive_macro.out) rather
    than a depth-limit blowup."""
    if macro.name in _stack:
        raise VAPreprocError(
            f"recursive expansion of macro `{macro.name} (the macro's "
            "expansion uses the macro itself; check for spelling mistakes "
            "or definition ordering)", use_tok, file)
    # argument tokens come from the USE site, not the macro body: they
    # expand against the stack as it stood at the call (so `M(`M(x)) is a
    # legal nested call, not self-recursion — ADVICE r3), while body-driven
    # expansion carries this macro's name (so a body that reaches itself
    # through an argument of ANOTHER macro, e.g. `define A `B(`A), is
    # still caught)
    arg_stack = _stack
    _stack = _stack + (macro.name,)
    if _depth > 100:
        raise VAPreprocError(f"macro expansion nested too deeply "
                             f"(`{macro.name})", use_tok, file)
    args = []
    if macro.params is not None:
        if toks[i].text != "(":
            raise VAPreprocError(
                f"macro `{macro.name} expects arguments", use_tok, file)
        i += 1
        depth = 1
        cur = []
        while depth > 0:
            t = toks[i]
            if t.kind == "eof":
                raise VAPreprocError(
                    f"unterminated call of macro `{macro.name}",
                    use_tok, file)
            if t.text == "(":
                depth += 1
            elif t.text == ")":
                depth -= 1
                if depth == 0:
                    i += 1
                    break
            elif t.text == "," and depth == 1:
                args.append(cur)
                cur = []
                i += 1
                continue
            if t.kind != "nl":
                cur.append(t)
            i += 1
        args.append(cur)
        if len(args) != len(macro.params):
            raise VAPreprocError(
                f"macro `{macro.name} expects {len(macro.params)} "
                f"argument(s), got {len(args)}", use_tok, file)
    argmap = dict(zip(macro.params or [], args))
    # virtual-position frame: tokens from the macro BODY keep their
    # definition-site coordinates plus this use-site frame prepended to the
    # origin chain (reference preproc.jl:6-60); argument tokens are use-site
    # text and keep their own coordinates/chain.
    frame = (macro.name, getattr(use_tok, "file", file), use_tok.line,
             use_tok.col, macro.def_file, macro.def_line)
    out = []
    j = 0
    body = macro.body
    while j < len(body):
        bt = body[j]
        if bt.kind == "paste":
            # `` token paste (Verilog-AMS LRM 10.3.3, used heavily by
            # compact-model parameter macros: NJ``SD → NJS): join the last
            # emitted token with the next body token post-substitution
            j += 1
            if not out or j >= len(body):
                raise VAPreprocError(
                    f"dangling `` token paste in macro `{macro.name}",
                    use_tok, file)
            nxt = body[j]
            if nxt.kind == "id" and nxt.text in argmap:
                subs = list(argmap[nxt.text])
            else:
                subs = [nxt]
            prev = out.pop()
            if subs:
                first = subs[0]
                out.append(Tok("id", prev.text + first.text, prev.line,
                               prev.col, None, prev.file, prev.origin))
                for at in subs[1:]:
                    out.append(Tok(at.kind, at.text, at.line, at.col,
                                   at.value, getattr(at, "file", file),
                                   getattr(at, "origin", None)))
            else:
                out.append(prev)
            j += 1
            continue
        if bt.kind == "id" and bt.text in argmap:
            # substitute the use-site argument tokens; macro uses INSIDE
            # an argument expand here (the reference expands arguments'
            # macro references at use time — recursive_macro.va passes
            # `TYPE == `ntype ? ... as an argument)
            ats = argmap[bt.text]
            k2 = 0
            while k2 < len(ats):
                at = ats[k2]
                if at.kind == "directive" and at.text in macros:
                    sub, k2 = _expand_macro(macros[at.text], ats, k2 + 1,
                                            use_tok, macros, file,
                                            _depth + 1, _stack=arg_stack)
                    out.extend(sub)
                    continue
                out.append(Tok(at.kind, at.text, at.line, at.col,
                               at.value, getattr(at, "file", file),
                               getattr(at, "origin", None)))
                k2 += 1
            j += 1
            continue
        if bt.kind == "directive":
            if bt.text in macros:
                sub, j2 = _expand_macro(macros[bt.text], body, j + 1, use_tok,
                                        macros, file, _depth + 1,
                                        _stack=_stack)
                for st2 in sub:
                    st2.origin = (frame,) + (st2.origin or ())
                out.extend(sub)
                j = j2
                continue
            # point at the macro-body token (definition site) and carry
            # the use-site frame so the render shows the full expansion
            # backtrace, like the reference's virtual positions
            etok = Tok("directive", "`" + bt.text, bt.line, bt.col, None,
                       macro.def_file, ((frame,) + (bt.origin or ())))
            raise VAPreprocError(
                f"undefined macro `{bt.text} (in expansion of "
                f"`{macro.name})", etok, macro.def_file)
        nt = Tok(bt.kind, bt.text, bt.line, bt.col, bt.value,
                 macro.def_file, ((frame,) + (bt.origin or ())))
        out.append(nt)
        j += 1
    return out, i
