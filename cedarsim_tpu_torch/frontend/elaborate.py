"""Netlist elaboration: SPICE AST → flat Circuit graph (counterpart of
``cedarsim_tpu/frontend/elaborate.py``).

The walk is the JAX package's: subcircuits flatten with dotted prefixes,
parameters resolve through lexically scoped lazy environments, models merge
into device parameter dicts and ``m=`` multipliers compose down the
hierarchy.  What differs is the binding: every card binds a device class of
the port.  A card whose device has no PyTorch counterpart yet raises
``NotImplementedError`` naming its ROADMAP item; nothing is bound in its
place.
"""

from __future__ import annotations

import math
import os
import warnings

from cedarsim_tpu_torch.core.circuit import Circuit, GROUND
from cedarsim_tpu_torch.devices import (
    Resistor, Capacitor, VSource, VSourcePWL, VSourcePULSE,
)
from cedarsim_tpu_torch.frontend import parser as P
from cedarsim_tpu_torch.frontend.expr import eval_expr, ExprError

_A11 = "ROADMAP A11 (PVT and Monte-Carlo sweeps)"
_A12 = "ROADMAP A12 (BSIM-CMG)"
_A14 = "ROADMAP A14 (other devices and VA channels)"
_A15 = "ROADMAP A15 (AC and noise)"
_A19 = "ROADMAP A19 (utilities and API)"


def _unported(what, item):
    return NotImplementedError(
        f"{what} has no PyTorch device yet — {item}")


class ElabError(ValueError):
    def __init__(self, msg, loc: P.Loc = None):
        if loc is not None:
            msg = f"{loc.file}:{loc.line}: {msg}\n    {loc.src.strip()}"
        super().__init__(msg)


class ParamEnv:
    """Lexically-scoped lazy parameter environment with cycle detection."""

    def __init__(self, parent=None):
        self.exprs = {}
        self.cache = {}
        self.parent = parent
        self._evaluating = set()

    def define(self, name, expr):
        name = name.lower()
        self.exprs[name] = expr
        self.cache.pop(name, None)

    def __contains__(self, name):
        name = name.lower()
        return (name in self.exprs
                or (self.parent is not None and name in self.parent))

    def __getitem__(self, name):
        name = name.lower()
        if name in self.cache:
            return self.cache[name]
        if name in self.exprs:
            if name in self._evaluating:
                raise ExprError(f"circular parameter definition: {name!r}")
            e = self.exprs[name]
            if isinstance(e, tuple) and e and e[0] == "funcdef":
                self.cache[name] = e
                return e
            if isinstance(e, (int, float)):
                v = float(e)
            else:
                self._evaluating.add(name)
                try:
                    v = eval_expr(e, self, None)
                finally:
                    self._evaluating.discard(name)
            self.cache[name] = v
            return v
        if self.parent is not None:
            return self.parent[name]
        raise ExprError(f"undefined parameter {name!r}")

    def get(self, name, default=None):
        return self[name] if name in self else default


def _tiny_default(v, d):
    return d if v is None else v


class Elaborator:
    def __init__(self, include_paths=(), temp=27.0, param_overrides=None):
        self.include_paths = [os.fspath(p) for p in include_paths]
        self.ckt = Circuit()
        self.globals = {"0", "gnd!", "vdd!", "vss!", "vcc!", "vee!"}
        self.warnings = []
        self.temp = temp
        self.param_overrides = {
            k.lower(): v for k, v in (param_overrides or {}).items()}

    # ---------------------------------------------------------------- utils

    def warn(self, msg, loc=None):
        if loc is not None:
            msg = f"{loc.file}:{loc.line}: {msg}"
        self.warnings.append(msg)
        warnings.warn(msg, stacklevel=2)

    def _resolve_file(self, path, loc):
        cands = [path]
        base = os.path.dirname(loc.file) if loc and os.path.isabs(
            loc.file) or (loc and os.sep in loc.file) else None
        if base:
            cands.append(os.path.join(base, path))
        for ip in self.include_paths:
            cands.append(os.path.join(ip, path))
        from cedarsim_tpu_torch.models import MODEL_SEARCH_PATHS
        for ip in MODEL_SEARCH_PATHS:
            cands.append(os.path.join(ip, path))
        for cand in cands:
            if os.path.isfile(cand):
                return cand
        raise ElabError(f"include file not found: {path!r}", loc)

    def vres(self, v, env, loc):
        """Resolve a value (float or expression AST) in an environment."""
        if isinstance(v, (int, float)):
            return float(v)
        try:
            return float(eval_expr(v, env, None))
        except ExprError as e:
            raise ElabError(str(e), loc)

    # ------------------------------------------------------------ main walk

    def run(self, netlist: P.SpiceNetlist) -> Circuit:
        self.ckt.title = netlist.title
        env = ParamEnv()
        env.define("$temp", self.temp)
        scope = dict(models={}, subckts={}, env=env)
        elements = []
        self._collect(netlist.statements, scope, elements)
        # user overrides win over netlist .param values
        for k, v in self.param_overrides.items():
            env.define(k, float(v))
        for el, sc in elements:
            if el.letter == "k":
                raise _unported("K (mutual inductance) card", _A14)
            self._instantiate(el, sc, prefix="", nodemap={}, mfac=1.0)
        return self.ckt

    def _collect(self, stmts, scope, elements):
        """Sequential definition pass: params/models/subckts register, includes
        splice, .if branches resolve; element cards queue for pass 2."""
        env = scope["env"]
        for st in stmts:
            if isinstance(st, P.Param):
                for name, expr in st.assignments:
                    env.define(name, expr)
            elif isinstance(st, P.Model):
                scope["models"][st.name] = st
            elif isinstance(st, P.Subckt):
                scope["subckts"][st.name] = (st, scope)
            elif isinstance(st, P.Include):
                self._do_include(st, scope, elements)
            elif isinstance(st, P.LibSection):
                scope.setdefault("libsections", {})[st.name] = st
            elif isinstance(st, P.IfBlock):
                taken = None
                for cond, body in st.branches:
                    if cond is None or bool(self.vres(cond, env, st.loc)):
                        taken = body
                        break
                if taken:
                    self._collect(taken, scope, elements)
            elif isinstance(st, P.Control):
                self._do_control(st, scope)
            elif isinstance(st, P.Element):
                elements.append((st, scope))
            else:
                self.warn(f"ignored statement {type(st).__name__}", st.loc)

    def _do_include(self, st: P.Include, scope, elements):
        path = self._resolve_file(st.path, st.loc)
        if path.lower().endswith(".scs"):
            raise NotImplementedError(
                f"Spectre-dialect include {path!r}: the Spectre front end "
                f"is not ported yet — {_A19}")
        with open(path, "r", errors="replace") as f:
            text = f.read()
        sub = P.SpiceParser(text, file=path, title_line=False).parse()
        stmts = sub.statements
        if st.section is not None:
            sections = {}
            for s in stmts:
                if isinstance(s, P.LibSection):
                    sections[s.name.lower()] = s
            sec = sections.get(st.section.lower())
            if sec is None:
                raise ElabError(
                    f"section {st.section!r} not found in {path!r}", st.loc)
            stmts = sec.body
        self._collect(stmts, scope, elements)

    def _do_control(self, st: P.Control, scope):
        env = scope["env"]
        if st.cmd == "statistics":
            raise NotImplementedError(
                f"statistics blocks are not ported yet — {_A11}")
        if st.cmd == "funcdecl":
            name, args, body = st.args
            env.define(name.lower() + "()", ("funcdef", list(args), body))
            return
        if st.cmd in ("ic", "nodeset"):
            for node, v in st.kwargs.items():
                val = self.vres(v, env, st.loc)
                if st.cmd == "ic":
                    self.ckt.ic(node.lower(), val)
                else:
                    self.ckt.nodesets[node.lower()] = val
            return
        if st.cmd == "global":
            for n in st.args:
                self.globals.add(n.lower())
            return
        if st.cmd == "option":
            for k, v in st.kwargs.items():
                if isinstance(v, (int, float)):
                    self.ckt.options[k] = float(v)
                    continue
                try:
                    self.ckt.options[k] = self.vres(v, env, st.loc)
                except ElabError:
                    if isinstance(v, tuple) and len(v) == 2 \
                            and v[0] in ("w", "ref") \
                            and isinstance(v[1], str):
                        self.ckt.options[k] = v[1].lower()
                    else:
                        raise
            return
        if st.cmd == "temp":
            if st.args:
                self.ckt.options["temp"] = self.vres(
                    P._val(("w", st.args[0]), st.loc), env, st.loc) \
                    if isinstance(st.args[0], str) else float(st.args[0])
            return
        if st.cmd in ("tran", "dc", "ac", "op", "noise", "four"):
            args = []
            for a in st.args:
                if isinstance(a, str):
                    from cedarsim_tpu_torch.frontend.numbers import \
                        parse_number
                    n = parse_number(a)
                    args.append(n if n is not None else a)
                else:
                    args.append(a)
            self.ckt.directives.append((st.cmd, args, {
                k: (self.vres(v, env, st.loc)
                    if not isinstance(v, (int, float)) else float(v))
                for k, v in st.kwargs.items()}))
            return
        if st.cmd in ("hdl", "va"):
            from cedarsim_tpu_torch.va.codegen import load_va
            path = self._resolve_file(st.args[0].strip('"'), st.loc)
            with open(path, "r", errors="replace") as f:
                mods = load_va(f.read(), path,
                               include_paths=self.include_paths)
            vam = scope.setdefault("va_modules", {})
            for name, cls in mods.items():
                vam[name.lower()] = cls
            return
        if st.cmd in ("alterstmt", "data", "meas", "measure", "save",
                      "probe"):
            raise NotImplementedError(
                f".{st.cmd} is not ported yet — {_A19}")
        if st.cmd in ("print", "plot", "width", "end", "backanno"):
            return
        self.warn(f"unhandled directive .{st.cmd}", st.loc)

    # -------------------------------------------------------------- devices

    def _net(self, name, prefix, nodemap):
        n = name.lower()
        if n in nodemap:
            return nodemap[n]
        if n in ("0", "gnd", "gnd!", "ground"):
            return GROUND
        if n in self.globals or n.endswith("!"):
            return self.ckt.net(n)
        return self.ckt.net(prefix + n)

    def _model(self, name, scope, loc, l=None, w=None, env=None):
        """Resolve a model by name; models named ``base.N`` are bins selected
        by instance L/W against their LMIN/LMAX/WMIN/WMAX."""
        n = name.lower()
        sc = scope
        while sc is not None:
            if n in sc["models"]:
                return sc["models"][n]
            bins = [m for key, m in sc["models"].items()
                    if key.startswith(n + ".")]
            if bins:
                if l is None or w is None:
                    return bins[0]
                scale = self.ckt.options.get("scale", 1.0)
                for m in bins:
                    def g(pname, d):
                        v = m.params.get(pname)
                        return d if v is None else self.vres(v, env, loc)
                    lmin, lmax = g("lmin", 0.0), g("lmax", 1.0)
                    wmin, wmax = g("wmin", 0.0), g("wmax", 1.0)
                    if lmin <= l * scale < lmax and wmin <= w * scale < wmax:
                        return m
                raise ElabError(
                    f"no bin of model {name!r} covers l={l:g} w={w:g}", loc)
            sc = sc.get("parent")
        raise ElabError(f"model {name!r} not found", loc)

    def _subckt(self, name, scope, loc):
        n = name.lower()
        sc = scope
        while sc is not None:
            if n in sc["subckts"]:
                return sc["subckts"][n]
            sc = sc.get("parent")
        return None

    def _instantiate(self, el: P.Element, scope, prefix, nodemap, mfac):
        env = scope["env"]
        name = prefix + el.name.lower()
        nets = [self._net(n, prefix, nodemap) for n in el.nodes]
        letter = el.letter
        if letter == "b":
            raise _unported(f"{el.name}: behavioral source", _A14)
        if letter == "sparam":
            raise _unported(f"{el.name}: S-parameter element", _A15)
        kw = {k: self.vres(v, env, el.loc) for k, v in el.params.items()}
        m = mfac * kw.pop("m", 1.0)

        def val(i, default=None):
            if i < len(el.values):
                return self.vres(el.values[i], env, el.loc)
            return default

        if letter == "x":
            self._instantiate_subckt(el, scope, prefix, nodemap, m, kw)
            return
        if letter == "r":
            p = {}
            mp = {}
            if el.model is not None:
                mdl = self._model(el.model, scope, el.loc)
                mp = {k: self.vres(v, env, el.loc)
                      for k, v in mdl.params.items()}
            for src in (mp, kw):
                for k, v in src.items():
                    if k in ("r", "res", "resistance"):
                        p["r"] = v
                    elif k in ("rsh",):
                        p["rsh"] = v
                    elif k in ("w", "l", "narrow", "short"):
                        p[k] = v
                    elif k in ("tc1", "tc2", "tnom"):
                        p[k] = v
                    elif k == "tc":
                        p["tc1"] = v
            if "r" not in p and el.values:
                p["r"] = val(0)
            self.ckt.add(Resistor, name, nets, p, m=m)
            return
        if letter == "c":
            c = kw.get("c", val(0))
            if c is None and el.model is not None:
                mdl = self._model(el.model, scope, el.loc)
                c = self.vres(mdl.params.get("c", 0.0), env, el.loc)
            self.ckt.add(Capacitor, name, nets, dict(c=c or 0.0), m=m)
            if "ic" in kw:
                self.ckt.ic(nets[0].name, kw["ic"])
            return
        if letter == "v":
            self._instantiate_source(el, name, nets, kw, env, m)
            return
        if letter == "m":
            mdl = self._model(el.model, scope, el.loc,
                              l=kw.get("l"), w=kw.get("w"), env=env)
            polarity, level = self._mos_kind(mdl, env, el.loc)
            if level in (8.0, 14.0, 49.0, 53.0, 54.0):
                self._instantiate_bsim4(el, name, nets, kw, mdl, env, m,
                                        polarity)
                return
            if level in (17.0, 72.0):
                raise _unported(f"{el.name}: BSIM-CMG (level {level:g})",
                                _A12)
            raise _unported(f"{el.name}: MOS level {level:g}", _A14)
        if letter == "osdi":
            raise ElabError(
                f"{el.name}: OSDI compiled-binary models are not supported — "
                "load the model's Verilog-A source instead", el.loc)
        if letter in ("i", "l", "d", "q", "j", "z", "e", "g", "f", "h", "t",
                      "o", "u", "s", "w"):
            raise _unported(f"{el.name}: {letter.upper()} card", _A14)
        raise ElabError(
            f"device type {el.letter.upper()!r} not implemented yet "
            f"({el.name})", el.loc)

    #: Spectre MOS master name -> equivalent SPICE level
    _SPECTRE_MOS_LEVEL = {"bsim4": 54.0, "bsim3v3": 49.0, "bsim3": 49.0,
                          "bsimcmg": 72.0, "bsimcmg107": 72.0,
                          "mos1": 1.0, "mos902": 1.0, "mos0": 1.0}

    def _mos_kind(self, mdl, env, loc):
        """Normalize a MOS model statement to (polarity, level)."""
        t = mdl.mtype
        if t in ("nmos", "pmos"):
            return t, self.vres(mdl.params.get("level", 1.0), env, loc)
        if t in self._SPECTRE_MOS_LEVEL:
            ty = mdl.params.get("type")
            if isinstance(ty, tuple) and ty and ty[0] == "ref":
                ty = ty[1]
            pol = "pmos" if str(ty).lower().startswith("p") else "nmos"
            return pol, self._SPECTRE_MOS_LEVEL[t]
        raise ElabError(f"model {mdl.name!r}: unknown MOS model kind {t!r}",
                        loc)

    def _instantiate_bsim4(self, el, name, nets, kw, mdl, env, m, polarity):
        """BSIM4-class MOSFET from a `.model level=8/14/49/53/54` card.
        Model-card parameters map case-insensitively onto the VA module's
        parameters; names the core does not implement are collected into one
        warning instead of failing the card."""
        from cedarsim_tpu_torch.models import bsim4_class
        rdsmod = 0
        if "rdsmod" in mdl.params:
            rdsmod = int(self.vres(mdl.params["rdsmod"], env, el.loc))
            if rdsmod not in (0, 1):
                self.warn(f"bsim4 model {el.model!r}: RDSMOD={rdsmod} not "
                          "supported (0/1); using 0", el.loc)
                rdsmod = 0
        cls = bsim4_class(rdsmod)
        p = {"TYPE": 1.0 if polarity == "nmos" else -1.0}
        ignored = []
        bin_corr = {}          # base param -> {'l': LP, 'w': WP, 'p': PP}

        def take(k, v):
            kl = k.lower()
            actual = cls.param_lower.get(kl)
            if actual is not None:
                p[actual] = v
                return
            if kl[:1] in ("l", "w", "p"):
                base = cls.param_lower.get(kl[1:])
                if base is not None:
                    bin_corr.setdefault(base, {})[kl[0]] = float(v)
                    return
            ignored.append(k)

        for k, v in mdl.params.items():
            if k in ("level", "version", "type"):
                continue
            take(k, self.vres(v, env, el.loc))
        for k, v in kw.items():
            take(k, v)
        if bin_corr:
            self._apply_bsim4_binning(cls, p, bin_corr)
        if ignored:
            self.warn(f"bsim4 model {el.model!r}: ignoring unsupported "
                      f"parameter(s) {sorted(set(ignored))}", el.loc)
        while len(nets) < 4:
            nets.append(nets[-1])
        self.ckt.add(cls, name, nets[:4], p, m=m)

    @staticmethod
    def _apply_bsim4_binning(cls, p, bin_corr):
        """Denormalize L/W/P binning corrections into effective card
        values: P_eff = P + LP/Lb + WP/Wb + PP/(Lb·Wb) (BSIM4 binning
        geometry, binunit 1 = microns, 2 = meters)."""
        resolved = cls.prepare(p)

        def g(name, d=0.0):
            return float(resolved.get(name, d))

        binunit = g("BINUNIT", 1.0)
        L = g("L", 5e-6)
        W = g("W", 5e-6)
        NF = max(g("NF", 1.0), 1.0)
        lln, lwn = g("LLN", 1.0), g("LWN", 1.0)
        wln, wwn = g("WLN", 1.0), g("WWN", 1.0)
        dL = (g("LINT") + g("LL") / L ** lln + g("LW") / W ** lwn
              + g("LWL") / (L ** lln * W ** lwn))
        dW = (g("WINT") + g("WL") / L ** wln + g("WW") / W ** wwn
              + g("WWL") / (L ** wln * W ** wwn))
        Lb = L + g("XL") - 2.0 * dL
        Wb = W / NF + g("XW") - 2.0 * dW
        if int(binunit) == 1:
            Lb, Wb = Lb / 1e-6, Wb / 1e-6
        for base, c in bin_corr.items():
            base_v = float(p.get(base, resolved.get(base, 0.0)))
            p[base] = (base_v + c.get("l", 0.0) / Lb + c.get("w", 0.0) / Wb
                       + c.get("p", 0.0) / (Lb * Wb))

    def _instantiate_source(self, el, name, nets, kw, env, m):
        p = {}
        vals = list(el.values)
        pending = []
        if el.model is not None:
            pending.append(("ref", el.model))
        pending += vals
        i = 0
        positional = []
        while i < len(pending):
            v = pending[i]
            if (isinstance(v, tuple) and v[0] == "ref"
                    and isinstance(v[1], str)):
                word = v[1].lower()
                if word == "dc":
                    i += 1
                    if i < len(pending):
                        p["dc"] = self.vres(pending[i], env, el.loc)
                    i += 1
                    continue
                if word == "ac":
                    i += 1
                    if i < len(pending):
                        p["ac"] = self.vres(pending[i], env, el.loc)
                        i += 1
                    if i < len(pending) and not (
                            isinstance(pending[i], tuple)
                            and pending[i][0] == "ref"):
                        p["acphase"] = self.vres(pending[i], env, el.loc)
                        i += 1
                    continue
            positional.append(self.vres(v, env, el.loc))
            i += 1
        if positional and "dc" not in p:
            p["dc"] = positional[0]
        if "dc" in kw:
            p["dc"] = kw["dc"]
        if "ac" in kw:
            p["ac"] = kw["ac"]

        if not el.waves:
            self.ckt.add(VSource, name, nets, p, m=m)
            return
        kind, args = el.waves[0]
        args = [self.vres(a, env, el.loc) for a in args]

        def a(i, d=None):
            return args[i] if i < len(args) else d

        if kind == "pulse":
            cls = VSourcePULSE
            p.update(v1=a(0, 0.0), v2=a(1, 0.0), td=a(2, 0.0),
                     tr=_tiny_default(a(3), 1e-12),
                     tf=_tiny_default(a(4), 1e-12),
                     pw=_tiny_default(a(5), math.inf),
                     per=_tiny_default(a(6), math.inf))
        elif kind == "pwl":
            cls = VSourcePWL
            ts, ys = args[0::2], args[1::2]
            if len(ts) != len(ys) or not ts:
                raise ElabError(f"{el.name}: malformed PWL points", el.loc)
            p.update(ts=tuple(ts), ys=tuple(ys))
        elif kind in ("sin", "sine", "exp"):
            raise _unported(f"{el.name}: {kind.upper()} source", _A14)
        else:
            raise ElabError(f"{el.name}: waveform {kind!r} not implemented",
                            el.loc)
        self.ckt.add(cls, name, nets, p, m=m)

    def _va_module(self, name, scope):
        n = name.lower()
        sc = scope
        while sc is not None:
            vam = sc.get("va_modules")
            if vam and n in vam:
                return vam[n]
            sc = sc.get("parent")
        return None

    #: model type → element letter for master-style instantiation (X-cards
    #: naming a .model)
    _MTYPE_LETTER = {"nmos": "m", "pmos": "m", "d": "d", "diode": "d",
                     "npn": "q", "pnp": "q", "vbic": "q", "r": "r",
                     "res": "r",
                     "resistor": "r", "c": "c", "capacitor": "c",
                     "l": "l", "inductor": "l",
                     "njf": "j", "pjf": "j", "nmf": "z", "pmf": "z",
                     "bsim4": "m", "bsim3v3": "m", "bsim3": "m",
                     "bsimcmg": "m", "bsimcmg107": "m", "mos1": "m",
                     "mos902": "m", "mos0": "m"}

    def _instantiate_subckt(self, el, scope, prefix, nodemap, mfac, kw):
        entry = self._subckt(el.model, scope, el.loc)
        if entry is None:
            cls = self._va_module(el.model, scope)
            if cls is not None:
                name = prefix + el.name.lower()
                nets = [self._net(n, prefix, nodemap) for n in el.nodes]
                self.ckt.add(cls, name, nets, kw, m=mfac)
                return
            try:
                mdl = self._model(el.model, scope, el.loc)
            except ElabError:
                mdl = None
            if mdl is not None and mdl.mtype in self._MTYPE_LETTER:
                import dataclasses as _dc
                el2 = _dc.replace(el, letter=self._MTYPE_LETTER[mdl.mtype])
                self._instantiate(el2, scope, prefix, nodemap, mfac)
                return
            raise ElabError(f"subcircuit {el.model!r} not found", el.loc)
        sub, def_scope = entry
        if len(el.nodes) != len(sub.nodes):
            raise ElabError(
                f"{el.name}: {el.model} has {len(sub.nodes)} ports "
                f"({' '.join(sub.nodes)}), got {len(el.nodes)}", el.loc)
        child_env = ParamEnv(parent=def_scope["env"])
        for pname, pexpr in sub.params.items():
            child_env.define(pname, pexpr)
        for pname, pval in kw.items():   # already evaluated in caller env
            child_env.define(pname, pval)
        child_prefix = prefix + el.name.lower() + "."
        child_map = {}
        for port, nodename in zip(sub.nodes, el.nodes):
            child_map[port.lower()] = self._net(nodename, prefix, nodemap)
        child_scope = dict(models=dict(), subckts=dict(), env=child_env,
                           parent=scope)
        elements = []
        self._collect(sub.body, child_scope, elements)
        # instance overrides win over `parameters` statements in the body
        for pname, pval in kw.items():
            child_env.define(pname, pval)
        for e2, sc2 in elements:
            self._instantiate(e2, sc2, child_prefix, child_map, mfac)


def elaborate(netlist, include_paths=(), params=None, temp=27.0) -> Circuit:
    el = Elaborator(include_paths=include_paths, temp=temp,
                    param_overrides=params)
    return el.run(netlist)


def load_spice(text: str, file="<netlist>", **kw) -> Circuit:
    """Parse + elaborate SPICE netlist text → Circuit."""
    return elaborate(P.parse_spice(text, file), **kw)
