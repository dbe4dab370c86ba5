""".measure evaluation over transient, AC, and DC-sweep solutions.

Reference parses MEAS forms for every analysis in its SPICE CST
(reference/SpectreNetlistParser.jl/src/SPICE/parse/forms.jl MEAS
forms); evaluation subset here: FIND ... AT=, MAX/MIN/AVG/RMS/PP/INTEG
with FROM/TO windows, WHEN <sig>=<val> with RISE/FALL/CROSS counts, and
TRIG/TARG delay measurements.  The independent axis is the analysis's
own: time (tran), frequency in Hz (ac), or the swept source value (dc).
AC signal accessors follow ngspice: ``vm(x)``/plain ``v(x)`` magnitude,
``vdb(x)`` 20·log10|v|, ``vp(x)`` phase in degrees, ``vr``/``vi``
real/imaginary parts.

Copy of ``cedarsim_tpu/analysis/measure.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import re

import numpy as np


class MeasureError(ValueError):
    pass


class MeasureResults(dict):
    """name -> value dict; failed measures get value None with the failure
    message in ``.errors[name]``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.errors = {}


# np.trapezoid is NumPy >= 2.0; fall back to the old name on 1.x.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


_NUM = r"[-+]?[\d.]+(?:[eE][-+]?\d+)?[a-zA-Z]*"


def _num(s):
    from cedarsim_tpu_torch.frontend.numbers import parse_number
    v = parse_number(s)
    if v is None:
        raise MeasureError(f"bad number {s!r}")
    return v


def _sig(sol, spec):
    spec = spec.strip()
    m = re.match(r"^[vV]\(\s*([^,)]+)\s*(?:,\s*([^)]+)\s*)?\)$", spec)
    if m:
        a = sol[m.group(1).lower()]
        if m.group(2):
            return a - sol[m.group(2).lower()]
        return a
    m = re.match(r"^[iI]\(\s*([^)]+)\s*\)$", spec)
    if m:
        return sol[m.group(1).lower() + ".I"]
    return sol[spec.lower()]


def _sig_ac(acsol, spec):
    """Real-valued AC accessor (ngspice vm/vdb/vp/vr/vi forms; plain v/i
    yields magnitude, matching ngspice's .meas ac behavior)."""
    spec = spec.strip()
    m = re.match(r"^(v|i|vm|im|vdb|idb|vp|ip|vr|ir|vi|ii)"
                 r"\(\s*([^,)]+)\s*(?:,\s*([^)]+)\s*)?\)$", spec, re.I)
    if not m:
        return np.abs(acsol[spec.lower()])
    op = m.group(1).lower()
    name = m.group(2).lower()
    if op.startswith("i"):
        name = name + ".I"
        op = "v" + op[1:] if len(op) > 1 else "v"
    y = acsol[name]
    if m.group(3):
        y = y - acsol[m.group(3).strip().lower()]
    if op in ("v", "vm"):
        return np.abs(y)
    if op == "vdb":
        return 20.0 * np.log10(np.maximum(np.abs(y), 1e-300))
    if op == "vp":
        return np.degrees(np.angle(y))
    if op == "vr":
        return np.real(y)
    return np.imag(y)   # vi


def _crossings(ts, y, val, kind="cross"):
    d = y - val
    s = np.sign(d)
    idx = np.nonzero(np.diff(s) != 0)[0]
    out = []
    for i in idx:
        rising = y[i + 1] > y[i]
        if kind == "rise" and not rising:
            continue
        if kind == "fall" and rising:
            continue
        # linear interpolation of the crossing time
        t = ts[i] + (val - y[i]) * (ts[i + 1] - ts[i]) / (y[i + 1] - y[i])
        out.append(t)
    return out


def analysis_of(line: str):
    """The analysis token of a .meas statement ("tran"/"ac"/"dc"), or None
    when unstated (ngspice requires it; we default missing to tran)."""
    toks = line.split()
    if toks and toks[0].lower().startswith(".meas"):
        toks = toks[1:]
    if toks and toks[0].lower() in ("tran", "ac", "dc"):
        return toks[0].lower()
    return None


def evaluate_measure(sol, line: str, xs=None, sig=None):
    """Evaluate one .meas statement. Returns (name, value).

    Default evaluation is over a TranSolution (axis = time, real signal
    access).  ``xs``/``sig`` override the independent axis and the
    spec→array accessor — how the AC (axis = Hz) and DC (axis = swept
    value) routes plug in (see ``evaluate_all``)."""
    toks = line.split()
    if toks[0].lower().startswith(".meas"):
        toks = toks[1:]
    if toks and toks[0].lower() in ("tran", "ac", "dc"):
        toks = toks[1:]
    if not toks:
        raise MeasureError(f"empty .measure: {line!r}")
    name = toks[0]
    rest = " ".join(toks[1:])
    low = rest.lower()
    if xs is None:
        xs = np.asarray(sol.ts)
    if sig is None:
        def sig(spec):
            return _sig(sol, spec)

    kw = dict(re.findall(r"(\w+)\s*=\s*('[^']*'|[^\s]+)", rest))
    kw = {k.lower(): v.strip("'") for k, v in kw.items()}
    t0 = _num(kw["from"]) if "from" in kw else float(xs[0])
    t1 = _num(kw["to"]) if "to" in kw else float(xs[-1])
    win = (xs >= t0) & (xs <= t1)

    m = re.match(r"^\s*find\s+(\S+)\s+at\s*=", low)
    if m or ("find" in low and "at" in kw):
        sigspec = re.search(r"find\s+(\S+)", rest, re.I).group(1)
        y = sig(sigspec)
        return name, float(np.interp(_num(kw["at"]), xs, y))

    m = re.match(r"^\s*(max|min|avg|rms|pp|integ)\s+(\S+)", rest, re.I)
    if m:
        op, sigspec = m.group(1).lower(), m.group(2)
        y = sig(sigspec)[win]
        t = xs[win]
        if op == "max":
            return name, float(y.max())
        if op == "min":
            return name, float(y.min())
        if op == "pp":
            return name, float(y.max() - y.min())
        if op == "avg":
            return name, float(_trapezoid(y, t) / (t[-1] - t[0]))
        if op == "rms":
            return name, float(np.sqrt(_trapezoid(y * y, t)
                                       / (t[-1] - t[0])))
        if op == "integ":
            return name, float(_trapezoid(y, t))

    m = re.match(r"^\s*deriv\s+(\S+)", rest, re.I)
    if m:
        # DERIV <sig> AT=<t> | DERIV <sig> WHEN <sig2>=<val> [RISE/FALL/
        # CROSS=n] — ngspice/HSPICE MEAS DERIV (reference MEAS forms,
        # reference/SpectreNetlistParser.jl/src/SPICE/parse/forms.jl).
        # d/dt on the (nonuniform) accepted-step axis via np.gradient's
        # second-order differences.
        y = sig(m.group(1))
        dy = np.gradient(y, xs)
        if "at" in kw:
            return name, float(np.interp(_num(kw["at"]), xs, dy))
        mw = re.search(r"when\s+(\S+)\s*=\s*(\S+)", rest, re.I)
        if mw:
            y2 = sig(mw.group(1))
            val = _num(mw.group(2))
            kind, nth = "cross", 1
            for k in ("rise", "fall", "cross"):
                if k in kw:
                    kind = k
                    nth = (int(_num(kw[k])) if kw[k].lower() != "last"
                           else -1)
            cr = _crossings(xs, y2, val, kind)
            if not cr:
                raise MeasureError(f"{name}: no {kind} crossing of {val}")
            return name, float(np.interp(cr[nth - 1 if nth > 0 else -1],
                                         xs, dy))
        raise MeasureError(f"{name}: DERIV needs AT= or WHEN: {line!r}")

    m = re.match(r"^\s*when\s+(\S+)\s*=\s*(\S+)", rest, re.I)
    if m:
        y = sig(m.group(1))
        val = _num(m.group(2))
        kind = "cross"
        nth = 1
        for k in ("rise", "fall", "cross"):
            if k in kw:
                kind = k
                nth = (int(_num(kw[k])) if kw[k].lower() != "last"
                       else -1)
        cr = _crossings(xs, y, val, kind)
        if not cr:
            raise MeasureError(f"{name}: no {kind} crossing of {val}")
        return name, float(cr[nth - 1 if nth > 0 else -1])

    m = re.match(r"^\s*trig\s+(\S+)\s+val\s*=\s*(\S+)(.*?)targ\s+(\S+)\s+"
                 r"val\s*=\s*(\S+)(.*)$", rest, re.I | re.S)
    if m:
        y1 = sig(m.group(1))
        v1 = _num(m.group(2))
        mid = m.group(3).lower()
        y2 = sig(m.group(4))
        v2 = _num(m.group(5))
        tail = m.group(6).lower()

        def kindn(txt):
            mm = re.search(r"(rise|fall|cross)\s*=\s*(\d+)", txt)
            if mm:
                return mm.group(1), int(mm.group(2))
            return "cross", 1

        k1, n1 = kindn(mid)
        k2, n2 = kindn(tail)
        c1 = _crossings(xs, y1, v1, k1)
        c2 = _crossings(xs, y2, v2, k2)
        if len(c1) < n1 or len(c2) < n2:
            raise MeasureError(f"{name}: trig/targ crossing not found")
        return name, float(c2[n2 - 1] - c1[n1 - 1])

    raise MeasureError(f"unsupported .measure form: {line!r}")


def measure_name(line: str) -> str:
    """The measure's name token (first token after `.meas [analysis]`)."""
    toks = line.split()
    if toks and toks[0].lower().startswith(".meas"):
        toks = toks[1:]
    if toks and toks[0].lower() in ("tran", "ac", "dc"):
        toks = toks[1:]
    return toks[0] if toks else line


def evaluate_all(results, circuit) -> MeasureResults:
    """Evaluate every .meas directive against the analyses that ran.

    ``results`` is the analysis dict (keys "tran"/"ac"/"dc"/"dc_sweep" as
    produced by ``simulate``) — or, legacy form, a bare TranSolution (then
    only tran-analysis measures evaluate).  Measures naming an analysis
    that did not run report a failure message, not an exception (the
    reference parses MEAS under every analysis; ngspice evaluates each
    against its own analysis axis)."""
    if not isinstance(results, dict):
        results = {"tran": results}
    out = MeasureResults()
    for cmd, args, kw in circuit.directives:
        if cmd not in ("meas", "measure"):
            continue
        line = args[0]
        name = measure_name(line)
        an = analysis_of(line) or "tran"
        try:
            if an == "tran":
                sol = results.get("tran")
                if sol is None:
                    raise MeasureError(f"{name}: no transient ran")
                _, out[name] = evaluate_measure(sol, line)
            elif an == "ac":
                acsol = results.get("ac")
                if acsol is None:
                    raise MeasureError(f"{name}: no AC analysis ran")
                _, out[name] = evaluate_measure(
                    acsol, line, xs=np.asarray(acsol.freqs),
                    sig=lambda spec, _a=acsol: _sig_ac(_a, spec))
            else:                              # dc
                res = results.get("dc")
                sweep = results.get("dc_sweep")
                if res is None or sweep is None:
                    raise MeasureError(f"{name}: no DC sweep ran")
                if not hasattr(sweep, "values"):
                    raise MeasureError(
                        f"{name}: .meas dc needs a single-source sweep "
                        f"axis (got {type(sweep).__name__})")
                _, out[name] = evaluate_measure(
                    res, line, xs=np.asarray(sweep.values, float),
                    sig=lambda spec, _r=res: np.asarray(_sig(_r, spec),
                                                        float))
        except MeasureError as e:
            out[name] = None
            out.errors[name] = str(e)
    return out


def fourier(sol, freq: float, names, n_harmonics: int = 9):
    """SPICE .FOUR: DFT of the last full period of each waveform at
    ``freq``; returns {name: dict(f0_mag, harmonics=[(k, mag, phase_deg)],
    thd_percent)}."""
    t1 = float(sol.ts[-1])
    t0 = t1 - 1.0 / freq
    if t0 < float(sol.ts[0]):
        raise MeasureError(".four: simulation shorter than one period")
    m = 512
    tg = np.linspace(t0, t1, m, endpoint=False)
    out = {}
    for name in names:
        y = np.interp(tg, sol.ts, _sig(sol, name))
        spec = np.fft.rfft(y) / m
        mags = 2.0 * np.abs(spec[1:n_harmonics + 1])
        phases = np.degrees(np.angle(spec[1:n_harmonics + 1]))
        thd = (np.sqrt(np.sum(mags[1:] ** 2)) / mags[0] * 100.0
               if mags[0] > 0 else float("inf"))
        out[name] = dict(
            dc=float(np.real(spec[0])), f0_mag=float(mags[0]),
            harmonics=[(k + 1, float(mags[k]), float(phases[k]))
                       for k in range(n_harmonics)],
            thd_percent=float(thd))
    return out
