"""Touchstone (.sNp) S-parameter file parser + network conversions.

Implements the Touchstone 1.x format the reference's SParameterElement
consumes (reference/SpectreNetlistParser.jl/src/SPICE/parse/forms.jl:
411-418 parses the element; the data files are industry-standard):

* option line ``# <freq-unit> S <format> R <z0>`` — units HZ/KHZ/MHZ/GHZ,
  formats RI (real/imag), MA (mag/angle-deg), DB (20log10-mag/angle-deg)
* data lines: frequency followed by 2·p² values; for 2-port files the
  column order is S11 S21 S12 S22 (the spec's quirk), for p≠2 row-major
  S11 S12 ... with wrapped continuation lines

Copy of ``cedarsim_tpu/frontend/touchstone.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import cmath
import math
import re

import numpy as np

_UNITS = {"hz": 1.0, "khz": 1e3, "mhz": 1e6, "ghz": 1e9}


class TouchstoneError(ValueError):
    pass


def _pair_to_complex(a, b, fmt):
    if fmt == "ri":
        return complex(a, b)
    if fmt == "ma":
        return cmath.rect(a, math.radians(b))
    if fmt == "db":
        return cmath.rect(10.0 ** (a / 20.0), math.radians(b))
    raise TouchstoneError(f"unknown format {fmt!r}")


def nports_from_name(path: str):
    m = re.search(r"\.s(\d+)p$", path.lower())
    return int(m.group(1)) if m else None


def parse_touchstone(text: str, nports: int = None):
    """Returns ``(freqs_hz [m], S [m, p, p] complex, z0)``.

    ``nports``: from the file extension when known; otherwise inferred from
    the first data record's value count."""
    unit, fmt, z0 = 1e9, "ma", 50.0   # touchstone defaults
    values = []
    for raw in text.splitlines():
        line = raw.split("!", 1)[0].strip()
        if not line:
            continue
        if line.startswith("#"):
            toks = line[1:].lower().split()
            i = 0
            while i < len(toks):
                t = toks[i]
                if t in _UNITS:
                    unit = _UNITS[t]
                elif t == "s":
                    pass
                elif t in ("y", "z", "h", "g"):
                    raise TouchstoneError(
                        f"only S-parameter files supported (got {t.upper()})")
                elif t in ("ri", "ma", "db"):
                    fmt = t
                elif t == "r" and i + 1 < len(toks):
                    z0 = float(toks[i + 1])
                    i += 1
                i += 1
            continue
        if line.startswith("["):   # touchstone 2.0 keywords — not needed
            continue
        values.extend(float(v) for v in line.split())

    if not values:
        raise TouchstoneError("no data records")
    if nports is None:
        # a record is 1 + 2p² numbers; try small p
        for p in (1, 2, 3, 4):
            if len(values) % (1 + 2 * p * p) == 0:
                nports = p
                break
        else:
            raise TouchstoneError("cannot infer port count")
    rec = 1 + 2 * nports * nports
    if len(values) % rec:
        raise TouchstoneError(
            f"data length {len(values)} not a multiple of record size {rec}")
    data = np.asarray(values).reshape(-1, rec)
    freqs = data[:, 0] * unit
    if np.any(np.diff(freqs) <= 0):
        raise TouchstoneError("frequencies must be strictly increasing")
    pairs = data[:, 1:].reshape(-1, nports * nports, 2)
    S = np.empty((data.shape[0], nports, nports), complex)
    for m in range(data.shape[0]):
        flat = [_pair_to_complex(a, b, fmt) for a, b in pairs[m]]
        M = np.asarray(flat).reshape(nports, nports)
        # 2-port files list S11 S21 S12 S22 → stored row-major that is
        # [[S11,S21],[S12,S22]]: transpose to matrix convention
        S[m] = M.T if nports == 2 else M
    return freqs, S, z0


def s_to_y(S, z0):
    """Port admittance matrices Y = (1/z0)·(I−S)·(I+S)⁻¹ per frequency."""
    p = S.shape[-1]
    eye = np.eye(p)
    out = np.empty_like(S)
    for m in range(S.shape[0]):
        out[m] = np.linalg.solve((eye + S[m]).T, (eye - S[m]).T).T / z0
    return out
