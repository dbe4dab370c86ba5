"""SPICE/Spectre numeric literals with SI suffixes, parsed exactly.

The reference parses SI-suffixed literals in decimal floating point (Dec64 via
DecFP) before converting to Float64, so e.g. ``23pf`` is exact
(reference/src/spectre.jl:434-457; suffix tables :385-415).  We use
Python's ``decimal`` for the same exactness.

Dialect quirk preserved: SPICE is case-insensitive with ``m``/``M`` = milli and
``meg`` = 1e6; Spectre is case-sensitive with ``M`` = mega and ``m`` = milli.
``mil`` = 25.4e-6 in both.

Copy of ``cedarsim_tpu/frontend/numbers.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

from decimal import Decimal
import re

_SPICE_SUFFIX = {
    "t": Decimal("1e12"), "g": Decimal("1e9"), "meg": Decimal("1e6"),
    "k": Decimal("1e3"), "mil": Decimal("25.4e-6"), "m": Decimal("1e-3"),
    "u": Decimal("1e-6"), "n": Decimal("1e-9"), "p": Decimal("1e-12"),
    "f": Decimal("1e-15"), "a": Decimal("1e-18"),
}

_SPECTRE_SUFFIX = {
    "T": Decimal("1e12"), "G": Decimal("1e9"), "M": Decimal("1e6"),
    "K": Decimal("1e3"), "k": Decimal("1e3"), "_": Decimal("1"),
    "%": Decimal("0.01"), "c": Decimal("1e-2"), "m": Decimal("1e-3"),
    "u": Decimal("1e-6"), "n": Decimal("1e-9"), "p": Decimal("1e-12"),
    "f": Decimal("1e-15"), "a": Decimal("1e-18"),
}

_NUM_RE = re.compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def parse_number(tok: str, dialect: str = "spice"):
    """Parse a SPICE numeric literal like ``23pF``, ``1meg``, ``2.5e-3``.
    Returns float or None if ``tok`` is not a number."""
    m = _NUM_RE.match(tok)
    if not m:
        return None
    mantissa = Decimal(m.group(0))
    rest = tok[m.end():]
    if not rest:
        return float(mantissa)
    if dialect == "spice":
        rest_l = rest.lower()
        for suf in ("meg", "mil"):
            if rest_l.startswith(suf):
                return float(mantissa * _SPICE_SUFFIX[suf])
        s = _SPICE_SUFFIX.get(rest_l[0])
        if s is not None:
            # trailing unit letters are ignored (23pF, 10kOhm)
            return float(mantissa * s)
        if rest_l[0].isalpha():
            # bare unit (e.g. 5V) — also legal, ignored
            return float(mantissa)
        return None
    else:  # spectre (case-sensitive)
        s = _SPECTRE_SUFFIX.get(rest[0])
        if s is not None:
            return float(mantissa * s)
        if rest[0].isalpha():
            return float(mantissa)
        return None


def is_number(tok: str, dialect: str = "spice") -> bool:
    return parse_number(tok, dialect) is not None
