"""Fused multiply-adds computed exactly on any device.

The GESP kernels update with fused multiply-adds (``__fmaf_rn``, or
``a -= b * c`` contracted by nvcc): one rounding of the exact ``a·b + c``.
PyTorch has no float32 FMA on the CPU, and ``a·b`` then ``+ c`` rounds
twice.  :func:`fma_f32` computes the single rounding exactly on any device.
XLA's CPU compiler contracts float64 ``c + a·b`` into an FMA too, so
``jnp.interp``'s interior value is one rounding of it; :func:`fma_f64`
gives that rounding, for the ring lookups that must equal ``jnp.interp``.
"""

from __future__ import annotations

import torch

from cedarsim_tpu_torch.ops.ad import any_tangent


def fma_f32(a, b, c):
    """The correctly rounded float32 ``a·b + c`` of float32 tensors (they
    broadcast), bitwise C's ``fmaf`` under round-to-nearest-even.

    The product of two float32 values is exact in float64; Knuth's TwoSum
    gives its float64 sum ``s`` with ``c`` and the exact error ``e``.  Where
    ``e`` is not 0 and ``s`` is even, ``s`` moves one ulp toward ``e``:
    that is the sum rounded to odd in 53 bits, and since 53 >= 2·24 + 2 the
    cast to float32 then rounds as one rounding of the exact sum would.  A
    plain float64 sum cast to float32 would round twice, and miss on
    ties."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    pv = s - c
    cv = s - pv
    e = (p - pv) + (c - cv)
    even = (s.view(torch.int64) & 1) == 0
    # non-finite sums (inf or NaN operands, or inf - inf) keep s as it is
    fix = (e != 0) & even & torch.isfinite(s)
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(fix, torch.nextafter(s, toward), s)
    return s.float()


def _two_sum(a, b):
    """Knuth's TwoSum: s = a + b rounded and the exact error e."""
    s = a + b
    bv = s - a
    av = s - bv
    return s, (a - av) + (b - bv)


_SPLIT = 134217729.0          # 2**27 + 1, Veltkamp's splitter for float64


def _two_prod(a, b):
    """Dekker's product: p = a·b rounded and the exact error e (no FMA;
    exact unless a·b overflows or its error underflows)."""
    p = a * b

    def split(x):
        t = _SPLIT * x
        hi = t - (t - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma_f64(a, b, c):
    """The correctly rounded float64 ``a·b + c`` of float64 tensors (they
    broadcast; finite and away from overflow), bitwise C's ``fma``: the
    exact product as uh + ul (Dekker), th + tl = c + uh exactly (TwoSum),
    v = tl + ul rounded to odd, and th + v rounded to nearest (Boldo and
    Melquiond's emulated FMA).  Its bit operations carry no tangent, so an
    input with AD state raises instead of losing it."""
    if any_tangent(a, b, c):
        raise ValueError(
            "fma_f64: an input carries an autograd tangent, which its bit "
            "operations (view as int64, nextafter) would drop")
    a, b, c = torch.broadcast_tensors(a, b, c)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, e = _two_sum(tl, ul)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(v.dtype)
    v = torch.where((e != 0) & even, torch.nextafter(v, toward), v)
    return th + v
