"""Float32 arithmetic that rounds as the card's kernels do, for their plain
PyTorch versions.

The GESP kernels update with fused multiply-adds (``__fmaf_rn``, or
``a -= b * c`` contracted by nvcc): one rounding of the exact ``a·b + c``.
PyTorch has no float32 FMA on the CPU, and ``a·b`` then ``+ c`` rounds
twice.  :func:`fma_f32` computes the single rounding exactly on any device.
"""

from __future__ import annotations

import torch


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
