"""``cedarsim_tpu_torch.ops.rounding.fma_f32`` against C's ``fmaf`` (glibc's
is correctly rounded), bitwise, on seeded float32 triples of several
kinds, and on constructed cases where a float64 sum cast to float32 rounds
twice and misses; ``fma_f64`` (the one rounding of XLA's contracted
multiply-add, which the history ring's lookups share with ``jnp.interp``)
against C's ``fma`` on seeded float64 triples, near-cancelling ones and
exact ties of the two roundings.

The plain versions of the GESP kernels round their multiply-adds with it,
so that they give the kernels' bits (``tests/test_torch_gesp_lu.py``);
``tests/test_torch_cuda.py`` repeats the check on a CUDA tensor.
"""

import ctypes

import numpy as np
import pytest
import torch

from cedarsim_tpu_torch.ops.rounding import fma_f32, fma_f64

#: seeded triples per kind (five kinds: 125,000 in all)
N = 25_000


def libm_fmaf(a, b, c):
    """C's ``fmaf`` on each triple of three float32 numpy arrays."""
    f = ctypes.CDLL("libm.so.6").fmaf
    f.restype = ctypes.c_float
    f.argtypes = [ctypes.c_float] * 3
    return np.array([f(float(x), float(y), float(z))
                     for x, y, z in zip(a.tolist(), b.tolist(), c.tolist())],
                    np.float32)


def triples(kind, n, seed):
    """n float32 triples (a, b, c) of one kind."""
    rng = np.random.default_rng(seed)

    def mag(lo, hi):
        m = rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(lo, hi, n)
        return (m * rng.choice([-1.0, 1.0], n)).astype(np.float32)

    if kind == "bits":          # every class, inf and NaN included
        a, b, c = (rng.integers(0, 2 ** 32, n, dtype=np.uint64)
                   .astype(np.uint32).view(np.float32) for _ in range(3))
    elif kind == "normal":
        a, b, c = mag(-20, 20), mag(-20, 20), mag(-40, 40)
    elif kind == "cancelling":  # c within a few ulps of -a·b
        a, b = mag(-30, 30), mag(-30, 30)
        p = a.astype(np.float64) * b.astype(np.float64)
        c = (-p).astype(np.float32)
        steps = rng.integers(-3, 4, n)
        for s in range(1, 4):
            c = np.where(steps >= s, np.nextafter(c, np.float32(np.inf)), c)
            c = np.where(steps <= -s, np.nextafter(c, np.float32(-np.inf)), c)
    elif kind == "subnormal":   # operands and results around 2^-126
        a, b = mag(-75, -50), mag(-75, -50)
        c = np.where(rng.random(n) < 0.5, mag(-149, -126), mag(-130, -110))
    elif kind == "huge":        # products and sums near float32's largest
        a, b = mag(60, 64), mag(60, 64)
        c = mag(120, 128)
    return a, b, c


def _same_bits(x, y):
    return (x.view(np.uint32) == y.view(np.uint32)) | (np.isnan(x)
                                                       & np.isnan(y))


KINDS = ["bits", "normal", "cancelling", "subnormal", "huge"]


@pytest.mark.parametrize("kind", KINDS)
def test_fma_f32_is_libm_fmaf(kind):
    a, b, c = triples(kind, N, seed=KINDS.index(kind))
    got = fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    ref = libm_fmaf(a, b, c)
    assert got.dtype == np.float32
    assert _same_bits(got, ref).all(), int((~_same_bits(got, ref)).sum())


def double_rounding_cases():
    """Triples whose exact a·b + c lies just off a float32 tie, and whose
    float64 sum lands on the tie: the product a·b (exact in float64) is
    the midpoint of two float32 numbers and c is far below half a float64
    ulp of it."""
    rng = np.random.default_rng(7)
    a = (1.0 + rng.integers(1, 2 ** 12, 4000) * 2.0 ** -12).astype(
        np.float32)
    b = (1.0 + rng.integers(1, 2 ** 12, 4000) * 2.0 ** -12).astype(
        np.float32)
    p = a.astype(np.float64) * b.astype(np.float64)
    # a midpoint: below float32's last bit, only the bit one place lower
    scale = 2.0 ** (23 - np.floor(np.log2(p)))
    frac = p * scale - np.floor(p * scale)
    mid = frac == 0.5
    a, b, p = a[mid], b[mid], p[mid]
    tiny = (p * 2.0 ** -60).astype(np.float32)
    c = np.concatenate([tiny, -tiny])
    return np.concatenate([a, a]), np.concatenate([b, b]), c


def test_fma_f32_rounds_once_where_float64_rounds_twice():
    a, b, c = double_rounding_cases()
    assert len(a) >= 100
    got = fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    ref = libm_fmaf(a, b, c)
    twice = (a.astype(np.float64) * b.astype(np.float64)
             + c.astype(np.float64)).astype(np.float32)
    assert _same_bits(got, ref).all()
    # these are the cases a float64 sum cast to float32 gets wrong (half of
    # them: the other sign of c rounds the tie the way RNE does anyway)
    assert (~_same_bits(twice, ref)).sum() >= len(a) // 4


def test_fma_f32_broadcasts_and_keeps_zero_signs():
    a = torch.tensor([1.0, -0.0, 2.0, float("inf"), 3.0])
    b = torch.tensor([0.0, 5.0, float("nan"), 0.0, -1.0])
    c = torch.tensor([-0.0, -0.0, 1.0, 1.0, 3.0])
    got = fma_f32(a, b, c).numpy()
    ref = libm_fmaf(a.numpy(), b.numpy(), c.numpy())
    assert _same_bits(got, ref).all()
    assert np.signbit(got[1]) and not np.signbit(got[4])
    row = fma_f32(torch.ones(3, 1), torch.arange(4.0), torch.zeros(4))
    assert row.shape == (3, 4) and row.dtype == torch.float32


def libm_fma(a, b, c):
    """C's ``fma`` on each triple of three float64 numpy arrays."""
    f = ctypes.CDLL("libm.so.6").fma
    f.restype = ctypes.c_double
    f.argtypes = [ctypes.c_double] * 3
    return np.array([f(x, y, z) for x, y, z in
                     zip(a.tolist(), b.tolist(), c.tolist())], np.float64)


def f64_triples(kind, n, seed):
    """n float64 triples (a, b, c): "normal" (magnitudes 2^-40 to 2^40),
    "cancelling" (c within a few ulps of −a·b) or "ties" (odd integers
    whose product needs 55 bits, so that rounding it to 53 drops two bits,
    a tie in a quarter of them, and c = ±1 or ±0.5 moves the exact sum on
    or off a tie: where the product rounded first and c added after would
    round twice)."""
    rng = np.random.default_rng(seed)

    def mag(lo, hi):
        return rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(lo, hi, n) \
            * rng.choice([-1.0, 1.0], n)

    a, b = mag(-20, 20), mag(-20, 20)
    if kind == "normal":
        c = mag(-40, 40)
    elif kind == "cancelling":
        c = -(a * b)
        steps = rng.integers(-3, 4, n)
        for s_ in range(1, 4):
            c = np.where(steps >= s_, np.nextafter(c, np.inf), c)
            c = np.where(steps <= -s_, np.nextafter(c, -np.inf), c)
    else:
        a = rng.integers(2 ** 26, 2 ** 27, n).astype(np.float64) * 2 + 1
        b = rng.integers(2 ** 26, 2 ** 27, n).astype(np.float64) * 2 + 1
        c = rng.choice([-1.0, 1.0, 0.5, -0.5], n)
    return a, b, c


@pytest.mark.parametrize("kind", ["normal", "cancelling", "ties"])
def test_fma_f64_is_libm_fma(kind):
    a, b, c = f64_triples(kind, 20_000, seed=7)
    got = fma_f64(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, libm_fma(a, b, c))
