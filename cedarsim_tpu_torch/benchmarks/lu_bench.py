"""Batched dense LU solves on the card: the port's counterpart of
``benchmarks/pallas_lu_bench.py``.

    python -m cedarsim_tpu_torch.benchmarks.lu_bench [--device cpu]
        [--shapes 512x25,64x122] [--chain 32] [--out FILE]

It times four ways of solving a batch of small dense systems at the
repo's two circuit shapes (the gf180 DFF's 25 unknowns at 512 lanes, and
the scale-curve chain cell's 122 unknowns at 64 lanes), each row named
after its JAX variant:

* ``torch_f64`` (``jax_f64``): ``ops/linalg.solve`` in float64, i.e.
  ``torch.linalg.solve_ex``;
* ``torch_f32`` (``jax_f32``): the same in float32;
* ``cell`` (``pallas_cell``): the partial-pivoting kernel,
  ``ops/pivot_lu.lu_solve_pivot_f32``;
* ``sublane`` (``pallas_sublane``): the fused GESP kernel,
  ``ops/gesp_lu.lu_solve_gesp_f32``.

The systems are the JAX bench's (``default_rng(0)`` per shape, diagonally
dominant, columns scaled over four decades).  Each variant is gated on one
solve against numpy float64 (relative error 1e-9 for float64, 5e-3 for
float32), then timed as ``--chain`` renormalised solves chained on the
device, after one warm-up chain, over 3 repetitions: CUDA events on the
card, the host clock on the CPU.  One JSON line per row; the last line is
a compact summary (under 500 bytes).  A file is written only where
``--out`` says.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from cedarsim_tpu_torch.config import resolve_device
from cedarsim_tpu_torch.ops import gesp_lu, linalg, pivot_lu

SHAPES = ((512, 25), (64, 122))
CHAIN = 32
REPS = 3

#: (row name, JAX variant, solve, dtype, gate tolerance)
VARIANTS = (
    ("torch_f64", "jax_f64", linalg.solve, torch.float64, 1e-9),
    ("torch_f32", "jax_f32", linalg.solve, torch.float32, 5e-3),
    ("cell", "pallas_cell", pivot_lu.lu_solve_pivot_f32, torch.float32,
     5e-3),
    ("sublane", "pallas_sublane", gesp_lu.lu_solve_gesp_f32, torch.float32,
     5e-3),
)


def make_systems(B, n):
    """The JAX bench's systems (``pallas_lu_bench.py:86-93``): float64 A
    [B, n, n] and b [B, n]."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((B, n, n))
    A += (n + 10) * np.eye(n)
    A *= 10.0 ** rng.uniform(-2, 2, size=(B, 1, n))
    b = rng.standard_normal((B, n))
    return A, b


def chained(solve, A, b, chain):
    """``chain`` solves with A, each of the previous solution scaled to a
    largest magnitude of 1 (``pallas_lu_bench.py:44-49``)."""
    x = b
    for _ in range(chain):
        x = x / torch.clamp(x.abs().max(), min=1e-30)
        x = solve(A, x)
    return x


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, device, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls: CUDA events on the
    card, the host clock on the CPU."""
    if device.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize(device)
        return e0.elapsed_time(e1) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def run_variant(name, jax_name, solve, dtype, tol, A, b, ref, chain,
                device):
    At = torch.as_tensor(A, dtype=dtype, device=device)
    bt = torch.as_tensor(b, dtype=dtype, device=device)
    x1 = solve(At, bt).double().cpu().numpy()
    rel = float(np.abs(x1 - ref).max() / np.abs(ref).max())
    _sync(device)
    t0 = time.perf_counter()
    chained(solve, At, bt, chain)
    _sync(device)
    cold = time.perf_counter() - t0
    ms = _time_ms(lambda: chained(solve, At, bt, chain), device, REPS)
    B, n = b.shape
    return dict(variant=name, jax_variant=jax_name, B=B, n=n,
                device=str(device), rel_err=rel, tol=tol,
                ok=bool(rel < tol), cold_s=cold, ms_per_chain=ms,
                us_per_solve=ms * 1e3 / chain / B,
                solves_per_s=B * chain / (ms * 1e-3))


def card_label(device):
    """The card's name and power limit as nvidia-smi gives them (the
    device's name alone where nvidia-smi is missing); "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
    except OSError:
        return torch.cuda.get_device_name(device)
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else \
        torch.cuda.get_device_name(device)


def parse_shapes(text):
    return tuple(tuple(int(v) for v in s.split("x"))
                 for s in text.split(","))


def main(argv=None):
    """Run the bench; prints its lines and returns the rows."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--shapes", type=parse_shapes, default=SHAPES,
                    help="BxN,... (default 512x25,64x122)")
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--out", default=None,
                    help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = []
    for B, n in args.shapes:
        A, b = make_systems(B, n)
        ref = np.linalg.solve(A, b[..., None])[..., 0]
        for variant in VARIANTS:
            row = run_variant(*variant, A, b, ref, args.chain, device)
            rows.append(row)
            print(json.dumps(row), flush=True)
    card = card_label(device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(rows=rows, card=card, chain=args.chain), f,
                      indent=1)
    summary = {"bench": "dense_lu", "card": card,
               "ok": all(r["ok"] for r in rows), "chain": args.chain,
               "us_per_solve": {
                   f"{B}x{n}": {r["variant"]: float(f"{r['us_per_solve']:.5g}")
                                for r in rows if (r["B"], r["n"]) == (B, n)}
                   for B, n in args.shapes}}
    print(json.dumps(summary, separators=(",", ":")), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main()) else 1)
