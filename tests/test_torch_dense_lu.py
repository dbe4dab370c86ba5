"""The port's dense batched solves against the JAX package's Pallas kernels
(interpret mode on the CPU), and the port's dense-LU bench at a small size.

- ``gesp_lu.lu_solve_gesp_f32_plain`` (the plain version of B4's CUDA
  kernel) against ``lu_solve_batched_sublane_f32(..., interpret=True)``,
  and ``pivot_lu.lu_solve_pivot_f32_plain`` (B5's) against
  ``lu_solve_batched_f32(..., interpret=True)``: 1e-5 relative (float32,
  another reduction order than Pallas's masked sums).  Cases: random
  systems at (B, n) in {(1, 25), (16, 25), (37, 11), (4, 32), (3, 33),
  (2, 64)}; B4 with a zero and a tiny negative pivot (boosted to
  ±1e-20); B5 with a pivot-forcing tiny corner, with two rows of equal
  magnitude in a column (the first wins) and with an exactly zero pivot;
  both on a column of NaNs.  Both plain versions substitute backwards in
  column order (``gesp_lu.back_substitute``), as their kernels do.
- ``cedarsim_tpu_torch.benchmarks.lu_bench`` on the CPU at shapes
  [(8, 11), (4, 20)], chain 2: every gate passes, the last line is under
  500 bytes, and no file is written; its systems equal those of
  ``benchmarks/pallas_lu_bench.py``'s generator, run from that file's own
  source without running its ``main``.
"""

import ast
import importlib.util
import inspect
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedarsim_tpu.ops.pallas_lu import (lu_solve_batched_f32,
                                        lu_solve_batched_sublane_f32)
from cedarsim_tpu_torch.benchmarks import lu_bench
from cedarsim_tpu_torch.ops import gesp_lu, pivot_lu

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _dominant(seed, B, n):
    """Diagonally dominant float32 systems (no pivoting needed)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)) + (n + 8) * np.eye(n)
    return A.astype(np.float32), rng.standard_normal((B, n)).astype(
        np.float32)


def _permuted(seed, B, n):
    """Dominant systems with their rows shuffled per system, so that
    partial pivoting swaps rows at almost every step."""
    A, b = _dominant(seed, B, n)
    rng = np.random.default_rng(seed + 1)
    for i in range(B):
        A[i] = A[i][rng.permutation(n)]
    return A, b


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _gesp(A, b):
    x_j = np.asarray(lu_solve_batched_sublane_f32(
        jnp.asarray(A), jnp.asarray(b), interpret=True))
    x_t = gesp_lu.lu_solve_gesp_f32(torch.from_numpy(A),
                                    torch.from_numpy(b)).numpy()
    return x_t, x_j


def _pivot(A, b):
    x_j = np.asarray(lu_solve_batched_f32(jnp.asarray(A), jnp.asarray(b),
                                          interpret=True))
    x_t = pivot_lu.lu_solve_pivot_f32(torch.from_numpy(A),
                                      torch.from_numpy(b)).numpy()
    return x_t, x_j


@pytest.mark.parametrize("kernel", ["gesp", "pivot"])
@pytest.mark.parametrize("B, n", [(1, 25), (16, 25), (37, 11), (4, 32),
                                  (3, 33), (2, 64)])
def test_plain_solve_matches_pallas(kernel, B, n):
    if kernel == "gesp":
        x_t, x_j = _gesp(*_dominant(10 * n + B, B, n))
    else:
        x_t, x_j = _pivot(*_permuted(10 * n + B, B, n))
    assert x_t.dtype == np.float32 and x_t.shape == (B, n)
    assert _rel(x_t, x_j) <= 1e-5


@pytest.mark.parametrize("pivot", [0.0, -1e-25])
def test_gesp_solve_boosts_the_pivot(pivot):
    """A zero pivot boosts to +1e-20 and a tiny negative one to -1e-20,
    both for the multipliers (0 / boost, where the unboosted 0 / 0 would
    be NaN) and again in the back substitution: x_2 = (b_2 - x_4) / boost.
    Column 2 is zero but for the pivot, so x_2 enters no other row and
    the rest of x stays well conditioned."""
    A, b = _dominant(7, 3, 6)
    A[:, :, 2] = 0.0
    A[:, 2, :] = 0.0
    A[:, 2, 2] = pivot
    A[:, 2, 4] = 1.0          # keep the row nonzero off the diagonal
    x_t, x_j = _gesp(A, b)
    assert np.isfinite(x_t).all() and np.isfinite(x_j).all()
    assert _rel(x_t, x_j) <= 1e-5
    boosted = np.float32(1e-20 if pivot == 0.0 else -1e-20)
    np.testing.assert_allclose(x_t[:, 2], (b[:, 2] - x_t[:, 4]) / boosted,
                               rtol=1e-6)


def test_pivot_solve_swaps_a_tiny_corner():
    """``A[:, 0, 0] = 1e-8`` forces a swap at step 0 (as
    tests/test_pallas_lu.py does)."""
    A, b = _dominant(3, 4, 9)
    A[:, 0, 0] = 1e-8
    x_t, x_j = _pivot(A, b)
    assert _rel(x_t, x_j) <= 1e-5
    ref = np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0]
    assert _rel(x_t, ref) <= 1e-5


def test_pivot_solve_ties_go_to_the_first_row():
    """Rows 0 and 2 have equal |A[i, 0]|: the first (row 0) is the pivot,
    so no row is swapped anywhere and the solve is bitwise the no-pivot
    solve (the same operations in the same order); the Pallas kernel
    agrees."""
    A, b = _dominant(5, 4, 8)
    A[:, 2, 0] = -A[:, 0, 0]
    x_t, x_j = _pivot(A, b)
    assert _rel(x_t, x_j) <= 1e-5
    x_g = gesp_lu.lu_solve_gesp_f32_plain(torch.from_numpy(A),
                                          torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(x_t, x_g)
    # the other order of the two rows pivots on the other one: not the
    # same bits (the tie rule is what the check above rests on)
    A2, b2 = A.copy(), b.copy()
    A2[:, [0, 2]], b2[:, [0, 2]] = A[:, [2, 0]], b[:, [2, 0]]
    x2 = pivot_lu.lu_solve_pivot_f32(torch.from_numpy(A2),
                                     torch.from_numpy(b2)).numpy()
    assert _rel(x2, x_t) <= 1e-5 and not np.array_equal(x2, x_t)


def test_pivot_solve_zero_pivot_is_not_finite():
    """An exactly singular system: the multipliers divide by the 1e-30
    boost, back substitution by the stored zero, so x is not finite, as
    in the Pallas kernel."""
    A, b = _dominant(9, 2, 5)
    A[:, :, 3] = 0.0
    x_t, x_j = _pivot(A, b)
    assert not np.isfinite(x_j).all()
    assert (np.isfinite(x_t) == np.isfinite(x_j)).all()


@pytest.mark.parametrize("kernel", ["gesp", "pivot"])
def test_solve_nan_column_is_not_finite_where_pallas_is_not(kernel):
    """A column of NaNs: the pivoting solve never takes a NaN magnitude
    for the largest (it keeps row k), and both solves are non-finite in
    the entries where the Pallas kernels are (here all of them)."""
    A, b = _dominant(11, 3, 7)
    A[:, :, 3] = np.nan
    x_t, x_j = (_gesp if kernel == "gesp" else _pivot)(A, b)
    assert not np.isfinite(x_j).any()
    assert (np.isfinite(x_t) == np.isfinite(x_j)).all()


def test_back_substitution_in_column_order():
    """The dense solves' back substitution (column order) against numpy's
    float64 triangular solve, and its two divisor rules."""
    rng = np.random.default_rng(4)
    U = np.triu(rng.standard_normal((5, 9, 9))) + 12 * np.eye(9)
    y = rng.standard_normal((5, 9))
    x = gesp_lu.back_substitute(torch.from_numpy(U), torch.from_numpy(y))
    ref = np.linalg.solve(U, y[..., None])[..., 0]
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-12, atol=0)
    x2 = gesp_lu.back_substitute(torch.from_numpy(U), torch.from_numpy(y),
                                 lambda d: 2 * d)
    assert not np.allclose(x2.numpy(), ref)


def test_ablation_cuts_match_the_kernel_source():
    """Each cut of ``benchmarks/dense_ablation.py`` (the dense solves' time
    by part, on the card) finds its text once in ``csrc/
    dense_solve.cuh``."""
    from cedarsim_tpu_torch.benchmarks import dense_ablation
    from cedarsim_tpu_torch.ops import cuda_lib
    with open(os.path.join(cuda_lib.CSRC, "dense_solve.cuh")) as f:
        header = f.read()
    for cuts in dense_ablation.CUTS.values():
        for old, _ in cuts:
            assert header.count(old) == 1, old


def test_wrappers_check_shapes():
    with pytest.raises(ValueError):
        gesp_lu.lu_solve_gesp_f32(torch.zeros(2, 3, 4), torch.zeros(2, 3))
    with pytest.raises(ValueError):
        pivot_lu.lu_solve_pivot_f32(torch.zeros(2, 3, 3), torch.zeros(2, 4))


# ------------------------------------------------------------------ bench

def _jax_bench_generator():
    """The statements of ``pallas_lu_bench.py``'s ``main`` that make A and
    b for one shape, taken from its source (the file is loaded by path and
    its ``main`` is not run)."""
    path = os.path.join(REPO, "benchmarks", "pallas_lu_bench.py")
    spec = importlib.util.spec_from_file_location("_pallas_lu_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn = ast.parse(inspect.getsource(mod.main)).body[0]
    loop = next(s for s in fn.body if isinstance(s, ast.For))
    body, keep = [], False
    for stmt in loop.body:
        src = ast.unparse(stmt)
        keep = keep or src.startswith("rng = ")
        if keep:
            body.append(stmt)
        if src.startswith("b = "):
            break
    code = compile(ast.Module(body=body, type_ignores=[]), path, "exec")

    def make(B, n):
        ns = {"np": np, "B": B, "n": n}
        exec(code, ns)
        return ns["A"], ns["b"]
    return make


@pytest.mark.parametrize("B, n", [(8, 11), (4, 20), (512, 25)])
def test_bench_systems_equal_the_jax_benchs(B, n):
    A_j, b_j = _jax_bench_generator()(B, n)
    A_t, b_t = lu_bench.make_systems(B, n)
    np.testing.assert_array_equal(A_t, A_j)
    np.testing.assert_array_equal(b_t, b_j)


def test_bench_gates_pass_at_small_size(capsys):
    jax_json = os.path.join(REPO, "benchmarks", "pallas_lu_bench.json")
    with open(jax_json, "rb") as f:
        before = f.read()
    rows = lu_bench.main(["--device", "cpu", "--shapes", "8x11,4x20",
                          "--chain", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [(r["B"], r["n"]) for r in rows] == [(8, 11)] * 4 + [(4, 20)] * 4
    assert [r["variant"] for r in rows[:4]] == [
        "torch_f64", "torch_f32", "cell", "sublane"]
    assert [r["jax_variant"] for r in rows[:4]] == [
        "jax_f64", "jax_f32", "pallas_cell", "pallas_sublane"]
    for r in rows:
        assert r["ok"], r
        assert r["device"] == "cpu"
    assert len(lines) == 9 and len(lines[-1].encode()) < 500
    last = json.loads(lines[-1])
    assert last["ok"] and last["card"] == "cpu" and last["chain"] == 2
    with open(jax_json, "rb") as f:
        assert f.read() == before
