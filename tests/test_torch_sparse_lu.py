"""The port's static-pattern sparse LU (``cedarsim_tpu_torch/ops/
sparse_lu.py``, its plain versions on the CPU) against the JAX package's
(``cedarsim_tpu/ops/sparse_lu.py``) on the same inputs, made from numpy
seeds:

- ``build_plan`` on random MNA-like patterns (n in {5, 20, 120}, as
  ``tests/test_sparse_lu.py``) and on the 2- and 6-cell level-1 DFF
  chains' patterns with their probe weights: every field of the
  ``SparsePlan`` equal, array by array.
- The native planner (``native/symbolic.cpp``) against its Python
  fallback, as ``tests/test_sparse.py``.
- ``factor``, ``solve_factored`` and ``solve`` with one refinement pass
  bitwise the JAX functions' (the plain versions sum each destination's
  terms in the order of XLA's serial scatter), and within 1e-10 of
  ``numpy.linalg.solve``; JAX's unrolled plans (n_levels <= 40) and its
  packed ``fori_loop`` bands (above) both.
- A pivot that is exactly zero at the iterate boosted to ±τ and written
  back, as in the JAX factor; the solve finite and accurate.
- Four lanes bitwise four single lanes; the plain factor bitwise a serial
  Python loop over the plan's division and update lists; the int32
  arrays the CUDA kernels S1 and S2 read, walked as the kernels walk them,
  bitwise the plain factor and solve.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedarsim_tpu.ops import sparse_lu as jlu
from cedarsim_tpu_torch.benchmarks import netlists
from cedarsim_tpu_torch.core.sparse_ops import get_sparse_ops
from cedarsim_tpu_torch.ops import sparse as tsparse
from cedarsim_tpu_torch.ops import sparse_lu as tlu

TAU = float(np.sqrt(np.finfo(np.float64).eps))


def _random_circuit_like(n, rng, density=4, with_branches=True):
    """The MNA-like matrix of ``tests/test_sparse_lu.py``: a diagonally
    weighted conductance block and a few voltage-source branch rows with a
    hard zero diagonal."""
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] += 2.0 + rng.random()
        for _ in range(density):
            j = int(rng.integers(0, n))
            if j != i:
                v = -rng.random()
                A[i, j] += v
                A[j, i] += v * (0.5 + rng.random())
    if with_branches and n >= 8:
        for b in range(3):
            i, j = n - 1 - 2 * b, int(rng.integers(0, n // 2))
            A[i, j] += 1.0
            A[j, i] += 1.0
        for b in range(3):
            A[n - 1 - 2 * b, n - 1 - 2 * b] = 0.0
    rr, cc = np.nonzero(A)
    return A, rr.astype(np.int32), cc.astype(np.int32)


def _same_plan(tp, jp):
    for f in ("n", "nnz", "nnz_f", "n_levels"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("in_pos", "in_rows", "in_cols", "rperm", "cperm", "diag_pos",
              "a_diag_pos", "pos_arow", "pos_acol"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
    for f in ("div_dst", "div_piv", "upd_dst", "upd_l", "upd_u", "f_lev",
              "b_lev", "fact_runs", "fwd_runs", "bwd_runs"):
        a, b = getattr(tp, f), getattr(jp, f)
        assert len(a) == len(b), f
        for u, w in zip(a, b):
            if isinstance(u, tuple):
                assert len(u) == len(w)
                for uu, ww in zip(u, w):
                    np.testing.assert_array_equal(uu, ww, f)
            else:
                np.testing.assert_array_equal(u, w, f)


def _plans(n, seed=None):
    rng = np.random.default_rng(42 + n if seed is None else seed)
    A, rows, cols = _random_circuit_like(n, rng, with_branches=n >= 8)
    w = A[rows, cols]
    return (A, rng, tlu.build_plan(n, rows, cols, weights=w),
            jlu.build_plan(n, rows, cols, weights=w))


def _bitwise(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.int64),
                                                 b.view(np.int64))


@pytest.mark.parametrize("n", [5, 20, 120])
def test_build_plan_equals_the_jax_plan(n):
    _, _, tp, jp = _plans(n)
    _same_plan(tp, jp)


@pytest.mark.parametrize("cells", [2, 6])
def test_build_plan_on_the_chain_pattern(cells):
    """The chain's structural pattern and probe weights (the port's
    ``SparseOps``) through both planners."""
    comp = netlists.chain(cells, sparse=True, device="cpu")
    rows, cols, w = _pattern(comp, get_sparse_ops(comp))
    _same_plan(tlu.build_plan(comp.n_x, rows, cols, weights=w),
               jlu.build_plan(comp.n_x, rows, cols, weights=w))


def _pattern(comp, sops):
    """The (rows, cols) pattern ``SparseOps`` plans on, with its weights."""
    n = comp.n_x
    nv = comp.n_nodes + comp.n_internal
    rows, cols = [], []
    for key in comp.group_order:
        g = comp.groups[key]
        r = np.broadcast_to(g.row_idx[:, :, None],
                            g.row_idx.shape + (g.var_idx.shape[1],))
        rows.append(r.ravel())
        cols.append(np.broadcast_to(g.var_idx[:, None, :], r.shape).ravel())
    rows = np.concatenate(rows + [np.arange(nv)])
    cols = np.concatenate(cols + [np.arange(nv)])
    keep = (rows < n) & (cols < n)
    return rows[keep], cols[keep], sops.probe_weights


def test_native_planner_matches_its_fallback():
    from cedarsim_tpu_torch.native import get_lib
    with open(os.path.join(netlists.DFF_DIR, "dff_tb.cir")) as f:
        text = f.read()
    import cedarsim_tpu_torch as T
    comp = T.compile_circuit(T.elaborate(T.parse_spice(text),
                                         include_paths=[netlists.DFF_DIR]),
                             device="cpu")
    assert get_lib() is not None, "g++ expected in this image"
    rows, cols = tsparse.jacobian_sparsity(comp)
    n = comp.n_x
    indptr, indices = tsparse._to_csr(n, rows, cols)
    for perm in (np.arange(n, dtype=np.int32),
                 tsparse.md_order(n, rows, cols)):
        assert sorted(perm.tolist()) == list(range(n))
        assert tsparse.symbolic_fill(n, rows, cols, perm) == \
            tsparse._symbolic_fill_py(n, indptr, indices, perm)
    p = tsparse.plan(comp)
    assert p["native"] and p["lnnz"] <= p["lnnz_natural"]


@pytest.mark.parametrize("n", [5, 20, 120])
def test_factor_and_solve_match_jax(n):
    A, rng, tp, jp = _plans(n)
    b = rng.standard_normal(n)
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    tv, jv = tlu.vals_from_dense(tp, At), jlu.vals_from_dense(jp, Aj)
    assert _bitwise(tv, jv)
    tf, jf = tlu.factor(tp, tv, TAU), jlu.factor(jp, jv, TAU)
    assert _bitwise(tf, jf)
    bt, bj = torch.as_tensor(b), jnp.asarray(b)
    assert _bitwise(tlu.solve_factored(tp, tf, bt),
                    jlu.solve_factored(jp, jf, bj))
    xt = tlu.solve(tp, tv, bt, refine=1, matvec=lambda x: tlu.matvec(tp, tv, x),
                   boost=TAU)
    xj = jlu.solve(jp, jv, bj, refine=1, matvec=lambda x: jlu.matvec(jp, jv, x),
                   boost=TAU)
    assert _bitwise(xt, xj)
    ref = np.linalg.solve(A, b)
    assert np.abs(xt.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
    assert (tp.n_levels > jlu.UNROLL_LEVELS) == bool(jp.fact_runs)


def test_zero_pivot_is_boosted():
    """A matched pivot that is exactly zero at the iterate: boosted to ±τ
    and written back, bitwise as in the JAX factor; the refined solve
    finite and within 1e-7 of numpy's (``tests/test_sparse_lu.py``)."""
    n = 12
    rng = np.random.default_rng(7)
    A, rows, cols = _random_circuit_like(n, rng, with_branches=False)
    tp = tlu.build_plan(n, rows, cols, weights=np.abs(A[rows, cols]))
    jp = jlu.build_plan(n, rows, cols, weights=np.abs(A[rows, cols]))
    # the first pivot of the elimination sees no update: zero it
    A2 = A.copy()
    A2[tp.rperm[0], tp.cperm[0]] = 0.0
    tau = TAU * np.abs(A2).max()
    tv = tlu.vals_from_dense(tp, torch.as_tensor(A2))
    tf = tlu.factor(tp, tv, tau)
    assert _bitwise(tf, jlu.factor(jp, jlu.vals_from_dense(
        jp, jnp.asarray(A2)), tau))
    assert float(tf[int(tp.diag_pos[0])]) == tau
    b = rng.standard_normal(n)
    A2t = torch.as_tensor(A2)
    x = tlu.solve(tp, tv, torch.as_tensor(b), refine=3,
                  matvec=lambda v: A2t @ v, boost=tau)
    assert torch.isfinite(x).all()
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A2, b),
                               rtol=1e-7, atol=1e-10)


def test_lanes_equal_single_lanes():
    n = 60
    A, rng, tp, _ = _plans(n, seed=7)
    mats = np.stack([A * (1.0 + 0.1 * k) for k in range(4)])
    mats[:, 0, 0] += np.linspace(0.0, 0.5, 4)
    bs = rng.standard_normal((4, n))
    v = tlu.vals_from_dense(tp, torch.as_tensor(mats))
    f = tlu.factor(tp, v, TAU)
    x = tlu.solve_factored(tp, f, torch.as_tensor(bs))
    for k in range(4):
        fk = tlu.factor(tp, v[k], TAU)
        assert _bitwise(f[k], fk)
        assert _bitwise(x[k], tlu.solve_factored(tp, fk,
                                                 torch.as_tensor(bs[k])))
        ref = np.linalg.solve(mats[k], bs[k])
        assert np.abs(x[k].numpy() - ref).max() <= 1e-10 * np.abs(ref).max()


def test_plain_order_is_a_serial_scatter():
    """The plain factor is bitwise a serial Python loop over each level's
    division and update lists in the plan's order (the order of a serial
    scatter-add), with the pivots boosted as it reads them."""
    n = 120
    A, _, tp, _ = _plans(n)
    v0 = tlu.vals_from_dense(tp, torch.as_tensor(A)).numpy()
    tau = 0.3                  # boosts several pivots
    v = [float(a) for a in v0]

    def boosted(p):
        return (-tau if p < 0 else tau) if abs(p) < tau else p
    for lv in range(tp.n_levels):
        for d, p in zip(tp.div_dst[lv], tp.div_piv[lv]):
            v[d] = v[d] / boosted(v[p])
        for p in set(tp.div_piv[lv].tolist()):
            v[p] = boosted(v[p])
        for d, lo, up in zip(tp.upd_dst[lv], tp.upd_l[lv], tp.upd_u[lv]):
            v[d] = v[d] - v[lo] * v[up]
    for p in tp.diag_pos:
        v[p] = boosted(v[p])
    assert _bitwise(tlu.factor_plain(tp, torch.as_tensor(v0), tau),
                    np.asarray(v))
    assert max(len(np.unique(d)) < len(d) for d in tp.upd_dst if len(d))


def _schedule_case(case):
    """A plan and its float64 values: the seeded MNA-like plans (n 5, 20,
    120) with their matrices, and the 2- and 6-cell level-1 chains' plans
    with seeded values on a dominant diagonal."""
    kind, size = case
    rng = np.random.default_rng(3 + size)
    if kind == "seeded":
        A, rng, tp, _ = _plans(size)
        return tp, tlu.vals_from_dense(tp, torch.as_tensor(A)).numpy(), rng
    tp = get_sparse_ops(netlists.chain(size, device="cpu")).plan
    v = rng.uniform(-1.0, 1.0, tp.nnz_f)
    v[tp.diag_pos] = rng.choice([-1.0, 1.0], tp.n) * rng.uniform(
        0.2, 4.0, tp.n)
    return tp, v, rng


def _dealt(lo, hi, threads):
    """Items lo..hi-1 of a level as the kernel's threads take them: thread
    t the items lo + t, lo + t + threads, ..."""
    return [i for t in range(threads) for i in range(lo + t, hi, threads)]


@pytest.mark.parametrize("case", [("seeded", 5), ("seeded", 20),
                                  ("seeded", 120), ("chain", 2),
                                  ("chain", 6)])
def test_kernel_schedule_replays_the_plain_order(case):
    """The int32 arrays S1 and S2 read (``build_schedule``), walked as the
    kernels walk them, give bitwise the plain factor and solve: the host
    half of the CUDA kernels, which run only on a card.  Per level: the
    divisions; the pivots written back and every product formed into a
    scratch at its term index minus ``lev_term`` (``fw_lev_term``,
    ``bw_lev_term``); then each destination, dealt round-robin to the
    kernel's threads longest first, minus its products in list order.  The
    dealing balances by term count: the busiest thread walks at most the
    level's longest destination plus its terms over the threads."""
    tp, v0, rng = _schedule_case(case)
    k = tlu.build_schedule(tp)[0]
    T = tlu.THREADS
    n = tp.n
    tau = 0.3
    v = [float(a) for a in v0]

    def boosted(p):
        return (-tau if p < 0 else tau) if abs(p) < tau else p

    def dealt_longest_first(off_name, term_off, lev_term, lv):
        lo, hi = k[off_name][lv], k[off_name][lv + 1]
        cnt = np.diff(term_off[lo:hi + 1])
        assert (np.diff(cnt) <= 0).all()            # longest first
        assert term_off[lo] == lev_term[lv] and term_off[hi] == lev_term[
            lv + 1]
        busiest = max((cnt[t::T].sum() for t in range(min(T, len(cnt)))),
                      default=0)
        assert busiest <= cnt.max(initial=0) + -(-cnt.sum() // T)
        return _dealt(lo, hi, T)

    for lv in range(tp.n_levels):
        for t in _dealt(k["div_off"][lv], k["div_off"][lv + 1], T):
            v[k["div_dst"][t]] /= boosted(v[k["div_piv"][t]])
        for t in _dealt(k["piv_off"][lv], k["piv_off"][lv + 1], T):
            v[k["piv"][t]] = boosted(v[k["piv"][t]])
        k0 = k["lev_term"][lv]
        prod = {j - k0: v[k["term_l"][j]] * v[k["term_u"][j]]
                for j in _dealt(k0, k["lev_term"][lv + 1], T)}
        for t in dealt_longest_first("dst_off", k["term_off"],
                                     k["lev_term"], lv):
            acc = v[k["dst"][t]]
            for j in range(k["term_off"][t], k["term_off"][t + 1]):
                acc = acc - prod[j - k0]
            v[k["dst"][t]] = acc
    for p in k["diag"]:
        v[p] = boosted(v[p])
    f = tlu.factor_plain(tp, torch.as_tensor(v0), tau)
    assert _bitwise(f, np.asarray(v))
    b = rng.standard_normal(n)
    y = [float(b[r]) for r in k["rperm"]]
    for lv in range(len(tp.f_lev)):
        k0 = k["fw_lev_term"][lv]
        prod = {j - k0: v[k["fw_pos"][j]] * y[k["fw_col"][j]]
                for j in _dealt(k0, k["fw_lev_term"][lv + 1], T)}
        for t in dealt_longest_first("fw_off", k["fw_term_off"],
                                     k["fw_lev_term"], lv):
            acc = y[k["fw_row"][t]]
            for j in range(k["fw_term_off"][t], k["fw_term_off"][t + 1]):
                acc = acc - prod[j - k0]
            y[k["fw_row"][t]] = acc
    for lv in range(len(tp.b_lev)):
        k0 = k["bw_lev_term"][lv]
        prod = {j - k0: v[k["bw_pos"][j]] * y[k["bw_col"][j]]
                for j in _dealt(k0, k["bw_lev_term"][lv + 1], T)}
        for t in dealt_longest_first("bw_off", k["bw_term_off"],
                                     k["bw_lev_term"], lv):
            acc = 0.0
            for j in range(k["bw_term_off"][t], k["bw_term_off"][t + 1]):
                acc = acc + prod[j - k0]
            r = k["bw_row"][t]
            y[r] = (y[r] - acc) / v[k["bw_diag"][t]]
    x = np.empty(n)
    x[k["cperm"]] = y
    assert _bitwise(tlu.solve_factored_plain(tp, f, torch.as_tensor(b)), x)
    wf, ws = tlu.widths(k)
    assert wf == max(len(d) for d in tp.upd_dst) and ws == max(
        [len(r) for r, _, _ in tp.f_lev] + [len(r) for r, *_ in tp.b_lev])
