"""The port's sparse Newton path on circuits (``core/sparse_ops.py``,
``compile_circuit(sparse=)``, the sparse branches of ``analysis/dc.py``
and ``analysis/tran.py``) against the JAX package's on the CPU, at small
sizes (the 2- and 6-cell level-1 DFF chains):

- ``SparseOps``: the plan field by field, ``group_pos`` and ``vdiag_pos``
  equal, the probe weights within 1e-12 relative; a plan built from a
  circuit compiled elsewhere equals it (the probe runs on the CPU).
- ``res_jacs_sparse`` (S, Q, Gv, Cv) within 1e-12 of each array's largest
  entry.
- ``solve_dc(mode="tranop")`` on the 6-cell chain, sparse against the JAX
  package's sparse solve and against the port's dense path: 1e-10 V.
- A ``.ic`` pin on the sparse path (``mask_rows``/``add_a_diag``) against
  the JAX package: 1e-10 V.
- ``resolve_impl`` on a sparse circuit: "jax"/"xla" at any lane count,
  ``newton_impl="fused"`` raises the JAX package's error; ``jac_reuse=4``
  is the per-step chord there.
- ``sparse=`` carried through ``ensure_dynamic`` and ``dc_sweep``, and
  ``simulate`` on a chain above the threshold (24 cells, 276 unknowns)
  sparse.
- A 4-lane transient with a per-lane W scale, lane for lane bitwise four
  single-lane runs.
- AC on a sparse circuit: dense, as in the JAX package, about the sparse
  DC's operating point.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.core.sparse_ops import get_sparse_ops as j_sops
from cedarsim_tpu_torch.analysis.tran import resolve_impl
from cedarsim_tpu_torch.benchmarks import netlists
from cedarsim_tpu_torch.core.sparse_ops import get_sparse_ops
from cedarsim_tpu_torch.core.compile import ensure_dynamic, use_sparse_solver

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "gf180_dff"))

GMIN = 1e-15


def _chains(cells):
    from chain import build
    return (netlists.chain(cells, sparse=True, device="cpu"),
            build(cells, sparse=True))


@pytest.mark.parametrize("cells", [2, 6])
def test_sparse_ops_match_jax(cells):
    tc, jc = _chains(cells)
    ts, js = get_sparse_ops(tc), j_sops(jc)
    w_t, w_j = ts.probe_weights, np.asarray(js.probe_weights)
    assert np.abs(w_t - w_j).max() <= 1e-12 * np.abs(w_j).max()
    assert np.all(np.abs(w_t - w_j) <= 1e-12 * np.abs(w_j))
    for f in ("in_pos", "rperm", "cperm", "diag_pos", "a_diag_pos",
              "pos_arow", "pos_acol"):
        np.testing.assert_array_equal(getattr(ts.plan, f),
                                      getattr(js.plan, f))
    assert (ts.plan.nnz_f, ts.plan.n_levels) == (js.plan.nnz_f,
                                                 js.plan.n_levels)
    assert list(ts.group_pos) == list(js.group_pos)
    for key in ts.group_pos:
        np.testing.assert_array_equal(ts.group_pos[key], js.group_pos[key])
    np.testing.assert_array_equal(ts.vdiag_pos, js.vdiag_pos)
    assert use_sparse_solver(tc) and tc.sparse_mode is True


def test_res_jacs_sparse_match_jax():
    tc, jc = _chains(2)
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 5.0, tc.n_x)
    ctx_t = T.SimSpec.make(gmin=GMIN).with_mode("tranop")
    ctx_j = J.SimSpec.make(gmin=GMIN).with_mode("tranop")
    got = get_sparse_ops(tc).res_jacs_sparse(torch.as_tensor(x), ctx_t)
    want = jax.jit(lambda v: j_sops(jc).res_jacs_sparse(v, ctx_j))(x)
    for name, a, b in zip("S Q Gv Cv".split(), got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max(), name


def test_chain_dc_sparse_matches_jax_and_dense():
    from chain import build
    tc = netlists.chain(6, sparse=True, device="cpu")
    td = netlists.chain(6, sparse=False, device="cpu")
    assert use_sparse_solver(tc) and not use_sparse_solver(td)
    xs = {}
    for name, c in (("sparse", tc), ("dense", td)):
        r = T.solve_dc(c, ctx=T.SimSpec.make(gmin=GMIN), mode="tranop")
        assert bool(r.converged)
        xs[name] = r.x.numpy()
    rj = J.solve_dc(build(6, sparse=True), ctx=J.SimSpec.make(gmin=GMIN),
                    mode="tranop")
    assert bool(rj.converged)
    assert np.abs(xs["sparse"] - np.asarray(rj.x)).max() < 1e-10
    assert np.abs(xs["sparse"] - xs["dense"]).max() < 1e-10


IC_DECK = """* ic on the sparse path
V1 in 0 PULSE(0 1 1n 1n 1n 5n 10n)
R1 in a 1k
C1 a 0 1p
R2 a b 2k
C2 b 0 2p
D1 b 0 dmod
.model dmod d (is=1e-14)
.ic v(a)=0.3 v(b)=0.2
.end
"""


def test_ic_rows_on_the_sparse_path_match_jax():
    tc = T.compile_circuit(T.elaborate(T.parse_spice(IC_DECK)), sparse=True,
                           device="cpu")
    jc = J.compile_circuit(J.elaborate(J.parse_spice(IC_DECK)), sparse=True)
    rt = T.solve_dc(tc, mode="tranop")
    rj = J.solve_dc(jc, mode="tranop")
    assert bool(rt.converged) and bool(rj.converged)
    assert abs(float(rt["a"]) - 0.3) < 1e-12
    assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() < 1e-10
    # the pinned rows: a value vector whose .ic rows hold only the pin
    sops = get_sparse_ops(tc)
    mask = torch.zeros(tc.n_x, dtype=torch.float64)
    mask[tc.node_names.index("a")] = 1.0
    v = torch.ones(sops.nnz_f, dtype=torch.float64)
    Jm = sops.add_a_diag(sops.mask_rows(v, 1.0 - mask), mask)
    row = torch.as_tensor(sops.plan.pos_arow) == tc.node_names.index("a")
    assert float(Jm[row].sum()) == 1.0


def test_resolve_impl_on_a_sparse_circuit():
    tc = netlists.chain(2, sparse=True, device="cpu")
    for opts in (T.TranOptions(), T.TranOptions(dense_lu="mixed"),
                 T.TranOptions(formulation="cap", jac_reuse=1)):
        for batched in (False, True):
            r = resolve_impl(tc, opts, T.SimSpec.make(), batched=batched)
            assert (r.dense_lu, r.newton_impl) == ("jax", "xla")
    with pytest.raises(ValueError, match="dense-path only"):
        resolve_impl(tc, T.TranOptions(newton_impl="fused",
                                       formulation="cap", jac_reuse=1))
    with pytest.raises(ValueError, match="dense-path only"):
        T.tran(tc, (0.0, 1e-9), opts=T.TranOptions(
            newton_impl="fused", formulation="cap", jac_reuse=1))
    # jac_reuse >= 2: no cross-step cache on the sparse path
    sol = T.tran(tc, (0.0, 2e-9), ctx=T.SimSpec.make(gmin=GMIN),
                 opts=T.TranOptions(jac_reuse=4))
    one = T.tran(tc, (0.0, 2e-9), ctx=T.SimSpec.make(gmin=GMIN),
                 opts=T.TranOptions(jac_reuse=1))
    assert sol.converged and np.array_equal(sol.xs, one.xs)


def test_sparse_mode_through_sweeps_and_simulate():
    tc = netlists.chain(2, sparse=True, device="cpu")
    var = ensure_dynamic(tc, ["vvdd.dc"])
    assert var is not tc and var.sparse_mode is True
    sw = T.Sweep("vvdd.dc", [4.5, 5.0])
    rs = T.dc_sweep(tc, sw, ctx=T.SimSpec.make(gmin=GMIN))
    rd = T.dc_sweep(netlists.chain(2, sparse=False, device="cpu"), sw,
                    ctx=T.SimSpec.make(gmin=GMIN))
    assert bool(rs.converged.all())
    assert float((rs.x - rd.x).abs().max()) < 1e-10
    text = netlists.chain_netlist(24).replace(".tran 1n 2e-07", ".op")
    out = T.simulate(text, include_paths=[netlists.DFF_DIR], device="cpu")
    comp = out["compiled"]
    assert comp.n_x == 276 and use_sparse_solver(comp)
    assert "_sparse_ops" in comp.__dict__
    dense = T.compile_circuit(comp.circuit, sparse=False, device="cpu")
    rd = T.solve_dc(dense)
    assert bool(out["op"].converged)
    assert float((out["op"].x - rd.x).abs().max()) < 1e-10


def test_lanes_equal_single_runs():
    """Four lanes with W scaled per lane through one sparse transient, each
    bitwise the same lane run alone."""
    tc = netlists.chain(2, sparse=True, device="cpu", dynamic_params=["w"])
    scale = torch.tensor([0.97, 0.99, 1.0, 1.03], dtype=torch.float64)
    lanes = []
    for k in range(4):
        p = {key: dict(g) for key, g in tc.params0.items()}
        for key, g in p.items():
            if "w" in g:
                g["w"] = g["w"] * scale[k]
        lanes.append(p)
    pb = {key: {pn: torch.stack([lp[key][pn] for lp in lanes])
                for pn in tc.params0[key]} for key in tc.params0}
    ctx = T.SimSpec.make(gmin=GMIN)
    opts = T.TranOptions(jac_reuse=1)
    # the CPU run is dispatch-bound: no autograd bookkeeping (the same bits)
    with torch.inference_mode():
        sols = T.tran(tc, (0.0, 2.2e-8), params=pb, ctx=ctx, opts=opts)
        ones = [T.tran(tc, (0.0, 2.2e-8), params=p, ctx=ctx, opts=opts)
                for p in lanes]
    for sol, one in zip(sols, ones):
        assert sol.converged and one.converged
        assert (sol.n_accepted, sol.n_rejected, sol.n_newton) == \
            (one.n_accepted, one.n_rejected, one.n_newton)
        assert np.array_equal(sol.ts, one.ts)
        assert np.array_equal(sol.xs, one.xs)
    assert not np.array_equal(sols[0].xs[-1], sols[3].xs[-1])


def test_ac_on_a_sparse_circuit():
    """AC stays dense on a sparse circuit, as in the JAX package
    (``cedarsim_tpu/analysis/ac.py`` solves with ``ops/linalg.py``); its
    operating point comes through the sparse DC: the same spectrum as the
    dense compile's to 1e-10 of its largest entry."""
    text = netlists.chain_netlist(2).replace("VVDD VDD 0 5.0",
                                             "VVDD VDD 0 5.0 AC 1")
    freqs = [1e3, 1e6, 1e9]
    out = {}
    for sp in (True, False):
        c = T.compile_circuit(T.elaborate(T.parse_spice(text),
                                          include_paths=[netlists.DFF_DIR]),
                              sparse=sp, device="cpu")
        assert use_sparse_solver(c) == sp
        out[sp] = np.asarray(T.ac(c, freqs,
                                  ctx=T.SimSpec.make(gmin=GMIN))["d2"])
    ref = np.abs(out[False]).max()
    assert ref > 0 and np.isfinite(out[True]).all()
    assert np.abs(out[True] - out[False]).max() <= 1e-10 * ref
