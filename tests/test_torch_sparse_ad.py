"""Forward-mode AD through the port's sparse LU (``core/sparse_ops.py::
SparseSolve``, ROADMAP A16b) against the JAX package's ``jax.jvp``
through its XLA sparse LU (``cedarsim_tpu/ops/sparse_lu.py``) on the CPU,
where S1/S2 run as their plain versions.

- The solve: on a seeded random system in the sparse LU's pattern of a
  small diode ladder compiled ``sparse=True`` (4 branches of 8 sections,
  35 unknowns: MNA stamps, a source's branch row with no diagonal), the
  primal is bitwise the solve without tangents and
  within 1e-12 relative of the JAX package's, and the tangent of (vals,
  rhs) → x within 1e-10 relative of the JAX package's ``jax.jvp``.
- ``tran_sensitivity`` on ``netlists.diode_ladder()`` (259 unknowns, so
  the sparse path by itself) of v(b0_4, 4 ns) to R0: the value and the
  derivative within 1e-9 relative of the JAX package's, and the
  derivative within 1e-2 relative of the port's central difference (the
  adaptive grid moves with the parameter: 8e-4 apart at this step).
- ``pss`` of the diode rectifier compiled ``sparse=True`` in both
  packages (``tests/test_torch_pss.py``'s dense case at its tolerances):
  the same Newton iterations, x0 within 1e-8 V, the residual norms within
  1e-3 relative.
- The sparse factor and solve wrappers still refuse a tangent on a direct
  call (``tests/test_torch_sensitivity.py``); a backward raises.
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis import pss as jpss
from cedarsim_tpu.analysis import sensitivity as jsens
from cedarsim_tpu.core.sparse_ops import get_sparse_ops as jops_of
from cedarsim_tpu_torch.analysis import pss as tpss
from cedarsim_tpu_torch.analysis import sensitivity as tsens
from cedarsim_tpu_torch.benchmarks import netlists
from cedarsim_tpu_torch.core.compile import ensure_dynamic, use_sparse_solver
from cedarsim_tpu_torch.core.sparse_ops import get_sparse_ops
from cedarsim_tpu_torch.ops.ad import ForwardTangents


def test_solve_tangent_equals_jax_jvp():
    text = netlists.diode_ladder(n_branches=4, n_sections=8)
    tc = T.compile_circuit(T.load_spice(text), device="cpu", sparse=True)
    jc = J.compile_circuit(J.load_spice(text), sparse=True)
    tops, jops = get_sparse_ops(tc), jops_of(jc)
    assert tops.nnz_f == jops.plan.nnz_f
    np.testing.assert_array_equal(tops.plan.pos_arow, jops.plan.pos_arow)
    rng = np.random.default_rng(17)
    x = 0.5 + 0.1 * rng.standard_normal(tc.n_x)
    _, _, G, _ = tc.evaluate(torch.as_tensor(x)[None],
                             T.SimSpec.make(mode="tran"),
                             tc.lane_params(tc.params0, 1), jac="sparse")
    G = tops.add_diag(G[0], 1e-3)
    filled = (G != 0).double()
    vals = G + 1e-4 * torch.as_tensor(rng.standard_normal(G.shape)) * filled
    dvals = torch.as_tensor(rng.standard_normal(G.shape)) * filled \
        * vals.abs()
    b = torch.as_tensor(rng.standard_normal(tc.n_x))
    db = torch.as_tensor(rng.standard_normal(tc.n_x))
    plain = tops.solve(vals, b)
    with fwAD.dual_level(), ForwardTangents():
        out = tops.solve(fwAD.make_dual(vals, dvals), fwAD.make_dual(b, db))
        x_t, dx_t = fwAD.unpack_dual(out)
    assert torch.equal(x_t, plain)
    x_j, dx_j = jax.jit(lambda p, t: jax.jvp(jops.solve, p, t))(
        (jnp.asarray(vals.numpy()), jnp.asarray(b.numpy())),
        (jnp.asarray(dvals.numpy()), jnp.asarray(db.numpy())))
    x_j, dx_j = np.asarray(x_j), np.asarray(dx_j)
    assert np.abs(x_t.numpy() - x_j).max() <= 1e-12 * np.abs(x_j).max()
    assert np.abs(dx_t.numpy() - dx_j).max() <= 1e-10 * np.abs(dx_j).max()
    # the tangent is the derivative: A·dx = db − dA·x
    r = db - tops.matvec(dvals, x_t) - tops.matvec(vals, dx_t)
    assert float(r.abs().max()) <= 1e-10 * float(db.abs().max())


def test_backward_raises():
    tc = T.compile_circuit(T.load_spice(netlists.diode_ladder()),
                           device="cpu")
    ops = get_sparse_ops(tc)
    vals = torch.zeros(ops.nnz_f, dtype=torch.float64)
    vals[ops._vdiag] = 1.0
    vals[ops._a_diag] = vals[ops._a_diag] + 1.0
    b = torch.ones(tc.n_x, dtype=torch.float64, requires_grad=True)
    x = ops.solve(vals, b)
    with pytest.raises(NotImplementedError, match="reverse-mode AD"):
        x.sum().backward()


LADDER_ARGS = ("b0_4", "r0.r", (0.0, 5e-9), 4e-9)


def test_ladder_tran_sensitivity_equals_jax_and_central_differences():
    text = netlists.diode_ladder()
    tc = T.compile_circuit(T.load_spice(text), device="cpu")
    assert tc.n_x >= 256 and use_sparse_solver(tc)
    tv, tdv = tsens.tran_sensitivity(tc, *LADDER_ARGS)
    jv, jdv = jsens.tran_sensitivity(J.compile_circuit(J.load_spice(text)),
                                     *LADDER_ARGS)
    assert float(tv) == pytest.approx(float(jv), rel=1e-9)
    assert float(tdv) == pytest.approx(float(jdv), rel=1e-9)
    assert abs(float(tdv)) > 1e-4
    tc = ensure_dynamic(tc, ["r0.r"])
    h = 0.1
    vals = []
    for s in (1.0, -1.0):
        p = tc.set_param(tc.params0, "r0.r", 100.0 + s * h)
        sol = T.tran(tc, LADDER_ARGS[2], params=p,
                     opts=T.TranOptions(max_steps=4096))
        vals.append(sol.interp("b0_4", LADDER_ARGS[3]))
    cd = (vals[0] - vals[1]) / (2 * h)
    assert float(tdv) == pytest.approx(cd, rel=1e-2)


def _rectifier(P, sparse):
    ckt = P.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(P.VSourceSIN, "V1", (vin, ckt.gnd),
            dict(vo=0.0, va=2.0, freq=1e6))
    ckt.add(P.Diode, "D1", (vin, vout), {"is": 1e-14, "n": 1.0})
    ckt.add(P.Resistor, "RL", (vout, ckt.gnd), dict(r=100e3))
    ckt.add(P.Capacitor, "CL", (vout, ckt.gnd), dict(c=1e-9))
    kw = {} if P is J else dict(device="cpu")
    return P.compile_circuit(ckt, sparse=sparse, **kw)


def test_sparse_pss_equals_the_jax_package():
    res = {}
    for P, mod in ((J, jpss), (T, tpss)):
        comp = _rectifier(P, True)
        if P is T:
            assert use_sparse_solver(comp)
        res[P] = mod.pss(comp, 1e-6, ctx=P.SimSpec.make(gmin=1e-12),
                         opts=P.TranOptions(max_steps=4096), tol=1e-6)
    rj, rt = res[J], res[T]
    assert rt.converged and rj.converged
    assert rt.iters == rj.iters > 1
    assert np.abs(rt.x0 - np.asarray(rj.x0)).max() < 1e-8
    assert rt.resnorm == pytest.approx(rj.resnorm, rel=1e-3)
