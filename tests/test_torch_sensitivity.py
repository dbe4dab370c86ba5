"""The port's sensitivities (``cedarsim_tpu_torch/analysis/sensitivity.py``)
against the JAX package's on the CPU, and the routing of AD through the
transient and the kernels.

- The divider's ``dc_sensitivity`` (both resistors) and ``tf`` (gain,
  rout, value) equal the JAX package's within 1e-10 relative, and the
  closed forms within 1e-9.
- The RC step's ``tran_sensitivity`` of v(1 ms) to R (forward-mode AD
  through the whole adaptive transient): the value and the derivative
  within 1e-9 relative of the JAX package's ``jax.jvp`` (the same
  accepted steps; only the last bits of the step loop's arithmetic part
  them), and within 5e-3 of the closed form (the discretisation's error,
  the JAX test's bound).
- The step controller is detached from AD: the accepted times of a run
  whose parameter carries a forward tangent are bitwise those of the run
  without one and carry no tangent, while the states do.
- Under AD, ``resolve_impl`` gives "auto" the exact float64 solve in the
  chord loop and an explicit "fused" or "mixed" raises.  A sparse circuit
  takes forward tangents through the sparse LU (``SparseSolve``): the RC
  step compiled sparse gives the value and derivative of the dense run,
  the port's and the JAX package's, within 1e-9 relative;
  with a leaf that requires grad it raises (no reverse-mode rule).  Every
  hand-written kernel's wrapper (B1,
  B2-B5, S1/S2) and ``fma_f64`` raise on an input that carries a forward
  tangent or requires grad, on the CPU as on a card.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis import sensitivity as jsens
from cedarsim_tpu_torch.analysis import sensitivity as tsens
from cedarsim_tpu_torch.analysis.tran import (resolve_impl, tran_core,
                                              xdot0_and_mask)
from cedarsim_tpu_torch.core.compile import ensure_dynamic
from cedarsim_tpu_torch.core.context import Modes

DIVIDER = """* divider
V1 vin 0 2
R1 vin vmid 1k
R2 vmid 0 1k
.op
"""

RC_STEP = """* rc
V1 vin 0 1
R1 vin vout 1k
C1 vout 0 1u
.ic v(vout)=0
.tran 1u 3m
"""


def _both(netlist):
    return (J.compile_circuit(J.load_spice(netlist)),
            T.compile_circuit(T.load_spice(netlist), device="cpu"))


def test_divider_dc_sensitivity_and_tf_equal_the_jax_packages():
    jc, tc = _both(DIVIDER)
    wrt = ["r1.r", "r2.r"]
    jv, jg = jsens.dc_sensitivity(jc, "vmid", wrt)
    tv, tg = tsens.dc_sensitivity(tc, "vmid", wrt)
    assert float(tv) == pytest.approx(float(jv), rel=1e-10)
    v, r1, r2 = 2.0, 1e3, 1e3
    closed = {"r1.r": -v * r2 / (r1 + r2) ** 2, "r2.r": v * r1 / (r1 + r2) ** 2}
    for name in wrt:
        assert float(tg[name]) == pytest.approx(float(jg[name]), rel=1e-10)
        assert float(tg[name]) == pytest.approx(closed[name], rel=1e-9)
    jr = jsens.tf(jc, "vmid", "v1")
    tr = tsens.tf(tc, "vmid", "v1")
    for k in ("gain", "rout", "value"):
        assert float(tr[k]) == pytest.approx(float(jr[k]), rel=1e-10), k
    assert float(tr["gain"]) == pytest.approx(0.5, rel=1e-9)
    assert float(tr["rout"]) == pytest.approx(500.0, rel=1e-9)


RC_ARGS = ("vout", "r1.r", (0.0, 3e-3), 1e-3)


@pytest.fixture(scope="module")
def rc_sensitivities():
    """The RC step's ``tran_sensitivity`` (value, derivative) by the JAX
    package and by the port, both dense, computed once for the module."""
    jc, tc = _both(RC_STEP)
    return (jsens.tran_sensitivity(jc, *RC_ARGS),
            tsens.tran_sensitivity(tc, *RC_ARGS))


def test_rc_tran_sensitivity_equals_the_jax_packages_and_the_closed_form(
        rc_sensitivities):
    (jv, jdv), (tv, tdv) = rc_sensitivities
    assert float(tv) == pytest.approx(float(jv), rel=1e-9)
    assert float(tdv) == pytest.approx(float(jdv), rel=1e-9)
    t, r, c = 1e-3, 1000.0, 1e-6
    assert float(tv) == pytest.approx(1 - np.exp(-t / (r * c)), rel=1e-3)
    assert float(tdv) == pytest.approx(
        -np.exp(-t / (r * c)) * t / (r * r * c), rel=5e-3)


def _rc_core_args():
    comp = ensure_dynamic(T.compile_circuit(T.load_spice(RC_STEP),
                                            device="cpu"), ["r1.r"])
    ctx = T.SimSpec.make()
    op = T.solve_dc(comp, ctx=ctx, mode=Modes.TRANOP)
    xd0, mask = xdot0_and_mask(comp, op.x, ctx.with_mode(Modes.TRANOP),
                               comp.params0)
    return comp, ctx, op.x, xd0, mask


def test_controller_is_detached_from_the_tangent():
    comp, ctx, x0, xd0, mask = _rc_core_args()
    opts = T.TranOptions(max_steps=4096)
    bps = np.array([3e-3, np.inf])
    plain = tran_core(comp, comp.params0, ctx, x0, xd0, 0.0, 3e-3, bps,
                      3e-9, opts, mask)
    with fwAD.dual_level():
        p = tsens._carry_tangent(comp, comp.params0, "r1.r")
        out = tran_core(comp, p, ctx, x0, xd0, 0.0, 3e-3, bps, 3e-9, opts,
                        mask)
        ts, dts = fwAD.unpack_dual(out[0])
        dxs = fwAD.unpack_dual(out[1]).tangent
    assert dts is None
    assert torch.equal(ts, plain[0])
    assert int(out[3][0]) == int(plain[3][0]) > 10
    assert dxs is not None and float(dxs.abs().max()) > 0.0


def test_auto_resolves_to_the_exact_solve_under_ad():
    comp, ctx, *_ = _rc_core_args()
    for batched in (False, True):
        o = resolve_impl(comp, T.TranOptions(), ctx, batched=batched,
                         ad=True)
        assert (o.dense_lu, o.newton_impl) == ("jax", "xla")
    for kw in (dict(dense_lu="mixed"), dict(newton_impl="fused",
                                             formulation="cap",
                                             jac_reuse=1)):
        with pytest.raises(ValueError, match="no derivative rule"):
            resolve_impl(comp, T.TranOptions(**kw), ctx, ad=True)


def test_fused_or_mixed_transient_with_a_tangent_raises():
    comp, ctx, x0, xd0, mask = _rc_core_args()
    opts = T.TranOptions(max_steps=64, dense_lu="mixed", jac_reuse=1)
    with fwAD.dual_level():
        p = tsens._carry_tangent(comp, comp.params0, "r1.r")
        with pytest.raises(ValueError, match="no derivative rule"):
            tran_core(comp, p, ctx, x0[None], xd0[None], 0.0, 3e-3,
                      np.array([3e-3, np.inf]), 3e-9, opts, mask)


def test_sparse_circuit_under_ad_names_a16b(rc_sensitivities):
    """The positive twin of the former refusal (ROADMAP A16b, done): the
    sparse RC step's forward-mode sensitivity through S1/S2's plain
    versions equals the dense one's, the port's and the JAX package's
    (``tests/test_torch_sparse_ad.py`` holds a sparse ladder to the JAX
    package's sparse path)."""
    comp = ensure_dynamic(
        T.compile_circuit(T.load_spice(RC_STEP), device="cpu",
                          sparse=True), ["r1.r"])
    tv, tdv = tsens.tran_sensitivity(comp, *RC_ARGS)
    for v, dv in rc_sensitivities:
        assert float(tv) == pytest.approx(float(v), rel=1e-9)
        assert float(tdv) == pytest.approx(float(dv), rel=1e-9)


def test_sparse_transient_with_requires_grad_raises():
    comp = ensure_dynamic(
        T.compile_circuit(T.load_spice(RC_STEP), device="cpu",
                          sparse=True), ["r1.r"])
    p, _ = tsens._with_grad_leaves(comp, comp.params0, ["r1.r"])
    with pytest.raises(NotImplementedError, match="reverse-mode AD"):
        T.tran(comp, (0.0, 1e-3), params=p)


def _kernel_calls():
    """(name, call on its inputs) of every hand-written kernel's wrapper
    and of ``fma_f64``."""
    from cedarsim_tpu_torch.ops import (fused_chord, gesp_lu, pivot_lu,
                                        rounding, sparse_lu)
    n = 4
    A = (torch.eye(n) * 4 + 0.1).to(torch.float32)[None]
    b = torch.ones(1, n, dtype=torch.float32)
    rows, cols = np.nonzero(np.ones((n, n)))
    plan = sparse_lu.build_plan(n, rows, cols)
    vals = sparse_lu.vals_from_dense(plan, A.double())
    return [
        ("lu_factor_gesp_f32", lambda t: gesp_lu.lu_factor_gesp_f32(t(A))),
        ("lu_subst_gesp_f32", lambda t: gesp_lu.lu_subst_gesp_f32(A, t(b))),
        ("lu_solve_gesp_f32", lambda t: gesp_lu.lu_solve_gesp_f32(t(A), b)),
        ("lu_solve_pivot_f32",
         lambda t: pivot_lu.lu_solve_pivot_f32(A, t(b))),
        ("sparse factor (S1)", lambda t: sparse_lu.factor(plan, t(vals))),
        ("sparse solve (S2)", lambda t: sparse_lu.solve_factored(
            plan, vals, t(b.double()))),
        ("fused_chord", lambda t: fused_chord.fused_chord(
            dataclasses.make_dataclass("P", ["n_x"])(n),
            t(b.double()), *([None] * 8))),
        ("fma_f64", lambda t: rounding.fma_f64(t(b.double()), b.double(),
                                               b.double())),
    ]


@pytest.mark.parametrize("name,call", _kernel_calls(),
                         ids=[c[0] for c in _kernel_calls()])
@pytest.mark.parametrize("kind", ["forward", "grad"])
def test_kernel_wrappers_raise_on_a_tangent(name, call, kind):
    if kind == "grad":
        def carry(x):
            return x.detach().clone().requires_grad_(True)
        with pytest.raises(ValueError, match="tangent"):
            call(carry)
        return
    with fwAD.dual_level():
        def carry(x):
            return fwAD.make_dual(x, torch.ones_like(x))
        with pytest.raises(ValueError, match="tangent"):
            call(carry)


def test_forward_tangents_mode_gives_the_same_bits():
    """``ForwardTangents`` (zero tangents instead of PyTorch's ZeroTensor
    path) changes no bit of a model walk's values or tangents: the VBIC
    amplifier's (S, Q, G, C) at 3 lanes, each carrying one direction."""
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.ops.ad import ForwardTangents
    comp = T.compile_circuit(T.elaborate(T.parse_spice(netlists.VBIC_AMP)),
                             device="cpu")
    ctx = T.SimSpec.make(gmin=1e-12)
    x0 = T.solve_dc(comp, ctx=ctx, mode=Modes.TRANOP).x
    rng = np.random.default_rng(5)
    x = x0 + torch.as_tensor(0.01 * rng.standard_normal((3, comp.n_x)))
    d = torch.as_tensor(rng.standard_normal((3, comp.n_x)))
    lp = comp.lane_params(comp.params0, 3)
    c = ctx.with_mode(Modes.TRAN)
    with fwAD.dual_level():
        plain = comp.evaluate(fwAD.make_dual(x, d), c, lp, jac=True)
        with ForwardTangents():
            fast = comp.evaluate(fwAD.make_dual(x, d), c, lp, jac=True)
        for a, b in zip(plain, fast):
            (pa, ta), (pb, tb) = fwAD.unpack_dual(a), fwAD.unpack_dual(b)
            assert torch.equal(pa, pb) and torch.equal(ta, tb)
            assert float(ta.abs().max()) > 0.0
