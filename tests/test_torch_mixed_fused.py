"""The fused chord kernel's float32 form (B1 on a circuit compiled with
``eval_dtype=torch.float32``; on the CPU its plain version) against the
JAX package's Pallas kernel, which computes in float32, in interpret
mode.

- Plan: under float32 evaluation the same linear / nonlinear split as the
  JAX plan's and float64-exact baked constants (the probe and G_lin,
  C_lin, q_off are walked in float64, as the JAX plan's ``exact=True``):
  equal to the float64 plan's within rtol 1e-12, atol 1e-18; the plan's
  scalar type is float32, its constants, per-lane params and scratch in
  float32, its library the float32 build (``fused_chord_f32``).
- One chord solve against the Pallas kernel on the VA diode and the
  level-1 inverter of ``tests/test_torch_fused_chord.py``, alone and over
  3 lanes with a per-lane param: equal ``ok`` and Newton counts per lane,
  xn within 1e-6·max|x| + 1e-8 V (both sides float32 now; the float64
  port's bound there is 1e-4·max|x| + 1e-6).
- The direction: on the BSIM-CMG DFF's plan (cell G, 2 lanes, BE starts
  at h = 1e-12 and 1e-11 from the warm state with the nodes moved by a
  seeded 1 mV and 10 mV) the float32 form, whose direction is summed in
  float64 from the float64 MT, converges on every lane, and the same loop
  with the Pallas kernel's float32 product (MT rounded to float32)
  converges on none: cond(J/r) reaches ~2e10 there, so MT's rounding
  alone moves the direction by volts.
- The A21 circuit's integer, bitwise and table nodes are inside the
  float32 form's envelope: its plan (with the point-list device) takes
  the float32 form, and one chord solve of 4 lanes (codes 3, 5, 6, 9,
  without the point-list device, which the Pallas kernel cannot hold)
  against the Pallas kernel with the float32 Newton tolerances of the
  solves above: equal ``ok`` and Newton counts, xn within the float32
  bound above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis.tran import TranOptions as JTranOptions
from cedarsim_tpu.ops.fused_chord import FusedChordPlan as JPlan
from cedarsim_tpu.va.codegen import load_va as jload_va
from cedarsim_tpu_torch.analysis.tran import fused_plan_for
from cedarsim_tpu_torch.benchmarks import kernel_times as kt
from cedarsim_tpu_torch.benchmarks import netlists
from cedarsim_tpu_torch.ops import fused_chord as fc
from cedarsim_tpu_torch.va.codegen import load_va as tload_va
from tests import test_torch_emit_a21 as ta21
from tests import test_torch_fused_chord as tfc


def _diode(P, load_va, eval_dtype):
    dev = load_va(tfc.VA_DIODE)["fdiode"]
    ckt = P.Circuit()
    a, b = ckt.net("a"), ckt.net("b")
    ckt.add(P.VSourcePULSE, "V1", (a, ckt.gnd),
            dict(v1=0.0, v2=3.0, td=1e-9, tr=1e-10, tf=1e-10, pw=5e-9,
                 per=20e-9))
    ckt.add(P.Resistor, "R1", (a, b), dict(r=1000.0))
    ckt.add(dev, "D1", (b, ckt.gnd), dict(is_=1e-14))
    ckt.add(P.Capacitor, "C1", (b, ckt.gnd), dict(c=1e-12))
    return P.compile_circuit(ckt, dynamic_params=("is_",),
                             eval_dtype=eval_dtype, **tfc._cpu(P))


def _inverter(P, eval_dtype):
    nl = P.parse_spice(tfc.INVERTER, file="inverter.cir")
    return P.compile_circuit(P.elaborate(nl, include_paths=[tfc.DFF_DIR]),
                             eval_dtype=eval_dtype, **tfc._cpu(P))


def _inv_rc(P, eval_dtype):
    return P.compile_circuit(P.elaborate(P.parse_spice(
        tfc.INV_RC, file="inv_rc.cir")), eval_dtype=eval_dtype,
        **tfc._cpu(P))


@pytest.fixture(scope="module")
def circuits():
    """Per circuit: (JAX float32, port float32, port float64)."""
    return {
        "diode": (_diode(J, jload_va, jnp.float32),
                  _diode(T, tload_va, torch.float32),
                  _diode(T, tload_va, None)),
        "inverter": (_inverter(J, jnp.float32),
                     _inverter(T, torch.float32), _inverter(T, None)),
        "inv_rc": (_inv_rc(J, jnp.float32), _inv_rc(T, torch.float32),
                   _inv_rc(T, None))}


@pytest.mark.parametrize("name", ["diode", "inverter", "inv_rc"])
def test_float32_plan_split_is_the_jax_packages(circuits, name):
    cj, ct, c64 = circuits[name]
    ctx = T.SimSpec.make().with_mode("tran")
    tp = fc.get_fused_plan(ct, ctx)
    t64 = fc.get_fused_plan(c64, ctx)
    jp = JPlan(cj, J.SimSpec.make().with_mode("tran"))
    assert tp.real == torch.float32 and t64.real == torch.float64
    assert (tp.lin_keys, tp.nl_keys) == (list(jp.lin_keys), list(jp.nl_keys))
    assert (tp.lin_keys, tp.nl_keys) == (t64.lin_keys, t64.nl_keys)
    for a, b in ((tp.G_lin, t64.G_lin), (tp.C_lin, t64.C_lin),
                 (tp.q_off, t64.q_off), (tp.G_lin, np.asarray(jp.G_lin)),
                 (tp.C_lin, np.asarray(jp.C_lin))):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-18)
    assert tp.G_lin_T.dtype == tp.q_off_t.dtype == torch.float32
    assert tp.hoist_scratch(2).dtype == torch.float32
    assert tp.entry == "fused_chord_f32" and t64.entry == "fused_chord_f64"
    ln = tp.lanes(None, 2)
    assert ln.dyn.dtype == ln.ent_scale.dtype == torch.float32
    assert "double" not in tp.header()


@pytest.mark.parametrize("name, lanes", [
    ("diode", [1e-14]), ("diode", [1e-14, 3e-14, 1e-13]),
    ("inv_rc", [1.0]), ("inv_rc", [0.97, 1.0, 1.05])],
    ids=["solo", "vmap3", "mos1_solo", "mos1_vmap3"])
def test_float32_chord_solve_matches_pallas(circuits, name, lanes):
    cj, ct, _ = circuits[name]
    L = len(lanes)
    x_pred, Jm, xdh, h, t, pb = tfc._chord_inputs(ct, name, lanes)
    ctx = T.SimSpec.make().with_mode("tran")
    tp = fc.get_fused_plan(ct, ctx)
    jp = JPlan(cj, J.SimSpec.make().with_mode("tran"))
    jopts = JTranOptions(**tfc.BASE, newton_impl="fused")
    so_t = tp.s_off(torch.full((L,), t, dtype=torch.float64), ctx, pb)
    so_j = np.asarray(jp.s_off(t, J.SimSpec.make().with_mode("tran")))
    key = tfc._nl_key(ct)
    pj = {k: {pn: jnp.asarray(np.repeat(np.asarray(v)[None], L, 0))
              for pn, v in g.items()} for k, g in cj.params0.items()}
    pn = tfc._CHORD[name][0]
    pj[key][pn] = jnp.asarray(pb[key][pn].numpy())

    def one(x, Jl, xd, p):
        return jp(jnp.asarray(x), jnp.asarray(Jl), jnp.asarray(so_j), 1.0,
                  h, jnp.asarray(xd), t, jopts, params=p, interpret=True)

    if L == 1:
        p1 = {k: {pn: v[0] for pn, v in g.items()} for k, g in pj.items()}
        xn_j, _, _, ok_j, nn_j = one(x_pred[0], Jm[0], xdh[0], p1)
        xn_j, ok_j, nn_j = (np.asarray(a)[None] for a in (xn_j, ok_j, nn_j))
    else:
        xn_j, _, _, ok_j, nn_j = jax.vmap(one)(x_pred, Jm, xdh, pj)
        xn_j, ok_j, nn_j = (np.asarray(a) for a in (xn_j, ok_j, nn_j))
    tx = torch.as_tensor
    ones = torch.ones(L, dtype=torch.float64)
    xn_t, _, _, ok_t, nnwt = tp(
        tx(x_pred), tx(Jm), so_t, ones, h * ones, tx(xdh), t * ones,
        T.TranOptions(**tfc.BASE, newton_impl="fused"), params=pb)
    assert ok_t.tolist() == ok_j.astype(bool).tolist()
    assert bool(ok_t.all()) and int(nnwt.min()) >= 2   # it iterated
    assert nnwt.tolist() == nn_j.astype(int).tolist()
    tol = 1e-6 * float(np.abs(xn_j).max()) + 1e-8
    np.testing.assert_allclose(xn_t.numpy(), xn_j, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def cmg32():
    dff = kt.dff_lanes(torch, T, "cpu", lanes=2, leg="cmg",
                       eval_dtype=torch.float32)
    return dff, fused_plan_for(*dff[:3])


@pytest.mark.parametrize("h", [1e-12, 1e-11])
@pytest.mark.parametrize("pert", [1e-3, 1e-2])
def test_the_float32_form_needs_its_float64_direction(cmg32, h, pert):
    dff, plan = cmg32
    assert plan.real == torch.float32
    opts = {k: v for k, v in kt.CMG_FUSED_OPTS.items() if k != "formulation"}
    args, o = kt.fused_args(torch, T, plan, dff, h, opts=opts, pert=pert)
    mine = fc.fused_chord(plan, *args, o)
    assert bool(mine[3][:, 0].all())
    # the Pallas kernel's float32 product: MT rounded to float32
    pallas = list(args)
    pallas[1] = args[1].float()
    theirs = fc.fused_chord_plain(plan, *pallas, o)
    assert not bool(theirs[3][:, 0].any())
    assert bool((theirs[3][:, 1] == o.max_newton).all())


def test_float32_form_envelope_of_the_emitter():
    ctx = T.SimSpec.make().with_mode("tran")
    tp = fc.get_fused_plan(T.compile_circuit(
        netlists.a21_circuit(), device="cpu", eval_dtype=torch.float32,
        dynamic_params=["code"]), ctx)
    assert tp.entry == "fused_chord_f32" and len(tp.nl_keys) == 2
    assert "static const float cs_tab_" in tp.header()
    ct = T.compile_circuit(netlists.a21_circuit(with_pwl=False),
                           device="cpu", eval_dtype=torch.float32,
                           dynamic_params=["code"])
    cj = ta21._jax_circuit(with_pwl=False, eval_dtype=jnp.float32)
    newton = {k: tfc.BASE[k] for k in ("newton_reltol", "newton_abstol",
                                        "res_tol", "res_rel", "jac_shunt")}
    xn_t, ok_t, nn_t, xn_j, ok_j, nn_j = ta21.chord_vs_pallas(
        cj, ct, dict(ta21.BASE, **newton))
    assert ok_t.all() and ok_t.tolist() == ok_j.tolist()
    assert nn_t.tolist() == nn_j.tolist() and nn_t.min() >= 2
    tol = 1e-6 * float(np.abs(xn_j).max()) + 1e-8
    np.testing.assert_allclose(xn_t, xn_j, rtol=0, atol=tol)
