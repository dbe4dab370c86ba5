"""The port's fused chord solve (cedarsim_tpu_torch/ops/fused_chord.py, its
plain PyTorch version on the CPU) against the JAX package's
``FusedChordPlan``, whose Pallas kernel runs here in interpret mode.

Circuits: the VA diode of tests/test_fused_chord.py (``is_`` kept dynamic
so that lanes can scatter it), a 2-MOSFET BSIM4 inverter on the DFF's own
nch_5p0 / pch_5p0 cards, and the JAX package's own fused test circuit
(tests/test_fused_chord.py's ``INV_RC``: a level-1 inverter driving an RC,
whose one nonlinear group is the built-in ``Mos1``, emitted for the
kernel).

- Plan: the same linear / nonlinear split as the JAX plan; G_lin, C_lin,
  q_off within rtol 1e-12, atol 1e-18; G_lin·x + s_off(t) + S_nl equals the
  full residual at three times (atol 1e-9 A, Q 1e-18 C).
- One chord solve against the Pallas kernel, alone (B1′) and under
  ``jax.vmap`` over 3 lanes with a per-lane ``is_`` (diode) or ``vto``
  (``INV_RC``) (B1, the custom_vmap rule): equal ``ok`` per lane, xn
  within 1e-4·max|x| + 1e-6 V (the JAX kernel is float32, the port
  float64).
- Transient: ``tran(newton_impl="fused")`` against the port's "xla" engine
  over 4 lanes with a scatter (is_ / W): rails within 5e-3 V, mid-edge
  within 8e-2 V, lanes strictly ordered.
- ``resolve_impl``: "auto" stays "xla" on the CPU; the "auto" rule fuses
  only inside the envelope, catches only ``FusedEnvelopeError``, and lets
  any other failure through.
"""

import os

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
from cedarsim_tpu_torch.analysis import tran as ttran
from cedarsim_tpu_torch.ops import fused_chord as fc
from cedarsim_tpu_torch.va.codegen import load_va as tload_va

DFF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "benchmarks", "gf180_dff")

VA_DIODE = """
module fdiode(a, c);
  inout a, c;
  electrical a, c;
  parameter real is_ = 1e-14 from (0:1];
  parameter real n = 1.0;
  real id, vd;
  analog begin
    vd = V(a, c);
    if (vd > -5.0 * n * $vt)
      id = is_ * (limexp(vd / (n * $vt)) - 1.0);
    else
      id = -is_;
    I(a, c) <+ id;
    I(a, c) <+ white_noise(2.0 * 1.602176634e-19 * abs(id), "shot");
  end
endmodule
"""

INVERTER = """* BSIM4 inverter on the DFF's 5 V cards
.include "models_bsim4.spice"
vdd vdd 0 5.0
vin in 0 PULSE(0 5 2n 0.2n 0.2n 4n 10n)
xp out in vdd vdd pfet_06v0 w=2u l=0.6u
xn out in 0 0 nfet_06v0 w=1u l=0.6u
cl out 0 10f
"""

#: the fused configuration of tests/test_fused_chord.py:172-174
BASE = dict(max_steps=4096, jac_reuse=1, formulation="cap",
            newton_reltol=1e-4, newton_abstol=5e-7, res_tol=1e-3,
            jac_shunt=1e-7, res_rel=3e-5, rtol=1e-2, atol=1e-4)


def _cpu(P):
    """The device argument of P's ``compile_circuit``: the port's runs on
    the card unless told otherwise; the JAX package's takes none."""
    return {"device": "cpu"} if P is T else {}


def _diode(P, load_va):
    dev = load_va(VA_DIODE)["fdiode"]
    ckt = P.Circuit()
    a, b = ckt.net("a"), ckt.net("b")
    ckt.add(P.VSourcePULSE, "V1", (a, ckt.gnd),
            dict(v1=0.0, v2=3.0, td=1e-9, tr=1e-10, tf=1e-10, pw=5e-9,
                 per=20e-9))
    ckt.add(P.Resistor, "R1", (a, b), dict(r=1000.0))
    ckt.add(dev, "D1", (b, ckt.gnd), dict(is_=1e-14))
    ckt.add(P.Capacitor, "C1", (b, ckt.gnd), dict(c=1e-12))
    return P.compile_circuit(ckt, dynamic_params=("is_",), **_cpu(P))


def _inverter(P):
    nl = P.parse_spice(INVERTER, file="inverter.cir")
    return P.compile_circuit(P.elaborate(nl, include_paths=[DFF_DIR]),
                             **_cpu(P))


#: tests/test_fused_chord.py's INV_RC
INV_RC = """* mos inverter driving an RC, plus PWL supply ripple path
.model n1 nmos (level=1 vto=0.7 kp=100u cgso=1n cgdo=1n)
.model p1 pmos (level=1 vto=-0.7 kp=40u cgso=1n cgdo=1n)
vdd vdd 0 3.3
vin in 0 PULSE(0 3.3 2n 0.2n 0.2n 4n 10n)
mp out in vdd vdd p1 w=2u l=0.35u
mn out in 0 0 n1 w=1u l=0.35u
r1 out mid 1k
cl mid 0 10f
.tran 0.1n 20n
"""


def _inv_rc(P):
    return P.compile_circuit(P.elaborate(P.parse_spice(
        INV_RC, file="inv_rc.cir")), **_cpu(P))


@pytest.fixture(scope="module")
def circuits():
    return {"diode": (_diode(J, jload_va), _diode(T, tload_va)),
            "inverter": (_inverter(J), _inverter(T)),
            "inv_rc": (_inv_rc(J), _inv_rc(T))}


def _nl_key(comp):
    return [k for k in comp.group_order
            if k.startswith("VA_") or k == "Mos1"][0]


# ------------------------------------------------------------------- plan

@pytest.mark.parametrize("name", ["diode", "inverter", "inv_rc"])
def test_plan_matches_jax(circuits, name):
    cj, ct = circuits[name]
    jp = JPlan(cj, J.SimSpec.make().with_mode("tran"))
    tp = fc.get_fused_plan(ct, T.SimSpec.make().with_mode("tran"))
    assert tp.lin_keys == jp.lin_keys
    assert tp.nl_keys == jp.nl_keys == [_nl_key(ct)]
    for a, b in ((tp.G_lin, jp.G_lin), (tp.C_lin, jp.C_lin),
                 (tp.q_off, jp.q_off)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=1e-18)


@pytest.mark.parametrize("name", ["diode", "inverter", "inv_rc"])
def test_linear_split_exact(circuits, name):
    """G_lin·x + s_off(t) + S_nl reproduces the full residual: the linear
    fold outside the kernel does not change the physics."""
    ct = circuits[name][1]
    ctx = T.SimSpec.make().with_mode("tran")
    plan = fc.get_fused_plan(ct, ctx)
    lp = ct.lane_params(None, 1)
    rng = np.random.default_rng(7)
    for t in (0.0, 2.1e-9, 7.7e-9):
        x = torch.as_tensor(rng.normal(size=ct.n_x) * 1.5)
        S_full, Q_full = ct.residuals(x, ctx.at_time(t))
        S_nl, Q_nl = ct.evaluate(x[None], ctx.at_time(t), lp,
                                 keys=plan.nl_keys)
        S_lin = plan.G_lin @ x.numpy() + plan.s_off(t).numpy()
        Q_lin = plan.C_lin @ x.numpy() + plan.q_off
        np.testing.assert_allclose(S_lin + S_nl[0].numpy(), S_full.numpy(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(Q_lin + Q_nl[0].numpy(), Q_full.numpy(),
                                   rtol=0, atol=1e-18)


def test_plan_cache_keys_on_values(circuits):
    ct = circuits["diode"][1]
    ctx = T.SimSpec.make().with_mode("tran")
    p1 = fc.get_fused_plan(ct, ctx)
    assert fc.get_fused_plan(ct, ctx, dict(ct.params0)) is p1
    assert fc.get_fused_plan(ct, ctx.replace(gmin=1e-13)) is not p1
    other = {k: dict(g) for k, g in ct.params0.items()}
    other["VA_fdiode"]["is_"] = other["VA_fdiode"]["is_"] * 2.0
    assert fc.get_fused_plan(ct, ctx, other) is not p1


# ------------------------------------------------ one chord solve vs Pallas

#: per circuit: the per-lane param, the time and step of the BE start, and
#: the node whose source has stepped there (its jump in volts)
_CHORD = {"diode": ("is_", 2e-9, 1e-11, (0, 3.0)),
          "inv_rc": ("vto", 2.1e-9, 1e-11, None)}


def _chord_inputs(ct, name, lanes):
    """A BE-start chord solve: predictor = operating point + a seeded 0.05
    V on the nodes (+ the stepped source); J from the port at the
    predictor with the 1e-7 shunt, per lane; the lanes' ``pn`` scaled by
    ``lanes``."""
    pn, t, h, jump = _CHORD[name]
    ctx = T.SimSpec.make()
    op = T.solve_dc(ct, ctx=ctx, mode="tranop")
    L = len(lanes)
    rng = np.random.default_rng(21)
    x_op = op.x.numpy()
    x_pred = x_op[None] + np.concatenate(
        [rng.uniform(-0.05, 0.05, (L, ct.n_nodes)),
         np.zeros((L, ct.n_x - ct.n_nodes))], 1)
    if jump is not None:
        x_pred[:, jump[0]] += jump[1]
    key = _nl_key(ct)
    pb = {k: dict(g) for k, g in ct.params0.items()}
    base = 1.0 if name == "diode" else ct.params0[key][pn]
    pb[key][pn] = base * torch.as_tensor(lanes)[:, None]
    _, _, G, C = ct.res_jacs_fwd(torch.as_tensor(x_pred),
                                 ctx.with_mode("tran").at_time(t), pb)
    nv = ct.n_nodes + ct.n_internal
    J_ = (C / h + G).numpy() + 1e-7 * np.diag(np.arange(ct.n_x) < nv)
    return x_pred, J_, -np.repeat(x_op[None], L, 0), h, t, pb


@pytest.mark.parametrize("name, lanes", [
    ("diode", [1e-14]), ("diode", [1e-14, 3e-14, 1e-13]),
    ("inv_rc", [1.0]), ("inv_rc", [0.97, 1.0, 1.05])],
    ids=["solo", "vmap3", "mos1_solo", "mos1_vmap3"])
def test_chord_solve_matches_pallas(circuits, name, lanes):
    cj, ct = circuits[name]
    L = len(lanes)
    x_pred, Jm, xdh, h, t, pb = _chord_inputs(ct, name, lanes)
    ctx = T.SimSpec.make().with_mode("tran")
    tp = fc.get_fused_plan(ct, ctx)
    jp = JPlan(cj, J.SimSpec.make().with_mode("tran"))
    jopts = JTranOptions(**BASE, newton_impl="fused")
    so_t = tp.s_off(torch.full((L,), t, dtype=torch.float64), ctx, pb)
    so_j = np.asarray(jp.s_off(t, J.SimSpec.make().with_mode("tran")))
    np.testing.assert_allclose(so_t.numpy(),
                               np.broadcast_to(so_j, (L, ct.n_x)),
                               rtol=1e-12, atol=1e-15)
    key = _nl_key(ct)
    pj = {k: {pn: jnp.asarray(np.repeat(np.asarray(v)[None], L, 0))
              for pn, v in g.items()} for k, g in cj.params0.items()}
    pn = _CHORD[name][0]
    pj[key][pn] = jnp.asarray(pb[key][pn].numpy())

    def one(x, Jl, xd, p):
        return jp(jnp.asarray(x), jnp.asarray(Jl), jnp.asarray(so_j), 1.0,
                  h, jnp.asarray(xd), t, jopts, params=p, interpret=True)

    if L == 1:
        p1 = {k: {pn: v[0] for pn, v in g.items()} for k, g in pj.items()}
        xn_j, _, _, ok_j, _ = one(x_pred[0], Jm[0], xdh[0], p1)
        xn_j, ok_j = np.asarray(xn_j)[None], np.asarray(ok_j)[None]
    else:
        xn_j, _, _, ok_j, _ = jax.vmap(one)(x_pred, Jm, xdh, pj)
        xn_j, ok_j = np.asarray(xn_j), np.asarray(ok_j)
    tx = torch.as_tensor
    ones = torch.ones(L, dtype=torch.float64)
    xn_t, _, _, ok_t, nnwt = tp(
        tx(x_pred), tx(Jm), so_t, ones, h * ones, tx(xdh), t * ones,
        T.TranOptions(**BASE, newton_impl="fused"), params=pb)
    assert ok_t.tolist() == ok_j.astype(bool).tolist()
    assert bool(ok_t.all()) and int(nnwt.min()) >= 2   # it iterated
    tol = 1e-4 * float(np.abs(xn_j).max()) + 1e-6
    np.testing.assert_allclose(xn_t.numpy(), xn_j, rtol=0, atol=tol)


# --------------------------------------------------------------- transient

def _lanes_run(ct, key, pn, scale, tstop, ni):
    pb = {k: dict(g) for k, g in ct.params0.items()}
    pb[key][pn] = ct.params0[key][pn][None, :] * torch.as_tensor(
        scale)[:, None]
    sols = T.tran(ct, (0.0, tstop), params=pb, ctx=T.SimSpec.make(),
                  opts=T.TranOptions(**BASE, newton_impl=ni))
    assert all(s.converged for s in sols)
    return sols


@pytest.mark.parametrize("name, pn, scale, node, rails, edges, sign", [
    ("diode", "is_", [1.0, 3.0, 10.0, 30.0], "b",
     np.r_[np.linspace(0.2e-9, 0.9e-9, 4), np.linspace(2e-9, 6e-9, 6),
           np.linspace(7e-9, 8e-9, 3)],
     (3e-9, 1.06e-9, 6.15e-9), -1),
    ("inverter", "W", [0.93, 1.0, 1.04, 1.09], "out",
     np.r_[np.linspace(0.5e-9, 1.9e-9, 4), np.linspace(3e-9, 6.2e-9, 5),
           np.linspace(7.3e-9, 8e-9, 3)],
     (2.3e-9, 6.4e-9), None),
])
def test_fused_transient_matches_xla(circuits, name, pn, scale, node, rails,
                                     edges, sign):
    ct = circuits[name][1]
    key = _nl_key(ct)
    fused = _lanes_run(ct, key, pn, scale, 8e-9, "fused")
    ref = _lanes_run(ct, key, pn, scale, 8e-9, "xla")
    worst_rail = max(abs(f.interp(node, t) - r.interp(node, t))
                     for f, r in zip(fused, ref) for t in rails)
    worst_edge = max(abs(f.interp(node, t) - r.interp(node, t))
                     for f, r in zip(fused, ref) for t in edges)
    assert worst_rail < 5e-3, worst_rail
    assert worst_edge < 8e-2, worst_edge
    # the scatter reaches the kernel: lanes strictly ordered at the first
    # of the edge samples (a stronger device pulls the node further)
    mids = [float(f.interp(node, edges[0])) for f in fused]
    step = np.diff(mids)
    if sign is None:
        sign = -1 if mids[-1] < mids[0] else 1
    assert all(sign * d > 0.01 for d in step), mids


# ------------------------------------------------------------ resolve_impl

def _ladder(n):
    """A resistor ladder of n nodes behind a source and one VA diode: the
    fused kernel's shared memory per lane grows with n²."""
    dev = tload_va(VA_DIODE)["fdiode"]
    ckt = T.Circuit()
    nets = [ckt.net(f"n{i}") for i in range(n)]
    ckt.add(T.VSource, "V1", (nets[0], ckt.gnd), dict(dc=1.0))
    for i in range(n - 1):
        ckt.add(T.Resistor, f"R{i}", (nets[i], nets[i + 1]), dict(r=100.0))
    ckt.add(dev, "D1", (nets[-1], ckt.gnd), dict(is_=1e-14))
    return T.compile_circuit(ckt, device="cpu")


def test_resolve_impl_rules(circuits, monkeypatch):
    ct = circuits["diode"][1]
    ctx = T.SimSpec.make()
    cap = T.TranOptions(**BASE)
    # on the CPU "auto" stays on the loop engine and the exact solver
    r = ttran.resolve_impl(ct, cap, ctx, ct.params0)
    assert (r.newton_impl, r.dense_lu) == ("xla", "jax")
    # the CUDA rule, applied here to the plain version
    assert ttran.auto_newton_impl(ct, cap, ctx) == "fused"
    charge = T.TranOptions(**{**BASE, "formulation": "charge"})
    assert ttran.auto_newton_impl(ct, charge, ctx) == "xla"
    # a per-lane resistor value enters the constant G_lin: not fused, and
    # refused when asked for explicitly
    rk = [k for k in ct.group_order if k.startswith("Resistor")][0]
    ct2 = T.compile_circuit(ct.circuit, dynamic_params=("is_", "r"),
                            device="cpu")
    pr = {k: dict(g) for k, g in ct2.params0.items()}
    pr[rk]["r"] = torch.tensor([[1000.0], [1200.0]], dtype=torch.float64)
    assert ttran.auto_newton_impl(ct2, cap, ctx, pr) == "xla"
    with pytest.raises(fc.FusedEnvelopeError):
        T.tran(ct2, (0.0, 1e-9), params=pr, ctx=ctx,
               opts=T.TranOptions(**BASE, newton_impl="fused"))
    # any failure other than the envelope propagates
    def broken(*a, **k):
        raise RuntimeError("emit failed")
    monkeypatch.setattr(ttran, "get_fused_plan", broken)
    with pytest.raises(RuntimeError, match="emit failed"):
        ttran.auto_newton_impl(ct, cap, ctx)


def test_shared_memory_envelope():
    big = _ladder(170)
    ctx = T.SimSpec.make()
    cap = T.TranOptions(**BASE)
    assert ttran.auto_newton_impl(big, cap, ctx) == "xla"
    with pytest.raises(fc.FusedEnvelopeError, match="shared memory"):
        T.tran(big, (0.0, 1e-9), ctx=ctx,
               opts=T.TranOptions(**BASE, newton_impl="fused"))
    small = _ladder(40)
    assert ttran.auto_newton_impl(small, cap, ctx) == "fused"


def test_fused_envelope_of_the_corrector(circuits):
    ct = circuits["diode"][1]
    with pytest.raises(ValueError, match="cap-form"):
        T.tran(ct, (0.0, 1e-9), opts=T.TranOptions(
            **{**BASE, "formulation": "charge"}, newton_impl="fused"))
    with pytest.raises(ValueError, match="jac_reuse"):
        T.tran(ct, (0.0, 1e-9), opts=T.TranOptions(
            **{**BASE, "jac_reuse": 0}, newton_impl="fused"))
