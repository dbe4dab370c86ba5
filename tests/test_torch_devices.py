"""The port's built-in device library (cedarsim_tpu_torch/devices/, the
behavioral sources of frontend/behavioral.py) against the JAX package's, on
the CPU in float64.

- Every device class the port added: two instances with different
  parameters (so every parameter is a per-instance array) in a small
  circuit of each package, the JAX compiled params carried over to the port
  with ``utils/convert.params_from_numpy``; (S, Q) within rtol 1e-12 and
  the local Jacobians (G, C) within rtol 1e-10 at seeded numpy points:
  rail to rail, beyond it (junctions past the built-ins' ``_limexp``
  limit of 40 thermal voltages) and at ties of drain and source (the
  ``maximum``/``minimum`` half-and-half tangents), in the transient mode at
  seeded times and in the operating-point mode.
- The circuits of tests/test_basic.py::test_functional_devices (short,
  open and nonlinear resistor at DC; the nonlinear capacitor's transient
  against a tiny-step reference), of tests/test_jfet_mes.py's DC cases and
  the bipolar amplifier's bias point (tests/test_bipolar_amplifier.py):
  each on both packages, the operating points within 1e-9 V.
- ``_limexp`` of the built-ins takes 40, not the Verilog-A ``limexp``'s 80.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.devices import simple as jsimple
from cedarsim_tpu.devices.bjt import Bjt as JBjt
from cedarsim_tpu.devices.jfet import Jfet as JJfet, Mesfet as JMesfet
from cedarsim_tpu.devices.mos import Mos1 as JMos1
from cedarsim_tpu.frontend import behavioral as jbeh
from cedarsim_tpu.frontend.expr import parse_expr as jparse_expr
from cedarsim_tpu_torch.devices import simple as tsimple
from cedarsim_tpu_torch.frontend import behavioral as tbeh
from cedarsim_tpu_torch.utils.convert import params_from_numpy


class _Pkg:
    """One package's device classes under common names."""

    def __init__(self, P, simple, beh, mos, bjt, jfet, mesfet):
        self.P, self.simple, self.beh = P, simple, beh
        self.Mos1, self.Bjt, self.Jfet, self.Mesfet = mos, bjt, jfet, mesfet

    def __getattr__(self, name):
        return getattr(self.simple, name)


JP = _Pkg(J, jsimple, jbeh, JMos1, JBjt, JJfet, JMesfet)
TP = _Pkg(T, tsimple, tbeh, T.Mos1, T.Bjt, T.Jfet, T.Mesfet)

_NLR = {}


def _nl_classes(pk):
    """The nonlinear R and C factories' classes, one per package."""
    if id(pk) not in _NLR:
        _NLR[id(pk)] = (
            pk.nonlinear_resistor(lambda v: 1e-3 * v * v + 2e-4 * v, "NLR"),
            pk.nonlinear_capacitor(lambda v: 1e-12 * v * v * v, "NLC"))
    return _NLR[id(pk)]


def _bsource(pk, kind, text, label):
    ast = jparse_expr(text)
    probes = pk.beh.collect_probes(ast)
    return pk.beh.make_bsource(kind, ast, probes, {"gain": 1.5}, label), \
        probes


def _add(pk, ckt, name):
    """Two instances of class ``name`` on nets n0..n3 (and a control V
    source ``vc`` between n3 and ground where the class needs one)."""
    n = [ckt.net(f"n{i}") for i in range(4)]
    g = ckt.gnd
    if name in ("CCVS", "CCCS", "ISwitch"):
        ckt.add(pk.VSource, "vc", (n[3], g), dict(dc=0.3))
    if name == "Inductor":
        ckt.add(pk.Inductor, "a", n[:2], dict(l=1e-6))
        ckt.add(pk.Inductor, "b", n[1:3], dict(l=3e-6))
    elif name == "CoupledInductors":
        ckt.add(pk.CoupledInductors, "a", n, dict(l1=1e-6, l2=4e-6, k=0.9))
        ckt.add(pk.CoupledInductors, "b", (n[1], n[0], n[3], n[2]),
                dict(l1=2e-6, l2=1e-6, k=0.5))
    elif name in ("VSourceSIN", "ISourceSIN"):
        cls = getattr(pk, name)
        ckt.add(cls, "a", n[:2], dict(vo=0.5, va=1.0, freq=1e7, td=2e-9,
                                      theta=1e6, phase=30.0))
        ckt.add(cls, "b", n[1:3], dict(vo=-0.2, va=2.0, freq=3e7,
                                       dc=0.7))
    elif name in ("VSourceEXP", "ISourceEXP"):
        cls = getattr(pk, name)
        ckt.add(cls, "a", n[:2], dict(v1=0.0, v2=1.0, td1=5e-9, tau1=5e-9,
                                      td2=40e-9, tau2=10e-9))
        ckt.add(cls, "b", n[1:3], dict(v1=1.0, v2=-2.0, td1=1e-9,
                                       tau1=2e-9, td2=20e-9, tau2=3e-9))
    elif name == "ISource":
        ckt.add(pk.ISource, "a", n[:2], dict(dc=1e-3))
        ckt.add(pk.ISource, "b", n[1:3], dict(dc=-2e-3))
    elif name == "ISourcePWL":
        ckt.add(pk.ISourcePWL, "a", n[:2], dict(
            ts=(0.0, 1e-8, 3e-8, 5e-8), ys=(0.0, 1e-3, 1e-3, -1e-3)))
        ckt.add(pk.ISourcePWL, "b", n[1:3], dict(
            ts=(0.0, 2e-8, 4e-8, 6e-8), ys=(1e-3, 0.0, 2e-3, 0.0)))
    elif name == "ISourcePULSE":
        ckt.add(pk.ISourcePULSE, "a", n[:2], dict(
            v1=0.0, v2=1e-3, td=5e-9, tr=1e-9, tf=1e-9, pw=1e-8, per=3e-8))
        ckt.add(pk.ISourcePULSE, "b", n[1:3], dict(
            v1=1e-3, v2=-1e-3, td=2e-9, tr=2e-9, tf=3e-9, pw=5e-9,
            per=2e-8))
    elif name in ("VCVS", "VCCS", "VSwitch"):
        cls = getattr(pk, name)
        pa, pb = dict(VCVS=({"gain": 2.0}, {"gain": -0.5}),
                      VCCS=({"gm": 1e-3}, {"gm": 2e-2}),
                      VSwitch=(dict(ron=10.0, roff=1e6, vt=0.5, vh=0.2),
                               dict(ron=1.0, roff=1e9, vt=-0.3,
                                    vh=0.05)))[name]
        ckt.add(cls, "a", n, pa)
        ckt.add(cls, "b", (n[1], n[2], n[3], n[0]), pb)
    elif name in ("CCVS", "CCCS", "ISwitch"):
        cls = getattr(pk, name)
        pa, pb = dict(CCVS=({"r": 100.0}, {"r": -20.0}),
                      CCCS=({"f": 2.0}, {"f": 0.5}),
                      ISwitch=(dict(ron=10.0, roff=1e6, it=1e-3, ih=2e-4),
                               dict(ron=1.0, roff=1e8, it=-1e-3,
                                    ih=1e-3)))[name]
        ckt.add(cls, "a", n[:2], pa, ctrl="vc")
        ckt.add(cls, "b", n[1:3], pb, ctrl="vc")
    elif name == "Diode":
        ckt.add(pk.Diode, "a", n[:2], {"is": 1e-14, "cj0": 1e-12,
                                       "tt": 1e-9, "bv": 5.0})
        ckt.add(pk.Diode, "b", n[1:3], {"is": 3e-15, "cj0": 2e-12,
                                        "m": 0.33, "n": 1.5, "area": 2.0})
    elif name in ("OpenCircuit", "ShortCircuit"):
        ckt.add(getattr(pk, name), "a", n[:2], {})
        ckt.add(getattr(pk, name), "b", n[2:], {})
    elif name in ("NonlinearResistor", "NonlinearCapacitor"):
        cls = _nl_classes(pk)[name == "NonlinearCapacitor"]
        ckt.add(cls, "a", n[:2], {})
        ckt.add(cls, "b", n[1:3], {})
    elif name == "Mos1":
        ckt.add(pk.Mos1, "a", n, {"ptype": 1.0, "vto": 0.7, "kp": 1e-4,
                                  "gamma": 0.5, "lam": 0.05, "w": 2e-6,
                                  "l": 0.5e-6, "cgso": 1e-10, "cgdo": 1e-10,
                                  "cgbo": 1e-10, "cbd": 2e-15,
                                  "cbs": 3e-15, "is": 1e-14})
        ckt.add(pk.Mos1, "b", n, {"ptype": -1.0, "vto": -0.8, "gamma": 0.4,
                                  "lam": 0.02, "w": 4e-6, "l": 0.5e-6,
                                  "ld": 0.05e-6, "cbd": 2e-15, "cbs": 1e-15,
                                  "mj": 0.4, "is": 2e-14})
    elif name == "Bjt":
        ckt.add(pk.Bjt, "a", n, {"ptype": 1.0, "vaf": 50.0, "ikf": 0.1,
                                 "ise": 1e-15, "isc": 1e-14, "cje": 1e-12,
                                 "cjc": 5e-13, "cjs": 1e-13, "tf": 1e-10,
                                 "tr": 1e-8, "is": 1e-16})
        ckt.add(pk.Bjt, "b", n, {"ptype": -1.0, "var": 20.0, "ikr": 0.05,
                                 "bf": 50.0, "is": 2e-16})
    elif name in ("Jfet", "Mesfet"):
        cls = getattr(pk, name)
        pa = {"vto": -2.0, "beta": 1e-3, "lam": 0.02, "cgs": 1e-12,
              "cgd": 5e-13}
        pb = ({"ptype": -1.0, "vto": -1.5, "beta": 2e-3} if name == "Jfet"
              else {"ptype": -1.0, "alpha": 3.0, "b": 0.1})
        ckt.add(cls, "a", n[:3], pa)
        ckt.add(cls, "b", n[1:], pb)
    elif name == "BSource":
        bv, pv = _bsource(pk, "v", "gain*V(n2, n3) + sin(V(n3))*1e-1 "
                          "+ (V(n2) > 0.5 ? 0.2*V(n2)**2 : exp(V(n3)/2))",
                          "bv")
        bi, pi = _bsource(pk, "i", "1e-3*tanh(V(n0)) + 1e-4*I(vc)"
                          " + 1e-4*max(V(n1), 0.1) + 1e-5*sqrt(abs(V(n2))"
                          " + 1) + 2e-5*pwr(V(n3), 3)", "bi")
        ckt.add(pk.VSource, "vc", (n[3], g), dict(dc=0.3))
        ckt.add(bv, "a", n[:2], {}, kw_extras=pk.beh.probe_extras(
            pv, ckt.net, ""))
        ckt.add(bi, "b", n[1:3], {}, kw_extras=pk.beh.probe_extras(
            pi, ckt.net, ""))
    else:
        raise KeyError(name)


CLASSES = ["Inductor", "CoupledInductors", "VSourceSIN", "VSourceEXP",
           "ISource", "ISourcePWL", "ISourcePULSE", "ISourceSIN",
           "ISourceEXP", "VCVS", "VCCS", "CCVS", "CCCS", "VSwitch",
           "ISwitch", "Diode", "OpenCircuit", "ShortCircuit",
           "NonlinearResistor", "NonlinearCapacitor", "Mos1", "Bjt", "Jfet",
           "Mesfet", "BSource"]


def _points(n_x, n_nodes, rng, L=48):
    """Seeded states: node voltages rail to rail (-3..3 V), a quarter
    doubled (junctions far past 40 thermal voltages), an eighth with n2 on
    n0 (drain-source ties); branch currents of mA."""
    x = rng.uniform(-3.0, 3.0, (L, n_x))
    x[:, n_nodes:] *= 1e-3
    x[L // 4: L // 2, :n_nodes] *= 2.0
    x[: L // 8, 2] = x[: L // 8, 0]
    return x


def _jax_eval(cj, X, t, mode):
    ctx = J.SimSpec.make(gmin=1e-12).with_mode(mode)

    def one(x, tt):
        c = ctx.at_time(tt)
        S, Q = cj.residuals(x, c)
        G, C = cj.jacobians(x, c)
        return S, Q, G, C
    return [np.asarray(a) for a in jax.jit(jax.vmap(one))(
        jnp.asarray(X), jnp.asarray(t))]


@pytest.mark.parametrize("mode", ["tran", "dcop"])
@pytest.mark.parametrize("name", CLASSES)
def test_device_matches_jax(name, mode):
    cj_ckt, ct_ckt = J.Circuit(), T.Circuit()
    _add(JP, cj_ckt, name)
    _add(TP, ct_ckt, name)
    cj = J.compile_circuit(cj_ckt)
    ct = T.compile_circuit(ct_ckt, device="cpu")
    assert ct.x_names == cj.x_names and ct.group_order == cj.group_order
    # every leaf through the parameter carry-over
    pt = params_from_numpy({k: {pn: np.asarray(v) for pn, v in g.items()}
                            for k, g in cj.params0.items()}, device="cpu")
    rng = np.random.default_rng(CLASSES.index(name))
    X = _points(cj.n_x, cj.n_nodes, rng)
    t = (rng.uniform(0.0, 6e-8, X.shape[0]) if mode == "tran"
         else np.zeros(X.shape[0]))
    want = _jax_eval(cj, X, t, mode)
    ctx = T.SimSpec.make(gmin=1e-12).with_mode(mode)
    tt = torch.as_tensor(t) if mode == "tran" else 0.0
    got = [a.numpy() for a in ct.res_jacs_fwd(torch.as_tensor(X),
                                              ctx.at_time(tt), pt)]
    for what, a, b, rtol in zip("SQGC", got, want,
                                (1e-12, 1e-12, 1e-10, 1e-10)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=what)


def test_builtin_limexp_limit_is_40():
    """The built-ins' ``_limexp`` continues linearly past 40 (the JAX
    package's ``devices/simple.py:24``), not past the VA ``limexp``'s 80;
    value and tangent as the JAX function's at and around the limit."""
    from cedarsim_tpu_torch.core.dual import Dual
    x = np.array([39.0, 40.0, 41.0, 60.0, 85.0])
    want = np.asarray(jsimple._limexp(jnp.asarray(x)))
    dwant = np.asarray(jax.vmap(jax.grad(jsimple._limexp))(jnp.asarray(x)))
    got = tsimple._limexp(Dual(torch.as_tensor(x),
                               torch.ones(1, x.size, dtype=torch.float64)))
    np.testing.assert_allclose(got.v.numpy(), want, rtol=1e-15)
    np.testing.assert_allclose(got.d[0].numpy(), dwant, rtol=1e-15)
    assert got.v[3].item() == pytest.approx(np.exp(40.0) * 21.0, rel=1e-15)


# ------------------------------------------------------------- circuits

def _op(pk, ckt, ctx=None):
    comp = pk.P.compile_circuit(ckt, **({"device": "cpu"} if pk is TP
                                        else {}))
    r = pk.P.solve_dc(comp, ctx=ctx)
    assert bool(np.all(np.asarray(r.converged)))
    x = r.x.numpy() if pk is TP else np.asarray(r.x)
    return comp, dict(zip(comp.node_names, x))


def _functional(pk):
    NLR = pk.nonlinear_resistor(lambda v: 1e-3 * v * v)
    ckt = pk.P.Circuit()
    a, b, c_ = ckt.net("a"), ckt.net("b"), ckt.net("c")
    ckt.add(pk.VSource, "V1", (a, ckt.gnd), dict(dc=2.0))
    ckt.add(pk.Resistor, "R1", (a, b), dict(r=1000.0))
    ckt.add(pk.ShortCircuit, "S1", (b, c_), {})
    ckt.add(pk.OpenCircuit, "O1", (b, ckt.gnd), {})
    ckt.add(NLR, "N1", (c_, ckt.gnd), {})
    return ckt


def _nl_capacitor(pk):
    NLC = pk.nonlinear_capacitor(lambda v: 1e-9 * v * v * v)
    ck2 = pk.P.Circuit()
    vin, vo = ck2.net("vin"), ck2.net("vo")
    ck2.add(pk.VSource, "V1", (vin, ck2.gnd), dict(dc=2.0))
    ck2.add(pk.Resistor, "R1", (vin, vo), dict(r=1e3))
    ck2.add(NLC, "C1", (vo, ck2.gnd), {})
    ck2.ic("vo", 0.5)
    return ck2


def test_functional_devices():
    """tests/test_basic.py::test_functional_devices on both packages: the
    short merges nets, the open adds nothing, the nonlinear resistor
    solves (2−v)/1000 = 1e-3·v² at v = 1; the nonlinear capacitor's
    transient against the tiny-step reference and the JAX package's."""
    vals = []
    for pk in (JP, TP):
        _, v = _op(pk, _functional(pk))
        assert abs(v["b"] - 1.0) < 1e-6 and abs(v["c"] - 1.0) < 1e-6
        vals.append(v)
    for n in vals[0]:
        assert abs(vals[0][n] - vals[1][n]) <= 1e-9, n
    v, dt = 0.5, 1e-9
    for _ in range(int(3e-6 / dt)):
        v += dt * (2.0 - v) / (1e3 * 3e-9 * v * v)
    got = []
    for pk in (JP, TP):
        comp = pk.P.compile_circuit(_nl_capacitor(pk), **(
            {"device": "cpu"} if pk is TP else {}))
        sol = pk.P.tran(comp, (0.0, 1e-5), opts=pk.P.TranOptions(uic=True))
        assert sol.converged
        got.append(float(sol.interp("vo", 3e-6)))
        assert abs(got[-1] - v) < 5e-3 * max(1.0, abs(v)), (got[-1], v)
    assert abs(got[0] - got[1]) <= 1e-6


_JFET = """* jfet bias
VG g 0 DC {vgs}
VD vdd 0 DC {vdd}
RD vdd d {rd}
J1 d g 0 jn {area}
.model jn NJF (VTO=-2 BETA={beta} LAMBDA={lam})
.end
"""

_NETLISTS = {
    "jfet_sat": _JFET.format(vgs=-1.0, vdd=10.0, rd=100.0, area="",
                             beta=1e-3, lam=0.02),
    "jfet_triode": _JFET.format(vgs=-1.0, vdd=10.0, rd=20e3, area="",
                                beta=1e-3, lam=0.02),
    "jfet_cutoff": _JFET.format(vgs=-3.0, vdd=10.0, rd=100.0, area="",
                                beta=1e-4, lam=0.0),
    "jfet_area": _JFET.format(vgs=-1.0, vdd=10.0, rd=100.0, area="2",
                              beta=1e-4, lam=0.0),
    "pjf_mirror": """* pjf mirror
VG g 0 DC 1
VD vdd 0 DC -10
RD vdd d 100
J1 d g 0 jp
.model jp PJF (VTO=-2 BETA=1e-3 LAMBDA=0.02)
.end
""",
    "jfet_gate_junction": """* gate junction
VIN vin 0 DC 0.65
RS vin g 1000
J1 d g 0 jn
VD d 0 DC 0
.model jn NJF (VTO=-2 BETA=0 IS=1e-12)
.end
""",
    "mesfet_cubic": """* mes bias
VG g 0 DC -1
VD vdd 0 DC 10
RD vdd d 200
Z1 d g 0 mn
.model mn NMF (VTO=-2 BETA=2.5e-3 B=0.3 ALPHA=2 LAMBDA=0.05)
.end
""",
    "mesfet_sat": """* mes bias
VG g 0 DC -1
VD vdd 0 DC 8
RD vdd d 8000
Z1 d g 0 mn
.model mn NMF (VTO=-2 BETA=2.5e-3 B=0.3 ALPHA=2 LAMBDA=0.05)
.end
""",
    "pmf": """* pmf
VG g 0 DC 1
VD vdd 0 DC -6
RD vdd d 200
Z1 d g 0 mp
.model mp PMF (VTO=-2 BETA=2.5e-3 B=0.3 ALPHA=2)
.end
""",
    "bipolar_bias": """* bipolar common-emitter amplifier
.model BC546B npn ( IS=7.59E-15 VAF=73.4 BF=480 IKF=0.0962 NE=1.2665
+ ISE=3.278E-15 IKR=0.03 ISC=2.00E-13 NC=1.2 NR=1 BR=5 RC=0.25 CJC=6.33E-12
+ FC=0.5 MJC=0.33 VJC=0.65 CJE=1.25E-11 MJE=0.55 VJE=0.65 TF=4.26E-10
+ ITF=0.6 VTF=3 XTF=20 RB=100 IRB=0.0001 RBM=10 RE=0.5 TR=1.50E-07)
RLoad1 out 0 100k
R2 nb 0 10k
Q1 nc nb 0 BC546B
Vin1 vin 0 dc 0 ac 1 sin(0 1m 500)
Cin1 vin nb 10u
VCC1 vcc 0 5
R1 vcc nb 68k
Cout1 nc out 10u
R3 vcc nc 10k
.end
""",
}


@pytest.mark.parametrize("name", sorted(_NETLISTS))
def test_netlist_dc_matches_jax(name):
    """tests/test_jfet_mes.py's DC cases and the bipolar amplifier's bias
    point (tests/test_bipolar_amplifier.py:39) through both packages'
    parse → elaborate → compile → DC: every node within 1e-9 V."""
    import warnings
    vals = []
    for pk in (JP, TP):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ckt = pk.P.elaborate(pk.P.parse_spice(_NETLISTS[name]))
        ctx = pk.P.SimSpec.make(gmin=1e-12)
        vals.append(_op(pk, ckt, ctx)[1])
    assert vals[0].keys() == vals[1].keys()
    for n in vals[0]:
        assert abs(vals[0][n] - vals[1][n]) <= 1e-9, (n, vals[0][n],
                                                       vals[1][n])
    if name == "bipolar_bias":
        assert 0.5 < vals[1]["nb"] < 0.8 and 0.5 < vals[1]["nc"] < 4.5
    if name == "jfet_sat":
        vd = vals[1]["d"]
        assert abs((10.0 - vd) / 100.0 - 1e-3 * 1.0 * (1 + 0.02 * vd)) \
            < 1e-9
