"""Sweeps and Monte-Carlo of the port (``analysis/sweeps.py``,
``analysis/montecarlo.py``, ``.dc`` in ``simulate``, ``mc_seed`` in the
elaborator) against the JAX package on the CPU in float64.

- The netlists and sweeps of ``tests/test_sweeps.py`` through both
  packages' ``dc_sweep``: the divider over one parameter, a product of two,
  temperature with a resistor's ``tc1``, the PULSE source's ``dc`` (its
  ``$given`` flag turns on); a temperature sweep of the level-1 CMOS
  inverter, of a Verilog-A diode and of the netlist with every built-in
  card (the diode, BJT, JFET and MESFET read the temperature).  Every operating point within 1e-9 V
  of the JAX package's, as ``tests/test_torch_dc.py`` holds them.
- The combinators, ``split_axes``, ``find_param_ranges`` and
  ``data_sweep`` (over a ``.data`` table) give what the JAX package's
  give.
- Monte-Carlo: ``mc_solve`` on the JAX package's own draws (its
  ``scatter_params``, carried across as numpy) lane by lane within 1e-9 V;
  the port's own draws (a ``torch.Generator``) meet the JAX test's mean
  and spread bounds and repeat bitwise for a seed.
- ``mc_seed``: ``statistics_params`` on a SPICE netlist with ``agauss``,
  ``gauss``, ``aunif`` and ``unif`` gives bitwise the JAX package's
  parameters for every seed, and a draw that flips an ``.if`` raises.
- ``.dc`` through ``simulate``: the JAX package's points and values.
- A per-lane temperature never takes the fused engine.
"""

import warnings

import numpy as np
import pytest
import torch

import jax

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis import montecarlo as jmc
from cedarsim_tpu.analysis import sweeps as jsw
from cedarsim_tpu.frontend.elaborate import load_spice as jload
from cedarsim_tpu_torch.analysis import montecarlo as tmc
from cedarsim_tpu_torch.analysis import sweeps as tsw
from cedarsim_tpu_torch.frontend.elaborate import load_spice as tload

#: operating points of the two packages (tests/test_torch_dc.py)
DC_TOL = 1e-9

DIVIDER = """* divider
V1 vin 0 1
R1 vin vmid 1k
R2 vmid 0 1k
.op
"""
DIVIDER2 = """* divider2
V1 vin 0 {vv}
R1 vin vmid 1k
R2 vmid 0 1k
.param vv=1
.op
"""
TEMP_DIVIDER = """* temp divider
V1 vin 0 1
R1 vin vmid 1k tc1=0.002 tnom=27
R2 vmid 0 1k
.op
"""
INVERTER = """* cmos inverter at its switching point
.model n1 nmos (level=1 vto=0.7 kp=100u is=1e-14)
.model p1 pmos (level=1 vto=-0.7 kp=40u is=1e-14)
vdd vdd 0 3.3
vin in 0 1.5
mp out in vdd vdd p1 w=2u l=0.35u
mn out in 0 0 n1 w=1u l=0.35u
.op
"""
VA_DIODE = """
module tdiode(a, c);
  inout a, c;
  electrical a, c;
  parameter real is_ = 1e-14 from (0:1];
  parameter real n = 1.0;
  parameter real xti = 3.0;
  real id, vd, isat;
  analog begin
    vd = V(a, c);
    isat = is_ * pow($temperature / 300.15, xti / n);
    if (vd > -5.0 * n * $vt)
      id = isat * (limexp(vd / (n * $vt)) - 1.0);
    else
      id = -isat;
    I(a, c) <+ id;
  end
endmodule
"""
TEMPS = [-40.0, 27.0, 85.0, 125.0]


def _pair(text):
    return (J.compile_circuit(jload(text)),
            T.compile_circuit(tload(text), device="cpu"))


def _x(res):
    return np.asarray(res.x.cpu() if isinstance(res.x, torch.Tensor)
                      else res.x)


def _agree(rj, rt):
    assert np.asarray(rj.converged).all() and bool(rt.converged.all())
    np.testing.assert_allclose(_x(rt), _x(rj), rtol=0, atol=DC_TOL)


def test_combinators_match_jax():
    for mod in (jsw, tsw):
        s1, s2 = mod.Sweep("a", [1, 2]), mod.Sweep("b", [10, 20, 30])
        prod = mod.ProductSweep(s1, s2)
        assert len(prod) == 6 and list(prod)[-1] == {"a": 2, "b": 30}
        tand = mod.TandemSweep(mod.Sweep("a", [1, 2, 3]),
                               mod.Sweep("b", [4, 5, 6]))
        assert list(tand)[1] == {"a": 2, "b": 5}
        ser = mod.SerialSweep(s1, s2)
        assert len(ser) == 5 and list(ser)[2] == {"b": 10}
        assert len(mod.sweepify({"a": [1, 2], "b": [3]})) == 2
    js = jsw.ProductSweep(jsw.Sweep("r", [1.0, 2.0, 3.0]), jsw.SerialSweep(
        jsw.Sweep("c", [5.0]), jsw.Sweep("c", [9.0])))
    ts = tsw.ProductSweep(tsw.Sweep("r", [1.0, 2.0, 3.0]), tsw.SerialSweep(
        tsw.Sweep("c", [5.0]), tsw.Sweep("c", [9.0])))
    assert tsw.find_param_ranges(ts) == jsw.find_param_ranges(js) \
        == {"r": (1.0, 3.0, 3), "c": (5.0, 9.0, 2)}
    o, i = tsw.split_axes(tsw.ProductSweep(tsw.Sweep("a", [1, 2]),
                                           tsw.Sweep("b", [3])), ["a"])
    assert (o.name, i.name) == ("a", "b")
    with pytest.raises(ValueError, match="ProductSweep"):
        tsw.split_axes(tand, ["a"])
    data = DIVIDER + ".data tbl r1 r2\n1k 1k 1k 3k 3k 1k\n.enddata\n"
    tpts, jpts = (list(m.data_sweep(load(data), "tbl"))
                  for m, load in ((tsw, tload), (jsw, jload)))
    assert tpts == jpts == [{"r1": 1000.0, "r2": 1000.0},
                            {"r1": 1000.0, "r2": 3000.0},
                            {"r1": 3000.0, "r2": 1000.0}]
    with pytest.raises(KeyError, match="nope"):
        tsw.data_sweep(tload(data), "nope")


@pytest.mark.parametrize("case", ["divider", "product", "temp_tc1"])
def test_dc_sweep_matches_jax(case):
    text, sweep = {
        "divider": (DIVIDER, ("r2.r", [500.0, 1000.0, 2000.0, 4000.0])),
        "product": (DIVIDER2, (("v1.dc", [1.0, 2.0]),
                               ("r1.r", [1e3, 3e3]))),
        "temp_tc1": (TEMP_DIVIDER, ("temp", [27.0, 77.0, 127.0])),
    }[case]
    cj, ct = _pair(text)

    def mk(mod):
        if case == "product":
            return mod.ProductSweep(*[mod.Sweep(*s) for s in sweep])
        return mod.Sweep(*sweep)
    rj = jsw.dc_sweep(cj, mk(jsw))
    rt = tsw.dc_sweep(ct, mk(tsw))
    _agree(rj, rt)
    v = rt["vmid"].numpy()
    if case == "divider":
        r2 = np.asarray(sweep[1])
        np.testing.assert_allclose(v, r2 / (1e3 + r2), rtol=1e-8)
    elif case == "temp_tc1":
        r1 = 1e3 * (1 + 0.002 * (np.asarray(sweep[1]) - 27.0))
        np.testing.assert_allclose(v, 1e3 / (r1 + 1e3), rtol=1e-8)
        assert rt.ctx.temp.shape == (3,)


def test_sweep_dc_on_wave_source_flips_given():
    """A swept ``dc`` of a PULSE source is given (in DC mode the source
    takes its wave's t=0 value unless ``dc`` is given)."""
    from cedarsim_tpu.core.compile import ensure_dynamic as jdyn
    from cedarsim_tpu_torch.core.compile import ensure_dynamic as tdyn
    comps = []
    for P in (J, T):
        ckt = P.Circuit()
        vin, mid = ckt.net("vin"), ckt.net("mid")
        ckt.add(P.VSourcePULSE, "V1", (vin, ckt.gnd),
                dict(v1=0.0, v2=5.0, td=1e-9, tr=1e-9, tf=1e-9, pw=1e-6,
                     per=2e-6))
        ckt.add(P.Resistor, "R1", (vin, mid), dict(r=1e3))
        ckt.add(P.Resistor, "R2", (mid, ckt.gnd), dict(r=1e3))
        comps.append(ckt)
    cj = jdyn(J.compile_circuit(comps[0]), ["V1.dc"])
    ct = tdyn(T.compile_circuit(comps[1], device="cpu"), ["V1.dc"])
    vals = np.array([0.0, 1.0, 2.0])
    rj = jsw.dc_sweep(cj, jsw.Sweep("V1.dc", vals),
                      ctx=J.SimSpec.make(gmin=1e-12))
    rt = tsw.dc_sweep(ct, tsw.Sweep("V1.dc", vals),
                      ctx=T.SimSpec.make(gmin=1e-12))
    _agree(rj, rt)
    np.testing.assert_allclose(rt["mid"].numpy(), vals / 2, atol=1e-9)


@pytest.mark.parametrize("device", ["inverter_mos1", "va_diode",
                                    "all_cards"])
def test_temperature_sweep_matches_jax(device):
    if device == "inverter_mos1":
        cj, ct = _pair(INVERTER)
    elif device == "all_cards":
        # every built-in card that reads the temperature: the diode, the
        # BJT, the JFET and the MESFET beside R, L, K, the sources
        from cedarsim_tpu_torch.benchmarks import netlists
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cj, ct = _pair(netlists.ALL_CARDS)
    else:
        from cedarsim_tpu.va.codegen import load_va as jva
        from cedarsim_tpu_torch.va.codegen import load_va as tva
        comps = []
        for P, lv in ((J, jva), (T, tva)):
            ckt = P.Circuit()
            a, b = ckt.net("a"), ckt.net("b")
            ckt.add(P.VSource, "V1", (a, ckt.gnd), dict(dc=5.0))
            ckt.add(P.Resistor, "R1", (a, b), dict(r=1000.0))
            ckt.add(lv(VA_DIODE)["tdiode"], "D1", (b, ckt.gnd),
                    dict(is_=1e-14))
            comps.append(ckt)
        cj = J.compile_circuit(comps[0])
        ct = T.compile_circuit(comps[1], device="cpu")
    rj = jsw.dc_sweep(cj, jsw.Sweep("temp", TEMPS))
    rt = tsw.dc_sweep(ct, tsw.Sweep("temp", TEMPS))
    _agree(rj, rt)
    # each point is the point solved alone at its temperature
    for i, tc in enumerate(TEMPS):
        one = T.solve_dc(ct, ctx=T.SimSpec.make(temp_c=tc))
        np.testing.assert_allclose(rt.x[i].numpy(), one.x.numpy(), rtol=0,
                                   atol=DC_TOL)
    if device == "va_diode":
        vb = rt["b"].numpy()
        # this model has no bandgap term: the drop rises with n·Vt
        assert np.all(np.diff(vb) > 0.01)


def test_per_lane_temperature_never_fuses():
    from cedarsim_tpu_torch.analysis import tran as ttran
    from cedarsim_tpu_torch.ops.fused_chord import FusedEnvelopeError
    from cedarsim_tpu_torch.va.codegen import load_va as tva
    ckt = T.Circuit()
    a, b = ckt.net("a"), ckt.net("b")
    ckt.add(T.VSource, "V1", (a, ckt.gnd), dict(dc=1.0))
    ckt.add(T.Resistor, "R1", (a, b), dict(r=1000.0))
    ckt.add(tva(VA_DIODE)["tdiode"], "D1", (b, ckt.gnd), dict(is_=1e-14))
    ct = T.compile_circuit(ckt, device="cpu")
    opts = T.TranOptions(formulation="cap", jac_reuse=1)
    one = T.SimSpec.make()
    assert ttran.auto_newton_impl(ct, opts, one) == "fused"
    lanes = one.replace(temp=torch.tensor([300.0, 350.0],
                                          dtype=torch.float64))
    assert ttran.auto_newton_impl(ct, opts, lanes) == "xla"
    with pytest.raises(FusedEnvelopeError, match="temperature"):
        ttran.fused_plan_for(ct, lanes)


def test_mc_dc_on_the_jax_draws():
    """The JAX package's scatter (jax.random) carried across as numpy:
    the port solves every lane to the JAX package's point."""
    cj, ct = _pair(DIVIDER)
    n = 64
    dist = {"r2.r": ("rel", 0.05), "r1.r": 30.0}
    cj2, bpj = jmc.scatter_params(cj, n, dist, jax.random.PRNGKey(5))
    rj = jmc._mc_solve(cj2, bpj, n, J.core.compile.default_ctx(cj2),
                       J.analysis.dc.default_newton_options(cj2), "dcop",
                       True)
    from cedarsim_tpu_torch.core.compile import ensure_dynamic
    ct2 = ensure_dynamic(ct, list(dist))
    bpt = {k: {pn: torch.as_tensor(np.array(v), dtype=torch.float64)
               for pn, v in g.items()} for k, g in bpj.items()}
    rt = tmc.mc_solve(ct2, bpt)
    _agree(rj, rt)
    assert tuple(rt.x.shape) == (n, ct.n_x)


def test_mc_dc_own_draws():
    """The port's own draws meet the bounds of the JAX package's test
    (tests/test_sweeps.py::test_monte_carlo_dc) and repeat bitwise."""
    ct = T.compile_circuit(tload(DIVIDER), device="cpu")
    n = 256
    res = tmc.mc_dc(ct, n, {"r2.r": ("rel", 0.05)}, seed=3)
    assert bool(res.converged.all())
    v = res["vmid"].numpy()
    assert abs(v.mean() - 0.5) < 0.005
    assert 0.006 < v.std() < 0.02
    again = tmc.mc_dc(ct, n, {"r2.r": ("rel", 0.05)}, seed=3)
    assert torch.equal(again.x, res.x)
    other = tmc.mc_dc(ct, n, {"r2.r": ("rel", 0.05)}, seed=4)
    assert not torch.equal(other.x, res.x)
    # the draws land where the solution says: vmid = r2 / (r1 + r2)
    _, bp = tmc.scatter_params(ct, n, {"r2.r": ("rel", 0.05)}, seed=3)
    key = [k for k in bp if "r2" in
           [i.name for i in ct.groups[k].instances]][0]
    j = [i.name for i in ct.groups[key].instances].index("r2")
    r2 = bp[key]["r"][:, j].numpy()
    np.testing.assert_allclose(v, r2 / (1e3 + r2), rtol=1e-9)


AGAUSS = """* monte-carlo draws at elaboration
.param rv={agauss(1k, 100, 1)}
.param gv={gauss(2k, 0.1, 1)}
.subckt leg a b
r1 a m {agauss(500, 50, 1)}
r2 m b {aunif(300, 30)}
.ends
v1 a 0 1
ra a b {rv}
rb b 0 {gv}
x1 b c leg
x2 c 0 leg
rc c 0 {unif(1k, 0.2)}
.op
"""


def test_statistics_params_bitwise_jax():
    from cedarsim_tpu.frontend.parser import parse_spice as jparse
    n, seed = 6, 17
    cj, bpj = jmc.statistics_params(jparse(AGAUSS), n, seed=seed)
    ct, bpt = tmc.statistics_params(T.parse_spice(AGAUSS), n, seed=seed,
                                    device="cpu")
    assert ct.group_order == cj.group_order
    for key in cj.group_order:
        assert set(bpt[key]) == set(bpj[key])
        for pn, v in bpj[key].items():
            a, b = bpt[key][pn].numpy(), np.asarray(v)
            assert a.shape == b.shape and \
                np.array_equal(a.view(np.int64), b.view(np.int64)), \
                (key, pn)
    # every seed's elaboration alone: the same bits
    for i in range(n):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ej = J.elaborate(jparse(AGAUSS), mc_seed=seed + i)
            et = T.elaborate(T.parse_spice(AGAUSS), mc_seed=seed + i)
        for ij, it in zip(ej.instances, et.instances):
            assert ij.name == it.name
            for pn, v in ij.params.items():
                assert np.asarray(it.params[pn]).tobytes() == \
                    np.asarray(v).tobytes(), (i, ij.name, pn)
    rj = jmc.mc_statistics(jparse(AGAUSS), n, seed=seed)
    rt = tmc.mc_statistics(T.parse_spice(AGAUSS), n, seed=seed,
                           device="cpu")
    _agree(rj, rt)


def test_statistics_structure_change_rejected():
    code = """* structure flip
.param g={agauss(0,1,1)}
v1 a 0 1
.if (g > 0)
r1 a 0 1k
.else
c1 a 0 1n
.endif
.end
"""
    with pytest.raises(ValueError, match="structure"):
        tmc.statistics_params(T.parse_spice(code), 16, seed=0,
                              device="cpu")
    # without a seed the draws take their nominal value: g = 0
    assert [i.name for i in T.elaborate(T.parse_spice(code)).instances] \
        == ["v1", "c1"]


@pytest.mark.parametrize("card", [".dc v1 0 1 0.25",
                                  ".dc v1 0 1 0.5 v2 1 2 1"])
def test_dc_directive_matches_jax(card):
    text = f"* dc\nv1 a 0 1\nv2 c 0 1\nr1 a b 1k\nr2 b c 2k\n{card}\n"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rj = J.simulate(text)
        rt = T.simulate(text, device="cpu")
    assert list(rt["dc_sweep"]) == [
        {k: pytest.approx(v) for k, v in p.items()} for p in rj["dc_sweep"]]
    _agree(rj["dc"], rt["dc"])
    assert len(rt["dc"].x) == len(rj["dc_sweep"])


def test_simulate_mc_seed_matches_jax():
    text = "* mc\nv1 a 0 1\nr1 a b {agauss(1k, 100, 1)}\nr2 b 0 1k\n.op\n"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rj = J.simulate(text, mc_seed=9)
        rt = T.simulate(text, device="cpu", mc_seed=9)
    np.testing.assert_allclose(rt["op"].x.numpy(), np.asarray(rj["op"].x),
                               rtol=0, atol=DC_TOL)
    assert abs(float(rt["op"]["b"]) - 0.5) > 1e-6     # a draw, not nominal
