"""The lossless transmission line (T element, ``devices/simple.py::TLine``)
in the port against the JAX package on the CPU, the circuits of
``tests/test_tline.py`` through both.

- DC: the line is a short; the operating points within 1e-12 V.
- Transient (Branin's waves over the history ring): the matched link, the
  open end and the ringing staircase of a mismatched source with the JAX
  package's accepted, rejected and Newton counts, the waveforms within
  1e-9 V, and the JAX tests' closed-form gates on the port's run; the
  echo closure of the breakpoint schedule equal to the JAX package's; no
  ring lookup underflows.
- The cap-form chord path (BDF2, ``jac_reuse=1``: the JAX package's TPU
  configuration, here in float64) through the delay channel, with equal
  counts.
- AC: the exact two-port Y(f) (quarter- and half-wave dividers within
  1e-6 of the closed forms, the solutions within 1e-12 of the JAX
  package's), biased through the line's DC short.
- The T card through ``simulate`` and the ``F=``/``NL=`` timing.
"""

import numpy as np
import pytest

import cedarsim_tpu as J
import cedarsim_tpu_torch as T

Z0, TD = 50.0, 25e-9
OPTS = dict(rtol=1e-4, atol=1e-7, max_steps=16384)


def _link(P, rl, pulse=True, rs=Z0, pw=200e-9, per=1e-3):
    ckt = P.Circuit()
    vin, a, b = ckt.net("vin"), ckt.net("a"), ckt.net("b")
    if pulse:
        ckt.add(P.VSourcePULSE, "V1", (vin, ckt.gnd),
                dict(v1=0.0, v2=2.0, td=10e-9, tr=0.2e-9, tf=0.2e-9,
                     pw=pw, per=per))
    else:
        ckt.add(P.VSource, "V1", (vin, ckt.gnd), dict(dc=2.0, ac=1.0))
    ckt.add(P.Resistor, "RS", (vin, a), dict(r=rs))
    ckt.add(P.TLine, "T1", (a, ckt.gnd, b, ckt.gnd), dict(z0=Z0, td=TD))
    ckt.add(P.Resistor, "RL", (b, ckt.gnd), dict(r=rl))
    if P is J:
        return J.compile_circuit(ckt)
    return T.compile_circuit(ckt, device="cpu")


def _tran_both(rl, tstop, opts=OPTS, **kw):
    cj, ct = _link(J, rl, **kw), _link(T, rl, **kw)
    np.testing.assert_array_equal(ct.breakpoints(tstop),
                                  cj.breakpoints(tstop))
    sj = J.tran(cj, (0.0, tstop), opts=J.TranOptions(**opts))
    st = T.tran(ct, (0.0, tstop), opts=T.TranOptions(**opts))
    assert sj.converged and st.converged
    assert st.n_ring_underflow == 0
    assert (st.n_accepted, st.n_rejected, st.n_newton) == \
        (sj.n_accepted, sj.n_rejected, sj.n_newton)
    np.testing.assert_array_equal(st.ts, sj.ts)
    np.testing.assert_allclose(st.xs, sj.xs, rtol=0.0, atol=1e-9)
    return st


def test_tline_dc_is_short():
    xj = np.asarray(J.solve_dc(_link(J, Z0, pulse=False)).x)
    ct = _link(T, Z0, pulse=False)
    r = T.solve_dc(ct)
    assert bool(r.converged)
    x = r.x.numpy()
    np.testing.assert_allclose(x, xj, rtol=0.0, atol=1e-12)
    assert abs(x[ct.node_names.index("a")] - 1.0) < 1e-9
    assert abs(x[ct.node_names.index("b")] - 1.0) < 1e-9


def test_tline_matched_pure_delay():
    st = _tran_both(Z0, 120e-9)
    assert abs(float(st.interp("b", 30e-9))) < 0.02
    assert abs(float(st.interp("b", 45e-9)) - 1.0) < 0.02
    assert abs(float(st.interp("b", 110e-9)) - 1.0) < 0.02
    assert abs(float(st.interp("a", 70e-9)) - 1.0) < 0.02


def test_tline_open_end_reflection():
    st = _tran_both(1e9, 120e-9)
    assert abs(float(st.interp("b", 45e-9)) - 2.0) < 0.04
    assert abs(float(st.interp("a", 50e-9)) - 1.0) < 0.04
    assert abs(float(st.interp("a", 70e-9)) - 2.0) < 0.04


def test_tline_multiple_echo_staircase():
    """Rs = 10 Ω (Γs = −2/3) and an open end: the bounce diagram's levels
    at b after the first three arrivals."""
    rs = 10.0
    st = _tran_both(1e9, 150e-9, opts=dict(OPTS, max_steps=32768), rs=rs,
                    pw=1e-3, per=2e-3)
    gs = (rs - Z0) / (rs + Z0)
    w = 2.0 * Z0 / (Z0 + rs)
    vb, arrivals = 0.0, []
    for _ in range(3):
        vb += 2.0 * w
        arrivals.append(vb)
        w *= gs
    for t_probe, want in zip((45e-9, 95e-9, 145e-9), arrivals):
        assert abs(float(st.interp("b", t_probe)) - want) < 0.05


def test_tline_cap_form_chord():
    """The JAX package's TPU design point (cap-form BDF2, per-step chord
    Newton), in float64 on both sides, through the delay channel."""
    opts = dict(max_steps=16384, jac_reuse=1, newton_reltol=1e-4,
                newton_abstol=5e-7, res_tol=1e-3, jac_shunt=1e-7,
                res_rel=3e-5, rtol=1e-3, atol=1e-5, formulation="cap")
    st = _tran_both(Z0, 120e-9, opts=opts)
    assert abs(float(st.interp("b", 30e-9))) < 0.02
    assert abs(float(st.interp("b", 60e-9)) - 1.0) < 0.02


def test_tline_fused_engine_is_refused():
    ct = _link(T, Z0)
    with pytest.raises(ValueError, match="delay/latch channels"):
        T.tran(ct, (0.0, 20e-9), opts=T.TranOptions(
            newton_impl="fused", formulation="cap", jac_reuse=1))


def test_tline_ac_quarter_wave_transformer():
    rl = 25.0
    freqs = np.array([1.0 / (4 * TD), 1.0 / (2 * TD), 3.3e6])
    sj = J.ac(_link(J, rl, pulse=False), freqs)
    st = T.ac(_link(T, rl, pulse=False), freqs)
    np.testing.assert_allclose(st.v.numpy(), np.asarray(sj.v), rtol=0.0,
                               atol=1e-12)
    va = st["a"]
    zin_q, zin_h = Z0 ** 2 / rl, rl
    assert abs(abs(va[0]) - zin_q / (zin_q + Z0)) < 1e-6
    assert abs(abs(va[1]) - zin_h / (zin_h + Z0)) < 1e-6


def test_tline_ac_bias_is_dc_short():
    ckt = T.Circuit()
    vin, a, b = ckt.net("vin"), ckt.net("a"), ckt.net("b")
    ckt.add(T.VSource, "V1", (vin, ckt.gnd), dict(dc=2.0, ac=1.0))
    ckt.add(T.Resistor, "RS", (vin, a), dict(r=Z0))
    ckt.add(T.TLine, "T1", (a, ckt.gnd, b, ckt.gnd), dict(z0=Z0, td=TD))
    ckt.add(T.Capacitor, "CL", (b, ckt.gnd), dict(c=1e-12))
    comp = T.compile_circuit(ckt, device="cpu")
    sol = T.ac(comp, np.array([1e6]))
    assert abs(float(sol.op_x[comp.node_names.index("b")]) - 2.0) < 1e-6
    assert bool(np.all(np.isfinite(sol.v.numpy())))


def test_tline_netlist_card():
    text = """* tline card
V1 vin 0 PULSE(0 2 10n 0.2n 0.2n 200n 1m)
RS vin a 50
T1 a 0 b 0 Z0=50 TD=25n
RL b 0 50
.tran 1n 60n
"""
    sj = J.simulate(text)["tran"]
    st = T.simulate(text, device="cpu")["tran"]
    assert (st.n_accepted, st.n_rejected) == (sj.n_accepted, sj.n_rejected)
    assert abs(float(st.interp("b", 45e-9)) - 1.0) < 0.02
    comp = T.compile_circuit(T.elaborate(T.parse_spice("""* tline f card
V1 vin 0 DC 1
RS vin a 50
T1 a 0 b 0 Z0=50 F=10MEG
RL b 0 50
.end
""", file="t2.cir")), device="cpu")
    g = [comp.groups[k] for k in comp.group_order if "tline" in k.lower()][0]
    assert abs(float(g.static_params.get(
        "td", g.instances[0].params["td"])) - 25e-9) < 1e-15
