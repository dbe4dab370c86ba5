"""The lossy lines in the port (the O element on an LTRA card, a cascade of
``devices/simple.py::LTRALine`` sections; the U element, a graded ladder)
against the JAX package on the CPU, the circuits of
``tests/test_ltra_urc.py`` through both.

- Elaboration: the same instances, section count and unknowns; the heavy
  loss link (R·LEN = 60 Ω) is 6 sections, 21 unknowns and 12 ring slots,
  with the JAX package's breakpoint schedule (169 times over 0–360 ns,
  the echo closure included).
- DC: the path resistance is exactly R·LEN; the operating points within
  1e-12 V of the JAX package's.
- AC: the exact RLCG two-port against an independent numpy solve of the
  node equations (2e-6), and the port's solution within 1e-12 of the JAX
  package's.
- Transient: the lossless link, the single-section and the six-section
  lossy links with the JAX package's accepted, rejected and Newton counts
  and waveforms within 1e-9 V; the first transit within 2 % of
  ``_first_transit`` and the settled level within 0.01 V of the divider;
  no ring lookup underflows.  The URC line's DC, its diffusion delay at
  N = 6 and 24 (0.38·RC), and the diode variant.
- O and U cards through ``simulate``.
"""

import numpy as np

import cedarsim_tpu as J
import cedarsim_tpu_torch as T

from tests.test_ltra_urc import (_ltra_netlist, _urc_netlist, _first_transit,
                                 Z0, TD, LTOT, CTOT)

OPTS = dict(rtol=1e-4, atol=1e-7, max_steps=32768)


def _comp(P, text):
    ckt = P.elaborate(P.parse_spice(text))
    if P is J:
        return J.compile_circuit(ckt)
    return T.compile_circuit(ckt, device="cpu")


def _tran_both(text, tstop, opts=OPTS):
    cj, ct = _comp(J, text), _comp(T, text)
    np.testing.assert_array_equal(ct.breakpoints(tstop),
                                  cj.breakpoints(tstop))
    sj = J.tran(cj, (0.0, tstop), opts=J.TranOptions(**opts))
    st = T.tran(ct, (0.0, tstop), opts=T.TranOptions(**opts))
    assert sj.converged and st.converged
    assert st.n_ring_underflow == 0
    assert (st.n_accepted, st.n_rejected, st.n_newton) == \
        (sj.n_accepted, sj.n_rejected, sj.n_newton)
    np.testing.assert_allclose(st.ts, sj.ts, rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(st.xs, sj.xs, rtol=0.0, atol=1e-9)
    return ct, st


def test_heavy_loss_link_elaborates_as_the_jax_package():
    text = _ltra_netlist(60.0, 50.0)
    cj, ct = _comp(J, text), _comp(T, text)
    names = [i.name for i in ct.circuit.instances]
    assert names == [i.name for i in cj.circuit.instances]
    assert len([n for n in names if "o1#s" in n]) == 6
    assert (ct.n_x, ct.n_dly, ct.n_ring, ct.n_lat) == \
        (cj.n_x, cj.n_dly, cj.n_ring, cj.n_lat) == (21, 12, 12, 0)
    bj = cj.breakpoints(360e-9)
    np.testing.assert_array_equal(ct.breakpoints(360e-9), bj)
    assert len(bj) == 169


def test_ltra_lossless_matches_ideal_line():
    _, st = _tran_both(_ltra_netlist(0.0, 50.0), 120e-9,
                       opts=dict(OPTS, max_steps=16384))
    assert abs(float(st.interp("b", 30e-9))) < 0.02
    assert abs(float(st.interp("b", 45e-9)) - 1.0) < 0.02
    assert abs(float(st.interp("a", 70e-9)) - 1.0) < 0.02


def test_ltra_dc_resistance_exact():
    for rtot in (8.0, 60.0):
        text = _ltra_netlist(rtot, 100.0, source="DC")
        xj = np.asarray(J.solve_dc(_comp(J, text)).x)
        ct = _comp(T, text)
        r = T.solve_dc(ct)
        assert bool(r.converged)
        np.testing.assert_allclose(r.x.numpy(), xj, rtol=0.0, atol=1e-12)
        vb = float(r.x[ct.node_names.index("b")])
        assert abs(vb - 2.0 * 100.0 / (50.0 + rtot + 100.0)) < 1e-8


def test_ltra_ac_exact_two_port():
    rtot, rl = 30.0, 75.0
    text = _ltra_netlist(rtot, rl, source="DC")
    freqs = np.array([1e6, 1 / (4 * TD), 1 / (2 * TD), 123.4e6])
    sj = J.ac(_comp(J, text), freqs)
    st = T.ac(_comp(T, text), freqs)
    np.testing.assert_allclose(st.v.numpy(), np.asarray(sj.v), rtol=0.0,
                               atol=1e-12)
    va, vb = st["a"], st["b"]
    for k, f in enumerate(freqs):
        s = 2j * np.pi * f
        zs, yp = rtot + s * LTOT, s * CTOT
        gl, zc = np.sqrt(zs * yp), np.sqrt(zs / yp)
        y11, y12 = 1.0 / (zc * np.tanh(gl)), -1.0 / (zc * np.sinh(gl))
        ref = np.linalg.solve(np.array([[1 / 50.0 + y11, y12],
                                        [y12, y11 + 1 / rl]]),
                              np.array([1 / 50.0, 0.0]))
        assert abs(va[k] - ref[0]) < 2e-6 * max(1.0, abs(ref[0]))
        assert abs(vb[k] - ref[1]) < 2e-6 * max(1.0, abs(ref[1]))


def test_ltra_transient_attenuation():
    rtot = 8.0
    _, st = _tran_both(_ltra_netlist(rtot, 50.0), 360e-9)
    vb_first = _first_transit(2.0, 50.0, 50.0, rtot, 1)
    assert abs(float(st.interp("b", 45e-9)) - vb_first) < 0.01 * vb_first
    vdc = 2.0 * 50.0 / (50.0 + rtot + 50.0)
    assert abs(float(st.interp("b", 350e-9)) - vdc) < 0.01


def test_ltra_heavy_loss_cascades_sections():
    """The lossy-link cell of the card smoke at one lane: 854 accepted, 0
    rejected, 882 Newton steps in the JAX package."""
    rtot, rl = 60.0, 50.0
    ct, st = _tran_both(_ltra_netlist(rtot, rl), 360e-9)
    k = len([i for i in ct.circuit.instances if "o1#s" in i.name])
    vb_first = _first_transit(2.0, 50.0, rl, rtot, k)
    got = float(st.interp("b", 37e-9))
    assert abs(got - vb_first) < 0.02 * vb_first
    assert abs(got - np.exp(-rtot / (2 * Z0))) < 0.05
    vdc = 2.0 * rl / (50.0 + rtot + rl)
    assert abs(float(st.interp("b", 350e-9)) - vdc) < 0.01


def test_urc_dc_exact():
    for rl, want, tol in (("1e12", 1.0, 1e-7), ("1e3", 0.5, 1e-7)):
        text = _urc_netlist(0.01, rl)
        xj = np.asarray(J.solve_dc(_comp(J, text)).x)
        ct = _comp(T, text)
        r = T.solve_dc(ct)
        assert bool(r.converged)
        np.testing.assert_allclose(r.x.numpy(), xj, rtol=0.0, atol=1e-12)
        assert abs(float(r.x[ct.node_names.index("b")]) - want) < tol


def test_urc_diffusion_delay_converges():
    length = 0.01
    rc = (1e5 * length) * (1e-7 * length)

    def t50(n):
        _, st = _tran_both(_urc_netlist(length, n=f"N={n}"), 3e-6)
        ts = np.linspace(0, 3e-6, 3001)
        vb = np.asarray(st.interp("b", ts))
        return ts[np.searchsorted(vb > 0.5, True)] - 1e-9

    a, b = t50(6), t50(24)
    assert abs(a - b) < 0.1 * b
    assert abs(b - 0.38 * rc) < 0.08 * rc


def test_urc_diode_variant_elaborates_and_blocks_dc():
    text = _urc_netlist(0.01, "1e3", isperl="ISPERL=1e-15 RSPERL=1e-3")
    ct = _comp(T, text)
    names = [i.name for i in ct.circuit.instances]
    assert names == [i.name for i in _comp(J, text).circuit.instances]
    assert any("#d" in n for n in names)
    r = T.solve_dc(ct)
    assert bool(r.converged)
    assert abs(float(r.x[ct.node_names.index("b")]) - 0.5) < 1e-6


def test_ltra_urc_end_to_end_simulate():
    text = """* lossy link
V1 vin 0 PULSE(0 2 10n 0.2n 0.2n 400n 1m)
RS vin a 50
O1 a 0 b 0 lmod
RL b 0 50
.model lmod LTRA (R=8 L=1.25u G=0 C=0.5n LEN=1)
.tran 1n 100n
"""
    sj = J.simulate(text)["tran"]
    st = T.simulate(text, device="cpu")["tran"]
    assert st.converged
    assert (st.n_accepted, st.n_rejected) == (sj.n_accepted, sj.n_rejected)
    assert abs(float(st.interp("b", 45e-9))
               - _first_transit(2.0, 50.0, 50.0, 8.0, 1)) < 0.01
    urc = """* rc line
V1 vin 0 DC 1 PULSE(0 1 1n 0.1n 0.1n 1m 2m)
U1 vin b 0 rcline L=0.01 N=6
RL b 0 1e12
.model rcline URC (K=2 FMAX=1G RPERL=1e5 CPERL=1e-7)
.tran 10n 1u
"""
    uj = J.simulate(urc)["tran"]
    ut = T.simulate(urc, device="cpu")["tran"]
    assert ut.converged
    assert (ut.n_accepted, ut.n_rejected) == (uj.n_accepted, uj.n_rejected)
