"""The corrector formulations (``tests/test_tran_formulation.py``), the
port against the JAX package on the CPU: the cap form's RC step within
0.02 V of its closed form, and on a diode's voltage-dependent junction
capacitance the charge and cap forms within 5e-3 V of each other; each
run with the JAX package's accepted and rejected steps and its waveform
within 1e-9 V.
"""

import math

import numpy as np

import cedarsim_tpu as J
import cedarsim_tpu_torch as T


def _rc(M, **kw):
    ckt = M.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(M.VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=0.0, v2=3.3, td=1e-6, tr=1e-9, tf=1e-9, pw=4e-6,
                 per=10e-6))
    ckt.add(M.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(M.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    return M.compile_circuit(ckt, **kw)


def _diode(M, **kw):
    ckt = M.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(M.VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=0.0, v2=0.6, td=1e-9, tr=1e-10, tf=1e-10, pw=40e-9,
                 per=100e-9))
    ckt.add(M.Resistor, "R1", (vin, vout), dict(r=10e3))
    ckt.add(M.Diode, "D1", (vout, ckt.gnd),
            {"is": 1e-14, "n": 1.5, "cj0": 5e-12, "vj": 0.7, "m": 0.4,
             "tt": 1e-9})
    return M.compile_circuit(ckt, **kw)


def _pair(build, tspan, form):
    sj = J.tran(build(J), tspan, opts=J.TranOptions(formulation=form))
    st = T.tran(build(T, device="cpu"), tspan,
                opts=T.TranOptions(formulation=form))
    assert st.converged and sj.converged
    assert (st.n_accepted, st.n_rejected) == (sj.n_accepted, sj.n_rejected)
    np.testing.assert_allclose(st["vout"], np.asarray(sj["vout"]), rtol=0,
                               atol=1e-9)
    return st


def test_cap_form_rc_matches_analytic():
    sol = _pair(_rc, (0.0, 20e-6), "cap")
    exact = 3.3 * (1 - math.exp(-(2e-6 - 1.0005e-6) / 1e-6))
    assert abs(float(sol.interp("vout", 2e-6)) - exact) < 0.02


def test_cap_vs_charge_nonlinear_capacitance():
    sols = {f: _pair(_diode, (0.0, 60e-9), f) for f in ("charge", "cap")}
    tgrid = np.linspace(2e-9, 58e-9, 40)
    va = np.interp(tgrid, sols["charge"].ts, sols["charge"]["vout"])
    vb = np.interp(tgrid, sols["cap"].ts, sols["cap"]["vout"])
    assert np.abs(va - vb).max() < 5e-3
