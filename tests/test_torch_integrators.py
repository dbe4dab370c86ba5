"""The BDF3/BDF5 ladder of the port (``analysis/tran.py``) against the JAX
package's on the CPU in float64: ``tests/test_integrators.py``'s BDF3 and
BDF5 cases.

- Each transient runs through both packages with the same circuit and
  options: the same accepted and rejected steps and Newton iterations,
  every unknown within 1e-9 of the JAX package's at its accepted points
  (the two take the same steps, so only rounding parts them), and the
  reference test's closed-form gate: the RC step, the underdamped RLC
  (Q ~ 20), the two-decade stiff split and the third-order Butterworth
  ladder, and BDF5's step-count cut against BDF2 at rtol 1e-5.
- ``bdf_alphas`` at uniform spacing gives the textbook BDF coefficients of
  orders 1-5 (``test_bdf5_uniform_alphas``).
- Both ladders through the fused chord engine's plain version (the cap
  form, ``jac_reuse=1``: what B1 runs on the card) with the counts of the
  JAX package's chord path on the stiff circuit (all linear: the fused
  plan with no nonlinear group).
- A bdf5 checkpoint carries the fifth history point (``x4``/``t4``); two
  windows chained through it, and through a checkpoint without it (the JAX
  package's layout, seeded as the JAX package seeds it), give the JAX
  package's counts in each window.
"""

import math

import numpy as np
import pytest
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.analysis import tran as ttran

#: the waveforms of two runs that take the same steps
WAVE_ATOL = 1e-9


def _pulse(P, ckt, node, tr=1e-9, td=0.0, pw=1.0, per=2.0):
    ckt.add(P.VSourcePULSE, "V1", (node, ckt.gnd),
            dict(v1=0.0, v2=1.0, td=td, tr=tr, tf=tr, pw=pw, per=per))


def _rc(P):
    ckt = P.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    _pulse(P, ckt, vin)
    ckt.add(P.Resistor, "R1", (vin, vout), dict(r=1e3))
    ckt.add(P.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    return ckt


def _rlc(P):
    ckt = P.Circuit()
    vin, mid, vout = ckt.net("vin"), ckt.net("mid"), ckt.net("vout")
    _pulse(P, ckt, vin)
    ckt.add(P.Resistor, "R1", (vin, mid), dict(r=5.0))
    ckt.add(P.Inductor, "L1", (mid, vout), dict(l=1e-6))
    ckt.add(P.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    return ckt


def _stiff(P):
    ckt = P.Circuit()
    vin, a, b = ckt.net("vin"), ckt.net("a"), ckt.net("b")
    _pulse(P, ckt, vin, td=1e-6)
    ckt.add(P.Resistor, "R1", (vin, a), dict(r=1e3))
    ckt.add(P.Capacitor, "C1", (a, ckt.gnd), dict(c=1e-9))
    ckt.add(P.Resistor, "R2", (a, b), dict(r=1e6))
    ckt.add(P.Capacitor, "C2", (b, ckt.gnd), dict(c=1e-8))
    return ckt


def _butterworth(P):
    ckt = P.Circuit()
    vin, n1, vout = ckt.net("vin"), ckt.net("n1"), ckt.net("vout")
    _pulse(P, ckt, vin, tr=1e-6, pw=1e3, per=2e3)
    ckt.add(P.Inductor, "L1", (vin, n1), dict(l=1.5))
    ckt.add(P.Capacitor, "C2", (n1, ckt.gnd), dict(c=4.0 / 3.0))
    ckt.add(P.Inductor, "L3", (n1, vout), dict(l=0.5))
    ckt.add(P.Resistor, "R4", (vout, ckt.gnd), dict(r=1.0))
    return ckt


def _counts(s):
    return (s.n_accepted, s.n_rejected, s.n_newton)


def _both(build, span, **kw):
    """(port solution, JAX solution) of one transient, with equal counts
    and waveforms."""
    st = T.tran(T.compile_circuit(build(T), device="cpu"), span,
                opts=T.TranOptions(**kw))
    sj = J.tran(J.compile_circuit(build(J)), span, opts=J.TranOptions(**kw))
    assert st.converged and sj.converged
    assert _counts(st) == _counts(sj), (kw, _counts(st), _counts(sj))
    _same_wave(st, sj)
    return st, sj


def _same_wave(st, sj):
    """Every unknown of the port's waveform, interpolated at the JAX
    package's accepted times, within ``WAVE_ATOL`` of the JAX package's."""
    tj, xj = np.asarray(sj.ts), np.asarray(sj.xs)
    for col in range(xj.shape[1]):
        got = np.interp(tj, st.ts, st.xs[:, col])
        np.testing.assert_allclose(got, xj[:, col], rtol=0.0,
                                   atol=WAVE_ATOL, err_msg=str(col))


@pytest.mark.parametrize("method", ["bdf3", "bdf5"])
def test_rc_step_closed_form(method):
    st, _ = _both(_rc, (0.0, 5e-6), method=method)
    for t in (1e-6, 2e-6, 3e-6):
        want = 1.0 - math.exp(-(t - 1e-9) / 1e-6)
        assert abs(float(st.interp("vout", t)) - want) < 0.005, (method, t)


def test_rlc_ringing_amplitude():
    st, _ = _both(_rlc, (0.0, 2e-6), method="bdf3", rtol=1e-4, atol=1e-7,
                  max_steps=16384)
    w0 = 1.0 / math.sqrt(1e-6 * 1e-9)
    alpha = 5.0 / (2 * 1e-6)
    wd = math.sqrt(w0 * w0 - alpha * alpha)
    for t in np.linspace(2e-7, 1.4e-6, 7):
        want = 1.0 - math.exp(-alpha * t) * (
            math.cos(wd * t) + alpha / wd * math.sin(wd * t))
        assert abs(float(st.interp("vout", t)) - want) < 0.02, t


def test_stiff_two_time_constants():
    st, _ = _both(_stiff, (0.0, 30e-3), method="bdf3")
    for t in (5e-3, 10e-3, 25e-3):
        want = 1.0 - math.exp(-t / 1e-2)
        assert abs(float(st.interp("b", t)) - want) < 0.02, t
    assert abs(float(st.interp("a", 20e-3)) - 1.0) < 1e-3
    assert st.n_accepted < 2000


def test_butterworth_transient_vs_inverse_laplace():
    st, _ = _both(_butterworth, (0.0, 12.0), method="bdf3", rtol=1e-5,
                  atol=1e-8, max_steps=32768)
    s3 = math.sqrt(3.0)
    for t in np.linspace(0.5, 11.5, 12):
        want = 1.0 - math.exp(-t) - (2.0 / s3) * math.exp(-t / 2.0) \
            * math.sin(s3 * t / 2.0)
        assert abs(float(st.interp("vout", t)) - want) < 2e-3, t


def test_bdf5_uniform_alphas():
    """The port's coefficients at uniform spacing: the textbook BDF values
    of orders 1-5 (order 5: 137/60, -5, 5, -10/3, 5/4, -1/5)."""
    ts = [torch.tensor([v], dtype=torch.float64)
          for v in (5.0, 4.0, 3.0, 2.0, 1.0, 0.0)]
    h = torch.ones(1, dtype=torch.float64)
    want = {
        1: [1.0, -1.0],
        2: [1.5, -2.0, 0.5],
        3: [11 / 6, -3.0, 1.5, -1 / 3],
        4: [25 / 12, -4.0, 3.0, -4 / 3, 1 / 4],
        5: [137 / 60, -5.0, 5.0, -10 / 3, 5 / 4, -1 / 5],
    }
    for k, w in want.items():
        got = [float(a) for a in ttran.bdf_alphas(ts, h, k)]
        assert np.allclose(got, w, rtol=0, atol=1e-12), (k, got, w)


def test_bdf5_step_count_reduction():
    counts = {}
    for method in ("bdf2", "bdf5"):
        st, _ = _both(_stiff, (0.0, 30e-3), method=method, rtol=1e-5)
        for t in (5e-3, 10e-3, 25e-3):
            want = 1.0 - math.exp(-t / 1e-2)
            assert abs(float(st.interp("b", t)) - want) < 0.02, (method, t)
        counts[method] = st.n_accepted
    assert counts["bdf5"] < 0.85 * counts["bdf2"], counts


@pytest.mark.parametrize("method", ["bdf3", "bdf5"])
def test_fused_engine_ladder(method):
    """The cap form through the fused chord engine (its plain version on
    the CPU; B1 on the card) on an all-linear circuit, with the counts of
    the JAX package's per-step chord (``newton_impl="xla"``) under the
    same options.  (The JAX package's own fused kernel, in interpret
    mode, takes 200 Newton iterations over bdf3 here against 197 of both
    chord paths.)"""
    kw = dict(method=method, formulation="cap", jac_reuse=1, rtol=1e-4)
    st = T.tran(T.compile_circuit(_stiff(T), device="cpu"), (0.0, 30e-3),
                opts=T.TranOptions(newton_impl="fused", **kw))
    sj = J.tran(J.compile_circuit(_stiff(J)), (0.0, 30e-3),
                opts=J.TranOptions(newton_impl="xla", **kw))
    assert st.converged and sj.converged
    assert _counts(st) == _counts(sj)
    _same_wave(st, sj)


def test_bdf5_checkpoint_round_trip():
    """Two bdf5 windows: the port's checkpoint holds ``x4``/``t4``; the
    second window from it, and from the same checkpoint without them
    (seeded at ``x3``/``t3``, the ladder capped at order 4), gives the JAX
    package's counts and waveform."""
    kw = dict(method="bdf5", rtol=1e-5)
    ct = T.compile_circuit(_stiff(T), device="cpu")
    cj = J.compile_circuit(_stiff(J))
    t1 = T.tran(ct, (0.0, 4e-3), opts=T.TranOptions(**kw))
    j1 = J.tran(cj, (0.0, 4e-3), opts=J.TranOptions(**kw))
    assert set(t1.checkpoint) == set(ttran.CHECKPOINT_FIELDS) | {"x4", "t4"}
    assert set(j1.checkpoint) == set(ttran.CHECKPOINT_FIELDS)
    assert float(t1.checkpoint["t4"]) < float(t1.checkpoint["t3"])
    j2 = J.tran(cj, (0.0, 12e-3), opts=J.TranOptions(**kw),
                resume=j1.checkpoint)
    old = {f: v for f, v in t1.checkpoint.items() if f not in ("x4", "t4")}
    for ck in (t1.checkpoint, old):
        t2 = T.tran(ct, (0.0, 12e-3), opts=T.TranOptions(**kw), resume=ck)
        assert (_counts(t1), _counts(t2)) == (_counts(j1), _counts(j2))
        assert t2.ts[0] == pytest.approx(4e-3)
        _same_wave(t2, j2)
    # resuming with the JAX package's own checkpoint
    t2 = T.tran(ct, (0.0, 12e-3), opts=T.TranOptions(**kw),
                resume={f: np.asarray(v) for f, v in j1.checkpoint.items()})
    assert _counts(t2) == _counts(j2)
