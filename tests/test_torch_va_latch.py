"""The latch channel in the port (``va/codegen.py``: ``transition`` in
"latch" mode, the LRM's linear ramps, and the sampled ``zi_nd/np/zd/zp``
filters; ``core/compile.py::latch_init``/``latch_update``; the latched
slots in ``analysis/tran.py``) against the JAX package on the CPU, the
circuits of ``tests/test_va_transition_latch.py`` and
``tests/test_va_zi.py``.

- Latch ``transition``: the linear ramp, the interrupted ramp and the
  asymmetric rise and fall with the JAX package's accepted, rejected and
  Newton counts, waveforms within 1e-9 V and the JAX tests' ramp gates;
  DC and AC are the identity; a resume mid-ramp carries the latched
  (target, y_start, t_start) and lands on the same line.
- ``zi_*``: the FIR moving average, the IIR low-pass and the single-pole
  ``zi_zp`` with equal counts and waveforms and the hand-computed
  difference-equation levels (1e-6); the sample clock scheduled as
  breakpoints equal to the JAX package's; the DC steady gain; the AC
  transfer H(e^{jωT}) of the FIR and IIR within 1e-9 of the closed forms
  and within 1e-12 of the JAX package's solutions.
- ``latch_init``/``latch_update`` equal the JAX package's on the IIR at
  a seeded point, before and at its sample time.
"""

import numpy as np
import torch

import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.va.codegen import load_va as j_load_va
from cedarsim_tpu_torch.va.codegen import load_va as t_load_va

from tests.test_va_transition_latch import TRANS
from tests.test_va_zi import FIR, IIR, ZP, T as TS

LATCH = dict(transition_mode="latch")
O5 = dict(rtol=1e-5, atol=1e-8, max_steps=16384)


def _both(va, mod, src, sp, load_kw=None, rl=None, **devp):
    out = []
    for P, load in ((J, j_load_va), (T, t_load_va)):
        ckt = P.Circuit()
        vin, vout = ckt.net("vin"), ckt.net("vout")
        ckt.add(getattr(P, src), "V1", (vin, ckt.gnd), sp)
        ckt.add(load(va, **(load_kw or {}))[mod], "F1", (vin, vout), devp)
        if rl is not None:
            ckt.add(P.Resistor, "RL", (vout, ckt.gnd), dict(r=rl))
        out.append(J.compile_circuit(ckt) if P is J
                   else T.compile_circuit(ckt, device="cpu"))
    return out


def _tran_both(cj, ct, span, **opts):
    o = dict(O5, **opts)
    np.testing.assert_array_equal(ct.breakpoints(span[1]),
                                  cj.breakpoints(span[1]))
    sj = J.tran(cj, span, opts=J.TranOptions(**o))
    st = T.tran(ct, span, opts=T.TranOptions(**o))
    assert sj.converged and st.converged
    assert (st.n_accepted, st.n_rejected, st.n_newton) == \
        (sj.n_accepted, sj.n_rejected, sj.n_newton)
    np.testing.assert_allclose(st.xs, sj.xs, rtol=0.0, atol=1e-9)
    return sj, st


def _trans(sp, **devp):
    return _both(TRANS, "vatrans", "VSourcePULSE", sp, LATCH, **devp)


def test_latch_ramp_is_linear():
    cj, ct = _trans(dict(v1=0.0, v2=3.3, td=2e-5, tr=1e-9, pw=1e-3,
                         per=2e-3), td=0.0, tt=1e-5)
    assert (ct.n_dly, ct.n_ring, ct.n_lat) == (cj.n_dly, 0, 3)
    _, st = _tran_both(cj, ct, (0.0, 6e-5))
    for fr in (0.25, 0.5, 0.75):
        assert abs(float(st.interp("vout", 2e-5 + fr * 1e-5))
                   - 3.3 * fr) < 0.05
    assert abs(float(st.interp("vout", 3.05e-5)) - 3.3) < 1e-6
    assert abs(float(st.interp("vout", 1.9e-5))) < 1e-9


def test_latch_interrupted_ramp():
    cj, ct = _trans(dict(v1=0.0, v2=3.3, td=2e-5, tr=1e-9, tf=1e-9,
                         pw=5e-6, per=2e-3), td=0.0, tt=1e-5)
    _, st = _tran_both(cj, ct, (0.0, 6e-5))
    peak = float(st.interp("vout", 2.5e-5))
    assert abs(peak - 1.65) < 0.05
    assert abs(float(st.interp("vout", 3.0e-5)) - peak / 2) < 0.05
    assert abs(float(st.interp("vout", 3.6e-5))) < 0.02


def test_latch_asymmetric_rise_fall():
    cj, ct = _trans(dict(v1=0.0, v2=2.0, td=1e-5, tr=1e-9, tf=1e-9,
                         pw=2e-5, per=2e-3), td=0.0, tt=1e-5, tf=2e-6)
    _, st = _tran_both(cj, ct, (0.0, 5e-5))
    assert abs(float(st.interp("vout", 2.05e-5)) - 2.0) < 1e-6
    assert abs(float(st.interp("vout", 3.1e-5)) - 1.0) < 0.06
    assert abs(float(st.interp("vout", 3.3e-5))) < 0.02


def test_latch_dc_and_ac_are_identity():
    cj, ct = _both(TRANS, "vatrans", "VSource", dict(dc=1.7, ac=1.0), LATCH,
                   td=0.0, tt=1e-5)
    r = T.solve_dc(ct)
    assert bool(r.converged)
    assert abs(float(r.x[ct.node_names.index("vout")]) - 1.7) < 1e-9
    sol = T.ac(ct, np.array([1e3, 1e6]))
    assert np.allclose(sol["vout"], 1.0, atol=1e-9)


def test_latch_state_checkpoints():
    cj, ct = _trans(dict(v1=0.0, v2=3.3, td=2e-5, tr=1e-9, pw=1e-3,
                         per=2e-3), td=0.0, tt=1e-5)
    o = T.TranOptions(**O5)
    ref = T.tran(ct, (0.0, 4e-5), opts=o)
    s1 = T.tran(ct, (0.0, 2.4e-5), opts=o)
    assert s1.checkpoint["latw"].shape == (3,)
    s2 = T.tran(ct, (2.4e-5, 4e-5), opts=o, resume=s1.checkpoint)
    j1 = J.tran(cj, (0.0, 2.4e-5), opts=J.TranOptions(**O5))
    j2 = J.tran(cj, (2.4e-5, 4e-5), opts=J.TranOptions(**O5),
                resume=j1.checkpoint)
    assert s2.converged
    assert (s2.n_accepted, s2.n_rejected) == (j2.n_accepted, j2.n_rejected)
    np.testing.assert_allclose(s2.xs, np.asarray(j2.xs), rtol=0.0,
                               atol=1e-9)
    for t in (2.6e-5, 2.8e-5, 3.2e-5):
        assert abs(float(ref.interp("vout", t))
                   - float(s2.interp("vout", t))) < 0.02


def test_zi_fir_moving_average_on_ramp():
    cj, ct = _both(FIR, "vafir", "VSourcePULSE",
                   dict(v1=0.0, v2=10.0, td=0.0, tr=10 * TS, pw=1e-3,
                        per=2e-3), rl=1e6)
    _, st = _tran_both(cj, ct, (0.0, 6.2 * TS))
    for n in (2, 3, 5):
        assert abs(float(st.interp("vout", (n + 0.5) * TS))
                   - (n - 0.5)) < 1e-6


def test_zi_iir_lowpass_step():
    A, cpar = 2.0, 0.5
    cj, ct = _both(IIR, "vaiir", "VSourcePULSE",
                   dict(v1=0.0, v2=A, td=0.5 * TS, tr=1e-9, pw=1e-3,
                        per=2e-3), rl=1e6, c=cpar)
    _, st = _tran_both(cj, ct, (0.0, 8.2 * TS))
    for m in (1, 2, 3, 6):
        assert abs(float(st.interp("vout", (m + 0.5) * TS))
                   - A * (1.0 - cpar ** m)) < 1e-6


def test_zi_zp_single_pole():
    cj, ct = _both(ZP, "vazp", "VSourcePULSE",
                   dict(v1=0.0, v2=1.0, td=0.5 * TS, tr=1e-9, pw=1e-3,
                        per=2e-3), rl=1e6)
    _, st = _tran_both(cj, ct, (0.0, 14.2 * TS), max_steps=32768)
    for m in (2, 3, 5):
        assert abs(float(st.interp("vout", (m + 0.5) * TS))
                   - 2.0 * (1.0 - 2.0 ** -(m - 1))) < 1e-6
    assert abs(float(st.interp("vout", 14.5 * TS)) - 2.0) < 1e-3


def test_zi_breakpoints_and_dc():
    dev = t_load_va(IIR)["vaiir"]
    jdev = j_load_va(IIR)["vaiir"]
    p = dev.prepare(dict(c=0.5))
    bps = dev.breakpoints(p, 10.5 * TS)
    np.testing.assert_array_equal(bps, jdev.breakpoints(p, 10.5 * TS))
    assert len(bps) == 10 and abs(bps[0] - TS) < 1e-18
    _, ct = _both(IIR, "vaiir", "VSource", dict(dc=1.5), rl=1e6, c=0.5)
    r = T.solve_dc(ct)
    assert bool(r.converged)
    assert abs(float(r.x[ct.node_names.index("vout")]) - 1.5) < 1e-9


def test_zi_ac_matches_z_transfer():
    freqs = np.array([1e3, 5e4, 2e5, 4.3e5])
    z = np.exp(2j * np.pi * freqs * TS)
    cases = ((FIR, "vafir", {}, 0.5 * (1.0 + 1.0 / z)),
             (IIR, "vaiir", dict(c=0.5), 0.5 / (1.0 - 0.5 / z)))
    for va, mod, dp, want in cases:
        cj, ct = _both(va, mod, "VSource", dict(dc=1.0, ac=1.0), rl=1e6,
                       **dp)
        st, sj = T.ac(ct, freqs), J.ac(cj, freqs)
        assert np.allclose(st["vout"], want, atol=1e-9)
        np.testing.assert_allclose(st.v.numpy(), np.asarray(sj.v),
                                   rtol=0.0, atol=1e-12)


def test_latch_walks_equal_the_jax_package():
    cj, ct = _both(IIR, "vaiir", "VSource", dict(dc=0.8), rl=1e6, c=0.3)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.0, 1.0, ct.n_x)
    cxt = T.SimSpec.make().with_mode(T.Modes.TRAN)
    cxj = J.SimSpec.make().with_mode(J.Modes.TRAN)
    w0 = ct.latch_init(torch.as_tensor(x), cxt.at_time(0.0))
    np.testing.assert_allclose(w0.numpy(), np.asarray(
        cj.latch_init(x, cxj.at_time(0.0))), rtol=1e-15, atol=0.0)
    for t in (0.5 * TS, TS):
        w1 = ct.latch_update(torch.as_tensor(x), cxt.at_time(t), w0)
        wj = cj.latch_update(x, cxj.at_time(t), jnp.asarray(w0.numpy()))
        np.testing.assert_allclose(w1.numpy(), np.asarray(wj), rtol=1e-15,
                                   atol=0.0)
