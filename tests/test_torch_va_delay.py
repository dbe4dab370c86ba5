"""VA ``absdelay`` in the port (``va/codegen.py``: "history" reads the
transient's ring, "pade" a Padé(3,3) block of states) against the JAX
package on the CPU, the delay line of ``tests/test_va_delay_history.py``.

- ``analysis/tran.py::ring_interp`` equals ``jnp.interp`` value for value
  on the ring's shapes: the seeded ring (KD copies of t0), repeated
  abscissae, queries before the first and after the last sample.
- History mode, a PULSE through the 2 µs delay: the JAX package's
  accepted, rejected and Newton counts, waveforms within 1e-9 V, and no
  ring underflow; the same after a checkpoint resume (the ring and its
  delays ride the checkpoint), and a resume with another
  ``delay_history`` raises.
- History mode, the JAX test's 1 MHz sine (ω·td = 12.6 rad): the counts
  equal the JAX package's over 0–2 µs; over 0–8 µs both runs stay within
  the JAX test's 0.02 of sin(2πF(t − td)) with no underflow, but their
  grids part from step 8 on, by ~1e-12 relative (the JAX package's
  XLA:CPU program rounds the predictor's multiply-adds once, as FMAs,
  ROADMAP C13), and after td its counts (1,237 / 839 / 4,087) are not the
  port's.
- C12: at td = 1.9 µs the JAX package's run ends with ``converged`` False;
  the port's does too, with ring underflows counted, and converges once
  the ring is 4096 samples long.
- Padé mode: ``tests/test_va_filters.py``'s in-band sine with the JAX
  package's counts and waveform; DC is a pass-through; AC of a history
  site is exactly e^{−jωtd} (1e-9); on the sparse path it raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.va.codegen import load_va as j_load_va
from cedarsim_tpu_torch.analysis.tran import ring_interp
from cedarsim_tpu_torch.va.codegen import load_va as t_load_va

from tests.test_va_delay_history import VA, F, TD
from tests.test_va_filters import DELAY

OPTS = dict(rtol=1e-4, atol=1e-7, max_steps=16384)
PULSE = dict(v1=0.0, v2=1.0, td=0.2e-6, tr=0.3e-6, tf=0.3e-6, pw=0.5e-6,
             per=2e-6)


def _line(P, src="sin", td=TD, delay_mode="history"):
    load = j_load_va if P is J else t_load_va
    dly = load(VA, delay_mode=delay_mode)["vdelay"]
    assert dly.n_delay == (1 if delay_mode == "history" else 0)
    ckt = P.Circuit()
    vin, out = ckt.net("vin"), ckt.net("out")
    if src == "sin":
        ckt.add(P.VSourceSIN, "V1", (vin, ckt.gnd),
                dict(vo=0.0, va=1.0, freq=F))
    elif src == "pulse":
        ckt.add(P.VSourcePULSE, "V1", (vin, ckt.gnd), PULSE)
    else:
        ckt.add(P.VSource, "V1", (vin, ckt.gnd), dict(dc=src, ac=1.0))
    ckt.add(dly, "X1", (out, ckt.gnd, vin, ckt.gnd), dict(td=td))
    ckt.add(P.Resistor, "RL", (out, ckt.gnd), dict(r=1e4))
    if P is J:
        return J.compile_circuit(ckt)
    return T.compile_circuit(ckt, device="cpu")


def _counts(s):
    return s.n_accepted, s.n_rejected, s.n_newton


def _sine_err(sol, td=TD):
    probes = np.linspace(3e-6, 7.5e-6, 60)
    return max(abs(float(sol.interp("out", t))
                   - np.sin(2 * np.pi * F * (t - td))) for t in probes)


def test_ring_interp_is_jnp_interp():
    rng = np.random.default_rng(5)
    L, KD, R = 3, 16, 2
    t0 = 1e-6
    tr = np.full((L, KD), t0)
    ur = np.tile(rng.standard_normal((L, 1, R)), (1, KD, 1))
    # lane 1: part-filled ring (repeated seeds, then samples, one repeat);
    # lane 2: full ring of distinct samples
    tr[1, 10:] = t0 + np.array([1, 2, 2, 3, 5, 8]) * 1e-9
    ur[1, 10:] = rng.standard_normal((6, R))
    tr[2] = t0 + np.cumsum(rng.uniform(0.5, 2.0, KD)) * 1e-9
    ur[2] = rng.standard_normal((KD, R))
    q = np.stack([
        np.array([[t0 - 5e-9, t0], [t0 + 1e-9, t0 + 3e-9]])[0],
        np.array([t0 + 2e-9, t0 + 2.5e-9]),
        np.array([tr[2, 0] - 1e-12, tr[2, -1] + 1e-9]),
    ])
    q = np.concatenate([q, rng.uniform(t0 - 2e-9, t0 + 40e-9, (L, R)),
                        tr[:, 11:13]], 1)
    R2 = q.shape[1]
    ur2 = np.concatenate([ur] * (R2 // R), 2)
    got = ring_interp(torch.as_tensor(q), torch.as_tensor(tr),
                      torch.as_tensor(ur2)).numpy()
    for i in range(L):
        for j in range(R2):
            want = float(jnp.interp(q[i, j], jnp.asarray(tr[i]),
                                    jnp.asarray(ur2[i, :, j])))
            assert got[i, j] == want, (i, j, got[i, j], want)


def test_history_pulse_equals_the_jax_package():
    sj = J.tran(_line(J, "pulse"), (0.0, 8e-6), opts=J.TranOptions(**OPTS))
    st = T.tran(_line(T, "pulse"), (0.0, 8e-6), opts=T.TranOptions(**OPTS))
    assert sj.converged and st.converged and st.n_ring_underflow == 0
    assert _counts(st) == _counts(sj)
    np.testing.assert_array_equal(st.ts, sj.ts)
    np.testing.assert_allclose(st.xs, sj.xs, rtol=0.0, atol=1e-9)
    # the pulse's top reaches out one delay later
    assert abs(float(st.interp("out", 2.2e-6 + 0.55e-6)) - 1.0) < 1e-9


def test_history_checkpoint_resume():
    ct, cj = _line(T, "pulse"), _line(J, "pulse")
    o_t, o_j = T.TranOptions(**OPTS), J.TranOptions(**OPTS)
    fj = J.tran(cj, (0.0, 3e-6), opts=o_j)
    rj = J.tran(cj, (0.0, 8e-6), opts=o_j, resume=fj.checkpoint)
    ft = T.tran(ct, (0.0, 3e-6), opts=o_t)
    for f in ("t_ring", "u_ring", "dly_td", "latw"):
        assert f in ft.checkpoint
    assert ft.checkpoint["t_ring"].shape == (512,)
    rt = T.tran(ct, (0.0, 8e-6), opts=o_t, resume=ft.checkpoint)
    assert rt.converged and rt.n_ring_underflow == 0
    assert _counts(rt) == _counts(rj)
    np.testing.assert_allclose(rt.xs, np.asarray(rj.xs), rtol=0.0,
                               atol=1e-9)
    full = T.tran(ct, (0.0, 8e-6), opts=o_t)
    for t in (4.5e-6, 5.1e-6, 7.5e-6):
        assert abs(float(rt.interp("out", t))
                   - float(full.interp("out", t))) < 0.02
    with pytest.raises(ValueError, match="delay_history"):
        T.tran(ct, (0.0, 8e-6), resume=ft.checkpoint,
               opts=T.TranOptions(**OPTS, delay_history=256))


def test_history_sine_parts_only_by_rounding():
    cj, ct = _line(J, "sin"), _line(T, "sin")
    sj = J.tran(cj, (0.0, 2e-6), opts=J.TranOptions(**OPTS))
    st = T.tran(ct, (0.0, 2e-6), opts=T.TranOptions(**OPTS))
    assert _counts(st) == _counts(sj)
    np.testing.assert_allclose(st.ts, sj.ts, rtol=1e-11, atol=0.0)
    np.testing.assert_allclose(st.xs, sj.xs, rtol=0.0, atol=1e-9)
    # before the first LTE-sized step the grids are the same bits
    np.testing.assert_array_equal(st.ts[:8], sj.ts[:8])
    sj = J.tran(cj, (0.0, 8e-6), opts=J.TranOptions(**OPTS))
    st = T.tran(ct, (0.0, 8e-6), opts=T.TranOptions(**OPTS))
    assert sj.converged and st.converged and st.n_ring_underflow == 0
    assert _sine_err(sj) < 0.02 and _sine_err(st) < 0.02


def test_c12_short_ring_collapse():
    sj = J.tran(_line(J, "sin", td=1.9e-6), (0.0, 8e-6),
                opts=J.TranOptions(**OPTS))
    assert not sj.converged
    st = T.tran(_line(T, "sin", td=1.9e-6), (0.0, 8e-6),
                opts=T.TranOptions(**OPTS))
    assert (not st.converged) or st.n_ring_underflow > 0
    assert st.n_ring_underflow > 0
    long = T.tran(_line(T, "sin", td=1.9e-6), (0.0, 8e-6),
                  opts=T.TranOptions(**OPTS, delay_history=4096))
    assert long.converged and long.n_ring_underflow == 0
    assert _sine_err(long, 1.9e-6) < 0.02


def test_pade_equals_the_jax_package():
    """Padé mode on ``tests/test_va_filters.py``'s in-band delay (50 µs,
    a 1 kHz sine, ω·td = 0.31 rad) over its first 0.4 ms."""
    sj = J.tran(_filter(J), (0.0, 4e-4), opts=J.TranOptions())
    ct = _filter(T)
    st = T.tran(ct, (0.0, 4e-4), opts=T.TranOptions())
    assert sj.converged and st.converged
    assert _counts(st) == _counts(sj)
    # the node voltages to 1e-9 V; the Padé states (w and its derivatives,
    # up to ~1e11 in their own units) to 1e-9 of each one's largest value
    nv = ct.n_nodes
    np.testing.assert_allclose(st.xs[:, :nv], sj.xs[:, :nv], rtol=0.0,
                               atol=1e-9)
    scale = np.abs(sj.xs).max(0)
    assert np.all(np.abs(st.xs - sj.xs) <= 1e-9 * scale)


def _filter(P):
    load = j_load_va if P is J else t_load_va
    ckt = P.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(P.VSourceSIN, "V1", (vin, ckt.gnd),
            dict(vo=0.0, va=1.0, freq=1e3))
    ckt.add(load(DELAY)["vadel"], "F1", (vin, vout), dict(td=50e-6))
    if P is J:
        return J.compile_circuit(ckt)
    return T.compile_circuit(ckt, device="cpu")


def test_history_dc_passthrough_and_exact_ac():
    ct = _line(T, 0.7)
    r = T.solve_dc(ct)
    assert bool(r.converged)
    assert abs(float(r.x[ct.node_names.index("out")]) - 0.7) < 1e-9
    freqs = np.array([1e3, 1e5, 1e6, 5e6])
    st = T.ac(_line(T, 0.0), freqs)
    sj = J.ac(_line(J, 0.0), freqs)
    h = st["out"]
    np.testing.assert_allclose(np.abs(h), 1.0, rtol=0.0, atol=1e-9)
    np.testing.assert_allclose(h, np.exp(-2j * np.pi * freqs * TD),
                               rtol=0.0, atol=1e-9)
    np.testing.assert_allclose(st.v.numpy(), np.asarray(sj.v), rtol=0.0,
                               atol=1e-12)


def test_sparse_ac_of_a_ring_site_raises():
    """The JAX package's sparse path linearises a ring site at aux = 0
    without its stamp (cedarsim_tpu/analysis/ac.py:107-109); the port
    raises there."""
    ckt = T.Circuit()
    vin, out = ckt.net("vin"), ckt.net("out")
    ckt.add(T.VSource, "V1", (vin, ckt.gnd), dict(dc=0.0, ac=1.0))
    ckt.add(t_load_va(VA, delay_mode="history")["vdelay"], "X1",
            (out, ckt.gnd, vin, ckt.gnd), dict(td=TD))
    ckt.add(T.Resistor, "RL", (out, ckt.gnd), dict(r=1e4))
    comp = T.compile_circuit(ckt, device="cpu", sparse=True)
    with pytest.raises(NotImplementedError, match="ac.py:107-109"):
        T.ac(comp, [1e3])
