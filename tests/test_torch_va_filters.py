"""The VA analog filter and event operators in the port (``va/codegen.py``:
``laplace_nd/np/zd/zp``, ``absdelay`` in "pade" mode, ``transition`` in
"smooth" mode, ``slew``, ``idtmod``, each a block of state rows) against
the JAX package on the CPU, the circuits of ``tests/test_va_filters.py``.

- (S, Q, G, C) of each filter device at a seeded point (the states
  included) within 1e-12 of the JAX package's, relative to each array's
  largest entry, in TRAN and in DCOP mode.
- DC and AC: the low-pass's gain and H = g/(1 + jωτ), the complex pair,
  the real zero and the single pole against their closed forms (1e-8
  relative, as the JAX tests) and the port's solutions within 1e-12 of
  the JAX package's; the Padé delay an all-pass of phase −ωtd; a zero
  delay is the identity.
- Transient: the low-pass step, ``slew``, the smooth ``transition`` and
  ``idtmod``'s phase wrap with the JAX package's accepted, rejected and
  Newton counts and waveforms within 1e-9 V, and the JAX tests' gates;
  the Padé-delayed ``transition`` over 0–22 µs (its input edge starts at
  20 µs; past it both packages grind through ~1,700 rejected steps) with
  equal counts.
- The fused chord plan builds for the low-pass (its states are ordinary
  rows) and its plain version gives the chord path's counts.
- Malformed sites raise as in the JAX package (an improper laplace, a
  zi_zp with more zeros than poles); zi_* compiles into latch slots.
"""

import numpy as np
import pytest
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.va.codegen import load_va as j_load_va
from cedarsim_tpu_torch.va.codegen import load_va as t_load_va, \
    VACodegenError

from tests.test_va_filters import LP, ZP, ZD, NP, DELAY, SLEW, TRANS, VCO


def _both(va, mod, src, sp, **devp):
    out = []
    for P, load in ((J, j_load_va), (T, t_load_va)):
        ckt = P.Circuit()
        vin, vout = ckt.net("vin"), ckt.net("vout")
        ckt.add(getattr(P, src), "V1", (vin, ckt.gnd), sp)
        ckt.add(load(va)[mod], "F1", (vin, vout), devp)
        out.append(J.compile_circuit(ckt) if P is J
                   else T.compile_circuit(ckt, device="cpu"))
    return out


def _tran_both(cj, ct, tstop, **opts):
    sj = J.tran(cj, (0.0, tstop), opts=J.TranOptions(**opts))
    st = T.tran(ct, (0.0, tstop), opts=T.TranOptions(**opts))
    assert sj.converged and st.converged
    assert (st.n_accepted, st.n_rejected, st.n_newton) == \
        (sj.n_accepted, sj.n_rejected, sj.n_newton)
    nv = ct.n_nodes
    np.testing.assert_allclose(st.xs[:, :nv], sj.xs[:, :nv], rtol=0.0,
                               atol=1e-9)
    return st


@pytest.mark.parametrize("va, mod, devp", [
    (LP, "valp", dict(tau=1e-3, gain=0.5)),
    (ZP, "vazp", dict(a=1000.0, b=3000.0)),
    (DELAY, "vadel", dict(td=50e-6)),
    (SLEW, "vaslew", dict(rp=1e4, rn=-2e4)),
    (TRANS, "vatrans", dict(td=3e-5, tt=5e-6)),
    (VCO, "vavco", dict(fc=1e3)),
], ids=["laplace_nd", "laplace_zp", "absdelay", "slew", "transition",
        "idtmod"])
def test_device_walk_equals_the_jax_package(va, mod, devp):
    cj, ct = _both(va, mod, "VSource", dict(dc=0.3), **devp)
    assert ct.n_x == cj.n_x
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.0, 1.0, ct.n_x)
    for mode in (T.Modes.TRAN, T.Modes.DCOP):
        cxt = T.SimSpec.make().with_mode(mode).at_time(1e-5)
        cxj = J.SimSpec.make().with_mode(mode).at_time(1e-5)
        got = ct.res_jacs_fwd(torch.as_tensor(x), cxt)
        Sj, Qj = cj.residuals(x, cxj)
        Gj, Cj = cj.jacobians(x, cxj)
        for a, b in zip(got, (Sj, Qj, Gj, Cj)):
            b = np.asarray(b)
            scale = max(np.abs(b).max(), 1e-300)
            np.testing.assert_allclose(a.numpy(), b, rtol=0.0,
                                       atol=1e-12 * scale)


def test_laplace_nd_lowpass_dc_ac():
    tau = 1e-3
    cj, ct = _both(LP, "valp", "VSource", dict(dc=2.0, ac=1.0), tau=tau,
                   gain=0.5)
    res = T.solve_dc(ct)
    assert bool(res.converged)
    assert np.isclose(float(res.x[ct.node_names.index("vout")]), 1.0,
                      rtol=1e-9)
    freqs = T.acdec(8, 1.0, 1e5)
    st, sj = T.ac(ct, freqs), J.ac(cj, freqs)
    np.testing.assert_allclose(st.v.numpy(), np.asarray(sj.v), rtol=0.0,
                               atol=1e-12)
    href = 0.5 / (1.0 + 1j * 2 * np.pi * freqs * tau)
    assert np.allclose(st["vout"], href, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("va, mod, devp, fs, href", [
    (ZP, "vazp", dict(a=1000.0, b=3000.0), (8, 10.0, 1e5),
     lambda s: 1.0 / (s ** 2 + 2000.0 * s + 1e6 + 9e6)),
    (ZD, "vazd", {}, (8, 1.0, 1e4),
     lambda s: (s + 500.0) / (1.0 + 2e-3 * s + 1e-6 * s ** 2)),
    (NP, "vanp", {}, (6, 1.0, 1e4), lambda s: 1.0 / (s + 1000.0)),
], ids=["zp", "zd", "np"])
def test_laplace_root_forms_ac(va, mod, devp, fs, href):
    cj, ct = _both(va, mod, "VSource", dict(dc=0.0, ac=1.0), **devp)
    freqs = T.acdec(*fs)
    st, sj = T.ac(ct, freqs), J.ac(cj, freqs)
    # within 1e-12 of each frequency's largest entry (the 1 V drive)
    np.testing.assert_allclose(st.v.numpy(), np.asarray(sj.v), rtol=0.0,
                               atol=1e-12)
    assert np.allclose(st["vout"], href(2j * np.pi * freqs), rtol=1e-8,
                       atol=1e-15)


def test_laplace_nd_step_response():
    tau = 1e-4
    cj, ct = _both(LP, "valp", "VSourcePULSE",
                   dict(v1=0.0, v2=1.0, td=1e-5, tr=1e-9), tau=tau,
                   gain=1.0)
    st = _tran_both(cj, ct, 6e-4)
    for t_rel in (0.5e-4, 1e-4, 3e-4):
        want = 1.0 - np.exp(-t_rel / tau)
        assert abs(float(st.interp("vout", 1e-5 + t_rel)) - want) < 4e-3


def test_absdelay_pade_ac_allpass_and_zero_delay():
    cj, ct = _both(DELAY, "vadel", "VSource", dict(dc=0.0, ac=1.0),
                   td=50e-6)
    freqs = np.array([100.0, 1e3, 3e3])
    h = T.ac(ct, freqs)["vout"]
    assert np.allclose(np.abs(h), 1.0, rtol=1e-9)
    assert np.allclose(np.angle(h), -2 * np.pi * freqs * 50e-6, rtol=1e-4)
    cj, ct = _both(DELAY, "vadel", "VSource", dict(dc=1.5, ac=1.0), td=0.0)
    res = T.solve_dc(ct)
    assert np.isclose(float(res.x[ct.node_names.index("vout")]), 1.5,
                      rtol=1e-12)


def test_slew_rate_limits():
    cj, ct = _both(SLEW, "vaslew", "VSourcePULSE",
                   dict(v1=0.0, v2=1.0, td=1e-5, tr=1e-9, tf=1e-9, pw=5e-4),
                   rp=1e4, rn=-2e4)
    st = _tran_both(cj, ct, 8e-4)
    assert abs(float(st.interp("vout", 1e-5 + 5e-5)) - 0.5) < 5e-3
    assert abs(float(st.interp("vout", 1e-5 + 1.5e-4)) - 1.0) < 2e-3
    assert abs(float(st.interp("vout", 5.1e-4 + 2.5e-5)) - 0.5) < 5e-3
    assert abs(float(st.interp("vout", 5.1e-4 + 8e-5))) < 2e-3


def test_transition_edge_shaping():
    cj, ct = _both(TRANS, "vatrans", "VSourcePULSE",
                   dict(v1=0.0, v2=3.3, td=2e-5, tr=1e-9), td=0.0, tt=1e-5)
    st = _tran_both(cj, ct, 1e-4)
    tau = 1e-5 / np.log(100.0)
    assert abs(float(st.interp("vout", 2e-5 + tau))
               - 3.3 * (1 - np.exp(-1))) < 0.04
    assert abs(float(st.interp("vout", 3e-5)) - 3.3 * 0.99) < 0.02
    assert abs(float(st.interp("vout", 9e-5)) - 3.3) < 1e-3


def test_transition_with_pade_delay():
    cj, ct = _both(TRANS, "vatrans", "VSourcePULSE",
                   dict(v1=0.0, v2=1.0, td=2e-5, tr=2e-5), td=3e-5,
                   tt=5e-6)
    _tran_both(cj, ct, 2.2e-5)


def test_idtmod_phase_wrap():
    cj, ct = _both(VCO, "vavco", "VSource", dict(dc=1.0), fc=1e3)
    res = T.solve_dc(ct)
    assert abs(float(res.x[ct.node_names.index("vout")])) < 1e-9
    st = _tran_both(cj, ct, 2.5e-3)
    for t, want in ((3e-4, 0.3), (1.25e-3, 0.25), (2.4e-3, 0.4)):
        assert abs(float(st.interp("vout", t)) - want) < 3e-3


def test_fused_plan_builds_for_the_lowpass():
    """A filter's states are ordinary rows: the fused chord plan builds,
    and its plain version (the kernel's, on the CPU) gives the chord
    path's counts on the low-pass step."""
    _, ct = _both(LP, "valp", "VSourcePULSE",
                  dict(v1=0.0, v2=1.0, td=1e-5, tr=1e-9), tau=1e-4,
                  gain=1.0)
    assert ct.n_dly == 0
    ctx = T.SimSpec.make()
    T.get_fused_plan(ct, ctx.with_mode(T.Modes.TRAN))
    kw = dict(formulation="cap", jac_reuse=1)
    x0 = T.solve_dc(ct, mode=T.Modes.TRANOP).x[None]
    a, = T.tran(ct, (0.0, 3e-4), ctx=ctx, x0=x0,
                opts=T.TranOptions(newton_impl="fused", **kw))
    b, = T.tran(ct, (0.0, 3e-4), ctx=ctx, x0=x0,
                opts=T.TranOptions(newton_impl="xla", **kw))
    assert a.converged and b.converged
    assert (a.n_accepted, a.n_rejected, a.n_newton) == \
        (b.n_accepted, b.n_rejected, b.n_newton)


def test_malformed_sites_raise():
    devs = t_load_va("""
module vazi(inp, out);
  inout inp, out;
  electrical inp, out;
  analog V(out) <+ zi_nd(V(inp), {1.0}, {1.0}, 1e-6);
endmodule
""")
    assert devs["vazi"].n_latch >= 2
    with pytest.raises(VACodegenError, match="more zeros"):
        t_load_va("""
module vazibad(inp, out);
  inout inp, out;
  electrical inp, out;
  analog V(out) <+ zi_zp(V(inp), {0.5, 0.0, 0.2, 0.0}, {0.1, 0.0}, 1e-6);
endmodule
""")
    with pytest.raises(VACodegenError, match="improper"):
        t_load_va("""
module vabad(inp, out);
  inout inp, out;
  electrical inp, out;
  analog V(out) <+ laplace_nd(V(inp), {1.0, 1.0, 1.0}, {1.0, 1e-3});
endmodule
""")
