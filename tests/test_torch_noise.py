"""The port's noise analysis (``cedarsim_tpu_torch/analysis/ac.py::noise``
and the noise channel of the devices, the VA interpreter and the compiler)
against the JAX package's on the CPU.

- ``noise_sources`` (power, exponent) within 1e-12 relative per source for
  the resistor, the diode, the BJT and BSIM4 (at ``tests/test_bsim4.py``'s
  on-state bias and per instance of the DFF at its operating point), and a
  Verilog-A module whose noise terms carry their own scale factors, sit in
  a branch of a bias-dependent conditional and include ``noise_table``.
- The eps Jacobian ∂S/∂eps within 1e-12 of the JAX ``jacfwd`` of the
  residuals, relative to its largest entry, for the same circuits.
- ``psd``, ``gain2`` and ``total()`` within 1e-8 relative per frequency,
  and ``per_source`` wherever a source carries more than 1e-12 of the
  total, for the resistor divider, the RC roll-off and kT/C circuits of
  ``tests/test_ac_noise.py``, its RLC circuit (the port also held to the
  ngspice table at that test's rtol 2e-6), the gf180 BSIM4 inverter on
  ``models_bsim4.spice`` (the port also held to
  ``tests/test_noise_pdk_goldens.py``'s structural gates and 0.5-2×
  plateau ratio) and the DFF AC/noise deck at ``dec 5``.
- A circuit without noise sources gives zeros and unit gain, as the JAX
  package's; ``source``, ``by_source`` and ``inoise`` agree.

The inverter's q sits 1e-10 V from its supply: the PFET's drain-source
voltage is ~0 and its sign picks BSIM4's source/drain orientation, which
moves the thermal noise by 8 %.  The default Newton tolerance (1e-4
relative) leaves q to within 1.3e-8 V, on either side, depending on the
path (the JAX package's cold solve lands above the supply, the port's
below).  Both packages therefore solve its operating point to 1e-9
relative (``INV_DC``), where both land at the same q.  The JAX package's
netlist-keyed operating-point cache is off in this module.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.models import bsim4_class as j_bsim4
from cedarsim_tpu.va.codegen import load_va as j_load_va
from cedarsim_tpu_torch.benchmarks import netlists
from cedarsim_tpu_torch.core.dual import Dual
from cedarsim_tpu_torch.models import bsim4_class as t_bsim4
from cedarsim_tpu_torch.va.codegen import load_va as t_load_va

from tests.data_gf180_inverter_noise_ngspice import NGSPICE_GF180_INV_NOISE
from tests.data_rlc_noise_ngspice import NGSPICE_RLC_NOISE
from tests.test_bsim4 import NCARD
from tests.test_noise_pdk_goldens import _loglog_slope

SRC_RTOL = 1e-12
PSD_RTOL = 1e-8
K = 1.380649e-23


@pytest.fixture(scope="module", autouse=True)
def _cold_reference_solves():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CEDARSIM_TPU_ARTIFACTS", "0")
        yield


def _load(M, text, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ckt = M.elaborate(M.parse_spice(text), **kw)
    return M.compile_circuit(ckt, **({} if M is J else {"device": "cpu"}))


def _both(text, **kw):
    return _load(J, text, **kw), _load(T, text, **kw)


def _rel_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= rtol * np.abs(b)), \
        np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))


def _check_sources_and_jac(cj, ct, ctx_kw, x=None):
    """At the port's operating point (or ``x``): (pwr, exp) per source and
    ∂S/∂eps against the JAX package's."""
    ctx_t = T.SimSpec.make(**ctx_kw).with_mode("ac")
    ctx_j = J.SimSpec.make(**ctx_kw).with_mode("ac")
    if x is None:
        x = T.solve_dc(ct, ctx=T.SimSpec.make(**ctx_kw)).x
    xj = jnp.asarray(x.numpy())
    assert ct.n_eps == cj.n_eps > 0
    pt, et = ct.noise_sources(x, ctx_t)
    pj, ej = cj.noise_sources(xj, ctx_j)
    _rel_close(pt.numpy(), pj, SRC_RTOL)
    _rel_close(et.numpy(), ej, SRC_RTOL)
    jt = ct.eps_jacobian(x, ctx_t).numpy()
    jj = np.asarray(jax.jacfwd(
        lambda e: cj.residuals(xj, ctx_j, eps=e)[0])(jnp.zeros(cj.n_eps)))
    assert jt.shape == jj.shape == (ct.n_x, ct.n_eps)
    assert np.abs(jt - jj).max() <= SRC_RTOL * np.abs(jj).max()
    return pt, jt


def _check_noise(nt, nj, rtol=PSD_RTOL):
    assert np.array_equal(nt.freqs, nj.freqs)
    assert nt.eps_names == nj.eps_names
    _rel_close(nt.psd, nj.psd, rtol)
    _rel_close(nt.gain2, nj.gain2, rtol)
    assert nt.total() == pytest.approx(nj.total(), rel=rtol)
    big = nj.per_source > 1e-12 * nj.psd[:, None]
    assert big.any()
    assert np.all(np.abs(nt.per_source - nj.per_source)[big]
                  <= rtol * nj.per_source[big])


NOISY_PARTS = """* resistor, diode and bjt noise
.model dmod d (is=1e-14 n=1.2)
.model qmod npn (is=1e-16 bf=100 vaf=50 cje=1p cjc=0.5p tf=0.1n)
.model pmod pnp (is=2e-16 bf=60)
V1 vcc 0 5 AC 1
R1 vcc b 470k
RC vcc c 2k
Q1 c b e 0 qmod
RE e 0 100
Q2 0 b2 c2 0 pmod
R2 vcc c2 10k
R3 b2 0 100k
R4 vcc b2 100k
D1 vcc dn dmod
RD dn 0 10k m=2
CL c 0 1p
"""


def test_noisy_parts_sources_jacobian_and_psd():
    cj, ct = _both(NOISY_PARTS)
    pt, jt = _check_sources_and_jac(cj, ct, {})
    assert np.all(pt.numpy() > 0)
    freqs = J.acdec(5, 1.0, 1e10)
    for out in ("c", "dn", "e"):
        _check_noise(T.noise(ct, out, freqs), J.noise(cj, out, freqs))


VA_NOISY = """
module nres(a, c);
  inout a, c;
  electrical a, c;
  parameter real r = 1e3;
  parameter real kf = 1e-12;
  real v, i;
  analog begin
    v = V(a, c);
    i = v / r;
    I(a, c) <+ i;
    I(a, c) <+ 3.0 * white_noise(4.0 * 1.380649e-23 * $temperature / r,
                                 "thermal");
    if (v > 0.3)
      I(a, c) <+ flicker_noise(kf * abs(i), 1.2, "flicker") * 0.5;
    else
      I(a, c) <+ -2.0 * white_noise(2.0 * 1.602176634e-19 * abs(i), "shot");
    I(a, c) <+ noise_table({1.0, 1e-20, 1e6, 1e-22}, "table");
  end
endmodule
"""


def _va_circuit(M):
    ckt = M.Circuit()
    a, b, c = ckt.net("a"), ckt.net("b"), ckt.net("c")
    nres = (j_load_va if M is J else t_load_va)(VA_NOISY)["nres"]
    ckt.add(M.VSource, "V1", (a, ckt.gnd), dict(dc=1.0, ac=1.0))
    ckt.add(nres, "X1", (a, b), dict(r=2e3))
    ckt.add(nres, "X2", (b, c), dict(r=1e3, kf=3e-12))
    ckt.add(nres, "X3", (c, ckt.gnd), dict(r=50.0))
    ckt.add(M.Capacitor, "C1", (b, ckt.gnd), dict(c=1e-9))
    return M.compile_circuit(ckt, **({} if M is J else {"device": "cpu"}))


def test_va_noise_terms_with_scale_factors_and_branches():
    cj, ct = _va_circuit(J), _va_circuit(T)
    assert ct.n_eps == cj.n_eps == 3 * 4
    pt, jt = _check_sources_and_jac(cj, ct, {})
    # the shot and flicker sites sit in the two branches of one
    # bias-dependent conditional: X1 and X2 take one, X3 the other
    nz = np.abs(jt).max(0)
    assert 3.0 in nz and 0.5 in nz and 2.0 in nz
    freqs = J.acdec(4, 1.0, 1e9)
    _check_noise(T.noise(ct, "b", freqs), J.noise(cj, "b", freqs))


def test_bsim4_noise_at_the_on_state_bias():
    """``tests/test_bsim4.py``'s card and on-state bias (vd = vg = 1.2 V):
    thermal and flicker (pwr, exp), and the eps columns of the device's
    residual, against the JAX class."""
    cj, ct = j_bsim4(), t_bsim4()
    raw = {**NCARD, "W": 1e-6, "L": 0.18e-6, "AS": 0.5e-12,
           "AD": 0.5e-12, "PS": 3e-6, "PD": 3e-6}
    pj = {k: jnp.asarray(v, jnp.float64) for k, v in cj.prepare(raw).items()}
    p = ct.prepare(raw)
    bias = [1.2, 1.2, 0.0, 0.0]
    ctx_j = J.SimSpec.make()
    ctx_t = T.SimSpec.make()
    lvj = jnp.asarray(bias, jnp.float64)
    lv = [torch.tensor([v], dtype=torch.float64) for v in bias]
    pwj, exj = cj.noise(lvj, pj, ctx_j)
    pwt, ext = ct.noise(lv, p, ctx_t)
    assert ct.n_noise == cj.n_noise == 2
    for got, want in ((pwt, pwj), (ext, exj)):
        got = np.array([float(torch.as_tensor(g).reshape(-1)[0])
                        for g in got])
        _rel_close(got, want, SRC_RTOL)
    assert float(pwj[0]) > 0 and float(pwj[1]) > 0
    eye = torch.eye(2, dtype=torch.float64)
    eps = [Dual(torch.zeros(1, dtype=torch.float64), eye[:, k:k + 1])
           for k in range(2)]
    s_rows, _ = ct.eval(lv, p, ctx_t, eps)
    jt = np.stack([np.asarray(r.d[:, 0]) if isinstance(r, Dual)
                   else np.zeros(2) for r in s_rows])
    jj = np.asarray(jax.jacfwd(
        lambda e: cj.eval(lvj, pj, ctx_j, e)[0])(jnp.zeros(2)))
    assert np.abs(jt - jj).max() <= SRC_RTOL * np.abs(jj).max()


@pytest.fixture(scope="module")
def dff():
    text = netlists.dff_ac_noise(5)
    cj, ct = _both(text, include_paths=[netlists.DFF_DIR])
    return text, cj, ct


def test_dff_noise_sources_per_instance(dff):
    _, cj, ct = dff
    x = T.solve_dc(ct, ctx=T.SimSpec.make(gmin=1e-15)).x
    pt, jt = _check_sources_and_jac(cj, ct, dict(gmin=1e-15), x=x)
    assert ct.n_eps == 60                 # 30 BSIM4 instances × 2
    assert np.all(pt.numpy()[0::2] >= 0)  # thermal


def test_dff_noise_matches_jax(dff, monkeypatch):
    """At one operating point (the port's, given to the JAX analysis):
    the supply-to-q gain at 1 Hz, 1.9e-21, is set by gmin-sized
    conductances and moves 1.4e-8 relative for the 4e-16 V between the
    two packages' own operating points; ``tests/test_torch_ac.py`` holds
    those within 1e-9 V and the PSD of each package's own op."""
    import dataclasses
    import cedarsim_tpu.analysis.ac as jac
    _, cj, ct = dff
    freqs = J.acdec(5, 1.0, 1e15)
    ctx = dict(gmin=1e-15)
    nt = T.noise(ct, "q", freqs, ctx=T.SimSpec.make(**ctx))
    x = T.solve_dc(ct, ctx=T.SimSpec.make(**ctx)).x
    real = jac.solve_dc
    monkeypatch.setattr(jac, "solve_dc", lambda *a, **kw: dataclasses.replace(
        real(*a, **kw), x=jnp.asarray(x.numpy())))
    nj = J.noise(cj, "q", freqs, ctx=J.SimSpec.make(**ctx))
    _check_noise(nt, nj)
    np.testing.assert_array_equal(nt.source("x_tn10.mn"),
                                  nt.source("x_tn10.mn#n0")
                                  + nt.source("x_tn10.mn#n1"))
    assert nt.inoise() == pytest.approx(nj.inoise(), rel=PSD_RTOL)


RDIV = """* noise divider
V1 vin 0 0
R1 vin vout 1000.0
R2 vout 0 3000.0
.op
"""

RLC = """* third order butterworth lowpass
V1 vin 0 AC 1 SIN (0, 1, 0.159154943)
L1 vin n1 1.5
C2 n1 0 1.333333333333333333
L3 n1 vout 0.5
R4 vout 0 2
R5 vout 0 2
"""


def _rc_rolloff(M):
    ckt = M.Circuit()
    vout = ckt.net("vout")
    ckt.add(M.Resistor, "R1", (vout, ckt.gnd), dict(r=1e3))
    ckt.add(M.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    return M.compile_circuit(ckt, **({} if M is J else {"device": "cpu"}))


def _rc_ktc(M):
    ckt = M.Circuit()
    vin, out = ckt.net("vin"), ckt.net("out")
    ckt.add(M.VSource, "V1", (vin, ckt.gnd), dict(dc=0.0, ac=1.0))
    ckt.add(M.Resistor, "R1", (vin, out), dict(r=10e3))
    ckt.add(M.Capacitor, "C1", (out, ckt.gnd), dict(c=1e-9))
    return M.compile_circuit(ckt, **({} if M is J else {"device": "cpu"}))


def test_resistor_divider_psd():
    cj, ct = _both(RDIV)
    freqs = np.array([1.0, 1e3, 1e6])
    nt, nj = T.noise(ct, "vout", freqs), J.noise(cj, "vout", freqs)
    _check_noise(nt, nj)
    rpar = 750.0
    assert np.allclose(nt.psd, 4 * K * 300.15 * rpar, rtol=1e-6)
    assert nt.by_source().keys() == nj.by_source().keys()


def test_rc_rolloff_and_ktc():
    freqs = J.acdec(5, 1e3, 1e8)
    nt, nj = (T.noise(_rc_rolloff(T), "vout", freqs),
              J.noise(_rc_rolloff(J), "vout", freqs))
    _check_noise(nt, nj)
    f = J.acdec(48, 1.0, 1e9)
    nt, nj = T.noise(_rc_ktc(T), "out", f), J.noise(_rc_ktc(J), "out", f)
    _check_noise(nt, nj)
    kT = K * 300.15
    assert abs(nt.total() - np.sqrt(kT / 1e-9)) / np.sqrt(kT / 1e-9) < 2e-3
    _rel_close(nt.inoise(), nj.inoise(), PSD_RTOL)
    assert nt.total(1e3, 1e5, input_referred=True) == pytest.approx(
        nj.total(1e3, 1e5, input_referred=True), rel=PSD_RTOL)


def test_rlc_matches_jax_and_ngspice():
    cj, ct = _both(RLC)
    freqs = np.array([r[0] for r in NGSPICE_RLC_NOISE])
    ref = np.array([r[1] for r in NGSPICE_RLC_NOISE])
    ctx = dict(temp_c=23.0, gmin=1e-15)
    nt = T.noise(ct, "vout", freqs, ctx=T.SimSpec.make(**ctx))
    nj = J.noise(cj, "vout", freqs, ctx=J.SimSpec.make(**ctx))
    _check_noise(nt, nj)
    assert np.allclose(np.sqrt(np.abs(nt.psd)), ref, rtol=2e-6)


#: the inverter's operating point to 1e-9 relative in both packages (see
#: the module docstring)
INV_DC = dict(reltol=1e-9, abstol=1e-15)


def test_gf180_inverter_matches_jax_and_the_gates():
    cj, ct = _both(netlists.INVERTER_NOISE, include_paths=[netlists.DFF_DIR])
    freqs = np.array([r[0] for r in NGSPICE_GF180_INV_NOISE])
    ref = np.array([r[1] for r in NGSPICE_GF180_INV_NOISE])
    nt = T.noise(ct, "q", freqs, ctx=T.SimSpec.make(gmin=1e-15),
                 dc_opts=T.NewtonOptions(**INV_DC))
    nj = J.noise(cj, "q", freqs, ctx=J.SimSpec.make(gmin=1e-15),
                 dc_opts=J.NewtonOptions(**INV_DC))
    _check_noise(nt, nj)
    got = np.sqrt(np.abs(nt.psd))
    pl = got[freqs <= 1e6]
    assert np.ptp(pl) / pl.mean() < 5e-3
    assert 0.5 < got[0] / ref[0] < 2.0
    assert abs(_loglog_slope(freqs, got, 1e12, 1e15) + 1.0) < 0.01
    corner = freqs[np.argmax(got < 0.5 * got[0])]
    assert 1e9 <= corner <= 1e11


def test_inverter_deck_through_simulate():
    """The deck's own ``.noise`` card: the ngspice grid to 7 digits, the
    gates as above (default Newton tolerance)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = T.simulate(netlists.INVERTER_NOISE,
                       include_paths=[netlists.DFF_DIR], device="cpu")
    ns = r["noise"]
    tab = np.array([row[0] for row in NGSPICE_GF180_INV_NOISE])
    np.testing.assert_allclose(ns.freqs, tab, rtol=1e-6)
    got = np.sqrt(ns.psd)
    pl = got[ns.freqs <= 1e6]
    assert np.ptp(pl) / pl.mean() < 5e-3
    assert abs(_loglog_slope(ns.freqs, got, 1e12, 1e15) + 1.0) < 0.01


def test_noiseless_circuit():
    text = "* lc\nV1 a 0 AC 1\nL1 a b 1u\nC1 b 0 1n\n"
    cj, ct = _both(text)
    freqs = [1e3, 1e6]
    nt, nj = T.noise(ct, "b", freqs), J.noise(cj, "b", freqs)
    assert ct.n_eps == cj.n_eps == 0
    np.testing.assert_array_equal(nt.psd, nj.psd)
    np.testing.assert_array_equal(nt.gain2, nj.gain2)
    assert nt.per_source.shape == nj.per_source.shape == (2, 0)
    assert nt.total() == 0.0 and np.all(nt.inoise() == 0.0)
