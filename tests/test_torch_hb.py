"""The port's harmonic balance (``cedarsim_tpu_torch/analysis/hb.py``)
against the JAX package's on the CPU, on ``tests/test_hb.py``'s circuits
(without its 400-period brute-force transient).

- Sine-driven RC from a flat DC start: the phasor answer within 1e-8 (the
  JAX test's bound) and the JAX package's samples within 1e-12 V.
- Diode peak rectifier from a 3-period warm-up, 25 harmonics: converged,
  its samples within 1e-7 V of the JAX package's (each package's Newton
  stops at 1e-9·scale from its own warm-up's start).
- Van der Pol (autonomous, ω a Newton unknown): amplitude within 0.02 of
  the describing function's 2 V, frequency within 5e-3 of 1/(2π√LC), and
  period and amplitude within 1e-6 relative of the JAX package's.
- PAC: on an LTI RC the k = 0 gain equals ``ac()`` within 1e-9 and the
  sidebands vanish; an ideal multiplier's ±1 sidebands are ∓1/(2i) within
  1e-8.
- PNOISE: on an LTI divider it equals the stationary ``noise()`` within
  1e-9 relative (per source too); through the multiplier it is half the
  source PSD (1e-6) and equals the JAX package's within 1e-9 relative.
- Oscillator phase noise of the noisy LC tank: the closed form within 15 %
  (the JAX test's bound), the PPV's biorthogonality spread under 0.05, and
  the diffusion constant within 1e-5 relative of the JAX package's.
- A circuit with a history-mode delay element raises.
"""

import numpy as np
import pytest

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis import hb as jhb
from cedarsim_tpu_torch.analysis import hb as thb

K_B, T_K = 1.380649e-23, 300.15


def _comp(P, netlist):
    kw = {} if P is J else dict(device="cpu")
    return P.compile_circuit(P.load_spice(netlist), **kw)


def _rc(P, source):
    ckt = P.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    if source == "sin":
        ckt.add(P.VSourceSIN, "V1", (vin, ckt.gnd),
                dict(vo=0.0, va=1.0, freq=1e6))
    else:
        ckt.add(P.VSource, "V1", (vin, ckt.gnd), dict(dc=0.0, ac=1.0))
    ckt.add(P.Resistor, "R1", (vin, vout), dict(r=1e3))
    ckt.add(P.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    kw = {} if P is J else dict(device="cpu")
    return P.compile_circuit(ckt, **kw)


def test_linear_rc_is_the_phasor():
    res = {}
    for P, mod in ((J, jhb), (T, thb)):
        res[P] = mod.hb(_rc(P, "sin"), 1e-6, ctx=P.SimSpec.make(gmin=1e-15),
                        n_harmonics=3, init="dc", tol=1e-12)
    rt = res[T]
    assert rt.converged
    w = 2 * np.pi * 1e6
    H = 1.0 / (1.0 + 1j * w * 1e-6)
    tgrid = np.linspace(0.0, 1e-6, 24, endpoint=False)
    exact = np.abs(H) * np.sin(w * tgrid + np.angle(H))
    assert np.abs(rt.interp("vout", tgrid) - exact).max() < 1e-8
    X = rt.spectrum("vout")
    assert abs(X[0]) < 1e-9 and abs(2 * np.abs(X[1]) - np.abs(H)) < 1e-8
    assert np.abs(rt.x_samples - res[J].x_samples).max() < 1e-12


RECTIFIER = """rectifier
V1 vin 0 SIN(0 2 1meg)
D1 vin vout dmod
RL vout 0 100k
CL vout 0 1n
.model dmod d is=1e-14 n=1
.end
"""


def test_rectifier_samples_match_the_jax_package():
    res = {}
    for P, mod in ((J, jhb), (T, thb)):
        res[P] = mod.hb(_comp(P, RECTIFIER), 1e-6,
                        ctx=P.SimSpec.make(gmin=1e-12), n_harmonics=25,
                        warmup_periods=3, tol=1e-9)
    rt, rj = res[T], res[J]
    assert rt.converged and rj.converged
    assert np.abs(rt.x_samples - rj.x_samples).max() < 1e-7
    v = rt.samples("vout")
    assert np.abs(v - rj.samples("vout")).max() < 1e-7
    assert 1.0 < float(rt.interp("vout", 0.5e-6)) < 1.6
    assert rt.thd("vout") == pytest.approx(rj.thd("vout"), rel=1e-4)


def _vdp(P, noisy):
    L, C, R = 1e-3, 1e-9, 1e4
    a = 2e-4
    b = a / 3.0
    g = a + 1.0 / R if noisy else a
    extra = f"R1 out 0 {R}\n" if noisy else ""
    return _comp(P, f"""vdp
L1 out 0 {L}
C1 out 0 {C}
{extra}B1 out 0 I='{-g}*V(out) + {b}*V(out)^3'
.end
"""), 2 * np.pi * np.sqrt(L * C)


def test_van_der_pol_period_and_amplitude():
    res = {}
    for P, mod in ((J, jhb), (T, thb)):
        comp, T0 = _vdp(P, noisy=False)
        res[P] = mod.hb_autonomous(comp, T0, anchor="out", n_harmonics=9,
                                   kick=0.5, warmup_periods=30.0, tol=1e-10)
    rt, rj = res[T], res[J]
    assert rt.converged
    A = 2.0 * abs(rt.spectrum("out")[1])
    assert abs(A - 2.0) < 0.02
    assert abs(rt.period - T0) / T0 < 5e-3
    assert rt.period == pytest.approx(rj.period, rel=1e-6)
    assert A == pytest.approx(2.0 * abs(rj.spectrum("out")[1]), rel=1e-6)
    X = rt.spectrum("out")
    assert abs(X[2]) < 1e-3 * abs(X[1])
    assert 1e-4 < abs(X[3]) / abs(X[1]) < 0.1


def test_pac_on_an_lti_circuit_equals_ac():
    comp = _rc(T, "ac")
    res = thb.hb(comp, 1e-6, ctx=T.SimSpec.make(gmin=1e-15), n_harmonics=2,
                 init="dc", tol=1e-12)
    assert res.converged
    freqs = np.array([1e4, 1.59e5, 1e6, 1e7])
    p = thb.pac(res, freqs)
    ref = T.ac(comp, freqs, ctx=T.SimSpec.make(gmin=1e-15))["vout"]
    assert np.abs(p.gain("vout", 0) - ref).max() < 1e-9
    sb = p.sidebands("vout")
    K = (sb.shape[1] - 1) // 2
    assert np.abs(np.delete(sb, K, axis=1)).max() < 1e-9


MULTIPLIER = """multiplier mixer
Vlo lo 0 SIN(0 1 1e6)
Vrf rf 0 DC 0 AC 1
Bmix out 0 V='V(rf)*V(lo)'
Rl out 0 1k
.end
"""


def test_pac_multiplier_conversion_gain():
    res = thb.hb(_comp(T, MULTIPLIER), 1e-6, n_harmonics=5, init="dc",
                 tol=1e-12)
    assert res.converged
    p = thb.pac(res, np.array([1e5]))
    assert abs(complex(p.gain("out", +1)[0]) - (-0.5j)) < 1e-8
    assert abs(complex(p.gain("out", -1)[0]) - (+0.5j)) < 1e-8
    assert abs(complex(p.gain("out", 0)[0])) < 1e-9
    assert abs(complex(p.gain("out", +2)[0])) < 1e-9


def test_pnoise_on_an_lti_circuit_equals_stationary_noise():
    ckt = T.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(T.VSource, "V1", (vin, ckt.gnd), dict(dc=1.0, ac=1.0))
    ckt.add(T.Resistor, "R1", (vin, vout), dict(r=1e3))
    ckt.add(T.Resistor, "R2", (vout, ckt.gnd), dict(r=1e3))
    ckt.add(T.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    comp = T.compile_circuit(ckt, device="cpu")
    res = thb.hb(comp, 1e-6, n_harmonics=2, init="dc", tol=1e-12)
    assert res.converged
    freqs = np.array([1e3, 1e5, 1.59e5, 1e7])
    pn = thb.pnoise(res, "vout", freqs)
    st = T.noise(comp, "vout", freqs)
    assert np.abs(pn.psd / st.psd - 1.0).max() < 1e-9
    assert np.abs(pn.source("R1") / st.source("R1") - 1.0).max() < 1e-9


MIXER_NOISE = """mixer noise folding
Vb nb 0 DC 0
R1 nb nr 1k
R2 nr 0 1k
Vlo lo 0 SIN(0 1 1e6)
Bmix out 0 V='V(nr)*V(lo)'
.end
"""


def test_pnoise_mixer_folding_matches_the_jax_package():
    freqs = np.array([1e4, 1e5])
    pn = {}
    for P, mod in ((J, jhb), (T, thb)):
        res = mod.hb(_comp(P, MIXER_NOISE), 1e-6, n_harmonics=5, init="dc",
                     tol=1e-12)
        assert res.converged
        pn[P] = mod.pnoise(res, "out", freqs)
    s_rf = 4 * K_B * T_K * 500.0          # R1 || R2
    assert np.abs(pn[T].psd / (0.5 * s_rf) - 1.0).max() < 1e-6
    assert np.abs(pn[T].psd / pn[J].psd - 1.0).max() < 1e-9
    assert np.abs(pn[T].per_source - pn[J].per_source).max() \
        <= 1e-9 * pn[J].psd.max()
    st = T.noise(_comp(T, MIXER_NOISE), "out", freqs)
    assert st.psd.max() < 1e-3 * pn[T].psd.min()


def test_lc_tank_phase_noise():
    pns = {}
    for P, mod in ((J, jhb), (T, thb)):
        comp, T0 = _vdp(P, noisy=True)
        res = mod.hb_autonomous(comp, T0, anchor="out", n_harmonics=9,
                                kick=0.5, warmup_periods=30.0, tol=1e-10)
        assert res.converged
        pns[P] = (mod.oscillator_phase_noise(res),
                  2.0 * abs(res.spectrum("out")[1]))
    pn, A_osc = pns[T]
    assert pn.norm_spread < 0.05
    L, C, R = 1e-3, 1e-9, 1e4
    w0 = 1.0 / np.sqrt(L * C)
    c_theory = K_B * T_K / (R * C ** 2 * A_osc ** 2 * w0 ** 2)
    assert abs(pn.c / c_theory - 1.0) < 0.15
    assert pn.c == pytest.approx(pns[J][0].c, rel=1e-5)
    l1, l2 = pn.ldbc([1e3, 1e4])
    assert 19.0 < l1 - l2 < 21.0
    assert abs(pn.jitter(100.0) / (10 * pn.jitter(1.0)) - 1.0) < 1e-9


def test_history_delay_raises():
    comp = T.compile_circuit(T.load_spice(
        "* line\nV1 a 0 SIN(0 1 1meg)\nR1 a b 50\n"
        "T1 b 0 c 0 Z0=50 TD=10n\nR2 c 0 50\n"), device="cpu")
    with pytest.raises(NotImplementedError, match="aux state"):
        thb.hb(comp, 1e-6, init="dc")
    with pytest.raises(NotImplementedError, match="aux state"):
        thb.hb_autonomous(comp, 1e-6, anchor="b")
