"""The port's AC analysis (``cedarsim_tpu_torch/analysis/ac.py``) against
the JAX package's on the CPU, the same circuits through both.

- ``ac_rhs`` (the sources' complex drive) equal exactly, a phase included.
- At each frequency |v_port − v_jax| ≤ 1e-9·max|v_jax| over the unknowns,
  and ``ACSolution[name]`` for a node voltage and a source current within
  the same bound (the solution's largest entry at that frequency), for
  the circuits of ``tests/test_ac_noise.py`` (RC low-pass, third-order
  Butterworth), ``tests/test_frontend.py``'s
  coupled inductors, ``tests/test_bipolar_amplifier.py``'s amplifier and
  ``tests/test_sparam.py``'s S-element divider (its touchstone file
  written to ``tmp_path``), and the BSIM4 DFF AC/noise deck
  (``benchmarks/netlists.py::dff_ac_noise``) at ``dec 5`` (76
  frequencies) through both ``simulate``s, its operating point first
  within 1e-9 V.
- ``simulate`` on ``.ac``, ``.noise``, ``.meas`` (over ``.ac``, ``.tran``
  and ``.dc``) and ``.four`` returns the JAX ``simulate``'s keys:
  ``.meas`` values within 1e-6 relative, ``.four``
  harmonics of a SIN-driven RC within 1e-4 relative on transients with the
  same accepted steps.
- The analysis runs on the compiled circuit's device; the AC of a
  history-mode ``absdelay`` site is stamped exactly (e^{−jωtd}) on the
  dense path, and on the sparse path, where the JAX package linearises it
  at aux = 0 without a word (``cedarsim_tpu/analysis/ac.py:107-109``), it
  raises naming that fault.

The JAX package's netlist-keyed operating-point cache is off in this
module, so its operating points are cold solves whatever ran before.
"""

import warnings

import numpy as np
import pytest
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.benchmarks import netlists

from tests.test_bipolar_amplifier import NETLIST as BJT_AMP
from tests.test_sparam import _s1p

AC_RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _cold_reference_solves():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CEDARSIM_TPU_ARTIFACTS", "0")
        yield


def _close_per_freq(vp, vj, scale=None, rtol=AC_RTOL):
    """Per frequency, the largest difference within ``rtol`` of ``scale``
    [n_f] (default: the reference's largest entry at that frequency)."""
    vp, vj = np.asarray(vp), np.asarray(vj)
    assert vp.shape == vj.shape
    if vp.ndim == 1:
        vp, vj = vp[:, None], vj[:, None]
    err = np.abs(vp - vj).max(1)
    scale = np.abs(vj).max(1) if scale is None else scale
    assert np.all(err <= rtol * scale), (err / scale).max()


def _close_obs(st, sj, names):
    """``ACSolution[name]`` per frequency within the bound of the
    solution: an observable is a linear map of v, so its rounding scales
    with the solution's largest entry."""
    scale = np.abs(np.asarray(sj.v)).max(1)
    for n in names:
        _close_per_freq(st[n], sj[n], scale)


def _rc(M):
    ckt = M.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(M.VSource, "V1", (vin, ckt.gnd), dict(dc=0.0, ac=1.0))
    ckt.add(M.Resistor, "R1", (vin, vout), dict(r=1e3))
    ckt.add(M.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-6))
    return ckt


def _butterworth(M):
    ckt = M.Circuit()
    vin, n1, vout = ckt.net("vin"), ckt.net("n1"), ckt.net("vout")
    ckt.add(M.VSource, "V1", (vin, ckt.gnd), dict(dc=0.0, ac=1.0))
    ckt.add(M.Inductor, "L1", (vin, n1), dict(l=1.5))
    ckt.add(M.Capacitor, "C2", (n1, ckt.gnd), dict(c=4.0 / 3.0))
    ckt.add(M.Inductor, "L3", (n1, vout), dict(l=0.5))
    ckt.add(M.Resistor, "R4", (vout, ckt.gnd), dict(r=1.0))
    return ckt


COUPLED = """* transformer
V1 vin 0 DC 0 AC 1
R1 vin p 1
L1 p 0 1m
L2 s 0 4m
K1 L1 L2 0.999
RL s 0 1meg
"""


def _load(M, text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return M.elaborate(M.parse_spice(text))


def _compiled(M, ckt):
    kw = {} if M is J else {"device": "cpu"}
    return M.compile_circuit(ckt, **kw)


CASES = {
    # name: (circuit factory, frequencies, observables, ctx kwargs)
    "rc_lowpass": (_rc, J.acdec(10, 1.0, 1e5), ("vout", "V1.I", "C1.I"),
                   {}),
    "butterworth": (_butterworth, np.logspace(-2, 1, 40) / (2 * np.pi),
                    ("vout", "vin", "L3.V", "V1.I"), {}),
    "coupled_inductors": (lambda M: _load(M, COUPLED),
                          J.acdec(5, 1e2, 1e6), ("s", "p", "v1.I"), {}),
    "bipolar_amplifier": (lambda M: _load(M, BJT_AMP),
                          J.acdec(5, 10.0, 1e8), ("out", "nc", "vin1.I"),
                          dict(gmin=1e-12)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ac_matches_jax(name):
    build, freqs, names, ckw = CASES[name]
    cj, ct = _compiled(J, build(J)), _compiled(T, build(T))
    assert ct.x_names == cj.x_names
    sj = J.ac(cj, freqs, ctx=J.SimSpec.make(**ckw))
    st = T.ac(ct, freqs, ctx=T.SimSpec.make(**ckw))
    assert st.v.device == torch.device("cpu")
    np.testing.assert_array_equal(ct.ac_rhs().numpy(),
                                  np.asarray(cj.ac_rhs()))
    _close_per_freq(st.v.numpy(), sj.v)
    _close_obs(st, sj, names)


def test_ac_rhs_exact_with_phase_and_current_sources():
    text = ("* drives\nV1 a 0 DC 1 AC 0.7 33\nR1 a b 1k\n"
            "I1 0 b DC 0 AC 2m -120\nR2 b 0 2k\nV2 c 0 SIN(0 1 1k) AC 1.5 "
            "200\nR3 c b 3k\nI2 c 0 AC 1u 45\n")
    cj, ct = _compiled(J, _load(J, text)), _compiled(T, _load(T, text))
    bj, bt = np.asarray(cj.ac_rhs()), ct.ac_rhs().numpy()
    assert np.count_nonzero(bj) >= 4
    np.testing.assert_array_equal(bt, bj)


def test_s_element_divider_matches_jax(tmp_path):
    fgrid = np.logspace(3, 8, 201)
    (tmp_path / "rc.s1p").write_text(_s1p(fgrid))
    text = """* s-element divider
V1 in 0 DC 0 AC 1
RS in p 50
S1 p smod
.model smod sp file="rc.s1p"
.end
"""
    # on the grid and between its points (the interpolation), and beyond
    # both ends (the clamp)
    freqs = np.concatenate([fgrid[[20, 80, 140, 190]],
                            np.sqrt(fgrid[[30, 100]] * fgrid[[31, 101]]),
                            [1e2, 1e9]])
    out = {}
    for M in (J, T):
        nl = M.parse_spice(text, spice_dialect="hspice")
        ckt = M.elaborate(nl, include_paths=[str(tmp_path)])
        assert len(ckt.sparam_blocks) == 1
        out[M] = M.ac(_compiled(M, ckt), freqs)
    _close_per_freq(out[T].v.numpy(), out[J].v)
    _close_obs(out[T], out[J], ("p", "v1.I"))


@pytest.fixture(scope="module")
def dff_both():
    """The DFF AC/noise deck at dec 5 through both ``simulate``s."""
    text = netlists.dff_ac_noise(5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rj = J.simulate(text, include_paths=[netlists.DFF_DIR])
        rt = T.simulate(text, include_paths=[netlists.DFF_DIR],
                        device="cpu")
    return rj, rt


def test_dff_ac_matches_jax(dff_both):
    rj, rt = dff_both
    sj, st = rj["ac"], rt["ac"]
    assert len(st.freqs) == 76 and np.array_equal(st.freqs, sj.freqs)
    assert rt["compiled"].n_x == 25
    # the operating point first: the bistable latch settles the same way
    np.testing.assert_allclose(st.op_x.numpy(), np.asarray(sj.op_x),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(rt["compiled"].ac_rhs().numpy(),
                                  np.asarray(rj["compiled"].ac_rhs()))
    _close_per_freq(st.v.numpy(), sj.v)
    _close_obs(st, sj, ("q", "vvdd.I", "vq.I"))


def test_simulate_keys_match_jax(dff_both):
    rj, rt = dff_both
    assert set(rt) == set(rj)
    assert {"ac", "noise"} <= set(rt)
    # each package's noise at its own operating point (the gain of the
    # drive is compared at one operating point in test_torch_noise.py)
    nj, nt = rj["noise"], rt["noise"]
    np.testing.assert_allclose(nt.psd, nj.psd, rtol=1e-8, atol=0)
    assert nt.total() == pytest.approx(nj.total(), rel=1e-8)


MEAS_RC = """* rc with measures
V1 in 0 DC 0 AC 1 SIN(0 1 1k)
R1 in out 1k
C1 out 0 100n
.ac dec 20 10 100k
.tran 10u 3m
.four 1k v(out) v(in)
.meas ac gain_1k find vdb(out) at=1k
.meas ac f3db when vdb(out)=-3
.meas ac ph_10k find vp(out) at=10k
.meas tran vmax max v(out) from=2m to=3m
.meas tran tcross when v(out)=0.2 rise=2
.end
"""


def test_simulate_measures_and_four_match_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rj = J.simulate(MEAS_RC)
        rt = T.simulate(MEAS_RC, device="cpu")
    assert set(rt) == set(rj)
    sj, st = rj["tran"], rt["tran"]
    assert (st.n_accepted, st.n_rejected) == (sj.n_accepted, sj.n_rejected)
    mj, mt = rj["measures"], rt["measures"]
    assert set(mt) == set(mj) == {"gain_1k", "f3db", "ph_10k", "vmax",
                                  "tcross"}
    assert not mt.errors and not mj.errors
    for k in mj:
        assert mt[k] == pytest.approx(mj[k], rel=1e-6, abs=1e-12), k
    assert set(rt["fourier"]) == set(rj["fourier"]) == {"v(out)", "v(in)"}
    for name, fj in rj["fourier"].items():
        ft = rt["fourier"][name]
        assert ft["f0_mag"] == pytest.approx(fj["f0_mag"], rel=1e-4)
        for (kj, mj_, pj), (kt_, mt_, pt) in zip(fj["harmonics"],
                                                 ft["harmonics"]):
            assert kt_ == kj
            assert abs(mt_ - mj_) <= 1e-4 * fj["f0_mag"]
        assert ft["dc"] == pytest.approx(fj["dc"], rel=1e-4, abs=1e-6)


def test_simulate_dc_measure_matches_jax():
    text = ("* divider\nV1 a 0 1\nR1 a b 1k\nR2 b 0 3k\n"
            ".dc v1 0 2 0.25\n.meas dc vb1 find v(b) at=1\n"
            ".meas dc vmax max v(b)\n.meas dc cross when v(b)=0.9\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rj = J.simulate(text)
        rt = T.simulate(text, device="cpu")
    mj, mt = rj["measures"], rt["measures"]
    assert set(mt) == set(mj) == {"vb1", "vmax", "cross"}
    assert not mt.errors
    for k in mj:
        assert mt[k] == pytest.approx(mj[k], rel=1e-6), k
    assert mt["vb1"] == pytest.approx(0.75, rel=1e-9)


def test_acdec_matches_jax():
    for args in ((50, 1.0, 1e15), (5, 1e3, 1e15), (7, 3.0, 4e5)):
        np.testing.assert_array_equal(T.acdec(*args), J.acdec(*args))
    assert len(T.acdec(50, 1.0, 1e15)) == 751


def test_delay_sites_raise_naming_a14b():
    """A delay site's AC: exact on the dense path; on the sparse path it
    raises, naming the JAX package's silent linearisation at aux = 0."""
    from cedarsim_tpu_torch.va.codegen import load_va
    from tests.test_va_delay_history import VA

    td = 2e-6
    dly = load_va(VA, delay_mode="history")["vdelay"]
    ckt = T.Circuit()
    vin, out = ckt.net("vin"), ckt.net("out")
    ckt.add(T.VSource, "V1", (vin, ckt.gnd), dict(dc=0.0, ac=1.0))
    ckt.add(dly, "X1", (out, ckt.gnd, vin, ckt.gnd), dict(td=td))
    ckt.add(T.Resistor, "RL", (out, ckt.gnd), dict(r=1e4))
    freqs = np.array([1e3, 1e6])
    h = T.ac(T.compile_circuit(ckt, device="cpu"), freqs)["out"]
    np.testing.assert_allclose(h, np.exp(-2j * np.pi * freqs * td),
                               rtol=0.0, atol=1e-9)
    sp = T.compile_circuit(ckt, device="cpu", sparse=True)
    with pytest.raises(NotImplementedError, match="ac.py:107-109"):
        T.ac(sp, [1e3])
    with pytest.raises(NotImplementedError, match="ac.py:107-109"):
        T.noise(sp, "out", [1e3])
