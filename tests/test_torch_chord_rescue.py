"""The full-Newton rescue of a failed per-step chord certify on the
rectifier of ``tests/test_chord_rescue.py`` (a ±5 V pulse through 100 Ω
into a diode, ``max_newton=4``), the port against the JAX package on the
CPU: in all six configurations (cap and charge form; rescue on at once,
gated off by an unreachable ``rescue_after``, and off) the same accepted,
rejected and Newton counts, and the waveform within 1e-9 V of the JAX
package's; the JAX test's claims on the port's runs (the rescue cuts the
rejections and the Newton iterations, the gated-off run is the run with
the rescue off); the rescued waveform within 0.03 V of a full-Newton
reference.  Cap form: 200 / 18 / 545 with the rescue, 244 / 36 / 615
without it (accepted / rejected / Newton).
"""

import numpy as np
import pytest

import cedarsim_tpu as J
import cedarsim_tpu_torch as T

TSPAN = (0.0, 2e-6)
RESCUE = {"on": dict(chord_fallback=True, rescue_after=0),
          "gated_off": dict(chord_fallback=True, rescue_after=1 << 20),
          "off": dict(chord_fallback=False, rescue_after=0)}
#: (accepted, rejected, Newton) of the JAX package's cap-form runs
CAP_COUNTS = {"on": (200, 18, 545), "off": (244, 36, 615)}


def _rectifier(M, **kw):
    ckt = M.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(M.VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=-5.0, v2=5.0, td=1e-7, tr=1e-9, tf=1e-9, pw=4e-7,
                 per=1e-6))
    ckt.add(M.Resistor, "R1", (vin, vout), dict(r=100.0))
    ckt.add(M.Diode, "D1", (vout, ckt.gnd), dict(**{"is": 1e-14}, n=1.0))
    ckt.add(M.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-12))
    return M.compile_circuit(ckt, **kw)


def _opts(M, form, rescue):
    return M.TranOptions(jac_reuse=1, max_newton=4, rtol=1e-2, atol=1e-4,
                         max_steps=8192, formulation=form, **RESCUE[rescue])


def _counts(sol):
    return sol.n_accepted, sol.n_rejected, sol.n_newton


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs in every configuration, made once."""
    cj, ct = _rectifier(J), _rectifier(T, device="cpu")
    out = {}
    for form in ("cap", "charge"):
        for rescue in RESCUE:
            out[form, rescue] = (
                J.tran(cj, TSPAN, opts=_opts(J, form, rescue)),
                T.tran(ct, TSPAN, opts=_opts(T, form, rescue)))
    return out


@pytest.mark.parametrize("form", ["cap", "charge"])
@pytest.mark.parametrize("rescue", sorted(RESCUE))
def test_counts_and_waveform_equal_the_jax_packages(runs, form, rescue):
    sj, st = runs[form, rescue]
    assert st.converged and sj.converged
    assert _counts(st) == _counts(sj)
    if form == "cap" and rescue in CAP_COUNTS:
        assert _counts(st) == CAP_COUNTS[rescue]
    for t in np.linspace(1.5e-7, 1.9e-6, 9):
        assert abs(float(st.interp("vout", t))
                   - float(sj.interp("vout", t))) <= 1e-9


@pytest.mark.parametrize("form", ["cap", "charge"])
def test_rescue_cuts_rejections_and_the_gate_holds(runs, form):
    on, gated, off = (runs[form, r][1] for r in ("on", "gated_off", "off"))
    assert on.n_rejected < off.n_rejected
    # an unreachable gate is the rescue switched off
    assert (gated.n_rejected, gated.n_newton) == \
        (off.n_rejected, off.n_newton)
    if form == "cap":
        assert off.n_rejected >= on.n_rejected + 10
        assert on.n_newton < off.n_newton


def test_rescue_waveform_matches_full_newton_reference(runs):
    ref = T.tran(_rectifier(T, device="cpu"), TSPAN,
                 opts=T.TranOptions(rtol=1e-3, atol=1e-5, max_steps=16384))
    fb = runs["cap", "on"][1]
    assert ref.converged
    for t in np.linspace(1.5e-7, 1.9e-6, 9):
        assert abs(float(fb.interp("vout", t))
                   - float(ref.interp("vout", t))) < 0.03
