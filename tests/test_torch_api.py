"""``cedarsim_tpu_torch.simulate`` (the port's netlist front door) against
the JAX package's ``simulate`` on the CPU in float64.

- The README's level-1 CMOS inverter and a netlist with every newly bound
  card (L with K, a pulsed I source, E, F, G, H, S, W, D, Q, J, Z, two B
  sources, SIN and EXP; ``benchmarks/netlists.py``) through both
  ``simulate``s: the same accepted and rejected steps, the operating point
  within 1e-9 V and every node at five stated times within 1e-6 V.
- The netlist's directives as the JAX package reads them: ``.op`` alone,
  no analysis (an operating point), ``tmax``, ``uic``, ``.options
  method=trap`` and ``method=gear`` (BDF2 up to ``maxord=2``, BDF3 at
  3, the order-5 ladder above).
- What is not ported raises ``NotImplementedError`` naming its ROADMAP
  item, and nothing is skipped: Spectre text and ``alter`` (A19),
  ``.save``, ``.probe`` and ``.data`` (A19, in the elaborator).  ``.dc`` runs (its tests are in
  ``tests/test_torch_sweeps.py``), and so do ``.ac``, ``.noise``,
  ``.four`` and ``.measure`` (``tests/test_torch_ac.py``; here: the keys
  they add).
"""

import warnings

import numpy as np
import pytest

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.api import tran_options
from cedarsim_tpu_torch.benchmarks import netlists


def _both(text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return J.simulate(text), T.simulate(text, device="cpu")


@pytest.mark.parametrize("name", ["readme_inverter", "all_cards"])
def test_simulate_matches_jax(name):
    text, times = {"readme_inverter": (netlists.README_INVERTER,
                                       netlists.README_TIMES),
                   "all_cards": (netlists.ALL_CARDS,
                                 netlists.ALL_CARDS_TIMES)}[name]
    rj, rt = _both(text)
    sj, st = rj["tran"], rt["tran"]
    assert sj.converged and st.converged
    assert (st.n_accepted, st.n_rejected) == (sj.n_accepted, sj.n_rejected)
    names = rt["compiled"].node_names
    assert names == rj["compiled"].node_names
    nodes = len(names)
    np.testing.assert_allclose(st.xs[0, :nodes],
                               np.asarray(sj.xs)[0, :nodes], rtol=0,
                               atol=1e-9)
    for n in names:
        for t in times:
            assert abs(float(st.interp(n, t)) - float(sj.interp(n, t))) \
                <= 1e-6, (n, t)


def _rc(extra):
    return f"* rc\nV1 a 0 PULSE(0 1 1n 1n 1n 5n 20n)\nR1 a b 1k\n" \
           f"C1 b 0 1p\n{extra}\n"


def test_op_and_default_analysis():
    for text in (_rc(".op"), _rc("")):
        rj, rt = _both(text)
        assert set(rt) - {"circuit", "compiled"} == {"op"}
        np.testing.assert_allclose(rt["op"].x.numpy(), np.asarray(rj["op"].x),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("extra, want", [
    (".tran 0.1n 40n", dict(hmax_frac=min(0.04, 5 * 0.1e-9 / 40e-9))),
    (".tran 0.1n 40n 0 0.2n", dict(hmax_frac=0.2e-9 / 40e-9)),
    (".tran 0.1n 40n uic", dict(uic=True)),
    (".tran 1n 40n\n.options method=trap", dict(method="trap")),
    (".tran 1n 40n\n.options method=gear", dict(method="bdf2")),
    (".tran 1n 40n\n.options method=gear maxord=2", dict(method="bdf2")),
    (".tran 1n 40n\n.options method=gear maxord=3", dict(method="bdf3")),
    (".tran 1n 40n\n.options method=gear maxord=5", dict(method="bdf5")),
])
def test_tran_directive_options(extra, want):
    """The options the netlist asks for, and the JAX package's transient
    under the same directive: the same steps, the waveform within 1e-6
    V."""
    rj, rt = _both(_rc(extra))
    opts = tran_options(rt["circuit"])
    for k, v in want.items():
        assert getattr(opts, k) == pytest.approx(v), k
    sj, st = rj["tran"], rt["tran"]
    assert (st.n_accepted, st.n_rejected) == (sj.n_accepted, sj.n_rejected)
    for t in np.linspace(2e-9, 38e-9, 5):
        assert abs(float(st.interp("b", t)) - float(sj.interp("b", t))) \
            <= 1e-6


@pytest.mark.parametrize("extra, item", [
    (".tran 1n 40n\n.save v(b)", "A19"),
    (".tran 1n 40n\n.probe v(b)", "A19"),
    (".tran 1n 40n\n.data d1 r1 1k 2k\n.enddata", "A19"),
])
def test_unported_directives_raise(extra, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        T.simulate(_rc(extra), device="cpu")


@pytest.mark.parametrize("extra, keys", [
    (".ac dec 5 1k 1meg", {"ac"}),
    (".noise v(b) v1 dec 5 1k 1meg", {"noise"}),
    (".tran 1n 40n\n.four 50meg v(b)", {"tran", "fourier"}),
    (".tran 1n 40n\n.measure tran vmax max v(b)", {"tran", "measures"}),
])
def test_ported_directives_run(extra, keys):
    rj, rt = _both(_rc(extra))
    assert set(rt) - {"circuit", "compiled"} == keys
    assert set(rt) == set(rj)


@pytest.mark.parametrize("text, kw", [
    ("simulator lang=spectre\nv1 (a 0) vsource dc=1\n", {}),
    ("* rc\nV1 a 0 1\nR1 a 0 1k\n", {"dialect": "spectre"}),
    ("* rc\nV1 a 0 1\nR1 a 0 1k\n", {"file": "rc.scs"}),
])
def test_spectre_raises(text, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A19"):
        T.simulate(text, device="cpu", **kw)
