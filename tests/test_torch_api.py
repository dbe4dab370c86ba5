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
- Spectre text, however it is asked for, runs as in the JAX package
  (``tests/test_torch_spectre.py`` holds the Spectre decks, ``alter`` and
  ``statistics``).  ``.dc`` runs (its tests are in
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


@pytest.mark.parametrize("extra, stored", [
    (".tran 1n 40n\n.save v(b)", ("b",)),
    (".tran 1n 40n\n.probe v(b)", ("b",)),
    (".tran 1n 40n\n.data d1 r1 1k 2k\n.enddata", None),
])
def test_save_probe_data_directives_match_jax(extra, stored):
    """``.save``/``.probe`` project the transient onto their nets, as the
    JAX package's ``simulate`` does (the same stored columns and steps,
    the values within 1e-9 V); a ``.data`` table leaves the run whole and
    is recorded as the JAX package records it."""
    rj, rt = _both(_rc(extra))
    sj, st = rj["tran"], rt["tran"]
    assert tran_options(rt["circuit"]).store_vars == stored
    assert st.store_map == sj.store_map
    assert (st.n_accepted, st.n_rejected) == (sj.n_accepted, sj.n_rejected)
    np.testing.assert_allclose(st.xs, np.asarray(sj.xs), rtol=0, atol=1e-9)
    assert [d for d in rt["circuit"].directives if d[0] == "data"] == \
        [d for d in rj["circuit"].directives if d[0] == "data"]


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
    ("simulator lang=spectre\nv1 (a b) vsource dc=1\nr1 (b 0) resistor "
     "r=1k\n", {}),
    ("// rc\nv1 (a b) vsource dc=1\nr1 (b 0) resistor r=1k\n",
     {"dialect": "spectre"}),
    ("// rc\nv1 (a b) vsource dc=1\nr1 (b 0) resistor r=1k\n",
     {"file": "rc.scs"}),
])
def test_spectre_runs(text, kw):
    """Each way of asking for Spectre (``simulator lang=``, ``dialect=``,
    a ``.scs`` file name) parses the Spectre grammar, as the JAX package's
    ``simulate`` does: the same operating point (a = 1 V above b = 0)."""
    rj, rt = _both_kw(text, **kw)
    assert rt["compiled"].node_names == rj["compiled"].node_names
    np.testing.assert_allclose(rt["op"].x.numpy(), np.asarray(rj["op"].x),
                               rtol=0, atol=1e-12)
    c = rt["compiled"]
    assert float(rt["op"].x[c.node_names.index("a")]) == pytest.approx(1.0)


def _both_kw(text, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (J.simulate(text, **kw),
                T.simulate(text, device="cpu", **kw))
