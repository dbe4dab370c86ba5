"""The port's Spectre front end against the JAX package's on the CPU in
float64: ``tests/test_spectre.py``'s decks through both ``simulate``s.

- Operating points (the divider, the mixed-language deck, a model master,
  a user function, an inline subcircuit) agree to round-off: 1e-12 in
  the linear decks, 1e-9 with the level-1 MOSFET, where Newton stops at
  its tolerance from iterates that part in their last bits (3e-11 apart
  here).
- The subcircuit RC's transient: the same accepted and rejected steps,
  and the waveform within 1e-9 V at the JAX test's sample times.
- ``altergroup`` and a device ``alter``: every segment's operating point
  under the same suffixed keys, to round-off.
- ``statistics`` blocks: every instance's drawn parameter equal as a
  float to the JAX package's (nominal, seeded, mismatch per instance,
  derived parameters, ``percent=yes``), and an undefined parameter the
  same ``ElabError``.
"""

import warnings

import numpy as np
import pytest

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.frontend.elaborate import ElabError as JElabError
from cedarsim_tpu.frontend.spectre import parse_spectre as j_parse
from cedarsim_tpu_torch.frontend.elaborate import ElabError as TElabError
from cedarsim_tpu_torch.frontend.spectre import parse_spectre as t_parse

OP_DECKS = {
    "divider": ("""// spectre divider
simulator lang=spectre
parameters rtop=1k rbot=3k
v1 (vin 0) vsource dc=2
r1 (vin vmid) resistor r=rtop
r2 (vmid 0) resistor r=rbot
op1 dc
""", "spectre", "vmid", 1.5),
    "mixed_language": ("""* spice section first
V1 a 0 1
R1 a b 1k
simulator lang=spectre
r2 (b 0) resistor r=1k
op1 dc
""", "spice", "b", 0.5),
    "model_master": ("""// model master
simulator lang=spectre
model mynmos nmos (level=1 vto=0.7 kp=100u)
v1 (vdd 0) vsource dc=3.3
v2 (g 0) vsource dc=3.3
r1 (vdd d) resistor r=10k
m1 (d g 0 0) mynmos w=10u l=1u
op1 dc
""", "spectre", "d", None),
    "user_function": ("""// user functions
simulator lang=spectre
real rscale(real base, real k) {
    return base * k + 100;
}
parameters rbase=1k rk=2
V1 (in 0) vsource dc=2.1
R1 (in out) resistor r=rscale(rbase, rk)
R2 (out 0) resistor r=rscale(rbase, rk)
""", "spectre", "out", 1.05),
    "inline_subckt": ("""// inline subckt
simulator lang=spectre
inline subckt myres (p n)
parameters r=1k
myres (p n) resistor r=r
ends myres
V1 (in 0) vsource dc=1.0
X1 (in mid) myres r=2k
X2 (mid 0) myres r=2k
""", "spectre", "mid", 0.5),
}

SUBCKT_TRAN = """// spectre rc
simulator lang=spectre
subckt lowpass (in out)
parameters r=1k c=1u
r1 (in out) resistor r=r
c1 (out 0) capacitor c=c
ends lowpass
v1 (vin 0) vsource type=pulse val0=0 val1=1 delay=1m rise=1u fall=1u width=10m
x1 (vin vout) lowpass r=2k
tran1 tran stop=5m
"""

ALTER_DECKS = {
    "altergroup": ("""// altergroup
simulator lang=spectre
parameters rr=1k
V1 (in 0) vsource dc=1.0
R1 (in out) resistor r=rr
R2 (out 0) resistor r=1k
op1 op
ag1 altergroup {
parameters rr=3k
}
op2 op
""", "ag1", 0.5, 0.25),
    "device_alter": ("""// device alter
simulator lang=spectre
V1 (in 0) vsource dc=1.0
R1 (in out) resistor r=1k
R2 (out 0) resistor r=1k
op1 op
a1 alter dev=r2 param=r value=3k
op2 op
""", "a1", 0.5, 0.75),
}

STATS_DECK = """// stats
simulator lang=spectre
parameters r0=1k c0=1p
statistics {
   process {
      vary r0 dist=gauss std=100
   }
   mismatch {
      vary r0 dist=gauss std=10
   }
}
i1 (0 a) isource dc=1m
r1 (a 0) resistor r=r0
"""

MATCHED = """// matched pair
simulator lang=spectre
parameters r0=1k rd=r0*2
statistics {
   process  { vary r0 dist=gauss std=100 }
   mismatch { vary r0 dist=gauss std=10 }
}
r1 (a 0) resistor r=r0
r2 (a 0) resistor r=r0
r3 (a 0) resistor r=rd
r4 (a 0) resistor r=rd
"""

PERCENT = """// stats pct
simulator lang=spectre
parameters r0=1k
statistics {
   process { vary r0 dist=gauss std=5 percent=yes }
}
r1 (a 0) resistor r=r0
"""


def _both(text, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return J.simulate(text, **kw), T.simulate(text, device="cpu", **kw)


def _node(res, key, node):
    comp = res["compiled" + key[len("op"):]]
    return float(np.asarray(res[key].x)[comp.node_names.index(node)])


@pytest.mark.parametrize("name", sorted(OP_DECKS))
def test_operating_points_match_jax(name):
    text, dialect, node, want = OP_DECKS[name]
    rj, rt = _both(text, dialect=dialect)
    assert bool(rt["op"].converged)
    assert rt["compiled"].node_names == rj["compiled"].node_names
    np.testing.assert_allclose(rt["op"].x.numpy(), np.asarray(rj["op"].x),
                               rtol=0, atol=1e-12 if want else 1e-9)
    v = _node(rt, "op", node)
    if want is None:
        assert v < 0.5                   # the strong NMOS pulls d low
    else:
        assert abs(v - want) < 1e-6


def test_subckt_transient_matches_jax():
    rj, rt = _both(SUBCKT_TRAN, dialect="spectre")
    sj, st = rj["tran"], rt["tran"]
    assert st.converged and sj.converged
    assert (st.n_accepted, st.n_rejected) == (sj.n_accepted, sj.n_rejected)
    for t in (1.5e-3, 2e-3, 3e-3, 4e-3, 5e-3):
        assert abs(float(st.interp("vout", t))
                   - float(sj.interp("vout", t))) <= 1e-9
    # tau = 2k * 1u = 2 ms: one tau after the edge
    assert abs(float(st.interp("vout", 3e-3)) - (1 - np.exp(-1))) < 0.02


@pytest.mark.parametrize("name", sorted(ALTER_DECKS))
def test_alter_segments_match_jax(name):
    text, label, base, altered = ALTER_DECKS[name]
    rj, rt = _both(text, dialect="spectre")
    assert sorted(k for k in rt if "@" in k) == \
        sorted(k for k in rj if "@" in k)
    for key, want in (("op", base), (f"op@{label}", altered)):
        np.testing.assert_allclose(rt[key].x.numpy(), np.asarray(rj[key].x),
                                   rtol=0, atol=1e-12)
        assert abs(_node(rt, key, "out") - want) < 1e-9


def _draws(mod_elab, parse, text, seed):
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # no approximation warning
        ckt = mod_elab(parse(text), mc_seed=seed)
    return {i.name: float(i.params["r"]) for i in ckt.instances
            if i.name.startswith("r")}


@pytest.mark.parametrize("deck, seed", [
    ("stats", None), ("stats", 7), ("stats", 8), ("matched", 11),
    ("process_only", 11), ("percent", 3)])
def test_statistics_draws_equal_the_jax_packages(deck, seed):
    text = {"stats": STATS_DECK, "matched": MATCHED, "percent": PERCENT,
            "process_only": MATCHED.replace(
                "mismatch { vary r0 dist=gauss std=10 }", "")}[deck]
    got = _draws(T.elaborate, t_parse, text, seed)
    assert got == _draws(J.elaborate, j_parse, text, seed)
    if deck == "matched":
        assert got["r1"] != got["r2"] and got["r3"] != got["r4"]
    if deck == "process_only":
        assert got["r1"] == got["r2"] and got["r3"] == got["r4"]
    if seed is None:
        assert got == {"r1": 1000.0}


def test_statistics_operating_point_and_undefined():
    """The seeded statistics deck's operating point through both packages
    (the resistor's drawn value times 1 mA), and an undefined varied
    parameter an ``ElabError`` naming it in both."""
    rj, rt = _both(STATS_DECK, dialect="spectre", mc_seed=7)
    np.testing.assert_allclose(rt["op"].x.numpy(), np.asarray(rj["op"].x),
                               rtol=1e-12, atol=0)
    bad = """// stats bad
simulator lang=spectre
statistics { process { vary nope dist=gauss std=1 } }
r1 (a 0) resistor r=1k
"""
    with pytest.raises(JElabError, match="nope"):
        J.elaborate(j_parse(bad), mc_seed=1)
    with pytest.raises(TElabError, match="nope"):
        T.elaborate(t_parse(bad), mc_seed=1)
