"""``cedarsim_tpu_torch.frontend.alter`` (a copy of the JAX package's
module) against the JAX package's on ``tests/test_frontend.py``'s four
``alter`` cases: every call returns the same text, or raises the same
error, in both, and the re-emitted netlist simulates through the port's
``simulate`` with the substituted value, as through the JAX package's.
"""

import warnings

import numpy as np
import pytest

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.frontend import alter as jalter
from cedarsim_tpu_torch.frontend import alter as talter

REEMIT = """* altered
.param rr=1k cc='rr*1n'
V1 a 0 5
R1 a b {rr}
C1 b 0 c=2p
.op
"""
SCOPED = """* scoped
.subckt blockA in out
.param rr=100
R1 in out {rr}
.ends
.subckt blockB in out
.param rr=200
R1 in out {rr}
.ends
XA a b blockA
XB b c blockB
RL c 0 rr=50
.end
"""
CONT = "* t\nX1 a b sub w=1u\n+ l=2u\nX2 a b sub w=3u\n.end\n"
HEADER = ("* hdr\n.subckt inv a y wn=2u wp=4u\nM1 y a 0 0 nmos w=wn\n"
          ".ends\nX1 in out inv\n.end\n")
NESTED = ("* n\n.subckt outer a b\n.subckt inner c d rr=10\nR1 c d rr\n"
          ".ends\nX1 a b inner\n.ends\n.end\n")
PATHOLOGICAL = ("* comment mentioning w=99 stays\n"
                "r1 a b r='x=1 ? 2 : 3' x=2 $ trailing x=5 note\n"
                "r2 b c r={x=7} w=3\n"
                "+ l=4\n"
                ".subckt sub p q\n"
                "r3 p q r=10 // spectre note r=77\n"
                ".ends\n")

#: test_frontend.py's calls, by test: (source, keyword arguments)
CASES = {
    "reemission": [(REEMIT, dict(rr=3000, c=5e-12))],
    "scoped": [(SCOPED, dict(scoped={"blockA.rr": 111})),
               (CONT, dict(scoped={"x1.w": "9u"})),
               (CONT, dict(scoped={"x1.l": "7u"})),
               (SCOPED, dict(scoped={"blockC.rr": 1})),
               (SCOPED, dict(scoped={"blockA.zz": 1}))],
    "subckt_header_default": [(HEADER, dict(scoped={"inv.wn": "5u"})),
                              (NESTED, dict(scoped={"inner.rr": 33})),
                              (NESTED, dict(scoped={"outer.rr": 44}))],
    "offset_exact_pathological": [
        (PATHOLOGICAL, dict(x=9)), (PATHOLOGICAL, dict(w=8)),
        (PATHOLOGICAL, dict(scoped={"r2.l": 6})),
        (PATHOLOGICAL, dict(scoped={"sub.r": 20})),
        (PATHOLOGICAL, dict(x=2)), (PATHOLOGICAL, dict(nonexistent=1))],
}


def _call(mod, src, kw):
    try:
        return mod.alter(src, **kw)
    except mod.AlterError as e:
        return ("AlterError", str(e))


@pytest.mark.parametrize("name", sorted(CASES))
def test_alter_equals_the_jax_packages(name):
    outs = [_call(talter, src, kw) for src, kw in CASES[name]]
    assert outs == [_call(jalter, src, kw) for src, kw in CASES[name]]
    if name == "reemission":
        out = outs[0]
        assert ".param rr=3000 cc='rr*1n'" in out
        assert "C1 b 0 c=5e-12" in out and "R1 a b {rr}" in out
    if name == "offset_exact_pathological":
        assert outs[4] == PATHOLOGICAL          # the same text: a no-op
        assert outs[5][0] == "AlterError"


def test_altered_source_simulates_as_in_the_jax_package():
    out = talter.alter(REEMIT, rr=3000, c=5e-12).replace("{rr}", "'rr'")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rj, rt = J.simulate(out), T.simulate(out, device="cpu")
    assert rt["circuit"].instances[1].params["r"] == 3000.0
    np.testing.assert_allclose(rt["op"].x.numpy(), np.asarray(rj["op"].x),
                               rtol=0, atol=1e-12)
