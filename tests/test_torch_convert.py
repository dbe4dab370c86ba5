"""``cedarsim_tpu_torch.tools.convert`` (a copy of the JAX package's
SPICE/Spectre/Verilog-A converter) on ``tests/test_convert.py``'s
netlists: every conversion gives the JAX package's text, and the
semantic round trips run through the port's own ``simulate(device=
"cpu")``: the converted Spectre netlist's operating point (or transient)
against the JAX package's ``simulate`` of the original (1e-9 V; 1e-6 V
with BSIM4, where Newton stops at its tolerance; the transient within
1e-9 V at the JAX test's times with the same steps); the SPICE text
converted back elaborates through the port.  The CLI runs as ``python -m
cedarsim_tpu_torch.tools.convert``.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.tools import convert as jconv
from cedarsim_tpu_torch.tools import convert as tconv

DIVIDER = """* divider with expression params
.param rr=2k vv={1+0.5}
v1 in 0 dc {2*vv}
r1 in mid {rr}
r2 mid 0 1k
c1 mid 0 1n
.op
.end
"""
BSIM4_INV = """* bsim4 inverter (level 54)
.model nch nmos level=54 toxe=4.1e-9 ndep=3.5e17 vth0=0.47 k1=0.55 k2=0.03
+ u0=320 ua=1.2e-9 ub=2e-18 vsat=9e4 rdsw=180 voff=-0.09 nfactor=1.2
+ cgso=3.5e-10 cgdo=3.5e-10 xj=1.6e-7
.model pch pmos level=54 toxe=4.1e-9 ndep=2.5e17 vth0=-0.45 k1=0.5 k2=0.02
+ u0=120 ua=1.4e-9 ub=2e-18 vsat=7e4 rdsw=300 voff=-0.1 nfactor=1.3
+ cgso=3.5e-10 cgdo=3.5e-10 xj=1.6e-7
vdd vdd 0 1.8
vin in 0 dc 0.6
mn out in 0 0 nch w=1u l=0.18u
mp out in vdd vdd pch w=2u l=0.18u
.end
"""
SUBCKT_PULSE = """* subckt + sources torture
.subckt lp in out r=1k c=1n
r1 in out {r}
c1 out 0 {c}
.ends
v1 in 0 dc 0 pulse(0 5 1u 1n 1n 4u 10u)
x1 in out lp r=2k
.tran 1n 20u
.end
"""
DIRECTIVES = """* directives
v1 a 0 dc 1 ac 1
r1 a b 1k
c1 b 0 1n
.option reltol=1e-4
.temp 85
.ic v(b)=0.5
.global vdd!
.tran 1n 10u
.ac dec 10 1 1e6
.op
.end
"""
VA_RT_SUBCKT = """* rc block
.subckt blk in out r=1k
r1 in out {r}
r2 out 0 2k
c1 out 0 1p
.ends
.end
"""
VA_RT_CTRL = """* controlled/behavioral block
.subckt amp in out
v1 ref 0 1
e1 mid 0 in 0 2
bload out 0 v={v(mid)+0.5*i(v1)}
.ends
.end
"""
HIERARCHY = """* tb
.param vddv=1.8
.model nch nmos level=54 vth0=0.47
.subckt lp a b r=1k
r1 a b {r}
.ends
vdd vdd 0 {vddv}
vp p 0 pulse(0 {vddv} 1n 100p 100p 4n 10n)
vs s 0 sin(0 1 1meg)
m1 out p 0 0 nch w=1u l=0.1u
x1 out qq lp r=2k
.tran 1n 20n
.end
"""
VBIC = """* vbic map
.model qv npn level=4 is=1e-16
q1 c b 0 0 qv
.end
"""
TEXTS = {"divider": DIVIDER, "bsim4_inv": BSIM4_INV,
         "subckt_pulse": SUBCKT_PULSE, "directives": DIRECTIVES,
         "va_subckt": VA_RT_SUBCKT, "va_ctrl": VA_RT_CTRL,
         "hierarchy": HIERARCHY, "vbic": VBIC}


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_conversions_equal_the_jax_packages(name):
    """SPICE to Spectre, to Verilog-A, and the Spectre text back to
    SPICE: the same text from both packages."""
    text = TEXTS[name]
    for out in ("spectre", "veriloga", "spice"):
        got = tconv.convert_text(text, "spice", out)
        assert got == jconv.convert_text(text, "spice", out), out
    scs = tconv.convert_text(text, "spice", "spectre")
    assert tconv.convert_text(scs, "spectre", "spice") == \
        jconv.convert_text(scs, "spectre", "spice")


def _op(res):
    comp = res["compiled"]
    return {n: float(np.asarray(res["op"].x)[i])
            for i, n in enumerate(comp.node_names)}


@pytest.mark.parametrize("name, tol", [("divider", 1e-9),
                                       ("bsim4_inv", 1e-6)])
def test_dc_roundtrip_through_the_port(name, tol):
    """SPICE → Spectre through the port's ``simulate``: every node of the
    JAX package's operating point of the original; the SPICE text
    converted back parses and elaborates through the port."""
    text = TEXTS[name]
    ref = _op(_quiet(J.simulate, text))
    scs = tconv.convert_text(text, "spice", "spectre")
    assert "simulator lang=spectre" in scs
    res = _quiet(T.simulate, scs, dialect="spectre", device="cpu")
    for n, v in _op(res).items():
        assert v == pytest.approx(ref[n], abs=tol), n
    # and back to SPICE, through the port's SPICE front end
    cir = tconv.convert_text(scs, "spectre", "spice")
    back = _quiet(T.elaborate, T.parse_spice(cir))
    assert sorted(i.name for i in back.instances) == \
        sorted(i.name for i in _quiet(T.load_spice, cir).instances)


def test_subckt_pulse_transient_roundtrip_through_the_port():
    """The converted Spectre text's transient through the port's
    ``simulate``: the JAX package's steps on the original and its
    waveform within 1e-9 V at the JAX test's times."""
    scs = tconv.convert_text(SUBCKT_PULSE, "spice", "spectre")
    assert "subckt lp" in scs and "type=pulse" in scs
    sj = _quiet(J.simulate, SUBCKT_PULSE)["tran"]
    st = _quiet(T.simulate, scs, dialect="spectre", device="cpu")["tran"]
    assert st.converged and sj.converged
    assert (st.n_accepted, st.n_rejected) == (sj.n_accepted, sj.n_rejected)
    for t in (0.5e-6, 3e-6, 6e-6, 12e-6):
        assert float(st.interp("out", t)) == pytest.approx(
            float(sj.interp("out", t)), abs=1e-9)


@pytest.mark.parametrize("name, drive, want", [
    ("va_subckt", "v1 vin 0 3\nx1 vin vout blk r=1k", 2.0),
    ("va_ctrl", "vin vin 0 1.5\nx1 vin vout amp", 3.0)])
def test_veriloga_roundtrip_through_the_port(tmp_path, name, drive, want):
    """A subckt converted to a VA module compiles through the port's VA
    pipeline and solves as the JAX package's does."""
    va = tconv.convert_text(TEXTS[name], "spice", "veriloga")
    f = tmp_path / f"{name}.va"
    f.write_text(va)
    code = f'* va roundtrip\n.hdl "{f}"\n{drive}\n.op\n'
    vt = _op(_quiet(T.simulate, code, device="cpu"))["vout"]
    vj = _op(_quiet(J.simulate, code))["vout"]
    assert vt == pytest.approx(want, abs=1e-6)
    assert vt == pytest.approx(vj, abs=1e-12)


def test_models_cli_and_helpers(tmp_path):
    nl = T.parse_spice(BSIM4_INV)
    db = tconv.extract_models(nl, source="inv.cir")
    assert db == jconv.extract_models(J.parse_spice(BSIM4_INV),
                                      source="inv.cir")
    json.dumps(db)
    assert tconv.fmt_num(1000.0) == "1000" and tconv.fmt_num(1e-9) == "1e-09"
    assert tconv.emit_expr(("bin", "*", ("num", 2.0), ("ref", "vv"))) \
        == "(2*vv)"
    src = tmp_path / "in.cir"
    src.write_text(BSIM4_INV)
    out, dbf = tmp_path / "out.scs", tmp_path / "db.json"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "cedarsim_tpu_torch.tools.convert", str(src),
         str(out), "--output-simulator", "spectre", "--extract-models",
         str(dbf)], cwd=repo, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert out.read_text() == jconv.convert_text(BSIM4_INV, "spice",
                                                 "spectre")
    assert len(json.loads(dbf.read_text())) == 2
