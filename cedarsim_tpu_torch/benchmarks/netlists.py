"""Netlists that ``chip_smoke.py`` drives through ``simulate`` on the card
and that ``tests/test_torch_api.py`` holds against the JAX package, with
the times at which their waveforms are compared.

- ``README_INVERTER``: the README's first example, a level-1 CMOS
  inverter driven by a pulse.
- ``ALL_CARDS``: one netlist with every card the port binds beyond R, C,
  V and BSIM4: L with K coupling, a pulsed I source, E, F, G, H, S, W, D,
  Q, J, Z, two B sources, and SIN and EXP sources.
- :func:`dff_ac_noise`: the gf180 DFF BSIM4 testbench
  (``benchmarks/gf180_dff/dff_tb_bsim4.cir``) with ``AC 1`` on ``VVDD``
  and ``.ac``/``.noise v(q) vvdd`` over 1 Hz-1 PHz in place of its
  ``.TRAN``: the supply-to-Q transfer (the PSRR a designer reads off a
  flop) and Q's noise, 30 BSIM4 instances with two noise sources each.
- ``INVERTER_NOISE``: the gf180 BSIM4 inverter noise testbench (the
  reference's ``inverter_noise.jl`` topology on ``models_bsim4.spice``),
  ``.noise v(q) vd`` on the ngspice table's grid, ``dec 5`` over 1 kHz-1
  PHz.
- :func:`diode_ladder`: RC ladders with diode clamps, 259 unknowns at
  its default size (a sparse circuit), the sensitivities' sparse case.
- :func:`a21_circuit` / :func:`a21_lanes`: the emitter's integer, bitwise
  and point-list constructs (``VA_A21``, :class:`PwlConductance`) in one
  circuit, four lanes of ``code``.
- ``CMG_INVERTER_NOISE``: the reference's BSIM-CMG inverter noise circuit
  on the ASAP7 TT Spectre deck ``7nm_TT.scs``: pass the deck's directory
  in ``include_paths``.
- :func:`chain_netlist`: the N-cell gf180 DFF shift register (Q of cell k
  drives D of cell k + 1, every cell on one CLKN), the JAX package's
  large-circuit workload of the sparse Newton path; 40 BSIM4 cells are
  452 unknowns.  :func:`chain` parses, elaborates and compiles it.

- ``VBIC_AMP``: the reference's bipolar common-emitter amplifier
  (``tests/test_bipolar_amplifier.py``: BC546B, a 1 mV 500 Hz drive, a
  100 kΩ load) with Q1 on a VBIC level-4 card mapped from that file's
  Gummel-Poon card (IBEI = IS/BF, IBCI = IS/BR, RBX = RBM, RBI = RB − RBM,
  the junction and transit parameters as they are) and self-heating on
  (RTH 250 K/W, a TO-92 junction to ambient; CTH 1 mJ/K), which puts the
  thermal node on the switched branch's I side.

- :func:`lossy_link`: the heavy-loss link of the JAX package's
  ``tests/test_ltra_urc.py`` (a 0→2 V PULSE at 10 ns, RS 50 Ω, an O
  element on ``LTRA (R=60 L=1.25u G=0 C=0.5n LEN=1)``, six sections, and
  RL): cell O.
- ``VA_DELAY_LINE``, ``VA_TRANSITION``, ``VA_ZI_FIR``, ``VA_ZI_IIR``: the
  Verilog-A modules of the JAX package's ``tests/test_va_delay_history.py``
  (an ``absdelay`` voltage line), ``tests/test_va_transition_latch.py``
  (``transition`` with separate rise and fall) and ``tests/test_va_zi.py``
  (a two-tap FIR and a one-pole IIR on a 1 µs clock), as text, and
  ``VA_TRANSITION_RAMP``, the transition module with a literal zero
  delay.
- :func:`pass_switch` / :func:`pass_switch_lanes`: one gf180
  ``nfet_06v0`` of ``models_bsim4.spice`` as a closed pass switch (gate
  at 5 V, W = 3.6 µm, L = 0.6 µm, a 10 kΩ load), the track phase of a
  sample-and-hold or a closed transmission gate.  At its operating point
  the drain sits exactly on the source (vds = 0), where BSIM4's ``vds =
  abs(vds_r)`` is differentiated at its kink (ROADMAP C17) and where the
  DELTA-smoothed Vdseff's tangent, identically zero there, is a rounding
  residue (C18).

The gf180 decks include files of ``DFF_DIR``: pass it in
``include_paths``.
"""

import os

README_INVERTER = """* cmos inverter
.model n1 nmos (level=1 vto=0.7 kp=100u cgso=1n cgdo=1n)
.model p1 pmos (level=1 vto=-0.7 kp=40u cgso=1n cgdo=1n)
vdd vdd 0 3.3
vin in 0 PULSE(0 3.3 2n 0.2n 0.2n 4n 10n)
mp out in vdd vdd p1 w=2u l=0.35u
mn out in 0 0 n1 w=1u l=0.35u
cl out 0 10f
.tran 0.1n 20n
"""
README_TIMES = (1e-9, 3e-9, 5e-9, 7e-9, 9e-9)

ALL_CARDS = """* every built-in card of the port
.model dmod d (is=1e-14 cjo=1p tt=1n)
.model qmod npn (is=1e-16 bf=100 vaf=50 cje=1p cjc=0.5p tf=0.1n)
.model jmod njf (vto=-2 beta=1e-3 lambda=0.02 cgs=1p cgd=0.5p)
.model zmod nmf (vto=-2 beta=2.5e-3 b=0.3 alpha=2 cgs=1p)
.model swm sw (ron=10 roff=1e6 vt=0.5 vh=0.1)
.model wm csw (ron=10 roff=1e6 it=0.5m ih=0.1m)
.param gain=2
vdd vdd 0 5
vsin in 0 SIN(0.5 0.5 20meg)
vexp ex 0 EXP(0 1 5n 5n 40n 10n)
r1 in p 50
l1 p 0 1u
l2 s 0 4u
k1 l1 l2 0.99
rl s 0 1k
i1 0 dn PULSE(0 1m 10n 1n 1n 20n 50n)
d1 dn 0 dmod
e1 eo 0 in 0 2
re eo 0 1k
g1 0 go in 0 1m
rg go 0 1k
vsense vdd fs 0
rf fs 0 1k
f1 0 fo vsense 0.5
rfo fo 0 100
h1 ho 0 vsense 100
rho ho 0 1k
rsw vdd sa 1k
s1 sa 0 ex 0 swm
rw vdd wa 1k
w1 wa 0 vsense wm
rb vdd qb 100k
rc vdd qc 1k
q1 qc qb 0 qmod
rj vdd jd 1k
j1 jd in 0 jmod
rz vdd zd 1k
z1 zd in 0 zmod
b1 bo 0 V='gain*V(in) + 0.1*sin(0)'
rbo bo 0 1k
b2 0 bi I='V(ex)*1m'
rbi bi 0 1k
.tran 1n 50n
.end
"""
ALL_CARDS_TIMES = (5e-9, 15e-9, 25e-9, 35e-9, 45e-9)

#: the gf180 DFF benchmark's directory (its decks and model cards)
DFF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "benchmarks", "gf180_dff")


#: the pass switch's input: ``ac`` (DC 0, AC 1) or ``sin`` (a 0.1 V,
#: 1 MHz sine from 0 V, AC 1), its width and load
SWITCH_INPUTS = {"ac": "DC 0 AC 1", "sin": "SIN(0 0.1 1MEG) AC 1"}
SWITCH_W = 3.6e-6
SWITCH_RL = 1e4


def pass_switch(source="ac"):
    """The pass switch's netlist (``include_paths=[DFF_DIR]``): VIN drives
    the drain with ``SWITCH_INPUTS[source]``, OUT is the source node."""
    return f"""* closed pass switch: the track phase of a sample-and-hold
.option gmin=1e-15
.include "models_bsim4.spice"
VG G 0 5
VIN IN 0 {SWITCH_INPUTS[source]}
X1 IN G OUT 0 nfet_06v0 W={SWITCH_W:g} L=6e-07
RL OUT 0 {SWITCH_RL:g}
.end
"""


def pass_switch_lanes(device=None, widths=(0.5, 1.0, 2.0, 4.0),
                      source="sin"):
    """:func:`pass_switch` compiled on ``device``, one lane per entry of
    ``widths`` (the switch's W times it), and each lane's transient
    operating point, where every lane's OUT is exactly 0 V: (compiled,
    ctx, per-lane params, per-lane states)."""
    import torch
    import cedarsim_tpu_torch as T
    nl = T.parse_spice(pass_switch(source), file="pass_switch.cir")
    comp = T.compile_circuit(T.elaborate(nl, include_paths=[DFF_DIR]),
                             device=device, dynamic_params=("W",))
    ctx = T.SimSpec.make(gmin=1e-15)
    L = len(widths)
    key = next(k for k in comp.group_order if "bsim4" in k.lower())
    pb = {k: {pn: v.expand((L,) + tuple(v.shape)) for pn, v in g.items()}
          for k, g in comp.params0.items()}
    pb[key] = dict(pb[key])
    pb[key]["W"] = comp.params0[key]["W"][None, :] * torch.as_tensor(
        widths, dtype=comp.dtype, device=comp.device)[:, None]
    op = T.solve_dc(comp, pb, ctx, mode="tranop",
                    x0=torch.zeros(L, comp.n_x, dtype=comp.dtype,
                                   device=comp.device))
    if not bool(op.converged.all()):
        raise AssertionError("pass switch: operating point did not "
                             "converge")
    return comp, ctx, pb, op.x


def dff_ac_noise(n_per_decade=50, fstart=1.0, fstop=1e15):
    """The DFF AC/noise deck, built from ``dff_tb_bsim4.cir`` as it stands
    in the repo: ``AC 1`` on ``VVDD``, and its ``.TRAN`` card (which
    ``simulate`` would run too) replaced by ``.ac dec`` and ``.noise v(q)
    vvdd dec`` with ``n_per_decade`` points a decade (50: 751
    frequencies)."""
    with open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")) as f:
        lines = f.read().splitlines()
    out = []
    for ln in lines:
        low = ln.strip().lower()
        if low == "vvdd vdd 0 5.0":
            ln += " AC 1"
        elif low.startswith(".tran"):
            grid = f"dec {n_per_decade} {fstart:g} {fstop:g}"
            out += [f".ac {grid}", f".noise v(q) vvdd {grid}"]
            continue
        out.append(ln)
    text = "\n".join(out) + "\n"
    if " AC 1" not in text or ".noise" not in text:
        raise ValueError("dff_tb_bsim4.cir changed: no VVDD or .TRAN card")
    return text


INVERTER_NOISE = """* gf180 inverter noise TB (reference inverter_noise.jl)
.option gmin=1e-15
.include "models_bsim4.spice"
Xneg VSS D Q VSS nfet_06v0 W=3.6e-07 L=6e-07
Xpos VDD D Q VDD pfet_06v0 W=4.95e-07 L=5e-07
VVDD VDD 0 5.0
VVSS VSS 0 0.0
CQ D 0 1e-15
VD D 0 0.0 AC 1
.noise v(q) vd dec 5 1k 1e15
.end
"""


#: the BSIM-CMG inverter of the reference's noise test on the ASAP7 TT
#: deck (``tests/test_noise_pdk_goldens.py::CMG_EXACT_TOPOLOGY``; include
#: path: the directory of ``7nm_TT.scs``): noise at q over the frequencies
#: of ngspice's table for it
CMG_INVERTER_NOISE = """* CMG inverter noise, ASAP7 TT (inverter_cmg_cedar.cir)
.include "7nm_TT.scs"
mneg Q D VSS VSS nmos_lvt
mpos Q D VDD VDD pmos_lvt
VVDD VDD 0 1.0
VVSS VSS 0 0.0
CQ D 0 1e-15
VD D 0 0.5 AC 1 SIN (0.5 0.01 1e7)
.end
"""


def chain_netlist(n_cells: int, tstop=2e-7, models="lv1") -> str:
    """``models``: "lv1" (level-1 substitutes) or "bsim4" (the in-tree
    BSIM4-class VA compact model): the same cell topology, the model cards
    swap by include.  (A copy of ``benchmarks/gf180_dff/chain.py::
    chain_netlist``, reading ``dffnq_cell.spice`` from ``DFF_DIR``.)"""
    with open(os.path.join(DFF_DIR, "dffnq_cell.spice")) as f:
        body = f.read()
    lines = [
        f"* {n_cells}-cell DFF shift register ({models} models)",
        ".option gmin=1e-15",
        f'.include "models_{models}.spice"',
        ".subckt dffnq D CLKN Q VDD VNW VPW VSS",
        body,
        ".ends",
        "VVDD VDD 0 5.0",
        "VVSS VSS 0 0.0",
        "VNW VNW VDD 0",
        "VPW VPW VSS 0",
        "VCLKN CLKN 0 PULSE(5 0 20n 1n 1n 25n 50n)",
        "VD d0 0 PULSE(0 5 45n 1n 1n 50n 100n)",
    ]
    for k in range(n_cells):
        lines.append(
            f"XD{k} d{k} CLKN d{k + 1} VDD VNW VPW VSS dffnq")
        lines.append(f"CL{k} d{k + 1} 0 5e-15")
    lines.append(f".tran 1n {tstop}")
    lines.append(".end")
    return "\n".join(lines)


def chain(n_cells: int, models="lv1", sparse="auto", device=None, **kw):
    """The N-cell chain compiled on ``device`` (the counterpart of
    ``benchmarks/gf180_dff/chain.py::build``)."""
    from cedarsim_tpu_torch import compile_circuit
    from cedarsim_tpu_torch.frontend.elaborate import elaborate
    from cedarsim_tpu_torch.frontend.parser import parse_spice
    nl = parse_spice(chain_netlist(n_cells, models=models),
                     file=f"chain{n_cells}_{models}.cir")
    ckt = elaborate(nl, include_paths=[DFF_DIR])
    return compile_circuit(ckt, sparse=sparse, device=device, **kw)


def diode_ladder(n_branches=16, n_sections=16, tstop=20e-9):
    """A 2 V pulse through ``R0`` into node ``a``, which feeds
    ``n_branches`` RC ladders of ``n_sections`` sections each (1 pF a
    node; branch b's resistors 100·(1 + b/n_branches) Ω), with a diode to
    ground at every 4th node of every branch.  That is ``n_branches ·
    n_sections + 3`` unknowns, 259 at the default size, so the compiler
    takes the sparse Newton path by itself (``SPARSE_AUTO_THRESHOLD``);
    the branches keep the sparse LU's elimination levels at about one
    branch's length.  The sensitivities' sparse circuit: a cheap
    nonlinearity on a ladder.  Node ``b<b>_<k>`` is branch b's k-th."""
    lines = [f"* {n_branches} RC ladders of {n_sections} sections with "
             "diode clamps",
             ".model dclamp d is=1e-14 n=1.0",
             "V1 in 0 PULSE(0 2 1n 1n 1n 40n 100n)",
             "R0 in a 100"]
    for b in range(n_branches):
        r = 100.0 * (1 + b / n_branches)
        prev = "a"
        for k in range(1, n_sections + 1):
            node = f"b{b}_{k}"
            lines.append(f"R{b}_{k} {prev} {node} {r:g}")
            lines.append(f"C{b}_{k} {node} 0 1p")
            if k % 4 == 0:
                lines.append(f"D{b}_{k} {node} 0 dclamp")
            prev = node
    lines += [f".tran 0.1n {tstop}", ".end"]
    return "\n".join(lines) + "\n"


VBIC_AMP = """* bipolar common-emitter amplifier, Q1 on VBIC with self-heating
.model qv npn level=4 is=7.59e-15 ibei=1.581e-17 nei=1 iben=3.278e-15
+ nen=1.2665 ibci=1.518e-15 ibcn=2e-13 ncn=1.2 ikf=0.0962 ikr=0.03
+ vef=73.4 rcx=0.25 rbx=10 rbi=90 re=0.5 cje=1.25e-11 pe=0.65 me=0.55
+ cjc=6.33e-12 pc=0.65 mc=0.33 fc=0.5 tf=4.26e-10 tr=1.5e-7 rth=250
+ cth=1e-3
RLoad1 out 0 100k
R2 nb 0 10k
Q1 nc nb 0 qv
Vin1 vin 0 dc 0 ac 1 sin(0 1m 500)
Cin1 vin nb 10u
VCC1 vcc 0 5
R1 vcc nb 68k
Cout1 nc out 10u
R3 vcc nc 10k
.end
"""


#: the link's line: Z0 50 Ω and TD 25 ns, L = Z0·TD and C = TD/Z0 per
#: unit length (the JAX test's floats)
LINK_Z0, LINK_TD = 50.0, 25e-9


def lossy_link(rtot=60.0, rl=50.0, pulse=True):
    """The LTRA link, the text of the JAX package's ``tests/test_ltra_urc.
    py::_ltra_netlist``: V1 (``DC 2 AC 1``, with the 0→2 V PULSE at 10 ns
    when ``pulse``) → RS 50 Ω → O1 (R·LEN = ``rtot``, Z0 50 Ω, TD 25 ns,
    G = 0) → RL ``rl``."""
    src = "PULSE(0 2 10n 0.2n 0.2n 400n 1m)" if pulse else ""
    return f"""* ltra link
V1 vin 0 DC 2 AC 1 {src}
RS vin a 50
O1 a 0 b 0 lossy
RL b 0 {rl}
.model lossy LTRA (R={rtot} L={LINK_Z0 * LINK_TD} G=0 C={LINK_TD / LINK_Z0} LEN=1)

.end
"""


VA_DELAY_LINE = """
module vdelay(p, n, ps, ns);
  inout p, n, ps, ns;
  electrical p, n, ps, ns;
  parameter real td = 1e-6;
  analog V(p, n) <+ absdelay(V(ps, ns), td);
endmodule
"""

VA_TRANSITION = """
module vatrans(inp, out);
  inout inp, out;
  electrical inp, out;
  parameter real td = 0.0;
  parameter real tt = 10e-6;
  parameter real tf = 0.0;
  analog V(out) <+ transition(V(inp), td, tt, (tf > 0.0) ? tf : tt);
endmodule
"""

#: ``VA_TRANSITION`` with its delay argument a literal zero: no Padé block
#: ahead of the latch (with the parameter ``td``, the block's three states
#: are kept at any value, as the JAX package keeps them, and at td = 0 its
#: rows pin z1 and z2 with zeros on the diagonal, which the no-pivot
#: float32 factor B2 cannot take)
VA_TRANSITION_RAMP = VA_TRANSITION.replace("transition(V(inp), td, tt",
                                           "transition(V(inp), 0.0, tt")

VA_ZI_FIR = """
module vafir(inp, out);
  inout inp, out;
  electrical inp, out;
  analog V(out) <+ zi_nd(V(inp), {0.5, 0.5}, {1.0}, 1e-06);
endmodule
"""

VA_ZI_IIR = """
module vaiir(inp, out);
  inout inp, out;
  electrical inp, out;
  parameter real c = 0.5;
  analog V(out) <+ zi_nd(V(inp), {1.0 - c}, {1.0, -c}, 1e-06);
endmodule
"""

#: the emitter's integer and bitwise constructs in one Verilog-A diode:
#: its saturation current scaled by integer arithmetic on the dynamic
#: param ``code`` (an ``integer`` assigned ``code / 2``, ``& | ^ ~ << >>``
#: and ``%``) and a piecewise-constant term ``(V·8) & 15`` of the walk's
#: own value
VA_A21 = """
module a21(a, c);
  inout a, c;
  electrical a, c;
  parameter real is_ = 1e-14;
  parameter real code = 5;
  integer m, k, q;
  real vd, scale;
  analog begin
    vd = V(a, c);
    m = code / 2;
    k = ((m & 3) | (code ^ 6)) << 1;
    q = (k >> 1) % 5;
    scale = 1.0 + 0.05 * (~k & 7) + 0.01 * q + 0.001 * (m % 3);
    I(a, c) <+ is_ * scale * (limexp(vd / $vt) - 1.0)
               + 1e-12 * ((vd * 8) & 15);
    I(a, c) <+ ddt(1e-13 * vd);
  end
endmodule
"""

#: the point list of :class:`PwlConductance`
PWL_XS = (-1.0, 0.0, 0.3, 0.6, 1.0, 2.0)
PWL_YS = (-1e-4, 0.0, 2e-5, 1e-4, 4e-4, 1.5e-3)
#: the ``code`` of each lane of :func:`a21_lanes`
A21_CODES = (3.0, 5.0, 6.0, 9.0)


_PWL = []


def _pwl_class():
    """:class:`PwlConductance`, made once (the module imports no torch)."""
    if _PWL:
        return _PWL[0]
    from cedarsim_tpu_torch.core.dual import val
    from cedarsim_tpu_torch.devices.base import DeviceModel
    import torch

    class PwlConductance(DeviceModel):
        """I(p, n) = the piecewise-linear table (``xs``, ``ys``, point-list
        params) at V(p, n), its ends extended along their end segments,
        read through ``searchsorted`` and indexing."""
        terminals = ("p", "n")
        params = {"xs": PWL_XS, "ys": PWL_YS}

        @staticmethod
        def eval(lv, p, ctx, eps):
            v = lv[0] - lv[1]
            xs, ys = p["xs"], p["ys"]
            n = xs.shape[-1]
            i = torch.searchsorted(xs, val(v).contiguous(), right=True) \
                .clamp(1, n - 1)
            x0, x1, y0, y1 = xs[i - 1], xs[i], ys[i - 1], ys[i]
            cur = y0 + (v - x0) * ((y1 - y0) / (x1 - x0))
            return [cur, -cur], [0.0, 0.0]
    _PWL.append(PwlConductance)
    return PwlConductance


def a21_circuit(with_pwl=True):
    """A pulse through 1 kΩ into node ``a`` (1 pF), with the ``a21``
    diode (``VA_A21``, instance X1) and a :class:`PwlConductance` (P1,
    unless ``with_pwl`` is False) to ground: the emitter's integer,
    bitwise and point-list constructs in one circuit (a ``Circuit``)."""
    from cedarsim_tpu_torch import Circuit, Capacitor, Resistor, VSourcePULSE
    from cedarsim_tpu_torch.va.codegen import load_va
    ckt = Circuit()
    vin, a = ckt.net("in"), ckt.net("a")
    ckt.add(VSourcePULSE, "V1", (vin, ckt.gnd),
            dict(v1=0.0, v2=1.2, td=1e-9, tr=1e-9, tf=1e-9, pw=5e-9,
                 per=20e-9))
    ckt.add(Resistor, "R1", (vin, a), dict(r=1000.0))
    ckt.add(Capacitor, "C1", (a, ckt.gnd), dict(c=1e-12))
    ckt.add(load_va(VA_A21)["a21"], "X1", (a, ckt.gnd),
            dict(is_=1e-14, code=5.0))
    if with_pwl:
        ckt.add(_pwl_class(), "P1", (a, ckt.gnd), {})
    return ckt


def a21_lanes(device=None, with_pwl=True):
    """:func:`a21_circuit` compiled on ``device`` with ``code`` dynamic,
    and its lanes, one a code of ``A21_CODES``: (compiled, ctx, per-lane
    params)."""
    import torch
    from cedarsim_tpu_torch import SimSpec, compile_circuit
    comp = compile_circuit(a21_circuit(with_pwl), device=device,
                           dynamic_params=["code"])
    key = next(k for k in comp.group_order if "a21" in k)
    pb = {k: dict(g) for k, g in comp.params0.items()}
    pb[key]["code"] = torch.as_tensor(A21_CODES, dtype=comp.dtype,
                                      device=comp.device)[:, None]
    return comp, SimSpec.make(), pb
