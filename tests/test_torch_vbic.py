"""VBIC in the port (``cedarsim_tpu_torch/models/vbic.va``, the BJT level
4/9 and Spectre ``vbic`` binder) against its closed forms and the JAX
package on the CPU in float64.

- ``tests/test_vbic.py``'s eight cases on the port: the forward Gummel
  curve and beta, the charge-based Early effect, high-injection roll-off,
  the pnp mirror, weak avalanche, the b-e junction capacitance through
  ``ac``, the Spectre ``vbic`` master and self-heating, each against the
  model's closed form as that file gates it, and each operating point
  against the JAX package's (both solved to 1e-9; the points within
  ‖G⁻¹‖∞ · 1e-12 · I, (S, Q, G, C) at the JAX package's point within
  1e-12 of their scales, as ``tests/test_torch_va_a14b.py`` derives).
- An unknown card parameter is named in one warning, as in the JAX
  package.
- The emitted VBIC walk (``va/emit.py``, what B1 runs on the VBIC plan)
  built as host code with ``g++`` against the eager walk on cell V's
  lanes (AREA per lane) at perturbed biases, as ``tests/test_torch_emit.
  py`` holds BSIM4's.
- Cell V (``benchmarks/vbic_amp.py``) at 2 lanes over 0-0.5 ms through
  the chord path (the exact solve on the CPU) with each lane's accepted
  and rejected steps and Newton iterations equal to the JAX package's
  run of that lane from the same operating point; and why its chord path
  takes a Jacobian shunt (the thermal node's row has no diagonal, which
  the no-pivot float32 factor cannot take).
"""

import math
import warnings

import numpy as np
import pytest
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.frontend.spectre import parse_spectre as j_parse_spectre
from cedarsim_tpu_torch.benchmarks import netlists, vbic_amp
from cedarsim_tpu_torch.frontend.spectre import parse_spectre as \
    t_parse_spectre
from tests.test_torch_va_a14b import _dc_equal

Q = 1.60219e-19
KB = 1.3806226e-23
VT = KB * 300.15 / Q          # $temperature at the default 27 C
GMIN = 1e-15


def _dc(text, spectre=False):
    """The port's operating point of ``text`` held to the JAX package's:
    (port compiled, {node: V})."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if spectre:
            ct = T.compile_circuit(T.elaborate(t_parse_spectre(text)),
                                   device="cpu")
            cj = J.compile_circuit(J.elaborate(j_parse_spectre(text)))
        else:
            ct = T.compile_circuit(T.elaborate(T.parse_spice(text)),
                                   device="cpu")
            cj = J.compile_circuit(J.elaborate(J.parse_spice(text)))
    x = _dc_equal(ct, cj, gmin=GMIN)
    return ct, {n: float(x[i]) for i, n in enumerate(ct.node_names)}


def _qdep(v, p, mj, fc=0.9):
    if v < fc * p:
        return p / (1 - mj) * (1 - (1 - v / p) ** (1 - mj))
    f1 = p / (1 - mj) * (1 - (1 - fc) ** (1 - mj))
    f2 = (1 - fc) ** (1 + mj)
    f3 = 1 - fc * (1 + mj)
    vl = v - fc * p
    return f1 + (vl * f3 + 0.5 * mj * vl * vl / p) / f2


def _tb(model_extra="", vb=0.65, vdd=2.0):
    return f"""* vbic bias
VB b 0 {vb}
VC vdd 0 {vdd}
RC vdd c 1.0
RE e 0 1.0
Q1 c b e 0 qn
.model qn npn level=4 is=1e-16 ibei=1e-18 rcx=1e-6 rbx=1e-6 re=1e-6
+ {model_extra}
.end
"""


def test_vbic_forward_gummel_and_beta():
    _, v = _dc(_tb())
    ic = (2.0 - v["c"]) / 1.0
    ib = v["e"] / 1.0 - ic
    vbe, vbc = 0.65 - v["e"], 0.65 - v["c"]
    ifi = 1e-16 * (math.exp(vbe / VT) - 1)
    iri = 1e-16 * (math.exp(vbc / VT) - 1)
    ibc = 1e-16 * (math.exp(vbc / VT) - 1)
    assert abs(ic - ((ifi - iri) - ibc)) / abs(ifi) < 1e-5
    ib_pred = 1e-18 * (math.exp(vbe / VT) - 1) + ibc
    assert abs(ib - ib_pred) / abs(ib_pred) < 1e-4
    assert abs(ic / ib - 100.0) < 0.1


def test_vbic_early_effect_charge_based():
    ics = {}
    for vdd in (2.0, 4.0):
        _, v = _dc(_tb("vef=10 pc=0.8 mc=0.4", vdd=vdd))
        vbe, vbc = 0.65 - v["e"], 0.65 - v["c"]
        ifi = 1e-16 * (math.exp(vbe / VT) - 1)
        iri = 1e-16 * (math.exp(vbc / VT) - 1)
        q1 = 1.0 + _qdep(vbc, 0.8, 0.4) / 10.0
        qb = 0.5 * q1 * (1 + math.sqrt(1 + 1e-12))
        ic_pred = (ifi - iri) / qb - iri
        ic = (vdd - v["c"]) / 1.0
        assert abs(ic - ic_pred) / ic_pred < 1e-5, (vdd, ic, ic_pred)
        ics[vdd] = ic
    assert ics[4.0] > ics[2.0]


def test_vbic_high_injection_rolloff():
    _, v = _dc(_tb("ikf=1e-6", vb=0.75))
    vbe, vbc = 0.75 - v["e"], 0.75 - v["c"]
    ifi = 1e-16 * (math.exp(vbe / VT) - 1)
    iri = 1e-16 * (math.exp(vbc / VT) - 1)
    q2 = ifi / 1e-6
    assert q2 > 10.0
    qb = 0.5 * (1 + math.sqrt(1 + 4 * q2 + 1e-12))
    ic_pred = (ifi - iri) / qb - iri
    ic = (2.0 - v["c"]) / 1.0
    assert abs(ic - ic_pred) / ic_pred < 1e-5


def test_vbic_pnp_mirror():
    _, vn = _dc(_tb())
    _, vp = _dc("""* vbic pnp
VB b 0 -0.65
VC vdd 0 -2.0
RC vdd c 1.0
RE e 0 1.0
Q1 c b e 0 qp
.model qp pnp level=4 is=1e-16 ibei=1e-18 rcx=1e-6 rbx=1e-6 re=1e-6
.end
""")
    assert abs(vp["c"] + vn["c"]) < 1e-9
    assert abs(vp["e"] + vn["e"]) < 1e-9


def test_vbic_avalanche():
    _, v0 = _dc(_tb(vdd=5.0))
    _, v1 = _dc(_tb("avc1=1e-3 avc2=1e-2", vdd=5.0))
    ic0 = (5.0 - v0["c"]) / 1.0
    ic1 = (5.0 - v1["c"]) / 1.0
    vbc = 0.65 - v1["c"]
    vl = 0.5 * (math.sqrt((0.75 - vbc) ** 2 + 0.01) + (0.75 - vbc))
    iavc_pred = ic0 * 1e-3 * vl * math.exp(-1e-2 * vl ** (0.33 - 1.0))
    assert abs((ic1 - ic0) - iavc_pred) / iavc_pred < 2e-3


def test_vbic_junction_cap_ac():
    text = """* vbic cap
VB in 0 dc -1 ac 1
RB in b 1k
Q1 0 b 0 0 qn
.model qn npn level=4 is=1e-16 ibei=1e-18 cje=2e-12 pe=0.7 me=0.4
+ rcx=1e-6 rbx=1e-6 re=1e-6
.end
"""
    comp, _ = _dc(text)
    r = T.ac(comp, np.array([1e6]), ctx=T.SimSpec.make(gmin=GMIN))
    vb_ac = complex(np.asarray(r["b"])[0])
    c_pred = 2e-12 * (1 - (-1.0) / 0.7) ** (-0.4)
    z = 1.0 / (1j * 2 * math.pi * 1e6 * c_pred)
    pred = z / (z + 1e3)
    assert abs(vb_ac - pred) / abs(pred) < 2e-3, (vb_ac, pred)


def test_vbic_spectre_master():
    scs = """// vbic spectre
simulator lang=spectre
model qsp vbic type=npn is=1e-16 ibei=1e-18 rcx=1e-6 rbx=1e-6 re=1e-6
vb (b 0) vsource dc=0.65
vc (vdd 0) vsource dc=2.0
rc (vdd c) resistor r=1.0
q1 (c b 0 0) qsp
"""
    comp, v = _dc(scs, spectre=True)
    assert comp.groups[[k for k in comp.group_order
                        if "vbic" in k.lower()][0]].static_params[
                            "TYPE"] == 1.0
    ic = (2.0 - v["c"]) / 1.0
    ic_pred = 1e-16 * (math.exp(0.65 / VT) - 1)
    assert abs(ic - ic_pred) / ic_pred < 1e-4


def test_vbic_self_heating():
    _, v = _dc("""* vbic sh
VB b 0 0.7
VC vdd 0 3.0
RC vdd c 1.0
RE e 0 1.0
Q1 c b e 0 qn
.model qn npn level=4 is=1e-16 ibei=1e-18 rcx=1e-6 rbx=1e-6 re=1e-6
+ rth=2e4
.end
""")
    ic = (3.0 - v["c"]) / 1.0
    vbe, vbc = 0.7 - v["e"], 0.7 - v["c"]
    tnomk = 300.15
    dT = 0.0
    for _ in range(300):
        t = tnomk + dT
        rt, vt = t / tnomk, KB * t / Q
        iset = 1e-16 * rt ** 3 * math.exp(1.12 * (rt - 1) / (rt * vt))
        ibei = 1e-18 * rt ** 3 * math.exp(1.12 * (rt - 1) / (rt * vt))
        ifi = iset * (math.exp(vbe / vt) - 1)
        iri = iset * (math.exp(vbc / vt) - 1)
        ibe = ibei * (math.exp(vbe / vt) - 1)
        itz = ifi - iri
        p = itz * (vbe - vbc) + ibe * vbe + iri * vbc
        dT = 0.5 * dT + 0.5 * 2e4 * p
    assert dT > 2.0
    ic_pred = itz - iri
    assert abs(ic - ic_pred) / ic_pred < 1e-4, (ic, ic_pred, dT)
    _, v0 = _dc("""* vbic cold
VB b 0 0.7
VC vdd 0 3.0
RC vdd c 1.0
RE e 0 1.0
Q1 c b e 0 qn
.model qn npn level=4 is=1e-16 ibei=1e-18 rcx=1e-6 rbx=1e-6 re=1e-6
.end
""")
    assert ic > 1.3 * (3.0 - v0["c"])


def test_unknown_card_parameter_warns():
    with pytest.warns(UserWarning, match=r"vbic model 'qn'.*'bogus'"):
        T.elaborate(T.parse_spice(_tb("bogus=3")))


@pytest.fixture(scope="module")
def amp():
    return vbic_amp.setup(lanes=2, device="cpu")[0]


def test_emitted_vbic_walk_matches_the_eager_walk(tmp_path, amp):
    from tests.test_torch_emit import _check, _emitted_vs_eager, _host_build
    comp, ctx, pb, x0, _ = amp
    key = [k for k in comp.group_order if "vbic" in k.lower()][0]
    ctx = ctx.with_mode("tran")
    lib = _host_build(tmp_path, comp, key, ctx)
    rng = np.random.default_rng(13)
    L = 6
    params = {k: dict(g) for k, g in comp.params0.items()}
    params[key]["AREA"] = comp.params0[key]["AREA"][None, :] * \
        torch.as_tensor(np.linspace(0.5, 2.0, L))[:, None]
    x = np.repeat(x0[1].numpy()[None], L, 0)
    x[:, :comp.n_nodes + comp.n_internal] += rng.uniform(
        -0.2, 0.2, (L, comp.n_nodes + comp.n_internal))
    v = rng.normal(size=(L, comp.n_x)) * 1e3
    _check(*_emitted_vs_eager(lib, comp, key, ctx, x, v,
                              np.linspace(0.0, 6e-3, L), params))


def test_chord_solve_needs_the_shunt(amp):
    """Why V-xla takes ``jac_shunt=1e-9``: the thermal node's KCL row holds
    only the switched branch's current, so the chord Jacobian J = C/h + G
    has no diagonal there; the no-pivot float32 factor (B2's plain
    version) then misses the exact solve by more than 1e2 relative, and
    with the shunt on the voltage rows it is within 1e-3."""
    from cedarsim_tpu_torch.ops import linalg
    comp, ctx, pb, x0, _ = amp
    ith = comp.x_names.index("q1#int3")
    nv = comp.n_nodes + comp.n_internal
    h = 1e-7
    t = torch.full((2,), h, dtype=torch.float64)
    _, _, G, C = comp.res_jacs_fwd(x0, ctx.with_mode("tran").at_time(t), pb)
    assert float((C / h + G)[:, ith, ith].abs().max()) == 0.0
    b = torch.as_tensor(np.random.default_rng(0).normal(size=(2, comp.n_x)))
    errs = []
    for shunt in (0.0, vbic_amp.XLA_OPTS["jac_shunt"]):
        J = C / h + G + shunt * torch.diag(
            (torch.arange(comp.n_x) < nv).to(torch.float64))
        exact = torch.linalg.solve(J, b)
        mixed = linalg.chord_backsolve(*linalg.chord_factor(J), J, b)
        errs.append(float(((mixed - exact).abs().amax(-1)
                           / exact.abs().amax(-1)).max()))
    assert errs[0] > 1e2 and errs[1] < 1e-3, errs


def test_cell_v_counts_equal_the_jax_packages(amp):
    """Cell V's two lanes over 0-0.5 ms on the port's chord path, each
    lane's counts those of the JAX package's run of that lane's AREA from
    the same operating point, the waveforms within 1e-9 V."""
    tstop = 5e-4
    comp, ctx, pb, x0, gains = amp
    assert 90.0 < gains[1] < 105.0          # |AC gain| at 500 Hz, ~97.3
    res = vbic_amp.run("xla", tstop, amp=amp)
    sols = res.pop("sols")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cj = J.compile_circuit(
            J.elaborate(J.parse_spice(netlists.VBIC_AMP)),
            dynamic_params=("area",))
    key = [k for k in cj.group_order if "vbic" in k.lower()][0]
    for lane, st in enumerate(sols):
        pj = {k: dict(g) for k, g in cj.params0.items()}
        pj[key]["AREA"] = np.asarray(pb[key]["AREA"][lane].numpy())
        sj = J.tran(cj, (0.0, tstop), params=pj,
                    ctx=J.SimSpec.make(gmin=vbic_amp.GMIN),
                    opts=J.TranOptions(**vbic_amp.XLA_OPTS),
                    x0=x0[lane].numpy())
        assert sj.converged and st.converged
        assert (st.n_accepted, st.n_rejected, st.n_newton) == \
            (sj.n_accepted, sj.n_rejected, sj.n_newton), lane
        for col in range(comp.n_x):
            np.testing.assert_allclose(
                np.interp(np.asarray(sj.ts), st.ts, st.xs[:, col]),
                np.asarray(sj.xs)[:, col], rtol=0, atol=1e-9)
