"""The Verilog-A → C++ emitter (cedarsim_tpu_torch/va/emit.py) against the
port's eager model walk.

- The DFF's BSIM4 group and a VA diode are emitted, compiled as host code
  with ``g++ -O1 -shared -fPIC`` (``__host__ __device__`` compile away off
  nvcc) and called through ``ctypes``, the hoisted part ``<name>_pre``
  first and then the walk on its values: the rows (s, q, qd) scattered
  into the circuit must match ``evaluate(keys=[group], v=...)`` over a grid
  of bias points, W values and tangent directions within rtol 1e-9, with
  absolute floors of 1e-18 A (S, and the charge tangent) and 1e-24 C (Q).
- The cut: the walk reads no ``dyn`` and no ``t``, the hoisted part no
  ``lv``/``lvd``; the DFF's BSIM4 hoists its 249 parameter-only nodes, 109
  of whose values cross into the walk.
- The text and its hash do not depend on the walk's order: emitting twice
  gives the same hash, in this process and under another hash seed.
- A construct bsim4.va does not use (integer bitwise arithmetic, ROADMAP
  A21, done) emits with its integer helpers; a walk that no device code
  can hold (a vector-valued one) still raises ``NotImplementedError``.
  ``tests/test_torch_emit_a21.py`` holds such models against the eager
  walk and the JAX package.
- The built-in models' walks (``Mos1`` of the level-1 DFF with vto per
  instance, ``Diode`` and ``Bjt``) emit, build on the host and match the
  eager walk per instance (no scatter) within 1e-12 of each entry, at
  biases rail to rail, past the built-ins' ``_limexp`` limit and at
  drain-source ties.  Not bitwise on the host: PyTorch's CPU ``sqrt``,
  ``exp`` and ``pow`` round some results differently from the C library's
  (``torch.sqrt`` is not correctly rounded on an AVX-512 build), so about
  1 % of the entries differ in their last bits.

Skips without ``g++``.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.va import emit
from cedarsim_tpu_torch.va.codegen import load_va

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DFF_DIR = os.path.join(REPO, "benchmarks", "gf180_dff")

VA_DIODE = """
module fdiode(a, c);
  inout a, c;
  electrical a, c;
  parameter real is_ = 1e-14 from (0:1];
  parameter real n = 1.0;
  parameter real cj = 1e-12;
  real id, vd;
  analog begin
    vd = V(a, c);
    if (vd > -5.0 * n * $vt)
      id = is_ * (limexp(vd / (n * $vt)) - 1.0);
    else
      id = -is_;
    I(a, c) <+ id;
    I(a, c) <+ ddt(cj * sqrt(1.0 + max(vd, -0.5) * vd * vd));
  end
endmodule
"""


@pytest.fixture(scope="module")
def dff():
    with open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")) as f:
        nl = T.parse_spice(f.read(), file="dff_tb_bsim4.cir")
    return T.compile_circuit(T.elaborate(nl, include_paths=[DFF_DIR]),
                             device="cpu")


def _diode_circuit():
    dev = load_va(VA_DIODE)["fdiode"]
    ckt = T.Circuit()
    a, b = ckt.net("a"), ckt.net("b")
    ckt.add(T.VSource, "V1", (a, ckt.gnd), dict(dc=1.0))
    ckt.add(T.Resistor, "R1", (a, b), dict(r=1000.0))
    ckt.add(dev, "D1", (b, ckt.gnd), dict(is_=1e-14))
    ckt.add(dev, "D2", (a, b), dict(is_=3e-14, cj=2e-12))
    return T.compile_circuit(ckt, device="cpu")


def _host_harness(name, n_lvar, n_lrow, n_dyn, n_hoist):
    """C++ source of an ``extern "C"`` loop over instances that calls the
    emitted functions ``name_pre`` and ``name`` on the host::

        void cs_run(int n, const double* lv, const double* lvd,
                    const double* dyn, const double* t,
                    double* s, double* q, double* qd)

    with ``lv``/``lvd`` [n, n_lvar], ``dyn`` [n, n_dyn], ``t`` [n] and the
    outputs [n, n_lrow]."""
    return (
        'extern "C" void cs_run(int n, const double* lv, const double* lvd,'
        " const double* dyn, const double* t, double* s, double* q,"
        " double* qd) {\n"
        f"  double h[{max(n_hoist, 1)}];\n"
        "  for (int i = 0; i < n; ++i) {\n"
        f"    {name}_pre(dyn + i * {max(n_dyn, 1)}, t[i], h);\n"
        f"    {name}(lv + i * {n_lvar}, lvd + i * {n_lvar}, h, "
        f"s + i * {n_lrow}, q + i * {n_lrow}, qd + i * {n_lrow});\n"
        "  }\n}\n")


def _host_build(tmp_path, comp, key, ctx):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emitted header as host code")
    e = emit.emit_group(comp, key, ctx)
    g = comp.groups[key]
    hdr = tmp_path / "model.h"
    hdr.write_text(e.text)
    src = tmp_path / "run.cpp"
    src.write_text('#include "model.h"\n' + _host_harness(
        e.name, g.model.n_lvar(), g.model.n_lrow(),
        len(emit.dyn_names(comp, key)), e.n_hoist))
    so = tmp_path / "model.so"
    out = subprocess.run(["g++", "-O1", "-shared", "-fPIC",
                          "-ffp-contract=off", "-o", str(so), str(src)],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.cs_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7
    return lib


def _emitted_vs_eager(lib, comp, key, ctx, x, v, t, params):
    """Scatter the emitted rows per lane exactly as ``evaluate`` does and
    return both (S, Q, Qd) triples as numpy."""
    g = comp.groups[key]
    L, n = x.shape
    ni, nlv, nlr = len(g.instances), g.model.n_lvar(), g.model.n_lrow()
    names = emit.dyn_names(comp, key)
    xp = np.concatenate([x, np.zeros((L, 1))], 1)
    vp = np.concatenate([v, np.zeros((L, 1))], 1)
    lv = np.ascontiguousarray(xp[:, g.var_idx].reshape(-1, nlv))
    lvd = np.ascontiguousarray(vp[:, g.var_idx].reshape(-1, nlv))
    dyn = np.zeros((L, ni, max(len(names), 1)))
    for k, pn in enumerate(names):
        dyn[:, :, k] = np.broadcast_to(
            torch.as_tensor(params[key][pn]).numpy(), (L, ni))
    dyn = np.ascontiguousarray(dyn.reshape(L * ni, -1))
    tt = np.ascontiguousarray(np.repeat(t, ni))
    s, q, qd = (np.zeros((L * ni, nlr)) for _ in range(3))
    lib.cs_run(L * ni, lv.ctypes.data, lvd.ctypes.data, dyn.ctypes.data,
               tt.ctypes.data, s.ctypes.data, q.ctypes.data, qd.ctypes.data)
    mult = torch.as_tensor(params[key]["$mult"]).numpy()
    scale = np.where(g.kcl_mask[None, None, :],
                     np.broadcast_to(mult, (L, ni))[:, :, None], 1.0)

    def scatter(a):
        a = a.reshape(L, ni, nlr) * scale
        out = np.zeros((L, n + 1))
        for lane in range(L):
            np.add.at(out[lane], g.row_idx, a[lane])
        return out[:, :n]

    got = [scatter(a) for a in (s, q, qd)]
    tx = torch.as_tensor
    want = comp.evaluate(tx(x), ctx.at_time(tx(t)),
                         comp.lane_params(params, L), v=tx(v), keys=[key])
    return got, [w.numpy() for w in want]


def _check(got, want):
    for name, a, b, floor in zip(("S", "Q", "Qd"), got, want,
                                 (1e-18, 1e-24, 1e-18)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=floor,
                                   err_msg=name)


def test_bsim4_emitted_matches_eager(tmp_path, dff):
    key = [k for k in dff.group_order if "bsim4" in k.lower()][0]
    ctx = T.SimSpec.make(gmin=1e-15).with_mode("tran")
    lib = _host_build(tmp_path, dff, key, ctx)
    rng = np.random.default_rng(11)
    L = 6
    W = dff.params0[key]["W"]
    params = {k: dict(g) for k, g in dff.params0.items()}
    params[key]["W"] = W[None, :] * torch.as_tensor(
        np.linspace(0.5, 2.0, L))[:, None]
    # bias grid: every node from rail to rail and beyond; branch currents
    x = np.zeros((L, dff.n_x))
    levels = np.linspace(-0.6, 5.6, L)
    x[:, :dff.n_nodes] = levels[:, None] + rng.uniform(
        -0.8, 0.8, (L, dff.n_nodes))
    x[:, dff.n_nodes:] = rng.normal(size=(L, dff.n_x - dff.n_nodes)) * 1e-3
    v = rng.normal(size=(L, dff.n_x)) * 1e9
    t = np.linspace(0.0, 7e-7, L)
    _check(*_emitted_vs_eager(lib, dff, key, ctx, x, v, t, params))


def test_diode_emitted_matches_eager(tmp_path):
    comp = _diode_circuit()
    key = [k for k in comp.group_order if "fdiode" in k][0]
    ctx = T.SimSpec.make().with_mode("tran")
    lib = _host_build(tmp_path, comp, key, ctx)
    vd = np.linspace(-2.0, 1.2, 17)          # reverse, knee, limexp tail
    L = vd.size
    x = np.zeros((L, comp.n_x))
    x[:, 0] = 1.0 + vd
    x[:, 1] = vd
    v = np.random.default_rng(5).normal(size=(L, comp.n_x)) * 1e8
    _check(*_emitted_vs_eager(lib, comp, key, ctx, x, v, np.zeros(L),
                              comp.params0))


def _bodies(e):
    """(hoisted body, walk body) of an emitted group's text."""
    pre = e.text.index(f"{e.name}_pre(")
    walk = e.text.index(f"{e.name}(const double* lv")
    return e.text[e.text.index("{", pre):walk], e.text[e.text.index("{",
                                                                    walk):]


@pytest.mark.parametrize("which", ["bsim4", "diode"])
def test_emit_cut_is_clean(dff, which):
    """The walk reads no params and no time, the hoisted part no unknown or
    tangent; every value of h the walk reads is written by the hoisted part
    once.  The DFF's BSIM4: 249 of 1,327 arithmetic nodes hoisted (31 of
    149 divisions), 109 values crossing."""
    if which == "bsim4":
        comp = dff
        key = [k for k in comp.group_order if "bsim4" in k.lower()][0]
        ctx = T.SimSpec.make(gmin=1e-15).with_mode("tran")
    else:
        comp = _diode_circuit()
        key = [k for k in comp.group_order if "fdiode" in k][0]
        ctx = T.SimSpec.make().with_mode("tran")
    e = emit.emit_group(comp, key, ctx)
    pre, walk = _bodies(e)
    assert re.search(r"\bdyn\[", walk) is None
    assert re.search(r"\bt\b", walk) is None
    assert re.search(r"\blvd?\[", pre) is None
    written = re.findall(r"^  h\[(\d+)\] = ", pre, re.M)
    read = re.findall(r"= h\[(\d+)\]", walk)
    assert sorted(map(int, written)) == list(range(e.n_hoist))
    assert sorted(map(int, read)) == list(range(e.n_hoist))
    if which == "bsim4":
        assert (e.n_pre, e.n_pre + e.n_walk, e.n_hoist) == (249, 1327, 109)
        assert pre.count(" / ") + walk.count(" / ") == 149
        assert pre.count(" / ") == 31


def test_emit_hash_is_stable(dff):
    key = [k for k in dff.group_order if "bsim4" in k.lower()][0]
    ctx = T.SimSpec.make(gmin=1e-15).with_mode("tran")
    h1 = emit.emit_group(dff, key, ctx)[2]
    h2 = emit.emit_group(dff, key, ctx)[2]
    assert h1 == h2
    code = (
        "import os, sys\n"
        f"sys.path.insert(0, {os.path.abspath(REPO)!r})\n"
        "import cedarsim_tpu_torch as T\n"
        "from cedarsim_tpu_torch.va import emit\n"
        f"d = {DFF_DIR!r}\n"
        "nl = T.parse_spice(open(os.path.join(d, 'dff_tb_bsim4.cir'))"
        ".read(), file='dff_tb_bsim4.cir')\n"
        "c = T.compile_circuit(T.elaborate(nl, include_paths=[d]), "
        "device='cpu')\n"
        f"print(emit.emit_group(c, {key!r}, T.SimSpec.make(gmin=1e-15)"
        ".with_mode('tran')).hash)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**env, "PYTHONHASHSEED": "12345"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == h1
    # the context folds into the function: another temperature, another
    # hash
    assert emit.emit_group(dff, key, T.SimSpec.make(
        temp_c=60.0, gmin=1e-15).with_mode("tran"))[2] != h1


def test_unsupported_construct_names_the_roadmap():
    dev = load_va("""
module bits(a, c);
  inout a, c;
  electrical a, c;
  analog begin
    I(a, c) <+ 1e-3 * (~V(a, c));
  end
endmodule
""")["bits"]
    ckt = T.Circuit()
    a = ckt.net("a")
    ckt.add(T.VSource, "V1", (a, ckt.gnd), dict(dc=1.0))
    ckt.add(dev, "B1", (a, ckt.gnd), {})
    comp = T.compile_circuit(ckt, device="cpu")
    key = [k for k in comp.group_order if "bits" in k][0]
    e = emit.emit_group(comp, key, T.SimSpec.make().with_mode("tran"))
    assert "cs_i32(" in e.text and "(~" in e.text and "A21" not in e.text

    class Vector(T.Resistor):
        """A walk whose current is a vector of two values."""
        @staticmethod
        def eval(lv, p, ctx, eps):
            i = (lv[0] - lv[1]) * torch.tensor([1.0, 2.0],
                                               dtype=torch.float64)
            return [i, -i], [0.0, 0.0]

    ckt = T.Circuit()
    a = ckt.net("a")
    ckt.add(T.VSource, "V1", (a, ckt.gnd), dict(dc=1.0))
    ckt.add(Vector, "R1", (a, ckt.gnd), dict(r=1.0))
    comp = T.compile_circuit(ckt, device="cpu")
    key = [k for k in comp.group_order if "Vector" in k][0]
    with pytest.raises(NotImplementedError, match="vector-valued walk"):
        emit.emit_group(comp, key, T.SimSpec.make().with_mode("tran"))


# ------------------------------------------------- built-in models emitted

_BUILTIN = """* diodes and bipolars
.model dmod d (is=1e-14 cjo=1p tt=1n bv=5)
.model dmod2 d (is=3e-15 cjo=2p m=0.33 n=1.5)
.model qn npn (is=1e-16 bf=100 vaf=50 ikf=0.1 ise=1e-15 cje=1p cjc=0.5p
+ cjs=0.1p tf=0.1n tr=10n)
.model qp pnp (is=2e-16 bf=50 var=20 ikr=0.05)
v1 a 0 1
d1 a b dmod
d2 b c dmod2 2
q1 a b c d qn
q2 d c b a qp
r1 c 0 1k
"""


def _builtin_group(which):
    if which == "Mos1":
        with open(os.path.join(DFF_DIR, "dff_tb.cir")) as f:
            nl = T.parse_spice(f.read(), file="dff_tb.cir")
        comp = T.compile_circuit(T.elaborate(nl, include_paths=[DFF_DIR]),
                                 device="cpu", dynamic_params=("vto",))
        return comp, T.SimSpec.make(gmin=1e-15).with_mode("tran")
    comp = T.compile_circuit(T.elaborate(T.parse_spice(_BUILTIN)),
                             device="cpu")
    return comp, T.SimSpec.make().with_mode("tran")


def _per_instance(lib, comp, key, ctx, lv, lvd):
    """The emitted walk and the eager one on the same per-instance inputs
    (instance k's params for row k modulo the instances): [(s, q, qd)]
    of each, numpy [N, n_lrow]."""
    from cedarsim_tpu_torch.core.dual import Dual
    g = comp.groups[key]
    names = emit.dyn_names(comp, key)
    N, nlv = lv.shape
    nlr = g.model.n_lrow()
    dyn = np.zeros((N, max(len(names), 1)))
    for k, pn in enumerate(names):
        dyn[:, k] = np.resize(torch.as_tensor(comp.params0[key][pn]).numpy(),
                              N)
    t = np.zeros(N)
    s, q, qd = (np.zeros((N, nlr)) for _ in range(3))
    lib.cs_run(N, lv.ctypes.data, lvd.ctypes.data, dyn.ctypes.data,
               t.ctypes.data, s.ctypes.data, q.ctypes.data, qd.ctypes.data)
    p = dict(g.static_params)
    for k, pn in enumerate(names):
        p[pn] = torch.as_tensor(dyn[:, k])
    x = [Dual(torch.as_tensor(lv[:, k]), torch.as_tensor(lvd[None, :, k]))
         for k in range(nlv)]
    s_rows, q_rows = g.model.eval(x, p, ctx.at_time(torch.as_tensor(t)),
                                  None)

    def rows(rs, tangent=False):
        out = []
        for r in rs:
            if isinstance(r, Dual):
                r = r.d[0] if tangent else r.v
            elif tangent:
                r = 0.0
            out.append(np.broadcast_to(torch.as_tensor(r).numpy(), (N,)))
        return np.stack(out, 1)
    return (s, q, qd), (rows(s_rows), rows(q_rows), rows(q_rows, True))


@pytest.mark.parametrize("which", ["Mos1", "Diode", "Bjt"])
def test_builtin_emitted_matches_eager(tmp_path, which):
    comp, ctx = _builtin_group(which)
    lib = _host_build(tmp_path, comp, which, ctx)
    nlv = comp.groups[which].model.n_lvar()
    rng = np.random.default_rng(17)
    N = 1024
    lv = rng.uniform(-1.0, 6.0, (N, nlv))
    lv[:256, 2 % nlv] = lv[:256, 0]                   # ties
    lv[256:512] = rng.uniform(-3.0, 9.0, (256, nlv))  # past _limexp's 40
    lvd = rng.normal(size=(N, nlv)) * 1e9
    lv, lvd = np.ascontiguousarray(lv), np.ascontiguousarray(lvd)
    got, want = _per_instance(lib, comp, which, ctx, lv, lvd)
    for name, a, b in zip(("s", "q", "qd"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-30,
                                   err_msg=name)
