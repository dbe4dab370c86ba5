"""The emitter's float32 form (``va/emit.py``, ``emit_group(...,
dtype=torch.float32)``: the walk B1's float32 form runs) against the
port's eager float32 walk, built as host code with ``g++`` as
``tests/test_torch_emit.py`` builds the float64 one.

- The DFF's BSIM4 group, the VA diode (``limexp`` past its cap) and the
  level-1 DFF's built-in ``Mos1`` group, on circuits compiled with
  ``eval_dtype=torch.float32``: the emitted rows (s, q, qd) per instance
  within 64 float32 ulps of each array's largest entry of the eager
  float32 walk's (``CompiledCircuit._walk_group`` on float32 states, the
  same operations; libm's float32 functions and PyTorch's vectorised ones
  part in their last bits, and the walk's cancellations carry that to
  ~4e-7 of the largest charge here), NaN where the eager walk's is NaN
  (the diode's charge below -0.5 V, as in the float64 test).
- The text is float32 throughout: no ``double``, the math functions'
  ``f`` forms, literals as the float32 values they round to; ``limexp``'s
  cap is 55 there and 80 in the float64 text of the same group (the JAX
  package's ``_limexp_cap``); the float64 text is the one the float64 plan
  builds (``emit_group``'s default on a float64 circuit).
- The integer, bitwise and point-list constructs (``netlists.
  a21_circuit``'s ``a21`` and ``PwlConductance`` groups, and a behavioral
  source's ``int``/``nint``) in the float32 form: ``int`` nodes, a
  hoisted ``int`` carried through ``h`` by its bits, a ``static const
  float`` table; the rows within the same 64 ulps of the eager float32
  walk's over biases across every table segment and codes 0-15.

Skips without ``g++``.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.benchmarks import netlists
from cedarsim_tpu_torch.core.compile import _n_pad
from cedarsim_tpu_torch.va import emit
from cedarsim_tpu_torch.va.codegen import load_va
from tests.test_torch_emit import DFF_DIR, VA_DIODE, _host_harness

EPS32 = float(np.finfo(np.float32).eps)
F32 = torch.float32


def _dff(name):
    with open(os.path.join(DFF_DIR, name)) as f:
        nl = T.parse_spice(f.read(), file=name)
    return T.compile_circuit(T.elaborate(nl, include_paths=[DFF_DIR]),
                             device="cpu", eval_dtype=F32)


def _diode():
    dev = load_va(VA_DIODE)["fdiode"]
    ckt = T.Circuit()
    a, b = ckt.net("a"), ckt.net("b")
    ckt.add(T.VSource, "V1", (a, ckt.gnd), dict(dc=1.0))
    ckt.add(T.Resistor, "R1", (a, b), dict(r=1000.0))
    ckt.add(dev, "D1", (b, ckt.gnd), dict(is_=1e-14))
    ckt.add(dev, "D2", (a, b), dict(is_=3e-14, cj=2e-12))
    return T.compile_circuit(ckt, device="cpu", eval_dtype=F32)


def _build(tmp_path, comp, key, ctx):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emitted header as host code")
    e = emit.emit_group(comp, key, ctx)
    g = comp.groups[key]
    (tmp_path / "model.h").write_text(e.text)
    (tmp_path / "run.cpp").write_text('#include "model.h"\n' + _host_harness(
        e.name, g.model.n_lvar(), g.model.n_lrow(),
        len(emit.dyn_names(comp, key)), e.n_hoist).replace("double",
                                                           "float"))
    so = tmp_path / "model.so"
    out = subprocess.run(["g++", "-O1", "-shared", "-fPIC",
                          "-ffp-contract=off", "-o", str(so),
                          str(tmp_path / "run.cpp")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.cs_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7
    return lib, e


def _compare(lib, comp, key, ctx, x, v, t, params):
    """The emitted rows and the eager float32 walk's, per instance."""
    g = comp.groups[key]
    L = x.shape[0]
    ni, nlv, nlr = len(g.instances), g.model.n_lvar(), g.model.n_lrow()
    names = emit.dyn_names(comp, key)
    xp = np.concatenate([x, np.zeros((L, 1))], 1).astype(np.float32)
    vp = np.concatenate([v, np.zeros((L, 1))], 1).astype(np.float32)
    lv = np.ascontiguousarray(xp[:, g.var_idx].reshape(-1, nlv))
    lvd = np.ascontiguousarray(vp[:, g.var_idx].reshape(-1, nlv))
    dyn = np.zeros((L, ni, max(len(names), 1)), np.float32)
    for k, pn in enumerate(names):
        dyn[:, :, k] = np.broadcast_to(
            torch.as_tensor(params[key][pn]).numpy(), (L, ni))
    dyn = np.ascontiguousarray(dyn.reshape(L * ni, -1))
    tt = np.ascontiguousarray(np.repeat(t, ni).astype(np.float32))
    got = [np.zeros((L * ni, nlr), np.float32) for _ in range(3)]
    lib.cs_run(L * ni, lv.ctypes.data, lvd.ctypes.data, dyn.ctypes.data,
               tt.ctypes.data, *(a.ctypes.data for a in got))
    s, q, _, dq, _ = comp._walk_group(
        key, torch.as_tensor(xp), ctx.at_time(torch.as_tensor(
            t, dtype=F32)), comp.lane_params(params, L), L, False,
        torch.as_tensor(vp), None)
    assert s.dtype == F32
    npd = _n_pad(ni)
    want = [a.reshape(L, npd, nlr)[:, :ni].reshape(-1, nlr).numpy()
            for a in (s, q, dq[:, :, 0])]
    for name, a, b in zip(("S", "Q", "Qd"), got, want):
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a)), name   # NaN where NaN
        err = float(np.abs(a[fin] - b[fin]).max())
        assert err <= 64 * EPS32 * float(np.abs(b[fin]).max()), (name, err)


def _float32_text(e):
    assert "double" not in e.text
    assert e.text.startswith(emit.PREAMBLE_F32)


def test_bsim4_float32_walk_matches_eager(tmp_path):
    comp = _dff("dff_tb_bsim4.cir")
    key = [k for k in comp.group_order if "bsim4" in k.lower()][0]
    ctx = T.SimSpec.make(gmin=1e-15).with_mode("tran")
    lib, e = _build(tmp_path, comp, key, ctx)
    _float32_text(e)
    assert "expf(" in e.text and "sqrtf(" in e.text
    rng = np.random.default_rng(11)
    L = 6
    params = {k: dict(g) for k, g in comp.params0.items()}
    params[key]["W"] = comp.params0[key]["W"][None, :] * torch.as_tensor(
        np.linspace(0.5, 2.0, L))[:, None]
    x = np.zeros((L, comp.n_x))
    x[:, :comp.n_nodes] = np.linspace(-0.6, 5.6, L)[:, None] + rng.uniform(
        -0.8, 0.8, (L, comp.n_nodes))
    x[:, comp.n_nodes:] = rng.normal(size=(L, comp.n_x - comp.n_nodes)) \
        * 1e-3
    v = rng.normal(size=(L, comp.n_x)) * 1e9
    _compare(lib, comp, key, ctx, x, v, np.linspace(0.0, 7e-7, L), params)


def test_diode_float32_walk_matches_eager(tmp_path):
    comp = _diode()
    key = [k for k in comp.group_order if "fdiode" in k][0]
    ctx = T.SimSpec.make().with_mode("tran")
    lib, e = _build(tmp_path, comp, key, ctx)
    _float32_text(e)
    assert "55.0f" in e.text and "80.0" not in e.text
    e64 = emit.emit_group(comp, key, ctx, torch.float64)
    assert "80.0" in e64.text and "55.0" not in e64.text
    c64 = T.compile_circuit(comp.circuit, device="cpu")
    assert emit.emit_group(c64, key, ctx).hash == e64.hash
    vd = np.linspace(-2.0, 1.2, 17)          # reverse, knee, limexp tail
    L = vd.size
    x = np.zeros((L, comp.n_x))
    x[:, 0] = 1.0 + vd
    x[:, 1] = vd
    v = np.random.default_rng(5).normal(size=(L, comp.n_x)) * 1e8
    _compare(lib, comp, key, ctx, x, v, np.zeros(L), comp.params0)


def test_mos1_float32_walk_matches_eager(tmp_path):
    comp = _dff("dff_tb.cir")
    ctx = T.SimSpec.make(gmin=1e-15).with_mode("tran")
    lib, e = _build(tmp_path, comp, "Mos1", ctx)
    _float32_text(e)
    rng = np.random.default_rng(3)
    L = 5
    x = np.zeros((L, comp.n_x))
    x[:, :comp.n_nodes] = rng.uniform(-0.5, 5.5, (L, comp.n_nodes))
    x[1, :comp.n_nodes] = 5.0           # drain-source ties on the rails
    x[:, comp.n_nodes:] = rng.normal(size=(L, comp.n_x - comp.n_nodes)) \
        * 1e-3
    v = rng.normal(size=(L, comp.n_x)) * 1e9
    _compare(lib, comp, "Mos1", ctx, x, v, np.linspace(0.0, 7e-7, L),
             comp.params0)


#: a behavioral source's ``int`` and ``nint`` (``tests/test_torch_emit_a21.py``)
BSRC = ("* b\nV1 a 0 1\nR1 a b 1k\n"
        "B1 b 0 I={1e-3*int(V(b)*3) + 2e-3*nint(V(b)*2) + 1e-4*V(b)}\n")


@pytest.mark.parametrize("part", ["a21", "Pwl", "BSource"])
def test_integer_and_table_nodes_in_float32(tmp_path, part):
    if part == "BSource":
        comp = T.compile_circuit(T.load_spice(BSRC), device="cpu",
                                 eval_dtype=F32)
        node = "b"
    else:
        comp = T.compile_circuit(netlists.a21_circuit(), device="cpu",
                                 eval_dtype=F32, dynamic_params=["code"])
        node = "a"
    key = [k for k in comp.group_order if part in k][0]
    ctx = T.SimSpec.make().with_mode("tran")
    lib, e = _build(tmp_path, comp, key, ctx)
    _float32_text(e)
    if part == "a21":
        for h in ("cs_i32(", "cs_shl(", "cs_ibits(", "cs_bitsi("):
            assert h in e.text, h
    elif part == "Pwl":
        assert "static const float cs_tab_" in e.text
        assert "cs_search(" in e.text
    else:
        assert "truncf(" in e.text and "rintf(" in e.text
    L = 128
    x = np.zeros((L, comp.n_x))
    x[:, comp.node_names.index(node)] = np.r_[
        np.linspace(-1.5, 2.5, L - len(netlists.PWL_XS)),
        np.asarray(netlists.PWL_XS)]           # every segment, the knots
    v = np.random.default_rng(5).normal(size=(L, comp.n_x)) * 1e9
    params = {k: dict(g) for k, g in comp.params0.items()}
    if part == "a21":
        params[key]["code"] = torch.as_tensor(
            np.resize(np.arange(16.0), L), dtype=F32)[:, None]
    _compare(lib, comp, key, ctx, x, v, np.zeros(L), params)
