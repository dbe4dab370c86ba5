"""The emitter's integer, bitwise and point-list constructs (ROADMAP A21,
``cedarsim_tpu_torch/va/emit.py``) on the CPU.

The circuit (``netlists.a21_circuit``): a pulse through 1 kΩ into node ``a`` (1 pF), where two
nonlinear devices go to ground:

- ``a21``, a Verilog-A diode whose saturation current is scaled by
  integer arithmetic on its dynamic param ``code`` (an ``integer``
  variable assigned ``code / 2``, ``& | ^ ~ << >>``, ``%``) and whose
  current carries a piecewise-constant term ``(V·8) & 15`` of the walk's
  own value (a cast and a bitwise ``and`` inside the walk);
- ``PwlConductance``, a built-in-style device whose current is a piecewise-linear
  table of V(a) in two point-list params (a Verilog-A param cannot hold a
  point list in either package: ``prepare`` makes it a float), read
  through ``searchsorted`` and indexing.

Checks:

- Both groups emit (the emitter no longer names A21 anywhere): the
  integer helpers and a ``static const double`` table appear, the hoisted
  part holds the params' integer algebra, and the text's hash does not
  depend on the walk's order (emitted twice, equal).
- Built as host code with ``g++`` and called through ``ctypes``, the
  emitted walk equals the eager walk per instance within 1e-12 relative
  over a grid of biases (both table ends and every segment) and codes
  0-15, bitwise on the integer parts; so does a behavioral source's
  ``int`` and ``nint`` (``torch.trunc``, ``torch.round``: ``trunc``,
  ``rint``).
- One chord solve of 4 lanes (``code`` 3, 5, 6, 9) through B1's plain
  version against the JAX package's Pallas kernel in interpret mode
  (float32 there): equal ``ok`` per lane, xn within 1e-4·max|x| + 1e-6 V,
  the tolerance of ``tests/test_torch_fused_chord.py``.  That circuit
  leaves ``PwlConductance`` out: the JAX package's fused kernel passes a nonlinear
  group's array-valued static params as one value per instance
  (``cedarsim_tpu/ops/fused_chord.py:445-447,487-493``), so it cannot
  hold a point list.
- The fused transient (B1's plain version) of the whole circuit over
  0-12 ns finishes every lane, the nominal lane (code 5) within 5e-3 V
  of the JAX package's transient; the lanes differ by their code.
"""

import ctypes
import inspect
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis.tran import TranOptions as JTranOptions
from cedarsim_tpu.devices.base import DeviceModel as JDeviceModel
from cedarsim_tpu.ops.fused_chord import FusedChordPlan as JPlan
from cedarsim_tpu.va.codegen import load_va as jload_va
from cedarsim_tpu_torch.benchmarks import netlists
from cedarsim_tpu_torch.core.dual import Dual
from cedarsim_tpu_torch.ops import fused_chord as fc
from cedarsim_tpu_torch.va import emit

VA_A21 = netlists.VA_A21
XS, YS, CODES = netlists.PWL_XS, netlists.PWL_YS, netlists.A21_CODES


class JPwl(JDeviceModel):
    terminals = ("p", "n")
    params = {"xs": XS, "ys": YS}

    @staticmethod
    def eval(lv, p, ctx, eps):
        v = lv[0] - lv[1]
        xs, ys = jnp.asarray(p["xs"]), jnp.asarray(p["ys"])
        i = jnp.clip(jnp.searchsorted(xs, v, side="right"), 1,
                     xs.shape[-1] - 1)
        x0, x1, y0, y1 = xs[i - 1], xs[i], ys[i - 1], ys[i]
        cur = y0 + (v - x0) * ((y1 - y0) / (x1 - x0))
        s = jnp.stack([cur, -cur])
        return s, jnp.zeros_like(s)


def _jax_circuit(with_pwl=True, eval_dtype=None):
    """``netlists.a21_circuit`` in the JAX package (models evaluated in
    ``eval_dtype``, default its dtype)."""
    ckt = J.Circuit()
    vin, a = ckt.net("in"), ckt.net("a")
    ckt.add(J.VSourcePULSE, "V1", (vin, ckt.gnd),
            dict(v1=0.0, v2=1.2, td=1e-9, tr=1e-9, tf=1e-9, pw=5e-9,
                 per=20e-9))
    ckt.add(J.Resistor, "R1", (vin, a), dict(r=1000.0))
    ckt.add(J.Capacitor, "C1", (a, ckt.gnd), dict(c=1e-12))
    ckt.add(jload_va(VA_A21)["a21"], "X1", (a, ckt.gnd),
            dict(is_=1e-14, code=5.0))
    if with_pwl:
        ckt.add(JPwl, "P1", (a, ckt.gnd), {})
    return J.compile_circuit(ckt, dynamic_params=["code"],
                             eval_dtype=eval_dtype)


@pytest.fixture(scope="module")
def circuits():
    return _jax_circuit(), netlists.a21_lanes("cpu")[0]


@pytest.fixture(scope="module")
def va_only():
    return (_jax_circuit(with_pwl=False),
            netlists.a21_lanes("cpu", with_pwl=False)[0])


def _key(comp, part):
    return [k for k in comp.group_order if part in k][0]


def _lane_params(comp, codes):
    pb = {k: dict(g) for k, g in comp.params0.items()}
    pb[_key(comp, "a21")]["code"] = torch.as_tensor(
        codes, dtype=torch.float64)[:, None]
    return pb


CTX = T.SimSpec.make().with_mode("tran")


def test_groups_emit_with_ints_and_a_table(circuits):
    _, ct = circuits
    assert "A21" not in inspect.getsource(emit)
    va = emit.emit_group(ct, _key(ct, "a21"), CTX)
    for h in ("cs_i32(", "cs_shl(", "cs_shr(", "fmod(", "(~"):
        assert h in va.text, h
    # the params' integer algebra is hoisted; the walk's own cast stays
    assert va.n_hoist >= 1 and "cs_i32" in va.text.split("_pre(")[1]
    pw = emit.emit_group(ct, _key(ct, "Pwl"), CTX)
    assert "static const double cs_tab_" in pw.text
    bs = T.compile_circuit(T.load_spice(BSRC), device="cpu")
    bt = emit.emit_group(bs, _key(bs, "BSource"), CTX).text
    assert "trunc(" in bt and "rint(" in bt
    assert "cs_search(" in pw.text
    assert emit.emit_group(ct, _key(ct, "a21"), CTX).hash == va.hash
    assert emit.emit_group(ct, _key(ct, "Pwl"), CTX).hash == pw.hash


def _host_build(tmp_path, comp, key):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emitted header as host code")
    e = emit.emit_group(comp, key, CTX)
    g = comp.groups[key]
    nlv, nlr = g.model.n_lvar(), g.model.n_lrow()
    nd = max(len(emit.dyn_names(comp, key)), 1)
    (tmp_path / "model.h").write_text(e.text)
    src = tmp_path / "run.cpp"
    src.write_text(
        '#include "model.h"\n'
        'extern "C" void cs_run(int n, const double* lv, const double* lvd,'
        " const double* dyn, double* s, double* q, double* qd) {\n"
        f"  double h[{max(e.n_hoist, 1)}];\n"
        "  for (int i = 0; i < n; ++i) {\n"
        f"    {e.name}_pre(dyn + i * {nd}, 0.0, h);\n"
        f"    {e.name}(lv + i * {nlv}, lvd + i * {nlv}, h, s + i * {nlr}, "
        f"q + i * {nlr}, qd + i * {nlr});\n  }}\n}}\n")
    so = tmp_path / "model.so"
    out = subprocess.run(["g++", "-O1", "-shared", "-fPIC",
                          "-ffp-contract=off", "-o", str(so), str(src)],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.cs_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6
    return lib, nd


#: a behavioral source whose current takes ``int`` (``torch.trunc``) and
#: ``nint`` (``torch.round``): the torch calls of the port's model walks
#: that the emitter had no C form for
BSRC = ("* b\nV1 a 0 1\nR1 a b 1k\n"
        "B1 b 0 I={1e-3*int(V(b)*3) + 2e-3*nint(V(b)*2) + 1e-4*V(b)}\n")


@pytest.mark.parametrize("part", ["a21", "Pwl", "BSource"])
def test_emitted_walk_equals_the_eager_walk(tmp_path, circuits, part):
    ct = circuits[1] if part != "BSource" else T.compile_circuit(
        T.load_spice(BSRC), device="cpu")
    key = _key(ct, part)
    lib, nd = _host_build(tmp_path, ct, key)
    g = ct.groups[key]
    nlv, nlr = g.model.n_lvar(), g.model.n_lrow()
    rng = np.random.default_rng(5)
    N = 512
    lv = np.zeros((N, nlv))
    lv[:, 0] = np.r_[np.linspace(-1.5, 2.5, N - 6),
                     np.asarray(XS)]          # every segment, the knots
    lvd = rng.normal(size=(N, nlv)) * 1e9
    dyn = np.zeros((N, nd))
    names = emit.dyn_names(ct, key)
    for k, pn in enumerate(names):
        dyn[:, k] = np.resize(np.arange(16.0), N) if pn == "code" \
            else float(ct.params0[key][pn][0])
    lv, lvd, dyn = (np.ascontiguousarray(a) for a in (lv, lvd, dyn))
    s, q, qd = (np.zeros((N, nlr)) for _ in range(3))
    lib.cs_run(N, lv.ctypes.data, lvd.ctypes.data, dyn.ctypes.data,
               s.ctypes.data, q.ctypes.data, qd.ctypes.data)
    p = dict(g.static_params)
    for k, pn in enumerate(names):
        p[pn] = torch.as_tensor(dyn[:, k])
    x = [Dual(torch.as_tensor(lv[:, k]), torch.as_tensor(lvd[None, :, k]))
         for k in range(nlv)]
    s_rows, q_rows = g.model.eval(x, p, CTX.at_time(torch.zeros(N)), None)

    def rows(rs, tangent=False):
        out = []
        for r in rs:
            if isinstance(r, Dual):
                r = r.d[0] if tangent else r.v
            elif tangent:
                r = 0.0
            out.append(np.broadcast_to(torch.as_tensor(r).numpy(), (N,)))
        return np.stack(out, 1)

    for name, a, b in zip(("s", "q", "qd"), (s, q, qd),
                          (rows(s_rows), rows(q_rows), rows(q_rows, True))):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-30,
                                   err_msg=name)


BASE = dict(formulation="cap", jac_reuse=1, newton_reltol=1e-4,
            newton_abstol=1e-9, res_tol=1e-9, res_rel=1e-6)


def chord_vs_pallas(cj, ct, opts=BASE):
    """One chord solve of ``len(CODES)`` lanes through B1's plain version
    on ``ct`` and through the JAX package's Pallas kernel in interpret
    mode on ``cj``, both with the Newton options ``opts``: (xn, ok, Newton
    counts) of the port's, then of theirs, as numpy arrays."""
    L = len(CODES)
    t, h = 2.5e-9, 1e-11
    ctx = T.SimSpec.make()
    op = T.solve_dc(ct, ctx=ctx, mode="tranop")
    rng = np.random.default_rng(21)
    x_op = op.x.numpy()
    x_pred = x_op[None] + np.concatenate(
        [rng.uniform(0.3, 0.6, (L, ct.n_nodes)),
         np.zeros((L, ct.n_x - ct.n_nodes))], 1)
    pb = _lane_params(ct, list(CODES))
    _, _, G, C = ct.res_jacs_fwd(torch.as_tensor(x_pred),
                                 ctx.with_mode("tran").at_time(t), pb)
    nv = ct.n_nodes + ct.n_internal
    Jm = (C / h + G).numpy() + 1e-7 * np.diag(np.arange(ct.n_x) < nv)
    xdh = -np.repeat(x_op[None], L, 0)
    tp = fc.get_fused_plan(ct, CTX)
    assert tp.nl_keys == [_key(ct, "a21")]
    jp = JPlan(cj, J.SimSpec.make().with_mode("tran"))
    jopts = JTranOptions(**opts, newton_impl="fused")
    so_j = np.asarray(jp.s_off(t, J.SimSpec.make().with_mode("tran")))
    key = _key(ct, "a21")
    pj = {k: {pn: jnp.asarray(np.repeat(np.asarray(v)[None], L, 0))
              for pn, v in g.items()} for k, g in cj.params0.items()}
    pj[_key(cj, "a21")]["code"] = jnp.asarray(pb[key]["code"].numpy())

    def one(x, Jl, xd, p):
        return jp(jnp.asarray(x), jnp.asarray(Jl), jnp.asarray(so_j), 1.0,
                  h, jnp.asarray(xd), t, jopts, params=p, interpret=True)

    xn_j, _, _, ok_j, nn_j = jax.vmap(one)(x_pred, Jm, xdh, pj)
    tx = torch.as_tensor
    ones = torch.ones(L, dtype=torch.float64)
    so_t = tp.s_off(t * ones, CTX, pb)
    xn_t, _, _, ok_t, nnwt = tp(
        tx(x_pred), tx(Jm), so_t, ones, h * ones, tx(xdh), t * ones,
        T.TranOptions(**opts, newton_impl="fused"), params=pb)
    return (xn_t.numpy(), ok_t.numpy(), nnwt.numpy(), np.asarray(xn_j),
            np.asarray(ok_j).astype(bool), np.asarray(nn_j).astype(int))


def test_chord_solve_matches_pallas(va_only):
    xn_t, ok_t, nnwt, xn_j, ok_j, _ = chord_vs_pallas(*va_only)
    assert ok_t.tolist() == ok_j.tolist()
    assert bool(ok_t.all()) and int(nnwt.min()) >= 2
    tol = 1e-4 * float(np.abs(xn_j).max()) + 1e-6
    np.testing.assert_allclose(xn_t, xn_j, rtol=0, atol=tol)


def test_fused_transient_on_the_a21_circuit(circuits):
    cj, ct = circuits
    pb = _lane_params(ct, list(CODES))
    runs = T.tran(ct, (0.0, 12e-9), params=pb, ctx=T.SimSpec.make(),
                  opts=T.TranOptions(**BASE, newton_impl="fused"))
    ia = ct.node_names.index("a")
    assert all(s.converged for s in runs)
    peak = [float(s.xs[:, ia].max()) for s in runs]
    assert len(set(peak)) == len(peak)
    js = J.tran(cj, (0.0, 12e-9), ctx=J.SimSpec.make(),
                opts=JTranOptions(**BASE, newton_impl="xla"))
    assert js.converged
    tg = np.linspace(0.5e-9, 11.5e-9, 45)
    f = runs[CODES.index(5.0)]
    vj = np.interp(tg, np.asarray(js.ts), np.asarray(js.xs)[:, ia])
    assert np.abs(np.interp(tg, f.ts, f.xs[:, ia]) - vj).max() < 5e-3
