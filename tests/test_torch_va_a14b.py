"""The VA interpreter's runtime-switched branches, ``ddx`` and ``idt`` in
the port (``cedarsim_tpu_torch/va/codegen.py``) against the JAX package's
interpreter on the CPU in float64.

- ``tests/test_va.py``'s switch (``vasw``: V(p, n) <+ ron·I(sw) when
  V(c) > 0.5, else a leakage I(p, n) <+ 1e-12·V(p, n)), closed and open:
  the condition is on an unknown, so both sides are walked and every
  accumulation and the branch's mode are merged with ``where``.  A second
  switch whose mode is a static parameter (the way ``vbic.va`` pins its
  thermal node) folds on the host.  Each operating point (both solved to
  ``reltol=1e-9``) within ‖G⁻¹‖∞ · 1e-12 · I of the JAX package's (I the
  largest source current: the two residual functions are held equal to
  1e-12 · I), and (S, Q, G, C) at the JAX package's point within 1e-12 of
  the JAX package's (S of the supply current, the rest of each array's
  largest entry).
- ``ddx``: ``VA_DDX``'s current gd = ddx(V(p)³, V(p)) = 3V(p)² reads 12 at
  2 V, and its Jacobian (the second derivative, 6V(p)) equals the JAX
  package's.
- ``idt``: ``VA_IDT``'s series R-L (i = ∫k·v dt) with the JAX package's
  accepted and rejected steps, Newton iterations and waveform (1e-9 V);
  at the operating point the idt state is pinned to its ic.
- With no ``ddx`` in a module the interpreter does no tangent arithmetic
  (one torch operation per +, −, ·, /, negation).
- The emitted walks (``va/emit.py``, what B1 runs) of the switched,
  ``ddx`` and ``idt`` modules built with ``g++`` against the eager walk,
  as ``tests/test_torch_emit.py`` does, the switch at biases on both sides
  of its condition.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.va.codegen import load_va as j_load_va
from cedarsim_tpu_torch.va.codegen import load_va as t_load_va

#: the two residual functions and (G, C) against the JAX package's,
#: relative to their scale
EVAL_RTOL = 1e-12
TIGHT = dict(reltol=1e-9, abstol=1e-15)

VA_SWITCH = """
module vasw(p, n, c);
  inout p, n, c;
  electrical p, n, c;
  parameter real ron = 1.0;
  analog begin
    if (V(c) > 0.5)
      V(p, n) <+ ron * I(sw);     // closed: tiny drop
    else
      I(p, n) <+ 1e-12 * V(p, n); // open: leakage only
  end
  branch (p, n) sw;
endmodule
"""

#: a switch whose mode is a static parameter: the row folds on the host
VA_SWITCH_STATIC = """
module vaswp(p, n);
  inout p, n;
  electrical p, n;
  parameter real closed = 1.0;
  parameter real ron = 10.0;
  parameter real roff = 1e4;
  analog begin
    if (closed > 0.5)
      V(p, n) <+ ron * I(br);
    else
      I(p, n) <+ V(p, n) / roff + ddt(1e-9 * V(p, n));
  end
  branch (p, n) br;
endmodule
"""

VA_DDX = """
module nlvcr(p, n);
  inout p, n;
  electrical p, n;
  real gd;
  analog begin
    gd = ddx(V(p)*V(p)*V(p), V(p));
    I(p, n) <+ gd;
  end
endmodule
"""

VA_IDT = """
module vaint(p, n);
  inout p, n;
  electrical p, n;
  parameter real k = 1.0;
  analog I(p, n) <+ idt(k * V(p, n), 0.0);
endmodule
"""


def _switch(P, dev, vctrl):
    ckt = P.Circuit()
    a, b, cn = ckt.net("a"), ckt.net("b"), ckt.net("cn")
    ckt.add(P.VSource, "V1", (a, ckt.gnd), dict(dc=2.0))
    ckt.add(P.VSource, "VC", (cn, ckt.gnd), dict(dc=vctrl))
    ckt.add(P.Resistor, "R1", (a, b), dict(r=1000.0))
    ckt.add(dev["vasw"], "S1", (b, ckt.gnd, cn), dict(ron=1.0))
    return ckt


def _static_switch(P, dev, closed):
    ckt = P.Circuit()
    a, b = ckt.net("a"), ckt.net("b")
    ckt.add(P.VSource, "V1", (a, ckt.gnd), dict(dc=2.0))
    ckt.add(P.Resistor, "R1", (a, b), dict(r=1000.0))
    ckt.add(dev["vaswp"], "S1", (b, ckt.gnd), dict(closed=closed))
    return ckt


def _ddx(P, dev):
    ckt = P.Circuit()
    a = ckt.net("a")
    ckt.add(P.VSource, "V1", (a, ckt.gnd), dict(dc=2.0))
    ckt.add(dev["nlvcr"], "N1", (a, ckt.gnd), dict())
    return ckt


def _idt(P, dev):
    ckt = P.Circuit()
    a, b = ckt.net("a"), ckt.net("b")
    ckt.add(P.VSource, "V1", (a, ckt.gnd), dict(dc=1.0))
    ckt.add(P.Resistor, "R1", (a, b), dict(r=2.0))
    ckt.add(dev["vaint"], "L1", (b, ckt.gnd), dict(k=100.0))
    return ckt


def _pair(build, text, *args):
    """(port compiled, JAX compiled) of ``build`` on each package's device
    class from ``text``."""
    ct = T.compile_circuit(build(T, t_load_va(text), *args), device="cpu")
    cj = J.compile_circuit(build(J, j_load_va(text), *args))
    return ct, cj


def _evals(ct, cj, x, mode, gmin=None):
    kw = {} if gmin is None else dict(gmin=gmin)
    port = [a.numpy() for a in ct.res_jacs_fwd(
        torch.as_tensor(x), T.SimSpec.make(**kw).with_mode(mode))]
    ref = [np.asarray(a) for a in cj.res_jacs_fwd(
        jnp.asarray(x), J.SimSpec.make(**kw).with_mode(mode))]
    return port, ref


def _dc_equal(ct, cj, gmin=None):
    """Both operating points solved to 1e-9 (``gmin``: the context's, else
    the default); (S, Q, G, C) at the JAX package's within ``EVAL_RTOL``
    of their scales and the points within the gap those bounds allow.
    Returns the port's point."""
    kw = {} if gmin is None else dict(gmin=gmin)
    rt = T.solve_dc(ct, ctx=T.SimSpec.make(**kw),
                    opts=T.NewtonOptions(**TIGHT))
    rj = J.solve_dc(cj, ctx=J.SimSpec.make(**kw),
                    opts=J.NewtonOptions(**TIGHT))
    assert bool(rt.converged) and bool(rj.converged)
    xt, xj = rt.x.numpy(), np.asarray(rj.x)
    port, ref = _evals(ct, cj, xj, "dcop", gmin)
    i_scale = float(np.abs(xj[ct.n_nodes + ct.n_internal:]).max())
    assert i_scale > 0
    s_scale = max(i_scale, float(np.abs(ref[0]).max()))
    assert float(np.abs(port[0] - ref[0]).max()) <= EVAL_RTOL * s_scale
    for name, a, b in zip("QGC", port[1:], ref[1:]):
        assert float(np.abs(a - b).max()) <= EVAL_RTOL * max(
            float(np.abs(b).max()), 1e-300), name
    g_inv = np.linalg.inv(ref[2])
    bound = float(np.abs(g_inv).sum(1).max()) * EVAL_RTOL * i_scale
    assert float(np.abs(xt - xj).max()) <= bound, (np.abs(xt - xj), bound)
    return xt


@pytest.mark.parametrize("vctrl, closed", [(1.0, True), (0.0, False)])
def test_switch_on_an_unknown(vctrl, closed):
    ct, cj = _pair(_switch, VA_SWITCH, vctrl)
    assert ct.n_x == cj.n_x
    x = _dc_equal(ct, cj)
    vb = x[ct.node_names.index("b")]
    assert (vb < 0.01) if closed else (vb > 1.99)
    # the row in the other mode at the same point: the transient's
    # (TRAN) evaluation walks both sides too
    port, ref = _evals(ct, cj, x, "tran")
    for name, a, b in zip("SQGC", port, ref):
        assert float(np.abs(a - b).max()) <= EVAL_RTOL * max(
            float(np.abs(b).max()), 1e-300), name


@pytest.mark.parametrize("closed", [1.0, 0.0])
def test_switch_on_a_static_parameter(closed):
    ct, cj = _pair(_static_switch, VA_SWITCH_STATIC, closed)
    x = _dc_equal(ct, cj)
    vb = x[ct.node_names.index("b")]
    # the divider, with the DC's gmin from b to ground
    gmin = T.SimSpec.make().gmin
    g_dev = 1.0 / 10.0 if closed else 1.0 / 1e4
    want = 2.0 * 1e-3 / (1e-3 + g_dev + gmin)
    assert abs(vb - want) <= 1e-12
    port, ref = _evals(ct, cj, x, "tran")
    for name, a, b in zip("SQGC", port, ref):
        assert float(np.abs(a - b).max()) <= EVAL_RTOL * max(
            float(np.abs(b).max()), 1e-300), name


def test_ddx_observable_and_jacobian():
    ct, cj = _pair(_ddx, VA_DDX)
    x = _dc_equal(ct, cj)
    obs = ct.observe("N1.I")(torch.as_tensor(x),
                             torch.zeros(ct.n_x, dtype=torch.float64),
                             T.SimSpec.make(), None)
    assert float(obs) == pytest.approx(3 * 2.0 ** 2, rel=1e-12)
    port, ref = _evals(ct, cj, x, "dcop")
    ia = ct.node_names.index("a")
    assert port[2][ia, ia] == pytest.approx(6 * 2.0, rel=1e-12)
    np.testing.assert_array_equal(port[2], ref[2])


def test_idt_rl_transient():
    ct, cj = _pair(_idt, VA_IDT)
    x = _dc_equal(ct, cj)
    # the idt state (the device's branch row) pinned to its ic, 0
    assert x[ct._inst_branch["L1"]] == 0.0
    st = T.tran(ct, (0.0, 0.1))
    sj = J.tran(cj, (0.0, 0.1))
    assert st.converged and sj.converged
    assert (st.n_accepted, st.n_rejected, st.n_newton) == \
        (sj.n_accepted, sj.n_rejected, sj.n_newton)
    for col in range(ct.n_x):
        np.testing.assert_allclose(
            np.interp(np.asarray(sj.ts), st.ts, st.xs[:, col]),
            np.asarray(sj.xs)[:, col], rtol=0, atol=1e-9)
    tau = (1.0 / 100.0) / 2.0
    assert np.allclose(st["b"], np.exp(-st.ts / tau), atol=0.02)


def test_no_tangent_arithmetic_without_ddx():
    """Values with no ddx tangent cost the interpreter no tangent
    arithmetic: each of +, −, ·, / and negation on two tensors is one
    torch operation (the eager walk of every model without ``ddx``, e.g.
    BSIM4 and BSIM-CMG, launches what it did before the third channel)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from cedarsim_tpu_torch.va import codegen as cg

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    a = (torch.tensor([2.0], dtype=torch.float64), None, None)
    b = (torch.tensor([3.0], dtype=torch.float64), None, None)
    for op in (cg._padd, cg._psub, cg._pmul, cg._pdiv,
               lambda u, v: cg._pneg(u)):
        with Count() as c:
            out = op(a, b)
        assert c.n == 1 and out[1] is None and out[2] is None, op


@pytest.mark.parametrize("which", ["switch", "ddx", "idt"])
def test_emitted_walk_matches_the_eager_walk(tmp_path, which):
    from tests.test_torch_emit import _check, _emitted_vs_eager, _host_build
    build, text, args = {"switch": (_switch, VA_SWITCH, (1.0,)),
                         "ddx": (_ddx, VA_DDX, ()),
                         "idt": (_idt, VA_IDT, ())}[which]
    comp = T.compile_circuit(build(T, t_load_va(text), *args),
                             device="cpu")
    key = [k for k in comp.group_order if k.startswith("VA_")][0]
    ctx = T.SimSpec.make().with_mode("tran")
    lib = _host_build(tmp_path, comp, key, ctx)
    rng = np.random.default_rng(7)
    L = 8
    x = rng.uniform(-1.5, 2.5, (L, comp.n_x))
    if which == "switch":
        # the control node on both sides of the condition
        x[:, comp.node_names.index("cn")] = np.linspace(0.0, 1.0, L)
    v = rng.normal(size=(L, comp.n_x)) * 1e3
    _check(*_emitted_vs_eager(lib, comp, key, ctx, x, v, np.zeros(L),
                              comp.params0))
