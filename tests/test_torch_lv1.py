"""The level-1 DFF leg of ``bench.py`` (``benchmarks/gf180_dff/dff_tb.cir``
on the level-1 MOSFETs of ``models_lv1.spice``) through the port's two
chord engines on the CPU (the kernels' plain versions), against the JAX
package's transient on the same 2 lanes (vto·0.99 and nominal, each from
its own operating point) over 0-150 ns, the first gate point:

- cell D's engine, the mixed chord path (``kernel_times.LV1_XLA_OPTS``:
  charge-form trap, ``jac_reuse=1``, float32 GESP factor and substitution,
  the Jacobian-only shunt 1e-9), against the JAX package's mixed path with
  its Pallas kernels in interpret mode: accepted and rejected steps equal,
  Newton iterations within 2 %;
- cell E's engine, the fused chord solve (``LV1_FUSED_OPTS``, cap form,
  BDF2), against the JAX package's float64 cap-form chord loop
  (``newton_impl="xla"``, exact solve, the same options; the JAX fused
  kernel computes in float32): every count equal;
- q within 1e-6 V of the reference at 100 and 150 ns on every lane, and
  within the gate of 0 V at 150 ns.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis.dc import solve_dc as jsolve_dc
from cedarsim_tpu.analysis.tran import (TranOptions as JTranOptions,
                                        _consistent_xdot, _differential_mask,
                                        tran_core)
from cedarsim_tpu.ops import linalg as jlinalg
from cedarsim_tpu_torch.benchmarks import kernel_times as kt

DFF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "benchmarks", "gf180_dff")
TSTOP = 1.5e-7
SCALE = [0.99, 1.0]


def _text():
    with open(os.path.join(DFF_DIR, "dff_tb.cir")) as f:
        return f.read()


@pytest.fixture(scope="module")
def port():
    comp = T.compile_circuit(T.elaborate(
        T.parse_spice(_text(), file="dff_tb.cir"), include_paths=[DFF_DIR]),
        device="cpu", dynamic_params=("vto",))
    pb = {k: {pn: v.expand((2,) + tuple(v.shape)) for pn, v in g.items()}
          for k, g in comp.params0.items()}
    pb["Mos1"] = dict(pb["Mos1"])
    pb["Mos1"]["vto"] = comp.params0["Mos1"]["vto"][None] * torch.tensor(
        SCALE, dtype=torch.float64)[:, None]
    return comp, pb


def _reference(opts, interpret):
    """Per lane (finished, accepted, rejected, Newton) and q at 100 and 150
    ns of the JAX package's transient: the two lanes vmapped through
    ``tran_core`` as ``bench.py`` runs them, each from its own operating
    point, the schedule and first step of ``tran``."""
    cj = J.compile_circuit(J.elaborate(
        J.parse_spice(_text(), file="dff_tb.cir"), include_paths=[DFF_DIR]),
        dynamic_params=("vto",))
    ctx = J.SimSpec.make(gmin=1e-15)
    pb = jax.tree.map(lambda a: jnp.repeat(a[None], 2, 0), cj.params0)
    pb["Mos1"] = dict(pb["Mos1"], vto=pb["Mos1"]["vto"]
                      * jnp.asarray(SCALE)[:, None])
    x0 = jnp.stack([jsolve_dc(cj, params=jax.tree.map(lambda a: a[i], pb),
                              ctx=ctx, mode="tranop").x for i in range(2)])
    ctx_op = ctx.with_mode("tranop").at_time(0.0)
    xd0 = jax.vmap(lambda x, p: _consistent_xdot(cj, x, ctx_op, p))(x0, pb)
    mask = jax.vmap(lambda x, p: _differential_mask(cj, x, ctx_op, p))(
        x0, pb)
    bps = cj.breakpoints(TSTOP)
    bps = np.concatenate([bps[bps > 0.0], [TSTOP], [np.inf]])
    h0 = min(TSTOP * 1e-6, max(float(bps[0]) * 0.1, TSTOP * 1e-9))
    d = cj.dtype
    saved = jlinalg._MIXED_INTERPRET
    jlinalg._MIXED_INTERPRET = interpret
    try:
        run = jax.jit(jax.vmap(lambda p, x, xd, m: tran_core(
            cj, p, ctx, x, xd, jnp.asarray(0.0, d), jnp.asarray(TSTOP, d),
            jnp.asarray(bps, d), jnp.asarray(h0, d), opts, m)))
        ts, xs, _, k, fin, nrej, nnwt, _ = run(pb, x0, xd0, mask)
    finally:
        jlinalg._MIXED_INTERPRET = saved
    qi = cj.node_names.index("q")
    q = [[float(np.interp(t, np.asarray(ts[i])[:int(k[i])],
                          np.asarray(xs[i])[:int(k[i]), qi]))
          for t in (1e-7, TSTOP)] for i in range(2)]
    counts = [(bool(f), int(a), int(r), int(w)) for f, a, r, w in zip(
        np.asarray(fin), np.asarray(k), np.asarray(nrej), np.asarray(nnwt))]
    return counts, q


@pytest.mark.parametrize("cell", ["D", "E"])
def test_lv1_engines_match_jax(port, cell):
    comp, pb = port
    if cell == "D":
        topts = kt.LV1_XLA_OPTS
        jopts = JTranOptions(**topts)
    else:
        topts = kt.LV1_FUSED_OPTS
        jopts = JTranOptions(**dict(topts, newton_impl="xla",
                                    dense_lu="jax"))
    sols = T.tran(comp, (0.0, TSTOP), params=pb,
                  ctx=T.SimSpec.make(gmin=1e-15),
                  opts=T.TranOptions(**topts))
    got = [(s.converged, s.n_accepted, s.n_rejected, s.n_newton)
           for s in sols]
    want, q_ref = _reference(jopts, interpret=cell == "D")
    assert all(g[0] and w[0] for g, w in zip(got, want)), (got, want)
    if cell == "E":
        assert got == want
    else:
        assert [g[1:3] for g in got] == [w[1:3] for w in want]
        for g, w in zip(got, want):
            assert abs(g[3] - w[3]) <= 0.02 * w[3], (got, want)
    for s, qr in zip(sols, q_ref):
        q = [float(s.interp("q", t)) for t in (1e-7, TSTOP)]
        np.testing.assert_allclose(q, qr, rtol=0, atol=1e-6)
        assert abs(q[1]) < 0.05


#: ROADMAP C3's window: the first 20 ns of the single stream, where one
#: lane through the float32 GESP path and the exact solve already part
C3_TSTOP = 2e-8


def test_c3_one_stream_takes_the_exact_solve(monkeypatch):
    """ROADMAP Queue C, C3: the level-1 DFF as one stream (full Newton, the
    leg's default options) under ``dense_lu="mixed"``.  The JAX package
    reaches its GESP kernels only inside ``vmap``, so its one stream takes
    the exact LU; the port's one stream must give its accepted, rejected
    and Newton counts, with no GESP factor.  The same lane as a batch of
    one ([1, n_x]) takes the GESP path (its plain version here) and parts
    from them."""
    from cedarsim_tpu_torch.ops import gesp_lu
    seen = []
    plain = gesp_lu.lu_factor_gesp_f32_plain
    monkeypatch.setattr(gesp_lu, "lu_factor_gesp_f32_plain",
                        lambda A: seen.append(A.shape) or plain(A))
    comp = T.compile_circuit(T.elaborate(
        T.parse_spice(_text(), file="dff_tb.cir"), include_paths=[DFF_DIR]),
        device="cpu")
    cj = J.compile_circuit(J.elaborate(
        J.parse_spice(_text(), file="dff_tb.cir"), include_paths=[DFF_DIR]))
    ctx = T.SimSpec.make(gmin=1e-15)
    ref = J.tran(cj, (0.0, C3_TSTOP), ctx=J.SimSpec.make(gmin=1e-15),
                 opts=JTranOptions(max_steps=16384, dense_lu="mixed"))
    one = T.tran(comp, (0.0, C3_TSTOP), ctx=ctx,
                 opts=T.TranOptions(max_steps=16384, dense_lu="mixed"))

    def counts(s):
        return (bool(s.converged), s.n_accepted, s.n_rejected, s.n_newton)
    assert counts(one) == counts(ref)
    assert seen == []
    x0 = T.solve_dc(comp, ctx=ctx, mode="tranop").x[None]
    lane, = T.tran(comp, (0.0, C3_TSTOP), ctx=ctx, x0=x0,
                   opts=T.TranOptions(max_steps=16384, dense_lu="mixed"))
    assert len(seen) > 0 and all(s[0] == 1 for s in seen)
    assert lane.converged and counts(lane) != counts(ref)
