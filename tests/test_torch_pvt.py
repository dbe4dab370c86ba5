"""The PVT sweep harness of the port (``benchmarks/pvt_sweep.py``)
against the JAX package's ``run_chunked`` on the CPU in float64: 4 points
(2 supplies × 2 widths) of the BSIM4 DFF over 0-60 ns (a short window,
past the first clock edge at 50 ns) in 2 windows chained by checkpoint,
q stored alone.

The reference is the JAX harness's chain (``benchmarks/pvt_sweep.py:
124-273``) built from the JAX package's own parts at this window: every
lane's operating point by the light ladder from the nominal one
(``dc_core`` under ``vmap``), ``blank_checkpoint``, ``window_schedules``
and ``tran_core`` under ``vmap`` with ``init_state``.  Through each of the
port's two engines' plain versions:

- the fused chord solve (B1's plain version) against the JAX package's
  float64 cap-form chord loop (its fused kernel computes in float32);
- the chord loop with the GESP factor and substitution (B2/B3's plain
  versions) against the JAX package's mixed path, its Pallas kernels in
  interpret mode;

each lane's accepted and rejected steps in each window equal, Newton
iterations within 1.5 %, q within 1e-6 V at the end of each window.  One
lane parts (``PARTED``): since ROADMAP C17 (``abs``'s derivative at 0
the JAX package's), the 5.25 V, W·1.03 lane takes 91 accepted steps and
275 Newton iterations over 30-60 ns in both engines where the reference
takes 93 and 287 (its rejected steps and q as the reference's); the two
step sequences part at the first step after the 50 ns clock edge's
breakpoint, 50.051 ns against 50.013 ns, from states equal to 1e-16
relative: the step controller's choice there follows the walk's last
bits, which XLA rounds apart from the port (C2's class).  Before C17 the
two agreed there.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import cedarsim_tpu as J
from cedarsim_tpu.analysis.dc import dc_core, default_newton_options
from cedarsim_tpu.analysis.tran import (TranOptions as JTranOptions,
                                        _consistent_xdot, _differential_mask,
                                        blank_checkpoint, tran_core,
                                        window_schedules)
from cedarsim_tpu.core.compile import ensure_dynamic
from cedarsim_tpu.ops import linalg as jlinalg
from cedarsim_tpu_torch.benchmarks import pvt_sweep

DFF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "benchmarks", "gf180_dff")
POINTS, SEGMENTS, TSTOP = 4, 2, 6e-8
NEWTON_REL = 0.015
#: {(window, lane): {count: (the port's, the reference's)}} where they
#: part (module docstring), in both engines
PARTED = {(1, 3): {"accepted": (91, 93), "newton": (275, 287)}}


@functools.lru_cache(maxsize=1)
def _jax_lanes():
    """The JAX harness's lanes, the same for both engines (made once): the
    compiled DFF, the contexts, q's index, the points' params, the nominal
    operating point and each lane's by the light ladder from it."""
    with open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")) as f:
        nl = J.parse_spice(f.read(), file="dff_tb_bsim4.cir")
    comp = ensure_dynamic(J.compile_circuit(
        J.elaborate(nl, include_paths=[DFF_DIR])), ["vvdd.dc", "w"])
    ctx = J.SimSpec.make(gmin=1e-15)
    ctx_op = ctx.with_mode("tranop")
    key = [k for k in comp.group_order if "bsim4" in k.lower()][0]
    iq = comp.node_names.index("q")
    vdds, wscs = pvt_sweep.grid(POINTS)
    trees = []
    for vdd, wm in zip(vdds, wscs):
        p = comp.set_param(comp.params0, "vvdd.dc", float(vdd))
        p = dict(p)
        p[key] = dict(p[key], W=p[key]["W"] * float(wm))
        trees.append(p)
    pb = jax.tree.map(lambda *ls: jnp.stack(ls), *trees)
    op = J.solve_dc(comp, ctx=ctx, mode="tranop")
    light = dataclasses.replace(default_newton_options(comp), gmin_steps=2,
                                src_steps=2, restarts=0, gmin_start=1e-6)
    r = jax.vmap(lambda p, x: dc_core(comp, p, ctx_op, x, light))(
        pb, jnp.repeat(op.x[None], POINTS, 0))
    x0 = jnp.where(r.converged[:, None], r.x, op.x[None])
    return comp, ctx, ctx_op, iq, pb, op, x0


def _reference(impl):
    """Per window and lane (accepted, rejected, Newton) and q at each
    window's end, of the JAX harness's chain at this window."""
    comp, ctx, ctx_op, iq, pb, op, x0 = _jax_lanes()
    edges = np.linspace(0.0, TSTOP, SEGMENTS + 1)
    win = window_schedules(comp.breakpoints(TSTOP), edges)
    kw = dict(pvt_sweep.PVT_OPTS, max_steps=8192 // SEGMENTS,
              store_vars=(iq,))
    kw.update(dict(newton_impl="xla", dense_lu="jax") if impl == "fused"
              else dict(newton_impl="xla", dense_lu="mixed"))
    opts = JTranOptions(**kw)
    mask = _differential_mask(comp, op.x, ctx_op, comp.params0)
    d = comp.dtype
    ftr = jax.jit(jax.vmap(
        lambda p, x, xd, ist, a, b, w: tran_core(
            comp, p, ctx, x, xd, a, b, w, jnp.asarray(pvt_sweep.H0, d),
            opts, mask, init_state=ist),
        in_axes=(0, 0, 0, 0, None, None, None)))
    xd = jax.vmap(lambda x, p: _consistent_xdot(comp, x, ctx_op, p))(x0, pb)
    st = blank_checkpoint(x0, xd, pvt_sweep.H0)
    out = []
    saved = jlinalg._MIXED_INTERPRET
    jlinalg._MIXED_INTERPRET = True
    try:
        for k in range(SEGMENTS):
            rb = ftr(pb, st["x"], st["xdot"], st, jnp.asarray(edges[k], d),
                     jnp.asarray(edges[k + 1], d), jnp.asarray(win[k], d))
            ts, qs = np.asarray(rb[0]), np.asarray(rb[1])[:, :, 0]
            kk = np.asarray(rb[3])
            out.append(dict(
                finished=np.asarray(rb[4]), accepted=kk - 1,
                rejected=np.asarray(rb[5]), newton=np.asarray(rb[6]),
                q=[float(np.interp(edges[k + 1] * (1 - 1e-9),
                                   ts[i][:kk[i]], qs[i][:kk[i]]))
                   for i in range(POINTS)]))
            st = rb[7]
    finally:
        jlinalg._MIXED_INTERPRET = saved
    return out


@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_pvt_chunked_matches_jax(impl):
    res = pvt_sweep.run_chunked(POINTS, POINTS, SEGMENTS, impl, TSTOP,
                                device="cpu", details=True)
    assert res["engine"] == ("fused" if impl == "fused" else "xla")
    assert res["dense_lu"] == ("jax" if impl == "fused" else "mixed")
    assert res["ok"] and res["tiers"] == dict(
        batch=0, solo_fast=0, solo_warm=0, solo_cold=0, failed=0)
    ch, = res["chunks"]
    assert ch["converged_op"].all() and ch["finished"].all()
    ref = _reference(impl)
    edges = np.linspace(0.0, TSTOP, SEGMENTS + 1)
    for k, rw in enumerate(ref):
        assert rw["finished"].all()
        got = {c: ch[c][k].copy() for c in ("accepted", "newton")}
        for (kw, i), pairs in PARTED.items():
            for c, pair in pairs.items():
                if kw == k:
                    assert (got[c][i], rw[c][i]) == pair, (c, k, i)
                    got[c][i] = rw[c][i]
        np.testing.assert_array_equal(got["accepted"], rw["accepted"])
        np.testing.assert_array_equal(ch["rejected"][k], rw["rejected"])
        np.testing.assert_allclose(got["newton"], rw["newton"],
                                   rtol=NEWTON_REL)
        t_end = edges[k + 1] * (1 - 1e-9)
        for i in range(POINTS):
            q = float(np.interp(t_end, ch["ts"][i], ch["q"][i]))
            assert abs(q - rw["q"][i]) <= 1e-6, (impl, k, i, q, rw["q"][i])
    assert res["accepted"] == int(sum(r["accepted"].sum() for r in ref)) \
        + sum(p["accepted"][0] - p["accepted"][1] for p in PARTED.values())


def test_pvt_whole_grid_run():
    """``run``: the grid as one transient from the nominal operating point
    through the public ``tran`` (0-60 ns, 4 points): every lane finishes
    on the fused engine's plain version."""
    res = pvt_sweep.run(POINTS, "fused", TSTOP, device="cpu")
    assert res["ok"] and res["engine"] == "fused" and res["points"] == POINTS
    assert res["accepted"] > 0 and res["newton"] >= res["accepted"]


def test_pvt_rescue_ladder():
    """The rescue tiers on the CPU at 0-20 ns: three suspects go through
    the batched pass together, one alone through the fast solo; with the
    chunk's options starved of steps, a lane falls to the warm solo with
    cross-step Jacobian reuse."""
    import dataclasses as dc
    pvt = pvt_sweep.PVT("cpu", 2e-8, 2, "fused")
    vdds, wscs = pvt_sweep.grid(POINTS)
    pb = pvt.chunk_params(vdds, wscs)
    res, nw = pvt.rescue(pb, [0, 1, 3], vdds)
    assert {k: v[0] for k, v in res.items()} == {0: "batch", 1: "batch",
                                                  3: "batch"}
    assert nw > 0
    res, _ = pvt.rescue(pb, [2], vdds)
    assert res[2][0] == "solo_fast" and res[2][2]
    pvt.solo_opts = dc.replace(pvt.solo_opts, max_steps=3)
    res, _ = pvt.rescue(pb, [1], vdds)
    assert res[1][0] == "solo_warm" and res[1][2]
