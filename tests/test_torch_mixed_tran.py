"""The BSIM4 DFF leg under float32 evaluation (``bench.py``'s accelerator
configuration of it: ``eval_dtype=float32``, ``LEGS["bsim4"]
["tpu_opts"]``, ``jac_reuse=1``, "auto" the cap form and BDF2, per-lane W
scatter from each lane's warm DC) through the port's transient against
the JAX package's on the CPU, and the float64 default paths as they were.

- Two lanes (W·0.99 and nominal) over 0-160 ns on the chord ("xla")
  engine with the exact solve, beside the JAX package's same
  configuration (its lanes vmapped through ``tran_core`` as ``bench.py``
  runs them): every lane finishes, q at 150 ns within 0.05 V of the JAX
  package's lane and of the golden's 0 V; the accepted and Newton counts
  within 12 % of the JAX package's, the rejected within 10 steps (the
  float32 walks part in their last bits: XLA fuses multiply-adds the
  port's kernels round apart; measured 184 / 44 / 610 and 188 / 43 / 607
  against 184 / 44 / 610 and 182 / 40 / 576).
- The same two lanes through the fused engine's float32 form (its plain
  version here) over 0-60 ns, across the first clock edge: every lane
  finishes, q at 45 and 55 ns within 0.05 V of the chord engine's.
- Float64, the default: cells A (the mixed chord path), B (the fused
  engine) and E (the level-1 DFF through the fused engine), two lanes
  each over a short window, give the per-lane accepted, rejected and
  Newton counts they gave before the float32 tier was added.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis.tran import (TranOptions as JTranOptions,
                                        _consistent_xdot, _differential_mask,
                                        tran_core)
from cedarsim_tpu_torch.benchmarks import kernel_times as kt

DFF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "benchmarks", "gf180_dff")
TSTOP = 1.6e-7
#: the fused form's window: across the first clock edge (50-51 ns)
FUSED_TSTOP = 6e-8
#: the leg's configuration on the chord engine with the exact solve
XLA = dict(max_steps=8192, jac_reuse=1, dense_lu="jax", newton_impl="xla",
           **kt.LEGS["bsim4"]["tpu_opts"])


def _q150(sol):
    return float(sol.interp("q", 1.5e-7))


@pytest.fixture(scope="module")
def lanes():
    return kt.dff_lanes(torch, T, "cpu", lanes=2, eval_dtype=torch.float32)


@pytest.fixture(scope="module")
def port_xla(lanes):
    comp, ctx, pb, x0 = lanes
    return T.tran(comp, (0.0, TSTOP), params=pb, ctx=ctx, x0=x0,
                  opts=T.TranOptions(**XLA))


def _jax_run(x0):
    """The JAX package's mixed configuration from the port's per-lane warm
    states ``x0`` [2, n]: per lane (finished, accepted, rejected, Newton,
    q at 150 ns)."""
    with open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")) as f:
        text = f.read()
    cj = J.compile_circuit(J.elaborate(
        J.parse_spice(text, file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]), eval_dtype=jnp.float32)
    key = [k for k in cj.group_order if "bsim4" in k.lower()][0]
    pb = jax.tree.map(lambda a: jnp.repeat(a[None], 2, 0), cj.params0)
    pb[key] = dict(pb[key],
                   W=pb[key]["W"] * jnp.asarray([0.99, 1.0])[:, None])
    ctx = J.SimSpec.make(gmin=1e-15)
    x0 = jnp.asarray(x0)
    ctx_op = ctx.with_mode("tranop").at_time(0.0)
    xd0 = jax.vmap(lambda x, p: _consistent_xdot(cj, x, ctx_op, p))(x0, pb)
    mask = jax.vmap(lambda x, p: _differential_mask(cj, x, ctx_op, p))(
        x0, pb)
    bps = cj.breakpoints(TSTOP)
    bps = np.concatenate([bps[bps > 0.0], [TSTOP], [np.inf]])
    h0 = TSTOP * 1e-6
    if len(bps) > 2:
        h0 = min(h0, max(float(bps[0]) * 0.1, TSTOP * 1e-9))
    d = cj.dtype
    run = jax.jit(jax.vmap(lambda p, x, xd, m: tran_core(
        cj, p, ctx, x, xd, jnp.asarray(0.0, d), jnp.asarray(TSTOP, d),
        jnp.asarray(bps, d), jnp.asarray(h0, d), JTranOptions(**XLA), m)))
    ts, xs, _, k, fin, nrej, nnwt, _ = run(pb, x0, xd0, mask)
    iq = cj.node_names.index("q")
    ts, xs = np.asarray(ts), np.asarray(xs)
    return [(bool(f), int(a), int(r), int(w),
             float(np.interp(1.5e-7, ts[i, :int(a)], xs[i, :int(a), iq])))
            for i, (f, a, r, w) in enumerate(zip(
                np.asarray(fin), np.asarray(k), np.asarray(nrej),
                np.asarray(nnwt)))]


def test_float32_leg_matches_the_jax_packages(lanes, port_xla):
    ref = _jax_run(lanes[3].numpy())
    for sol, (fin, acc, rej, nwt, q) in zip(port_xla, ref):
        assert sol.converged and fin
        assert abs(_q150(sol) - q) <= 0.05
        assert abs(_q150(sol)) <= 0.05            # the golden's 0 V
        assert abs(sol.n_accepted - acc) <= 0.12 * acc
        assert abs(sol.n_newton - nwt) <= 0.12 * nwt
        assert abs(sol.n_rejected - rej) <= 10


def test_float32_fused_form_matches_the_chord_engine(lanes, port_xla):
    comp, ctx, pb, x0 = lanes
    sols = T.tran(comp, (0.0, FUSED_TSTOP), params=pb, ctx=ctx, x0=x0,
                  opts=T.TranOptions(**dict(XLA, newton_impl="fused")))
    for sol, ref in zip(sols, port_xla):
        assert sol.converged and sol.n_attempts > 0
        for t in (4.5e-8, 5.5e-8):
            assert abs(float(sol.interp("q", t))
                       - float(ref.interp("q", t))) <= 0.05


#: per cell, (options, window, per-lane (accepted, rejected, Newton)),
#: recorded on the CPU from the tree before the float32 tier; cell A's
#: again after ROADMAP C17, which moved its per-lane warm DC by at most
#: 1.2e-16 V (39 / 2 / 94 and 36 / 0 / 35 before; from the new start
#: 40 / 3 / 110 and 38 / 1 / 49, where the factor in J's own row order
#: rounded pivots to 0), and after C19's repair, which factors such a lane
#: again in the source row order
F64_CELLS = {
    "A": ("XLA_OPTS", 2e-9, [(36, 0, 64), (36, 0, 35)]),
    "B": ("FUSED_OPTS", 2e-9, [(49, 0, 48), (49, 0, 48)]),
    "E": ("LV1_FUSED_OPTS", 5e-9, [(49, 0, 48), (49, 0, 48)]),
}


@pytest.fixture(scope="module")
def lanes64():
    """Cells A and B's float64 BSIM4 lanes, and cell E's level-1 lanes."""
    cache = {}

    def get(cell):
        setup = kt.lv1_lanes if cell == "E" else kt.dff_lanes
        if setup not in cache:
            cache[setup] = setup(torch, T, "cpu", lanes=2)
        return cache[setup]
    return get


@pytest.mark.parametrize("cell", sorted(F64_CELLS))
def test_float64_default_paths_unchanged(lanes64, cell):
    opts, tstop, want = F64_CELLS[cell]
    comp, ctx, pb, x0 = lanes64(cell)
    assert comp.eval_dtype == torch.float64
    sols = T.tran(comp, (0.0, tstop), params=pb, ctx=ctx, x0=x0,
                  opts=T.TranOptions(**getattr(kt, opts)))
    assert [(s.n_accepted, s.n_rejected, s.n_newton) for s in sols] == want
