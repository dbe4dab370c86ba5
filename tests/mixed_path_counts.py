"""The mixed chord path's step counts on the 2-lane DFF, the port's and the
JAX package's, over one window on the CPU.

    JAX_PLATFORMS=cpu python tests/mixed_path_counts.py --tstop 2e-8

The input is cell A's (``kernel_times.XLA_OPTS``, ``jac_shunt=1e-9``) at two
lanes: the DFF from the port's per-lane warm DC at W·0.99 and nominal
(``kernel_times.dff_lanes(lanes=2)``).  Four runs, each giving per lane
(finished, accepted, rejected, Newton iterations):

* ``port_twice``: the port with its plain GESP kernels on the CPU, the
  substitution rounding each column-order term twice (product, then
  difference), as ``gesp_lu.lu_subst_gesp_f32_plain`` does;
* ``port_once``: the same with the substitution rounding each term once (a
  fused multiply-add, ``subst_rounding_once``);
* ``port_pallas_subst``: the same with the substitution replaced by the
  Pallas substitution itself in interpret mode (``subst_pallas``): the port
  with the reference's substitution, to show what the substitution's order
  of sums alone moves;
* ``reference``: the JAX package's own mixed path, its Pallas factor and
  substitution in interpret mode (``cedarsim_tpu.ops.linalg.
  _MIXED_INTERPRET``), the two lanes vmapped through ``tran_core`` as
  ``bench.py`` runs them.

The factor rounds once in all of them (the Pallas factor under XLA, the
port's plain factor through ``rounding.fma_f32``); the port's runs factor
a lane again in the source row order where its factor rounds a pivot to 0
(``ops/linalg.py::chord_factor``, ROADMAP C19), the reference's do not.
``tests/test_torch_tran.py`` holds the 0-1 ns window to the recorded
counts of the port and the reference; the longer window is a measurement
(``PERF.md``).  One JSON object is printed.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DFF_DIR = os.path.join(REPO, "benchmarks", "gf180_dff")


def subst_rounding_once(LU, b):
    """The GESP substitution in column order with one rounding per term
    (``y_i = fma(-L_ik, y_k, y_i)``), the other candidate for B3's
    arithmetic."""
    from cedarsim_tpu_torch.ops.rounding import fma_f32
    n = LU.shape[-1]
    y = b.clone()
    for k in range(n - 1):
        y[:, k + 1:] = fma_f32(-LU[:, k + 1:, k], y[:, k, None], y[:, k + 1:])
    for k in range(n - 1, -1, -1):
        y[:, k] = y[:, k] / LU[:, k, k]
        y[:, :k] = fma_f32(-LU[:, :k, k], y[:, k, None], y[:, :k])
    return y


def subst_pallas(LU, b):
    """The JAX package's Pallas substitution (interpret mode) on the
    port's CPU tensors."""
    import jax.numpy as jnp
    from cedarsim_tpu.ops.pallas_lu import lu_subst_batched_sublane_f32
    x = lu_subst_batched_sublane_f32(jnp.asarray(LU.numpy()),
                                     jnp.asarray(b.numpy()), interpret=True)
    return torch.from_numpy(np.asarray(x).copy())


def dff_two_lanes():
    """(compiled, ctx, per-lane params, per-lane warm DC) of the port."""
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    return kt.dff_lanes(torch, T, "cpu", lanes=2)


def port_counts(tstop, subst=None, dff=None):
    """Per lane (finished, accepted, rejected, Newton) of the port's mixed
    path over 0-tstop; ``subst`` replaces the plain substitution."""
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    from cedarsim_tpu_torch.ops import gesp_lu
    comp, ctx, pb, x0 = dff or dff_two_lanes()
    saved = gesp_lu.lu_subst_gesp_f32_plain
    if subst is not None:
        gesp_lu.lu_subst_gesp_f32_plain = subst
    try:
        sols = T.tran(comp, (0.0, tstop), params=pb, ctx=ctx, x0=x0,
                      opts=T.TranOptions(**kt.XLA_OPTS))
    finally:
        gesp_lu.lu_subst_gesp_f32_plain = saved
    return [(bool(s.converged), s.n_accepted, s.n_rejected, s.n_newton)
            for s in sols]


def reference_counts(tstop, x0):
    """Per lane (finished, accepted, rejected, Newton) of the JAX package's
    mixed path (Pallas kernels in interpret mode) from the per-lane states
    ``x0`` (numpy [2, n]) over 0-tstop.  Sets ``_MIXED_INTERPRET`` for the
    call and restores it."""
    import jax
    import jax.numpy as jnp
    import cedarsim_tpu as J
    from cedarsim_tpu.analysis.tran import (TranOptions, _consistent_xdot,
                                            _differential_mask, tran_core)
    from cedarsim_tpu.ops import linalg as jlinalg
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    with open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")) as f:
        text = f.read()
    cj = J.compile_circuit(J.elaborate(
        J.parse_spice(text, file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]))
    key = [k for k in cj.group_order if "bsim4" in k.lower()][0]
    pb = jax.tree.map(lambda a: jnp.repeat(a[None], 2, 0), cj.params0)
    pb[key] = dict(pb[key],
                   W=pb[key]["W"] * jnp.asarray([0.99, 1.0])[:, None])
    ctx = J.SimSpec.make(gmin=1e-15)
    opts = TranOptions(**kt.XLA_OPTS)
    x0 = jnp.asarray(x0)
    ctx_op = ctx.with_mode("tranop").at_time(0.0)
    xd0 = jax.vmap(lambda x, p: _consistent_xdot(cj, x, ctx_op, p))(x0, pb)
    mask = jax.vmap(lambda x, p: _differential_mask(cj, x, ctx_op, p))(
        x0, pb)
    # the schedule and first step of J.tran / T.tran over 0-tstop
    bps = cj.breakpoints(tstop)
    bps = np.concatenate([bps[bps > 0.0], [tstop], [np.inf]])
    h0 = tstop * 1e-6
    if len(bps) > 2:
        h0 = min(h0, max(float(bps[0]) * 0.1, tstop * 1e-9))
    d = cj.dtype
    saved = jlinalg._MIXED_INTERPRET
    jlinalg._MIXED_INTERPRET = True
    try:
        run = jax.jit(jax.vmap(lambda p, x, xd, m: tran_core(
            cj, p, ctx, x, xd, jnp.asarray(0.0, d), jnp.asarray(tstop, d),
            jnp.asarray(bps, d), jnp.asarray(h0, d), opts, m)))
        _, _, _, k, fin, nrej, nnwt, final = run(pb, x0, xd0, mask)
    finally:
        jlinalg._MIXED_INTERPRET = saved
    t_end = np.asarray(final["t"])
    return [(bool(f) and abs(float(t) - tstop) <= 1e-12 * tstop, int(a),
             int(r), int(w))
            for f, t, a, r, w in zip(np.asarray(fin), t_end, np.asarray(k),
                                     np.asarray(nrej), np.asarray(nnwt))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tstop", type=float, default=1e-9)
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_platforms", "cpu")
    dff = dff_two_lanes()
    out = {"tstop": args.tstop, "lanes": ["W*0.99", "nominal"],
           "fields": ["finished", "accepted", "rejected", "newton"],
           "port_twice": port_counts(args.tstop, dff=dff),
           "port_once": port_counts(args.tstop, subst_rounding_once, dff),
           "port_pallas_subst": port_counts(args.tstop, subst_pallas, dff),
           "reference": reference_counts(args.tstop, dff[3].numpy())}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.abspath(REPO))
    main()
