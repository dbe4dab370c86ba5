"""Cell G's step counts on the CPU, the port's and the JAX package's, over
one window of the BSIM-CMG DFF leg.

    JAX_PLATFORMS=cpu python tests/cmg_dff_counts.py --tstop 6e-8
    JAX_PLATFORMS=cpu python tests/cmg_dff_counts.py --lanes 1 \\
        --jac-shunt 1e-7

The input is the leg's (``kernel_times.dff_lanes(leg="cmg")``): the
port's per-lane warm DC of the NFIN scatter, ``linspace(0.99, 1.01)``
with the middle lane nominal, at ``--lanes`` lanes (2: NFIN·0.99 and
nominal; 1: nominal).  Both packages run G-xla's options
(``kernel_times.CMG_XLA_OPTS``) with ``dense_lu="jax"``, the exact
float64 solve (``--jac-shunt`` overrides its shunt), from the same
states: the port through ``tran``, the JAX package through ``tran_core``
vmapped over the lanes as ``bench.py`` runs them.  One JSON object is
printed: per lane (finished, accepted, rejected, Newton iterations) of
each, and the walls.  ``tests/test_torch_cmg_dff.py`` holds the 0-2 ns
window to the JAX package's counts.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DFF_DIR = os.path.join(REPO, "benchmarks", "gf180_dff")


def options(jac_shunt=None):
    """G-xla's options with the exact solve (and ``jac_shunt`` if
    given)."""
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    o = dict(kt.CMG_XLA_OPTS, dense_lu="jax")
    if jac_shunt is not None:
        o["jac_shunt"] = jac_shunt
    return o


def port_counts(tstop, lanes=2, jac_shunt=None, dff=None):
    """(per lane (finished, accepted, rejected, Newton), the lanes'
    initial states as numpy, wall s) of the port."""
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    comp, ctx, pb, x0 = dff or kt.dff_lanes(torch, T, "cpu", lanes=lanes,
                                            leg="cmg")
    t0 = time.perf_counter()
    sols = T.tran(comp, (0.0, tstop), params=pb, ctx=ctx, x0=x0,
                  opts=T.TranOptions(**options(jac_shunt)))
    return ([(bool(s.converged), s.n_accepted, s.n_rejected, s.n_newton)
             for s in sols], x0.numpy(), time.perf_counter() - t0)


def reference_counts(tstop, x0, jac_shunt=None):
    """(per lane (finished, accepted, rejected, Newton), wall s) of the JAX
    package from the per-lane states ``x0`` (numpy [L, n])."""
    import jax
    import jax.numpy as jnp
    import cedarsim_tpu as J
    from cedarsim_tpu.analysis.tran import (TranOptions, _consistent_xdot,
                                            _differential_mask, tran_core)
    t0 = time.perf_counter()
    with open(os.path.join(DFF_DIR, "dff_tb_cmg.cir")) as f:
        text = f.read()
    cj = J.compile_circuit(J.elaborate(
        J.parse_spice(text, file="dff_tb_cmg.cir"), include_paths=[DFF_DIR]))
    key = [k for k in cj.group_order if "bsimcmg" in k.lower()][0]
    lanes = x0.shape[0]
    sc = np.linspace(0.99, 1.01, lanes)
    sc[lanes // 2] = 1.0
    pb = jax.tree.map(lambda a: jnp.repeat(a[None], lanes, 0), cj.params0)
    pb[key] = dict(pb[key],
                   NFIN=pb[key]["NFIN"] * jnp.asarray(sc)[:, None])
    ctx = J.SimSpec.make(gmin=1e-15)
    opts = TranOptions(**options(jac_shunt))
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
    run = jax.jit(jax.vmap(lambda p, x, xd, m: tran_core(
        cj, p, ctx, x, xd, jnp.asarray(0.0, d), jnp.asarray(tstop, d),
        jnp.asarray(bps, d), jnp.asarray(h0, d), opts, m)))
    _, _, _, k, fin, nrej, nnwt, final = run(pb, x0, xd0, mask)
    t_end = np.asarray(final["t"])
    return ([(bool(f) and abs(float(t) - tstop) <= 1e-12 * tstop, int(a),
              int(r), int(w))
             for f, t, a, r, w in zip(np.asarray(fin), t_end, np.asarray(k),
                                      np.asarray(nrej), np.asarray(nnwt))],
            time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tstop", type=float, default=2e-9)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--jac-shunt", type=float, default=None)
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_platforms", "cpu")
    port, x0, port_s = port_counts(args.tstop, args.lanes, args.jac_shunt)
    ref, ref_s = reference_counts(args.tstop, x0, args.jac_shunt)
    out = {"tstop": args.tstop, "lanes": args.lanes,
           "jac_shunt": options(args.jac_shunt)["jac_shunt"],
           "fields": ["finished", "accepted", "rejected", "newton"],
           "port": port, "reference": ref, "port_s": port_s,
           "reference_s": ref_s}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.abspath(REPO))
    main()
