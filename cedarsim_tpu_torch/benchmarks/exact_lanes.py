"""What the transient's exact solve costs when it makes one library call a
lane instead of one batched call, and what each gives the lanes.

The witness is ROADMAP C6's: the level-1 DFF chain of 21 cells
(``netlists.chain``, 243 unknowns, dense), whose lane-batched transient
takes the exact float64 solve under ``dense_lu="auto"`` on every device.
From one operating point, ``tran`` runs over 0-``--tstop`` at ``--lanes``
identical lanes under each of two rules for ``ops/linalg.py``'s transient
solves (``solve_lanes``, ``lu_factor_exact``, ``lu_solve_exact``):
``batched`` (one ``torch.linalg`` call for all lanes) and ``per_lane``
(one call a lane), in turns batched, per_lane, per_lane, batched, after
one warm-up run of each.  Beside each run: its wall (ending in a
synchronise), its counts, and whether every lane is bitwise the one
stream (``tran`` without a lane axis, run once).  The port's own rule on
the device (``linalg._lanes_apart``) is named in ``"port_rule"``.

    python -m cedarsim_tpu_torch.benchmarks.exact_lanes
    python -m cedarsim_tpu_torch.benchmarks.exact_lanes --device cpu \\
        --lanes 4 --tstop 2e-11

prints one JSON object, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time

#: the rules compared, as a predicate on the batched matrix A [L, n, n]
RULES = {"batched": lambda A: False,
         "per_lane": lambda A: A.dim() == 3 and A.shape[0] > 1}


def run(cells=21, lanes=256, tstop=1e-9, device=None):
    import numpy as np
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.analysis.tran import resolve_impl
    from cedarsim_tpu_torch.benchmarks import chain_transient as ct
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.ops import linalg

    comp = netlists.chain(cells, sparse=False, device=device)
    opts = T.TranOptions(max_steps=4096)
    dense_lu = resolve_impl(comp, opts, batched=True).dense_lu
    if dense_lu != "jax":
        raise SystemExit(f"exact_lanes: {comp.n_x} unknowns take "
                         f"dense_lu={dense_lu!r} here, not the exact solve")
    ctx = T.SimSpec.make(gmin=1e-15)
    op = T.solve_dc(comp, ctx=ctx, mode="tranop",
                    opts=T.NewtonOptions(**ct.DC_OPTS))
    x0 = op.x.expand(lanes, -1).contiguous()
    port_rule = "per_lane" if linalg._lanes_apart(
        torch.zeros(2, 1, 1, device=comp.device)) else "batched"
    saved = linalg._lanes_apart
    one = T.tran(comp, (0.0, tstop), ctx=ctx, opts=opts, x0=op.x)

    def sync():
        if comp.device.type == "cuda":
            torch.cuda.synchronize()

    def one_run(rule):
        linalg._lanes_apart = RULES[rule]
        try:
            sync()
            t0 = time.perf_counter()
            sols = T.tran(comp, (0.0, tstop), ctx=ctx, opts=opts, x0=x0)
            sync()
            wall = time.perf_counter() - t0
        finally:
            linalg._lanes_apart = saved
        same = sum(bool(np.array_equal(s.xs, one.xs)
                        and np.array_equal(s.ts, one.ts)) for s in sols)
        return dict(rule=rule, wall_s=wall,
                    converged=all(s.converged for s in sols),
                    accepted=[s.n_accepted for s in sols[:1]],
                    newton=[s.n_newton for s in sols[:1]],
                    lanes_bitwise_one_stream=same)

    for rule in RULES:                         # warm-up
        one_run(rule)
    runs = [one_run(r) for r in ("batched", "per_lane", "per_lane",
                                 "batched")]
    walls = {r: [x["wall_s"] for x in runs if x["rule"] == r] for r in RULES}
    return dict(cells=cells, n_x=comp.n_x, lanes=lanes, tstop=tstop,
                device=str(comp.device), port_rule=port_rule, runs=runs,
                per_lane_over_batched=min(walls["per_lane"])
                / min(walls["batched"]))


def main(argv=None):
    from cedarsim_tpu_torch.benchmarks.sparse_levels import smi
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=21)
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--tstop", type=float, default=1e-9)
    ap.add_argument("--device", default=None,
                    help="cpu for the CPU (default: the card)")
    args = ap.parse_args(argv)
    res = run(args.cells, args.lanes, args.tstop, args.device)
    res["card"] = smi()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
