"""Where S1 (``sparse_lu.factor``) and S2 (``sparse_lu.solve_factored``)
spend their time, level by level, on one plan at one lane.

    python -m cedarsim_tpu_torch.benchmarks.sparse_levels [--cells 40]
        [--models bsim4] [--out FILE]

The plan is the chain's (``netlists.chain(cells, models)``, compiled on the
CPU, as every device builds it).  Each kernel is timed on plans cut after
their first k levels (the same plan with its later levels dropped, through
the public wrappers, so the code timed is the code the solvers run): S1 at
k = 0 .. levels, S2 over its forward levels with no backward level, then
over its backward levels after every forward one.  The difference between
two consecutive cuts is that level's device time (``kernel_times.
device_ms``: 100 calls in one CUDA graph, replayed).  Beside each level:
its terms, its destinations (rows), the longest destination's terms (the
in-order chain one thread walks) and the terms the busiest of the kernels'
``sparse_lu.THREADS`` threads subtracts, the destinations dealt as the
kernels deal them (``build_schedule``: longest first, round-robin).
Values are seeded random numbers with a dominant diagonal; the kernels do
the same work whatever the values.  One JSON object is printed, with the
card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np


def cut(plan, k=None, fwd=None, bwd=None):
    """``plan`` with only its first ``k`` factor levels, ``fwd`` forward and
    ``bwd`` backward levels (None keeps them all)."""
    def first(t, m):
        return t if m is None else t[:m]
    return dataclasses.replace(
        plan, n_levels=plan.n_levels if k is None else k,
        div_dst=first(plan.div_dst, k), div_piv=first(plan.div_piv, k),
        upd_dst=first(plan.upd_dst, k), upd_l=first(plan.upd_l, k),
        upd_u=first(plan.upd_u, k), f_lev=first(plan.f_lev, fwd),
        b_lev=first(plan.b_lev, bwd))


def level_shapes(kernel, off_name, term_off_name, threads):
    """Per level of a schedule's kernel arrays (destinations ``off_name``,
    their term offsets ``term_off_name``): terms, destinations, longest,
    busiest (thread t takes the level's destinations t, t + threads, ...
    in the schedule's order)."""
    off, term_off = kernel[off_name], np.asarray(kernel[term_off_name])
    out = []
    for lv in range(len(off) - 1):
        cnt = np.diff(term_off[off[lv]:off[lv + 1] + 1])
        out.append(dict(
            terms=int(cnt.sum()), dests=int(len(cnt)),
            longest=int(cnt.max(initial=0)),
            busiest=int(max([cnt[t::threads].sum()
                             for t in range(min(threads, len(cnt)))],
                            default=0))))
    return out


def smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=40)
    ap.add_argument("--models", default="bsim4", choices=["bsim4", "lv1"])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    # the package of the checkout this file is in
    sys.path.insert(0, os.path.abspath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..")))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sparse_levels: no CUDA device")
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.core.sparse_ops import TAU, get_sparse_ops
    from cedarsim_tpu_torch.ops import sparse_lu
    dev = torch.device("cuda", 0)
    plan = get_sparse_ops(netlists.chain(args.cells, models=args.models,
                                         device="cpu")).plan
    rng = np.random.default_rng(11)
    v = rng.uniform(-1.0, 1.0, (1, plan.nnz_f))
    v[:, plan.diag_pos] = 10.0 + rng.uniform(0.0, 1.0, (1, plan.n))
    vals = torch.as_tensor(v, device=dev)
    b = torch.as_tensor(rng.standard_normal((1, plan.n)), device=dev)
    f = sparse_lu.factor(plan, vals, TAU)
    if not bool(torch.isfinite(sparse_lu.solve_factored(plan, f, b)).all()):
        raise AssertionError("sparse_levels: non-finite solve")

    def timed(p, which):
        if which == "factor":
            return kt.device_ms(lambda: sparse_lu.factor(p, vals, TAU))
        return kt.device_ms(lambda: sparse_lu.solve_factored(p, f, b))

    n_f, n_b = len(plan.f_lev), len(plan.b_lev)
    t_fac = [timed(cut(plan, k=k), "factor")
             for k in range(plan.n_levels + 1)]
    t_fwd = [timed(cut(plan, fwd=k, bwd=0), "solve") for k in range(n_f + 1)]
    t_bwd = [timed(cut(plan, bwd=k), "solve") for k in range(n_b + 1)]
    kernel = {name: np.asarray(a) for name, a in
              sparse_lu.build_schedule(plan)[0].items()}
    th = sparse_lu.THREADS
    fac = level_shapes(kernel, "dst_off", "term_off", th)
    fwd = level_shapes(kernel, "fw_off", "fw_term_off", th)
    bwd = level_shapes(kernel, "bw_off", "bw_term_off", th)
    for rows, t in ((fac, t_fac), (fwd, t_fwd), (bwd, t_bwd)):
        for i, r in enumerate(rows):
            r["us"] = 1e3 * (t[i + 1] - t[i])
    sch = sparse_lu.schedule(plan, dev)
    res = {
        "card": smi(),
        "plan": dict(cells=args.cells, models=args.models, n=plan.n,
                     nnz_f=plan.nnz_f, levels=plan.n_levels,
                     forward=n_f, backward=n_b),
        "threads": th,
        "shared": dict(factor=sparse_lu.shared_regime(sch.factor_smem, dev),
                       solve=sparse_lu.shared_regime(sch.solve_smem, dev)),
        "factor": dict(us=1e3 * t_fac[-1], no_level_us=1e3 * t_fac[0],
                       busiest_sum=sum(r["busiest"] for r in fac),
                       longest_sum=sum(r["longest"] for r in fac),
                       levels=fac),
        "solve": dict(us=1e3 * t_bwd[-1], no_level_us=1e3 * t_fwd[0],
                      forward_us=1e3 * (t_fwd[-1] - t_fwd[0]),
                      backward_us=1e3 * (t_bwd[-1] - t_bwd[0]),
                      longest_sum=sum(r["longest"] for r in fwd + bwd),
                      forward=fwd, backward=bwd)}
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text, flush=True)
    return res


if __name__ == "__main__":
    main()
