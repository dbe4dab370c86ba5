"""The dense/sparse Newton crossover of the DC solve on one device
(counterpart of ``benchmarks/sparse_crossover.py``).

Over level-1 DFF chains (``netlists.chain``), the operating point
(``solve_dc(mode="tranop")``, float64) is solved once through the dense
path (``sparse=False``: ``torch.linalg`` solves) and once through the
sparse one (``sparse=True``: ``SparseOps``, S1 and S2 on a card), each
first cold (the compile, the sparse plan with its probe weights, the first
solve) and then warm (the mean of ``REPS`` solves).  The largest chain
gates as ``tests/test_sparse_circuit.py::test_large_chain_sparse_dc`` does:
every cell's Q within 0.05 V of a rail.

    python -m cedarsim_tpu_torch.benchmarks.sparse_crossover
    python -m cedarsim_tpu_torch.benchmarks.sparse_crossover --device cpu \\
        --sizes 2,6

prints one JSON line per size (n_x, the plan's levels and filled values,
each path's set-up and warm solve seconds, Newton iterations, the two
solutions' largest difference, the speedup dense/sparse), then one line
with the smallest n_x where sparse wins and the gate.  The JAX package's
TPU rows (``benchmarks/sparse_crossover_tpu.json``) are not this script's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: the rail gate of the largest chain (test_large_chain_sparse_dc)
RAIL_TOL = 0.05
#: warm solves per path and size
REPS = 2


def time_dc(cells, sparse, device):
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.core.sparse_ops import get_sparse_ops

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    ctx = T.SimSpec.make(gmin=1e-15)
    sync()
    t0 = time.perf_counter()
    comp = netlists.chain(cells, sparse=sparse, device=device)
    plan = get_sparse_ops(comp).plan if sparse else None
    r = T.solve_dc(comp, ctx=ctx, mode="tranop")
    sync()
    setup = time.perf_counter() - t0
    if not bool(r.converged):
        raise AssertionError(f"{cells} cells, sparse={sparse}: DC failed")
    t0 = time.perf_counter()
    for _ in range(REPS):
        r = T.solve_dc(comp, ctx=ctx, mode="tranop")
    sync()
    warm = (time.perf_counter() - t0) / REPS
    return comp, plan, r, setup, warm


def run(sizes=(6, 20, 40, 90), device=None):
    """One row per chain size, then the summary; returns (rows, summary)."""
    rows = []
    gate = None
    for cells in sizes:
        row = {"cells": cells}
        xs = {}
        for sparse in (False, True):
            tag = "sparse" if sparse else "dense"
            comp, plan, r, setup, warm = time_dc(cells, sparse, device)
            row.update({"n_x": comp.n_x, "device": str(comp.device),
                        f"{tag}_setup_s": setup, f"{tag}_solve_s": warm,
                        f"{tag}_newton": int(r.iters)})
            if plan is not None:
                row.update(n_levels=plan.n_levels, nnz_f=plan.nnz_f)
            xs[tag] = (comp, r.x.cpu())
        row["max_abs_diff_v"] = float(
            (xs["dense"][1] - xs["sparse"][1]).abs().max())
        row["speedup"] = row["dense_solve_s"] / row["sparse_solve_s"]
        rows.append(row)
        print(json.dumps(row), flush=True)
        if cells == max(sizes):
            comp, x = xs["sparse"]
            worst = max(min(abs(float(x[comp.node_names.index(f"d{k}")])),
                            abs(float(x[comp.node_names.index(f"d{k}")])
                                - 5.0)) for k in range(1, cells + 1))
            gate = dict(cells=cells, worst_rail_err_v=worst,
                        ok=worst < RAIL_TOL)
    cross = next((r["n_x"] for r in rows if r["speedup"] > 1.0), None)
    summary = {"crossover_n_x": cross, "gate": gate}
    print(json.dumps(summary), flush=True)
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="6,20,40,90")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    _, summary = run([int(s) for s in args.sizes.split(",")], args.device)
    return 0 if summary["gate"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
