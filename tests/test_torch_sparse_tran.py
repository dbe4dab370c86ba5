"""The 2-cell level-1 DFF chain's transient over 0-100 ns through the
port's sparse Newton path, the per-step chord (``jac_reuse=1``: one ``SparseOps.factorize`` per step attempt, ``solve_factorized`` per iteration, the full-Newton rescue), against the JAX package's sparse run on
the same circuit (as ``tests/test_sparse_circuit.py::
test_sparse_chord_newton_transient_matches_full``): both finish, the
accepted and rejected steps and the Newton iterations are equal, every
accepted time within 1e-9 of the window and every state within 1e-8 V,
and d1 at 45, 68 and 99 ns within 1e-9 V.  (tests/test_torch_sparse_newton.py holds full Newton (``jac_reuse=0``); the two run on
separate workers.)
"""

import os
import sys

import numpy as np
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.benchmarks import netlists
from cedarsim_tpu_torch.core.compile import use_sparse_solver

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "gf180_dff"))

PROBES = (4.5e-8, 6.8e-8, 9.9e-8)


def test_chain_transient_matches_jax():
    from chain import build
    jc = build(2, sparse=True)
    tc = netlists.chain(2, sparse=True, device="cpu")
    assert use_sparse_solver(tc) and tc.n_x == jc.n_x
    sj = J.tran(jc, (0.0, 1e-7), ctx=J.SimSpec.make(gmin=1e-15),
                opts=J.TranOptions(max_steps=16384, jac_reuse=1))
    # the CPU run is dispatch-bound: no autograd bookkeeping (the same bits)
    with torch.inference_mode():
        st = T.tran(tc, (0.0, 1e-7), ctx=T.SimSpec.make(gmin=1e-15),
                    opts=T.TranOptions(max_steps=16384, jac_reuse=1))
    assert sj.converged and st.converged
    assert (st.n_accepted, st.n_rejected, st.n_newton) == \
        (sj.n_accepted, sj.n_rejected, sj.n_newton)
    ts_j, xs_j = np.asarray(sj.ts), np.asarray(sj.xs)
    assert st.ts.shape == ts_j.shape
    assert np.abs(st.ts - ts_j).max() <= 1e-9 * 1e-7
    assert np.abs(st.xs - xs_j).max() <= 1e-8
    for t in PROBES:
        assert abs(float(st.interp("d1", t)) - float(sj.interp("d1", t))) \
            <= 1e-9, t
