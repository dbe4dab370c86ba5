"""Cell G, ``bench.py``'s BSIM-CMG DFF leg (``benchmarks/cmg_dff.py``),
on the CPU.

- The port's counts equal the JAX package's: 2 lanes (NFIN·0.99 and
  nominal) from the same warm states over 0-2 ns, G-xla's options with
  the exact float64 solve in both (``tests/cmg_dff_counts.py``, which
  prints them over any window).
- G-xla's Jacobian-only shunt (ROADMAP Queue C): on the CMG Jacobian at
  the warm state and h = 1e-12, the mixed chord solve (the float32
  no-pivot GESP factor and two float64 refinement passes) is off by more
  than 1e6 relative to the exact solve at the leg's shunt of 1e-7, where
  the no-pivot float32 factor cancels an internal node's pivot, and
  within 1e-2 at G-xla's 1e-4 (4.9e-3: the chord iteration still
  contracts).
- Both engines through ``cmg_dff.run`` (the kernels' plain versions) on
  2 lanes over 0-2 ns: every lane finished, q on its 1 V rail, no kernel
  launched (a CPU tensor never launches one), the mixed path's counts
  equal to the exact solve's.
- ROADMAP C9: the leg's operating point is the linear solver's rounding.
  The DC's first Newton step solves G at 0 V, of cond ~3.5e15 (cond·eps
  above 0.1: the step's component along the latch's near-null direction
  is not determined), and the slave latch has two DC states, q at VDD
  and at 0 V, each a solution to the residual tolerance.  The port on the
  CPU lands at VDD; the port on the card and the JAX package on the CPU
  land at 0 V (the latter slow-gated: its CMG DC compile).
"""

import os

import numpy as np
import pytest
import torch

import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.benchmarks import cmg_dff
from cedarsim_tpu_torch.benchmarks import kernel_times as kt
from cedarsim_tpu_torch.ops import linalg

from tests import cmg_dff_counts

TSTOP = 2e-9


@pytest.fixture(scope="module")
def lanes():
    return cmg_dff.setup(lanes=2, device="cpu")[0]


@pytest.fixture(scope="module")
def exact_xla(lanes):
    """G-xla's options with the exact solve over 0-TSTOP on the two lanes:
    the port's run of ``cmg_dff_counts.port_counts``, made once for the
    two tests that read it."""
    return cmg_dff.run("xla", TSTOP, dff=lanes, dense_lu="jax")


def test_counts_equal_the_jax_packages(lanes, exact_xla):
    port = [(bool(s.converged), s.n_accepted, s.n_rejected, s.n_newton)
            for s in exact_xla["sols"]]
    ref, _ = cmg_dff_counts.reference_counts(TSTOP, lanes[3].numpy())
    assert all(p[0] for p in port)
    assert port == ref


@pytest.mark.parametrize("shunt, worst", [(1e-7, None), (1e-4, 1e-2)])
def test_mixed_chord_solve_needs_the_shunt(lanes, shunt, worst):
    comp, ctx, pb, x0 = lanes
    h = 1e-12
    n = comp.n_x
    t = torch.full((2,), h, dtype=comp.dtype)
    _, _, G, C = comp.res_jacs_fwd(x0, ctx.with_mode("tran").at_time(t), pb)
    nv = comp.n_nodes + comp.n_internal
    J = C / h + G + shunt * torch.diag((torch.arange(n) < nv).to(G.dtype))
    b = torch.randn(2, n, dtype=G.dtype,
                    generator=torch.Generator().manual_seed(0))
    x_e = torch.linalg.solve(J, b)
    rel = float((linalg.chord_solve_once(J, b) - x_e).abs().max()
                / x_e.abs().max())
    if worst is None:
        assert not rel < 1e6
    else:
        assert rel < worst


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_cell_g_engines_on_the_cpu(lanes, engine, exact_xla):
    res = cmg_dff.run(engine, TSTOP, dff=lanes,
                      dense_lu=None if engine == "fused" else "mixed")
    sols = res["sols"]
    assert len(sols) == 2 and all(s.converged for s in sols)
    assert all(abs(float(s.interp("q", TSTOP)) - 1.0) < 1e-6 for s in sols)
    assert res["launches"] == {"fused": 0, "factor": 0, "subst": 0}
    assert res["newton_impl"] == engine
    if engine == "xla":
        assert res["dense_lu"] == "mixed"
        assert [(s.n_accepted, s.n_rejected, s.n_newton) for s in sols] == \
            [(s.n_accepted, s.n_rejected, s.n_newton)
             for s in exact_xla["sols"]]
    assert res["jac_shunt"] == (kt.CMG_FUSED_OPTS if engine == "fused"
                                else kt.CMG_XLA_OPTS)["jac_shunt"]


def test_c9_operating_point_is_the_solvers_rounding(lanes):
    comp, ctx, _, x0 = lanes
    tranop = ctx.with_mode("tranop")
    zero = torch.zeros(comp.n_x, dtype=comp.dtype)
    G = comp.res_jacs_fwd(zero, tranop)[2].numpy()
    assert np.linalg.cond(G) * np.finfo(np.float64).eps > 0.1
    iq = comp.x_names.index("q")
    start = zero.clone()
    start[comp.x_names.index("q_neg")] = 1.0
    other = T.solve_dc(comp, ctx=ctx, mode="tranop", x0=start)
    assert bool(other.converged)
    assert abs(float(x0[1, iq]) - 1.0) < 1e-6      # the CPU's: q at VDD
    assert abs(float(other.x[iq])) < 1e-6          # the card's: q at 0 V
    tol = T.NewtonOptions().res_tol
    for x in (x0[1], other.x):
        assert float(comp.res_jacs_fwd(x, tranop)[0].abs().max()) <= tol


@pytest.mark.skipif(not os.environ.get("CEDARSIM_RUN_SLOW"),
                    reason="slow: the JAX package's CMG DC compile; set "
                           "CEDARSIM_RUN_SLOW=1")
def test_c9_jax_package_lands_at_0v():
    import cedarsim_tpu as J
    dff = cmg_dff_counts.DFF_DIR
    tb = kt.LEGS["cmg"]["tb"]
    with open(os.path.join(dff, tb)) as f:
        cj = J.compile_circuit(J.elaborate(J.parse_spice(f.read(), file=tb),
                                           include_paths=[dff]))
    op = J.solve_dc(cj, ctx=J.SimSpec.make(gmin=1e-15), mode="tranop")
    assert bool(op.converged)
    assert abs(float(np.asarray(op.x)[cj.x_names.index("q")])) < 1e-6
