"""Two faults of the port's transient set-up, closed (ROADMAP Queue C):

- C7: ẋ0's normal matrix CᵀC (``ops/linalg.py::normal_matrix``) within
  1e-13 of ``C.mT @ C`` at L in {1, 3} lanes, each lane bitwise the same
  matrix alone, and at n = 2,000 on the CPU (the old broadcast product
  held L·n³ values: 64 GB there); ``xdot0_and_mask`` against the JAX
  package's near the level-1 chain's operating point, with and without a
  lane axis, lanes bitwise the one stream; the transient's exact solves
  one batched call on the CPU, and the benchmark that times the lane
  loop against it (``benchmarks/exact_lanes.py``).
- C6: ``resolve_impl``'s ``dense_lu`` on a card (``smem_per_block``
  patched to an H100's 232,448 bytes) at n = 240, 241, 255 and 256: "auto"
  takes the GESP kernels ("mixed") with a lane axis only where they hold
  the system (n <= 240), the exact solve ("jax") above, the sparse path at
  256; an explicit "mixed" above 240 raises, naming ``dense_lu="jax"`` and
  ``sparse=True``; one stream takes the exact solve; the CPU keeps its
  resolution.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.analysis import tran as ttran
from cedarsim_tpu_torch.benchmarks import netlists
from cedarsim_tpu_torch.ops import cuda_lib, gesp_lu, linalg

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "gf180_dff"))


def _bitwise(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int64),
                                              b.view(torch.int64))


@pytest.mark.parametrize("L", [1, 3])
def test_normal_matrix_against_matmul(L):
    rng = np.random.default_rng(70 + L)
    C = rng.standard_normal((L, 61, 61)) * rng.uniform(1e-15, 1e-12,
                                                      (L, 61, 1))
    C[:, 7] = 0.0                       # an algebraic row
    C = torch.as_tensor(C)
    M = linalg.normal_matrix(C)
    ref = C.mT @ C
    assert float((M - ref).abs().max() / ref.abs().max()) <= 1e-13
    for i in range(L):
        assert _bitwise(M[i], linalg.normal_matrix(C[i]))
        assert _bitwise(M[i], linalg.normal_matrix(C[i:i + 1])[0])


def test_normal_matrix_at_2000_unknowns():
    rng = np.random.default_rng(2000)
    C = torch.as_tensor(rng.standard_normal((1, 2000, 2000)))
    M = linalg.normal_matrix(C)
    ref = C.mT @ C
    assert float((M - ref).abs().max() / ref.abs().max()) <= 1e-13


def test_xdot0_matches_jax_on_the_chain():
    """ẋ0 and the LTE mask of the 2-cell level-1 chain (34 unknowns) at its
    operating point moved by seeded 1 mV noise (so that the right-hand side
    −S is far from zero: ẋ0 reaches ~6e11 V/s), three such points as one
    stream each and as three lanes, against the JAX package's within 1e-10
    of ẋ0's largest entry; lanes bitwise the one stream."""
    import jax.numpy as jnp
    import cedarsim_tpu as J
    from cedarsim_tpu.analysis import tran as jtran
    from chain import build
    comp = netlists.chain(2, device="cpu")
    ctx = T.SimSpec.make(gmin=1e-15)
    op = T.solve_dc(comp, ctx=ctx, mode="tranop")
    ctx_op = ctx.with_mode("tranop")
    rng = np.random.default_rng(34)
    x3 = op.x + torch.as_tensor(1e-3 * rng.standard_normal((3, comp.n_x)))
    xd3, m3 = ttran.xdot0_and_mask(comp, x3, ctx_op, comp.params0)
    cj = build(2)
    assert cj.n_x == comp.n_x == 34
    jctx = J.SimSpec.make(gmin=1e-15).with_mode("tranop")
    for i in range(3):
        xd1, m1 = ttran.xdot0_and_mask(comp, x3[i], ctx_op, comp.params0)
        assert _bitwise(xd3[i], xd1) and _bitwise(m3[i], m1)
        xj = jnp.asarray(x3[i].numpy())
        xd_j = np.asarray(jtran._consistent_xdot(cj, xj, jctx, cj.params0))
        m_j = np.asarray(jtran._differential_mask(cj, xj, jctx,
                                                  cj.params0))
        np.testing.assert_array_equal(m1.numpy(), m_j)
        scale = np.abs(xd_j).max()
        assert scale > 1e9
        assert np.abs(xd1.numpy() - xd_j).max() <= 1e-10 * scale


def test_exact_solves_are_one_batched_call_on_the_cpu():
    """On the CPU the transient's exact solves make the one batched
    ``torch.linalg`` call (no caller there holds lanes bitwise the one
    stream; on a card they go a lane at a time, ``test_torch_cuda.py``)."""
    rng = np.random.default_rng(243)
    A = torch.as_tensor(rng.standard_normal((3, 243, 243))
                        + 243 * np.eye(243))
    b = torch.as_tensor(rng.standard_normal((3, 243)))
    assert not linalg._lanes_apart(A)
    assert _bitwise(linalg.solve_lanes(A, b),
                    torch.linalg.solve_ex(A, b)[0])
    LU, piv, r = linalg.lu_factor_exact(A)
    LU_b, piv_b, _ = torch.linalg.lu_factor_ex(A / r[..., None])
    assert _bitwise(LU, LU_b) and torch.equal(piv, piv_b)
    assert _bitwise(linalg.lu_solve_exact(LU, piv, r, b),
                    torch.linalg.lu_solve(LU_b, piv_b,
                                          (b / r)[..., None])[..., 0])


def _card_circuit(n):
    """What ``resolve_impl`` reads of a circuit of n unknowns compiled on a
    card."""
    return types.SimpleNamespace(n_x=n, device=torch.device("cuda", 0),
                                 sparse_mode="auto")


@pytest.fixture
def h100_smem(monkeypatch):
    monkeypatch.setattr(cuda_lib, "smem_per_block",
                        lambda device: cuda_lib.H100_SMEM_PER_BLOCK)


@pytest.mark.parametrize("n, auto", [(240, "mixed"), (241, "jax"),
                                     (255, "jax"), (256, "jax")])
def test_auto_resolution_on_a_card(h100_smem, n, auto):
    assert gesp_lu.max_n(torch.device("cuda", 0)) == 240
    comp = _card_circuit(n)
    got = ttran.resolve_impl(comp, T.TranOptions(), batched=True)
    assert (got.dense_lu, got.newton_impl) == (auto, "xla")
    one = ttran.resolve_impl(comp, T.TranOptions(dense_lu="mixed"),
                             batched=False)
    assert one.dense_lu == "jax"
    mixed = T.TranOptions(dense_lu="mixed")
    if n == 240 or n >= 256:
        # the GESP kernels hold n = 240; at 256 the circuit is sparse
        assert ttran.resolve_impl(comp, mixed).dense_lu == (
            "mixed" if n == 240 else "jax")
    else:
        with pytest.raises(ValueError) as e:
            ttran.resolve_impl(comp, mixed, batched=True)
        assert "dense_lu='jax'" in str(e.value)
        assert "sparse=True" in str(e.value)
        assert "n <= 240" in str(e.value)


def test_cpu_resolution_is_unchanged():
    comp = types.SimpleNamespace(n_x=243, device=torch.device("cpu"),
                                 sparse_mode="auto")
    assert ttran.resolve_impl(comp, T.TranOptions()).dense_lu == "jax"
    assert ttran.resolve_impl(
        comp, T.TranOptions(dense_lu="mixed")).dense_lu == "mixed"


def test_exact_lanes_benchmark_on_the_cpu():
    """``benchmarks/exact_lanes.py`` at 2 lanes over C6's chain: both rules
    run the same steps, a lane at a time gives each lane the one stream's
    bits, and the CPU's own rule is the batched call."""
    from cedarsim_tpu_torch.benchmarks import exact_lanes
    res = exact_lanes.run(lanes=2, tstop=2e-11, device="cpu")
    assert res["n_x"] == 243 and res["port_rule"] == "batched"
    assert len({(tuple(r["accepted"]), tuple(r["newton"]))
                for r in res["runs"]}) == 1
    for r in res["runs"]:
        assert r["converged"]
        if r["rule"] == "per_lane":
            assert r["lanes_bitwise_one_stream"] == 2
