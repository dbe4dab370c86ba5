"""The port's compiled circuit (cedarsim_tpu_torch/core/compile.py) against
the JAX package's on the gf180 DFF testbench: structure index by index, and
S, Q, G, C at random states with the JAX params converted by
``params_from_numpy``.  Tolerance: rtol 1e-10 (absolute floors 1e-18 A,
1e-24 C)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.utils.convert import params_from_numpy

DFF_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                       "gf180_dff")


def _both():
    with open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")) as f:
        text = f.read()
    cj = J.compile_circuit(J.elaborate(
        J.parse_spice(text, file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]))
    ct = T.compile_circuit(T.elaborate(
        T.parse_spice(text, file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]), device="cpu")
    return cj, ct


def test_dff_structure_matches_jax():
    cj, ct = _both()
    assert ct.node_names == cj.node_names
    assert ct.x_names == cj.x_names
    assert ct.n_x == cj.n_x == 25
    assert ct.group_order == cj.group_order
    for key in cj.group_order:
        assert sorted(ct.params0[key]) == sorted(cj.params0[key])
        np.testing.assert_array_equal(ct.groups[key].var_idx,
                                      cj.groups[key].var_idx)
        np.testing.assert_array_equal(ct.groups[key].row_idx,
                                      cj.groups[key].row_idx)
        assert set(ct.groups[key].static_params) == set(
            cj.groups[key].static_params)
    np.testing.assert_array_equal(ct.breakpoints(7e-7),
                                  cj.breakpoints(7e-7))


def test_dff_residuals_and_jacobians_match_jax():
    cj, ct = _both()
    params = params_from_numpy(jax.tree.map(np.asarray, cj.params0),
                               device="cpu")
    rng = np.random.default_rng(5)
    fj = jax.jit(lambda x, t: cj.res_jacs_fwd(
        x, J.SimSpec.make(gmin=1e-15).at_time(t)))
    for trial in range(5):
        x = rng.uniform(-0.5, 5.5, cj.n_x)
        t = float(rng.uniform(0.0, 7e-7))
        ref = [np.asarray(a) for a in fj(jnp.asarray(x), t)]
        ours = ct.res_jacs_fwd(torch.from_numpy(x),
                               T.SimSpec.make(gmin=1e-15).at_time(t),
                               params)
        for name, a, b, floor in zip("SQGC", ours, ref,
                                     (1e-18, 1e-24, 1e-18, 1e-24)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=floor,
                                       err_msg=f"{name} trial {trial}")
        S, Q = ct.residuals(torch.from_numpy(x),
                            T.SimSpec.make(gmin=1e-15).at_time(t), params)
        np.testing.assert_array_equal(S.numpy(), ours[0].numpy())
        np.testing.assert_array_equal(Q.numpy(), ours[1].numpy())


def test_lanes_evaluate_independently():
    """A lane axis with per-lane W and per-lane time gives each lane what a
    one-lane call gives it, to the bit (the eval batch is padded per lane
    to whole SIMD vectors)."""
    _, ct = _both()
    key = [k for k in ct.group_order if "bsim4" in k.lower()][0]
    rng = np.random.default_rng(8)
    L = 3
    x = torch.from_numpy(rng.uniform(-0.5, 5.5, (L, ct.n_x)))
    t = torch.tensor([1e-7, 2.2e-7, 4.01e-7], dtype=torch.float64)
    sc = torch.tensor([0.99, 1.0, 1.01], dtype=torch.float64)
    pb = {k: dict(g) for k, g in ct.params0.items()}
    pb[key]["W"] = ct.params0[key]["W"][None, :] * sc[:, None]
    ctx = T.SimSpec.make(gmin=1e-15)
    S, Q, G, C = ct.res_jacs_fwd(x, ctx.at_time(t), pb)
    for i in range(L):
        p1 = {k: dict(g) for k, g in ct.params0.items()}
        p1[key]["W"] = pb[key]["W"][i]
        S1, Q1, G1, C1 = ct.res_jacs_fwd(x[i], ctx.at_time(float(t[i])), p1)
        for a, b in ((S[i], S1), (Q[i], Q1), (G[i], G1), (C[i], C1)):
            torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)


def test_charge_tangent_is_c_times_v():
    _, ct = _both()
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(0.0, 5.0, (2, ct.n_x)))
    v = torch.from_numpy(rng.standard_normal((2, ct.n_x)))
    ctx = T.SimSpec.make(gmin=1e-15).at_time(1e-7)
    S, Q, Qd = ct.residuals_jvp(x, v, ctx)
    _, _, _, C = ct.res_jacs_fwd(x, ctx)
    torch.testing.assert_close(Qd, (C @ v[..., None])[..., 0], rtol=1e-12,
                               atol=1e-30)


@pytest.mark.parametrize("card, n_ring", [
    ("T1 a 0 b 0 z0=50 td=1n", 2),
    ("O1 a 0 b 0 lmod\n.model lmod ltra r=60 l=1n c=1p len=1", 20),
    ("U1 a b 0 umod l=0.01\n.model umod urc k=2 rperl=1e5 cperl=1e-7", 0),
], ids=["T", "O", "U"])
def test_unported_cards_raise(card, n_ring):
    """The T, O and U cards, which the port once refused, elaborate and
    compile to the JAX package's instances, unknowns and ring slots."""
    text = f"* lines\nV1 a 0 1.0\nR1 a 0 1k\nR2 b 0 1k\n{card}\n.end\n"
    ct = T.compile_circuit(T.elaborate(T.parse_spice(text)), device="cpu")
    cj = J.compile_circuit(J.elaborate(J.parse_spice(text)))
    assert [i.name for i in ct.circuit.instances] == \
        [i.name for i in cj.circuit.instances]
    assert (ct.n_x, ct.n_dly, ct.n_ring, ct.n_lat) == \
        (cj.n_x, cj.n_dly, cj.n_ring, cj.n_lat)
    assert ct.n_ring == n_ring
