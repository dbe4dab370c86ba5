"""The port's GESP LU (cedarsim_tpu_torch/ops/gesp_lu.py) against the JAX
package's Pallas kernels (interpret mode on the CPU), and the port's batched
mixed-precision chord pair against the JAX pair under ``jax.vmap``.

Inputs are made with numpy from fixed seeds and fed to both packages.
Tolerances: 1e-5 relative for the float32 kernels (another rounding order
than Pallas's reductions), 1e-10 relative for the chord solve (float32
factors, two float64 refinement passes on well-conditioned systems).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cedarsim_tpu.ops import linalg as jlinalg
from cedarsim_tpu.ops.pallas_lu import (lu_factor_batched_sublane_f32,
                                        lu_subst_batched_sublane_f32)
from cedarsim_tpu_torch.ops import gesp_lu
from cedarsim_tpu_torch.ops import linalg as tlinalg


def _systems(seed, B, n):
    """Row-equilibrated, diagonally dominant float32 systems."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    A += (n + 8) * np.eye(n)
    A /= np.abs(A).max(-1, keepdims=True)
    b = rng.standard_normal((B, n))
    return A.astype(np.float32), b.astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("n", [11, 25])
@pytest.mark.parametrize("B", [1, 12, 37])
def test_plain_gesp_matches_pallas(n, B):
    A, b = _systems(100 * n + B, B, n)
    lu_j = np.asarray(lu_factor_batched_sublane_f32(jnp.asarray(A),
                                                    interpret=True))
    lu_t = gesp_lu.lu_factor_gesp_f32(torch.from_numpy(A))
    assert _rel(lu_t.numpy(), lu_j) <= 1e-5
    # the substitution on the same factors
    x_j = np.asarray(lu_subst_batched_sublane_f32(
        jnp.asarray(lu_j), jnp.asarray(b), interpret=True))
    x_t = gesp_lu.lu_subst_gesp_f32(torch.from_numpy(lu_j.copy()),
                                    torch.from_numpy(b))
    assert _rel(x_t.numpy(), x_j) <= 1e-5


@pytest.mark.parametrize("pivot, boosted", [(0.0, 1e-20), (-1e-25, -1e-20)])
def test_gesp_pivot_boost_sign(pivot, boosted):
    """A zero pivot boosts to +1e-20, a tiny negative one to -1e-20; the
    boosted pivot is what the factor stores on the diagonal."""
    A, b = _systems(7, 3, 6)
    A[:, 2, :] = 0.0
    A[:, 2, 2] = pivot
    A[:, 2, 4] = 1.0          # keep the row nonzero off the diagonal
    A[:, :2, 2] = 0.0         # so that the pivot reaches step 2 unchanged
    lu_j = np.asarray(lu_factor_batched_sublane_f32(jnp.asarray(A),
                                                    interpret=True))
    lu_t = gesp_lu.lu_factor_gesp_f32(torch.from_numpy(A)).numpy()
    np.testing.assert_array_equal(lu_t[:, 2, 2],
                                  np.float32(boosted) * np.ones(3, np.float32))
    np.testing.assert_array_equal(lu_j[:, 2, 2], lu_t[:, 2, 2])
    fin = np.isfinite(lu_j)
    assert (np.isfinite(lu_t) == fin).all()
    assert _rel(lu_t[fin], lu_j[fin]) <= 1e-5


def test_chord_pair_matches_jax_mixed(monkeypatch):
    """Batched chord_factor + chord_backsolve (plain kernels on the CPU)
    against ``jax.vmap`` of the JAX pair routed through the Pallas kernels
    in interpret mode."""
    monkeypatch.setattr(jlinalg, "_MIXED_INTERPRET", True)
    rng = np.random.default_rng(11)
    B, n = 5, 25
    J = rng.standard_normal((B, n, n)) * np.logspace(-3, 2, n)[:, None]
    J += np.diag(np.abs(J).sum(-1).max(0) + 1.0)
    b = rng.standard_normal((B, n))

    def jax_pair(Jk, bk):
        return jlinalg.chord_backsolve(*jlinalg.chord_factor(Jk), Jk, bk)

    x_j = np.asarray(jax.vmap(jax_pair)(jnp.asarray(J), jnp.asarray(b)))
    Jt, bt = torch.from_numpy(J), torch.from_numpy(b)
    LU, perm, r = tlinalg.chord_factor(Jt)
    x_t = tlinalg.chord_backsolve(LU, perm, r, Jt, bt)
    assert LU.dtype == torch.float32
    assert torch.equal(perm, torch.arange(n).expand(B, n))
    assert _rel(x_t.numpy(), x_j) <= 1e-10
    x_e = np.linalg.solve(J, b[..., None])[..., 0]
    assert _rel(x_t.numpy(), x_e) <= 1e-10
    x_once = tlinalg.chord_solve_once(Jt, bt).numpy()
    np.testing.assert_array_equal(x_once, x_t.numpy())


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        gesp_lu.lu_factor_gesp_f32(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        gesp_lu.lu_subst_gesp_f32(torch.zeros(3, 4), torch.zeros(3))
