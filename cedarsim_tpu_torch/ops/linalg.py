"""Dense linear algebra of the port (counterpart of
``cedarsim_tpu/ops/linalg.py``).

Exact solves are ``torch.linalg`` in float64 on every device: the JAX
package's pure-JAX ``lu_factor``/``lu_solve`` exist only because XLA:TPU has
no f64 LU, so they have no counterpart here.

The mixed-precision chord pair (``TranOptions.dense_lu="mixed"``) is batched
over an explicit lane axis: :func:`chord_factor` row-equilibrates J in f64
and factors it in float32 with the GESP kernel (``ops/gesp_lu.py``; perm is
the identity), and :func:`chord_backsolve` substitutes in float32 and runs
``_REFINE`` float64 refinement passes against the true J.  The Newton loop's
own f64 residual test stays the correctness gate above this.
"""

from __future__ import annotations

import torch

from cedarsim_tpu_torch.ops import gesp_lu

_REFINE = 2


def solve(A, b):
    """Exact A x = b (float64, batched over leading axes).  A singular
    system gives non-finite entries, as LAPACK's solve does in the JAX
    package, instead of raising: the Newton loops test for them."""
    return torch.linalg.solve_ex(A, b, check_errors=False)[0]


def _equilibrate(J):
    r = J.abs().amax(-1)
    return torch.where(r == 0, torch.ones_like(r), r)


def lu_factor_exact(J):
    """Row-equilibrated partial-pivoting LU in J's dtype: (LU, pivots, r)."""
    r = _equilibrate(J)
    LU, piv, _ = torch.linalg.lu_factor_ex(J / r[..., None],
                                           check_errors=False)
    return LU, piv, r


def lu_solve_exact(LU, piv, r, b):
    return torch.linalg.lu_solve(LU, piv, (b / r)[..., None])[..., 0]


def chord_factor(J):
    """GESP factor of a batch of Jacobians J [L, n, n] (float64): returns
    (LU float32, perm, rowscale) for :func:`chord_backsolve`."""
    L, n, _ = J.shape
    r = _equilibrate(J)
    LU = gesp_lu.lu_factor_gesp_f32(
        (J / r[..., None]).to(torch.float32).contiguous())
    perm = torch.arange(n, device=J.device).expand(L, n)
    return LU, perm, r


def chord_backsolve(LU, perm, r, J, b):
    """Solve J x = b [L, n] with factors from :func:`chord_factor`: float32
    substitution plus ``_REFINE`` float64 refinement passes, the residual
    b − J·x a float64 batched matvec."""
    del perm                      # GESP factors are unpivoted

    def subst(v):
        return gesp_lu.lu_subst_gesp_f32(
            LU, (v / r).to(torch.float32).contiguous()).to(J.dtype)

    x = subst(b)
    for _ in range(_REFINE):
        resid = b - (J * x[:, None, :]).sum(-1)
        x = x + subst(resid)
    return x


def chord_solve_once(J, b):
    """One-shot factor + solve through the chord pair (the full-Newton
    ``lin_solve`` of the mixed path)."""
    LU, perm, r = chord_factor(J)
    return chord_backsolve(LU, perm, r, J, b)
