"""Dense linear algebra of the port (counterpart of
``cedarsim_tpu/ops/linalg.py``).

Exact solves are ``torch.linalg`` in float64 on every device: the JAX
package's pure-JAX ``lu_factor``/``lu_solve`` exist only because XLA:TPU has
no f64 LU, so they have no counterpart here.

The transient's exact solves (:func:`solve_lanes`, :func:`lu_factor_exact`,
:func:`lu_solve_exact`: its chord pair under ``dense_lu="jax"`` and ẋ0's
solve) give each lane on a card the bits of its system alone, because
``tran``'s lanes there must be bitwise the one stream (the smoke's C6
witness, the 243-unknown chain at 2 lanes, holds them so): PyTorch factors
a batch of two or more systems below 512 unknowns with cuBLAS's batched LU
and one system with cuSOLVER's, whose bits differ
(``tests/test_torch_cuda.py``), so on a card they make one library call a
lane (``benchmarks/exact_lanes.py`` times what that costs).  On the CPU
they make the one batched call: LAPACK factors each lane of a batch on one
thread, where a lone call may thread its factor, so a lane's last bits can
differ there too, but no caller on the CPU holds lanes bitwise the one
stream.  :func:`solve` (DC, AC, the LU bench) is one batched call on every
device: its lanes (sweep points, frequencies) are held to tolerances.

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


def matvec(A, v):
    """A·v over the lanes as a product and a row sum (A [n, n] or
    [L, n, n], v [L, n]): on the CPU a batched ``@`` picks its kernel by
    batch size, so a lane's rounding would depend on how many lanes run
    beside it."""
    return (A * v[..., None, :]).sum(-1)


def solve(A, b):
    """Exact A x = b (float64, batched over leading axes).  A singular
    system gives non-finite entries, as LAPACK's solve does in the JAX
    package, instead of raising: the Newton loops test for them."""
    return torch.linalg.solve_ex(A, b, check_errors=False)[0]


def _lanes_apart(A):
    """Whether a transient's exact call on A [L, n, n] goes one lane at a
    time: on a card, at two lanes or more (see the module docstring)."""
    return A.is_cuda and A.dim() == 3 and A.shape[0] > 1


def solve_lanes(A, b):
    """:func:`solve` of A [L, n, n] (or [n, n]) and b, each lane's bits
    those of its system alone."""
    if not _lanes_apart(A):
        return solve(A, b)
    return torch.cat([solve(A[i:i + 1], b[i:i + 1])
                      for i in range(A.shape[0])])


def normal_matrix(C):
    """Cᵀ·C of C [..., n, n] in a fixed order: the outer products of C's
    rows k = 0, 1, ..., n − 1 added one after another into a sum that
    starts at 0, each product and each sum rounded on its own (elementwise
    operations).  So a lane's bits are those of its matrix alone on any
    device, and the memory is the sum and one product, 2·L·n² values, where
    a one-line broadcast product and reduction would hold L·n³."""
    acc = torch.zeros_like(C)
    outer = torch.empty_like(C)
    for k in range(C.shape[-2]):
        row = C[..., k, :]
        torch.mul(row[..., :, None], row[..., None, :], out=outer)
        acc.add_(outer)
    return acc


def _equilibrate(J):
    r = J.abs().amax(-1)
    return torch.where(r == 0, torch.ones_like(r), r)


def lu_factor_exact(J):
    """Row-equilibrated partial-pivoting LU in J's dtype: (LU, pivots, r),
    each lane's bits those of its system alone."""
    r = _equilibrate(J)
    Js = J / r[..., None]
    if _lanes_apart(Js):
        parts = [torch.linalg.lu_factor_ex(Js[i:i + 1], check_errors=False)
                 for i in range(Js.shape[0])]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]), r)
    LU, piv, _ = torch.linalg.lu_factor_ex(Js, check_errors=False)
    return LU, piv, r


def lu_solve_exact(LU, piv, r, b):
    rhs = (b / r)[..., None]
    if _lanes_apart(LU):
        return torch.cat([torch.linalg.lu_solve(LU[i:i + 1], piv[i:i + 1],
                                                rhs[i:i + 1])
                          for i in range(LU.shape[0])])[..., 0]
    return torch.linalg.lu_solve(LU, piv, rhs)[..., 0]


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
