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
and factors it in float32 with the GESP kernel (``ops/gesp_lu.py``, no
pivoting; a lane whose factor rounds a pivot to 0 is factored again with
its voltage sources' rows swapped onto their nodes, the transient's one
departure from the JAX package's order, ROADMAP C19), and
:func:`chord_backsolve` substitutes in float32 and runs ``_REFINE``
float64 refinement passes against the true J.  The Newton loop's
own f64 residual test stays the correctness gate above this.
"""

from __future__ import annotations

import torch

from cedarsim_tpu_torch.ops import gesp_lu

_REFINE = 2
#: lanes that :func:`chord_factor` factored again in the source row order
reordered = 0


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
    for k in range(C.shape[-2]):
        row = C[..., k, :]
        acc.add_(row[..., :, None] * row[..., None, :])
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


def source_row_order(J, first_branch):
    """A row order for one system J [n, n] (any dtype, any device): each
    branch row from ``first_branch`` on whose diagonal is 0 (a voltage
    source's or a controlled voltage source's equation) trades places with
    the row of a node that it sets: the node with the largest |J[b, p]|
    whose own row holds the branch current (J[p, b] != 0) and a nonzero
    diagonal, each node taken once (first by index on a tie).  So each
    source's node voltage is pinned where its KCL row stood, which keeps
    the leading blocks of an unpivoted elimination away from the circuit's
    floating-node singularity: in the natural order every supply node's
    KCL precedes its branch row, and the last of them is left with the
    circuit's conductance to ground (gmin, the shunt, C/h) as its pivot.
    Returns a list: new row i is J's row ``order[i]``."""
    Jc = J.detach().to("cpu")
    n = Jc.shape[-1]
    nz = Jc != 0
    diag = nz.diagonal()
    taken = torch.zeros(n, dtype=torch.bool)
    order = list(range(n))
    for b in range(first_branch, n):
        if diag[b]:
            continue
        cand = nz[b] & nz[:, b] & diag & ~taken
        if not bool(cand.any()):
            continue
        p = int(torch.where(cand, Jc[b].abs(), -1.0).argmax())
        taken[p] = True
        order[b], order[p] = order[p], order[b]
    return order


def chord_factor(J, first_branch=None):
    """GESP factor of a batch of Jacobians J [L, n, n] (float64): returns
    (LU float32, perm, rowscale) for :func:`chord_backsolve`.  The factor
    runs in J's own row order, as the JAX package's does.  Given
    ``first_branch`` (the index of the first branch unknown), a lane whose
    factor there rounds a pivot to 0 (GESP boosts it to ``gesp_lu.TAU``,
    and the solve along it then overflows float32) is factored again in
    :func:`source_row_order`; perm is then [L, n] (the identity on the
    other lanes), else None.  The module's ``reordered`` counts the lanes
    factored again."""
    global reordered
    r = _equilibrate(J)
    Js = (J / r[..., None]).to(torch.float32).contiguous()
    LU = gesp_lu.lu_factor_gesp_f32(Js)
    if first_branch is None:
        return LU, None, r
    broke = (LU.diagonal(dim1=-2, dim2=-1).abs() <= gesp_lu.TAU).any(-1)
    if not bool(broke.any()):
        return LU, None, r
    L, n, _ = J.shape
    perm = torch.arange(n, device=J.device).repeat(L, 1)
    lanes = torch.nonzero(broke).flatten().tolist()
    for i in lanes:
        perm[i] = torch.as_tensor(source_row_order(J[i], first_branch),
                                  device=J.device)
    LU_p = gesp_lu.lu_factor_gesp_f32(
        Js.gather(1, perm[:, :, None].expand(L, n, n)).contiguous())
    reordered += len(lanes)
    return torch.where(broke[:, None, None], LU_p, LU), perm, r


def chord_backsolve(LU, perm, r, J, b):
    """Solve J x = b [L, n] with factors from :func:`chord_factor`: float32
    substitution (of b's rows in the factor's order ``perm``, where it is
    not None) plus ``_REFINE`` float64 refinement passes, the residual
    b − J·x a float64 batched matvec."""

    def subst(v):
        v = v / r
        if perm is not None:
            v = v.gather(1, perm)
        return gesp_lu.lu_subst_gesp_f32(
            LU, v.to(torch.float32).contiguous()).to(J.dtype)

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
