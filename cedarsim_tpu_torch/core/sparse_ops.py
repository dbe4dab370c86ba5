"""Sparse-matrix Newton operations for large circuits (counterpart of
``cedarsim_tpu/core/sparse_ops.py``).

Couples the batched-stamp compiler (``core/compile.py``) to the
static-pattern sparse LU (``ops/sparse_lu.py``): instead of scatter-adding
per-instance local Jacobians into dense [n, n] matrices, the Jacobian walk
(``CompiledCircuit.evaluate(jac="sparse")``) scatters them into value
vectors in the factorization's filled pattern, one per lane, [L, nnz_f].
That removes the O(n²) memory and the dense O(n³) solve: the role KLU plays
in the reference.  Every method takes values with a leading lane axis (or
one system without it); every lane shares the plan.

The plan does not depend on the device: the probe weights that guide its
pivot matching are computed on the CPU, by a CPU compile of the same
circuit, wherever the circuit itself was compiled.

Forward-mode AD (the sensitivities and the shooting monodromy, as the JAX
package's ``jax.jvp`` through its XLA sparse LU) goes through
:class:`SparseSolve`: the factorization is of the primal values, and a
tangent (dA, db) is solved with the same factors and refinement as
dx = A⁻¹(db − dA·x), so on a card the tangent solve launches S2 again.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from cedarsim_tpu_torch.core.context import SimSpec
from cedarsim_tpu_torch.ops import sparse_lu
from cedarsim_tpu_torch.ops.ad import any_tangent

#: the boost threshold of the equilibrated factor: √ε of float64
TAU = float(np.sqrt(np.finfo(np.float64).eps))


class SparseOps:
    """Holds the plan and the assembly maps of one CompiledCircuit."""

    def __init__(self, compiled):
        self.compiled = compiled
        n = compiled.n_x
        nv = compiled.n_nodes + compiled.n_internal

        # structural pattern from the stamp index matrices plus the gmin /
        # integrator diagonal on voltage rows only (branch rows have a
        # numerically zero diagonal: forcing it would mislead the static
        # pivot matching, see ops/sparse_lu.py)
        rows, cols = [], []
        for key in compiled.group_order:
            g = compiled.groups[key]
            r = np.broadcast_to(g.row_idx[:, :, None],
                                g.row_idx.shape + (g.var_idx.shape[1],))
            c = np.broadcast_to(g.var_idx[:, None, :], r.shape)
            rows.append(r.ravel())
            cols.append(c.ravel())
        rows.append(np.arange(nv))
        cols.append(np.arange(nv))
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        keep = (rows < n) & (cols < n)

        weights = self._numeric_weights(keep)
        #: pattern-order probe weights, kept for tests of the pivot
        #: matching's inputs
        self.probe_weights = weights
        rows, cols = rows[keep].astype(np.int64), cols[keep].astype(np.int64)

        self.plan = sparse_lu.build_plan(n, rows, cols, weights=weights)
        p = self.plan

        # (row, col) -> filled position lookup for the assembly maps
        posmap = {}
        for r, c, q in zip(p.in_rows, p.in_cols, p.in_pos):
            posmap[(int(r), int(c))] = int(q)
        trash = p.nnz_f
        self.group_pos = {}
        for key in compiled.group_order:
            g = compiled.groups[key]
            ni, nr, nc_ = (g.row_idx.shape[0], g.row_idx.shape[1],
                           g.var_idx.shape[1])
            pos = np.full((ni, nr, nc_), trash, np.int32)
            for j in range(ni):
                for a in range(nr):
                    r = int(g.row_idx[j, a])
                    if r >= n:
                        continue
                    for b in range(nc_):
                        c = int(g.var_idx[j, b])
                        if c < n:
                            pos[j, a, b] = posmap[(r, c)]
            self.group_pos[key] = pos
        # gmin-shunt diagonal positions (voltage rows)
        self.vdiag_pos = np.asarray(
            [posmap[(i, i)] for i in range(nv)], np.int32)
        self.nnz_f = p.nnz_f
        dev = compiled.device

        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)
        self._vdiag = t(self.vdiag_pos)
        self._arow = t(p.pos_arow)
        self._acol = t(p.pos_acol)
        ok = p.a_diag_pos >= 0
        self._a_diag_ok = t(np.nonzero(ok)[0])
        self._a_diag = t(p.a_diag_pos[ok])

    def _numeric_weights(self, keep):
        """Representative |G| + |C| magnitudes at two bias points to guide
        the static pivot matching, run once on the CPU whatever the
        circuit's device: each group's local Jacobians at the probe states
        (zeros, and 0.5 + 0.1·N(0, 1) from ``default_rng(0)``), summed over
        the probes, KCL rows scaled by ``$mult``, NaN and inf mapped to 0,
        raveled in the structural pattern's order, the trailing voltage
        diagonal at 0, then ``keep`` and a 1e-30 floor (an entry that is
        zero at both probes stays matchable).  The CPU compile of the same
        circuit makes the plan independent of the device."""
        from cedarsim_tpu_torch.core.compile import CompiledCircuit
        compiled = self.compiled
        cpu = compiled
        if compiled.device.type != "cpu":
            cpu = CompiledCircuit(compiled.circuit, dtype=compiled.dtype,
                                  device="cpu",
                                  dynamic_params=compiled.dynamic_params,
                                  sparse=compiled.sparse_mode,
                                  eval_dtype=compiled.eval_dtype)
        n = compiled.n_x
        nv = compiled.n_nodes + compiled.n_internal
        rng = np.random.default_rng(0)
        probes = [np.zeros(n),
                  0.5 + 0.1 * rng.standard_normal(n)]
        ctx = SimSpec.make(mode="dcop")
        x = torch.as_tensor(np.stack(probes), dtype=cpu.dtype)
        jacs = cpu.local_jacobians(x, ctx)
        parts = []
        for key in cpu.group_order:
            g = cpu.groups[key]
            Js, Jq = jacs[key]
            W = 0.0
            for k in range(len(probes)):
                W = W + (Js[k].abs() + Jq[k].abs()).double().numpy()
            # the assembly scales KCL rows by the $mult instance multiplier:
            # without it a device with m >> 1 probes m times weaker than
            # its matrix entries
            mult = cpu.params0[key]["$mult"].double().numpy()
            kcl = np.asarray(g.kcl_mask, bool)
            W = W * np.where(kcl[None, :, None], mult[:, None, None], 1.0)
            # NaN-producing probe points (off-bias compact models) must not
            # poison the matching: treat them as unknown magnitude
            parts.append(np.nan_to_num(W, nan=0.0, posinf=0.0).ravel())
        parts.append(np.zeros(nv))
        w = np.concatenate(parts)[np.asarray(keep)]
        return w + 1e-30

    # ------------------------------------------------------------- numerics

    def res_jacs_sparse(self, x, ctx, params=None):
        """(S, Q, Gv, Cv): the residual vectors [..., n_x] and the Jacobian
        value vectors [..., nnz_f] in the filled pattern, from one walk."""
        return self.compiled._call(x, ctx, params, jac="sparse")

    def add_diag(self, vals, d):
        """vals + d on the voltage rows' diagonal (gmin shunts; ``d`` a
        float, or [L, 1])."""
        out = vals.clone()
        out[..., self._vdiag] = out[..., self._vdiag] + d
        return out

    def equilibrate(self, vals):
        """Row, then column equilibration A′ = D_r·A·D_c of values [L,
        nnz_f] (or [nnz_f]): (A′'s values, d_r, d_c), each row and column
        of A′ at most 1 in magnitude."""
        v, single = sparse_lu._lanes(vals)
        L, n = v.shape[0], self.compiled.n_x
        tiny = torch.finfo(v.dtype).tiny
        rmax = torch.zeros(L, n, dtype=v.dtype, device=v.device) \
            .scatter_reduce(1, self._arow.expand(L, -1), v.abs(), "amax")
        dr = 1.0 / rmax.clamp(min=tiny)
        vs = v * dr[:, self._arow]
        cmax = torch.zeros(L, n, dtype=v.dtype, device=v.device) \
            .scatter_reduce(1, self._acol.expand(L, -1), vs.abs(), "amax")
        dc = 1.0 / cmax.clamp(min=tiny)
        vs = vs * dc[:, self._acol]
        return (vs[0], dr[0], dc[0]) if single else (vs, dr, dc)

    def factorize(self, vals):
        """Equilibrate and factor once: the opaque factorization of
        ``solve_factorized``, the factor/solve split that lets a chord
        Newton freeze one factorization across iterations (KLU's
        klu_factor/klu_solve).  The GESP static-pivoted recipe: the
        equilibration (:meth:`equilibrate`; MNA entries span ~20 decades),
        then the factor with pivots below τ = √ε(float64) boosted
        (``ops/sparse_lu.py::factor``; ‖A′‖∞ = 1 by the scaling).  Under
        AD the factors are of the primal values (see :class:`SparseSolve`)."""
        vs, dr, dc = self.equilibrate(_primal(vals))
        return sparse_lu.factor(self.plan, vs, boost=TAU), dr, dc

    def solve_factorized(self, fct, vals, rhs, refine: int = 1):
        """Solve A x = rhs with a factorization from ``factorize(vals)``;
        ``refine`` iterative-refinement passes against the unfactored
        values recover the digits the boosted static pivots perturbed.
        When ``vals`` or ``rhs`` carries AD state the solve is
        :class:`SparseSolve`'s, with the same primal result."""
        if any_tangent(vals, rhs):
            f, dr, dc = fct
            return SparseSolve.apply(vals, rhs, f, dr, dc, self, refine)
        return self._solve_primal(fct, vals, rhs, refine)

    def _solve_primal(self, fct, vals, rhs, refine):
        f, dr, dc = fct

        def solve_scaled(b):
            # A x = b  ⇔  A′·(D_c⁻¹ x) = D_r b
            return dc * sparse_lu.solve_factored(self.plan, f, b * dr)

        x = solve_scaled(rhs)
        for _ in range(refine):
            r = rhs - self.matvec(vals, x)
            x = x + solve_scaled(r)
        return x

    def solve(self, vals, rhs, refine: int = 1):
        """One-shot factor and solve (see factorize/solve_factorized)."""
        return self.solve_factorized(self.factorize(vals), vals, rhs,
                                     refine=refine)

    def matvec(self, vals, v):
        """y = A·v for values in the filled pattern (A-space indices; fill
        positions hold 0)."""
        return sparse_lu.matvec(self.plan, vals, v)

    def mask_rows(self, vals, keep):
        """Every stored value scaled by keep[row] (``.ic`` row overwrites);
        ``keep`` [n_x] or [L, n_x]."""
        return vals * keep[..., self._arow]

    def add_a_diag(self, vals, d):
        """vals + diag(d) wherever A[i, i] is structurally present; ``d``
        [n_x] or [L, n_x]."""
        out = vals.clone()
        out[..., self._a_diag] = out[..., self._a_diag] \
            + d[..., self._a_diag_ok]
        return out


def _primal(v):
    """``v`` without its forward tangent and detached: what the kernels
    factor."""
    if fwAD._current_level >= 0:
        v = fwAD.unpack_dual(v).primal
    return v.detach()


class SparseSolve(torch.autograd.Function):
    """x = A⁻¹·rhs through the sparse LU (``SparseOps.solve_factorized``)
    with a forward-mode rule: the forward is the primal solve (S1's
    factors ``f``, ``dr``, ``dc`` of the primal ``vals``, S2 and the
    refinement passes, the same operations as without AD), and
    :meth:`jvp` solves the tangent dx = A⁻¹(d_rhs − dA·x) with the same
    factors and refinement.  Reverse mode is not provided: neither
    package's transient takes it (the JAX package's ``tran_core`` is a
    ``while_loop``), and the DC sensitivities solve their adjoint densely
    in both (``analysis/sensitivity.py``)."""

    @staticmethod
    def forward(vals, rhs, f, dr, dc, ops, refine):
        return ops._solve_primal((f, dr, dc), vals, rhs, refine)

    @staticmethod
    def setup_context(ctx, inputs, output):
        vals, rhs, f, dr, dc, ops, refine = inputs
        ctx.save_for_forward(vals, f, dr, dc, output)
        ctx.ops, ctx.refine = ops, refine

    @staticmethod
    def jvp(ctx, dvals, drhs, df, ddr, ddc, dops, drefine):
        vals, f, dr, dc, x = ctx.saved_tensors
        b = torch.zeros_like(x) if drhs is None else drhs
        if dvals is not None:
            b = b - ctx.ops.matvec(dvals, x)
        return ctx.ops._solve_primal((f, dr, dc), vals, b, ctx.refine)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "reverse-mode AD through the sparse LU (S1/S2) is not provided: "
            "the transient is differentiated in forward mode "
            "(torch.autograd.forward_ad), as the JAX package's jax.jvp "
            "through its while_loop, and DC sensitivities solve their "
            "adjoint densely (analysis/sensitivity.py)")


def get_sparse_ops(compiled) -> SparseOps:
    """``compiled``'s SparseOps, built at first use and kept on it."""
    ops = compiled.__dict__.get("_sparse_ops")
    if ops is None:
        ops = SparseOps(compiled)
        compiled.__dict__["_sparse_ops"] = ops
    return ops
