"""Periodic steady state (PSS) of driven circuits by single shooting
(counterpart of ``cedarsim_tpu/analysis/pss.py``).

Find x₀ with Φ(x₀) = x₀, Φ integrating one drive period T with the
adaptive transient core.  Newton on r(x₀) = Φ(x₀) − x₀ with the monodromy
M = ∂Φ/∂x₀ from forward-mode AD through the whole adaptive integrator, so
the shooting Jacobian is exact for the realised step sequence.

The JAX package takes M with ``jax.jacfwd`` over ``tran_core``, whose n
tangent integrations batch like a vmap.  Here they are n lanes of one
``tran_core`` run under ``torch.autograd.forward_ad``: every lane carries
the primal x₀ and lane i the tangent eᵢ, so lane i's final state carries
column i of M (every lane's primal is Φ(x₀)).  The host control flow
reads only the detached primal, so every lane takes the same steps; under
AD the chord loop takes the exact float64 solve, which on a card makes one
``torch.linalg`` call a lane (``ops/linalg.py``), so each lane's primal is
bitwise the one stream's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from cedarsim_tpu_torch.analysis.dc import solve_dc
from cedarsim_tpu_torch.analysis.tran import (TranOptions, TranSolution,
                                              tran, tran_core,
                                              xdot0_and_mask)
from cedarsim_tpu_torch.core.compile import CompiledCircuit, default_ctx
from cedarsim_tpu_torch.core.context import Modes, SimSpec
from cedarsim_tpu_torch.ops import linalg
from cedarsim_tpu_torch.ops.ad import ForwardTangents


@dataclasses.dataclass
class PSSResult:
    x0: np.ndarray            # state on the periodic orbit at t = 0
    converged: bool
    iters: int
    resnorm: float            # max |Phi(x0) - x0|
    period: float
    solution: TranSolution    # one steady-state period, starting at x0


def _shooting_maps(compiled, period, params, ctx, opts):
    """(operating point, Φ, M) of one period: ``phi(x0)`` → (Φ(x0) [L,
    n], finished [L]) for x0 [n] (one stream) or [L, n] (lanes), with ẋ0
    consistent at x0 inside the integrated map as in the JAX package, and
    ``monodromy(x0)`` → M = ∂Φ/∂x0 [n, n] from one forward-AD run of n
    lanes."""
    dt, dev = compiled.dtype, compiled.device
    n = compiled.n_x
    T = float(period)
    op = solve_dc(compiled, params, ctx, mode=Modes.TRANOP)
    ctx_op = ctx.with_mode(Modes.TRANOP)
    mask = xdot0_and_mask(compiled, op.x, ctx_op, params)[1]
    bps = compiled.breakpoints(T)
    bps = np.concatenate([bps, [T], [np.inf]])
    h0 = opts.h0 if opts.h0 is not None else T * 1e-4

    def phi(x0):
        xd0 = xdot0_and_mask(compiled, x0, ctx_op, params)[0]
        out = tran_core(compiled, params, ctx, x0, xd0, 0.0, T, bps, h0,
                        opts, mask)
        return out[8]["x"], out[4]

    def monodromy(x0):
        with fwAD.dual_level(), ForwardTangents():
            X = fwAD.make_dual(x0.expand(n, n).clone(),
                               torch.eye(n, dtype=dt, device=dev))
            dxT = fwAD.unpack_dual(phi(X)[0]).tangent
        if dxT is None:
            return torch.zeros(n, n, dtype=dt, device=dev)
        # lane i's tangent is M·eᵢ, column i of M
        return dxT.T

    return op, phi, monodromy


def pss(compiled: CompiledCircuit, period: float, params=None,
        ctx: SimSpec = None, opts: TranOptions = None, max_iter: int = 10,
        tol: float = 1e-9, damping: float = 1.0) -> PSSResult:
    """Shooting PSS for a circuit driven at a known ``period``."""
    if getattr(compiled, "n_dly", 0):
        raise NotImplementedError(
            "shooting PSS does not support exact-history delay elements "
            "(TLine / absdelay delay_mode='history'): the shooting state "
            "x0 does not include the in-flight wave history, so the fixed "
            "point would correspond to a flat-history integrator rather "
            "than the true periodic orbit.  Use delay_mode='pade' (state-"
            "based) for PSS.")
    params = compiled.params0 if params is None else params
    ctx = default_ctx(compiled) if ctx is None else ctx
    opts = opts or TranOptions()
    dt, dev = compiled.dtype, compiled.device
    n = compiled.n_x
    T = float(period)
    op, phi, monodromy = _shooting_maps(compiled, T, params, ctx, opts)

    x0 = op.x.detach()
    converged = False
    resnorm = float("inf")
    it = 0
    stepped = False
    for it in range(1, max_iter + 1):
        xT, fin = phi(x0)
        r = xT[0] - x0
        resnorm = float(r.abs().max())
        scale = float(x0.abs().max()) + 1.0
        stepped = False
        if not bool(fin.all()):
            break
        if resnorm <= tol * scale:
            converged = True
            break
        dx = linalg.solve(monodromy(x0) - torch.eye(n, dtype=dt, device=dev),
                          -r)
        if not bool(torch.isfinite(dx).all()):
            break
        x0 = x0 + damping * dx
        stepped = True

    # the final check at the last x0 (the JAX package takes Φ there once
    # more; the loop already has it unless it ended on a Newton step)
    if stepped:
        xT, fin = phi(x0)
        resnorm = float((xT[0] - x0).abs().max())
    converged = converged and bool(fin.all())
    sol = tran(compiled, (0.0, T), params=params, ctx=ctx, opts=opts, x0=x0)
    return PSSResult(x0=x0.cpu().numpy(), converged=converged, iters=it,
                     resnorm=resnorm, period=T, solution=sol)
