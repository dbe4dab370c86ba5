"""DC-initialisation quality probes (counterpart of
``cedarsim_tpu/analysis/fragility.py``).

``initialization_norm`` scores a state by the residual norm of the static
equations; ``init_fragility`` solves the operating point from n randomised
starting points and clusters the distinct operating points found, the
metastability probe for circuits with more than one stable operating point
(a DFF latch, a bistable core).  The JAX package solves the n starts as one
``jax.vmap`` of ``dc_core``; here they are the n lanes of one lane-batched
``dc_core`` (a lane's result does not depend on the other lanes), and the
clustering runs on the host afterwards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cedarsim_tpu_torch.analysis.dc import (NewtonOptions, dc_core,
                                            default_newton_options)
from cedarsim_tpu_torch.core.compile import CompiledCircuit, default_ctx
from cedarsim_tpu_torch.core.context import Modes, SimSpec


def initialization_norm(compiled: CompiledCircuit, x, params=None,
                        ctx: SimSpec = None) -> float:
    """Residual 2-norm of the static equations at ``x``: zero at an exact
    operating point; large values flag a bad or drifting init."""
    params = compiled.params0 if params is None else params
    if ctx is None:
        ctx = SimSpec.make(mode=Modes.DCOP)
    x = torch.as_tensor(np.asarray(x), dtype=compiled.dtype,
                        device=compiled.device)
    S, _ = compiled.residuals(x, ctx, params)
    return float(torch.linalg.norm(S))


@dataclasses.dataclass
class FragilityReport:
    """Result of :func:`init_fragility`.

    ``solutions``/``counts`` list the distinct converged operating points
    (clustered to ``cluster_tol``) and how many random inits landed in each
    basin; more than one row means the circuit is metastable at DC.
    """
    converged: np.ndarray        # [n] bool per sample
    resnorm: np.ndarray          # [n] final residual norm per sample
    iters: np.ndarray            # [n] Newton iterations per sample
    x: np.ndarray                # [n, n_x] per-sample solutions
    solutions: np.ndarray        # [k, n_x] distinct operating points
    counts: np.ndarray           # [k] samples per basin

    @property
    def converged_frac(self) -> float:
        return float(np.mean(self.converged))

    @property
    def n_solutions(self) -> int:
        return int(len(self.solutions))

    def summary(self) -> str:
        lines = [f"init_fragility: {self.converged_frac * 100:.0f}% of "
                 f"{len(self.converged)} random inits converged; "
                 f"{self.n_solutions} distinct operating point(s)"]
        for k, (sol, c) in enumerate(zip(self.solutions, self.counts)):
            head = np.array2string(sol[:6], precision=4, suppress_small=True)
            lines.append(f"  #{k}: {c} inits -> x[:6]={head}")
        return "\n".join(lines)


def _cluster(x: np.ndarray, tol: float):
    """Greedy tolerance clustering of solution vectors (rows of x)."""
    reps, counts = [], []
    for row in x:
        for k, rep in enumerate(reps):
            if np.max(np.abs(row - rep)) <= tol * (1.0 + np.max(np.abs(rep))):
                counts[k] += 1
                break
        else:
            reps.append(row)
            counts.append(1)
    if not reps:
        return (np.zeros((0, x.shape[1] if x.ndim == 2 else 0)),
                np.zeros((0,), np.int64))
    order = np.argsort(counts)[::-1]
    return (np.stack([reps[i] for i in order]),
            np.asarray([counts[i] for i in order]))


def _setup(compiled, params, ctx, opts, mode):
    params = compiled.params0 if params is None else params
    ctx = (default_ctx(compiled) if ctx is None else ctx).with_mode(mode)
    opts = opts or default_newton_options(compiled)
    return params, ctx, dataclasses.replace(opts, restarts=0)


def _fragility_from_starts(compiled: CompiledCircuit, x0, params=None,
                           ctx: SimSpec = None, opts: NewtonOptions = None,
                           mode=Modes.DCOP, cluster_tol: float = 1e-4
                           ) -> FragilityReport:
    """The solve and the clustering of :func:`init_fragility` from given
    starting points ``x0`` [n, n_x]: one lane-batched ``dc_core`` with the
    randomised restarts off."""
    params, ctx, opts = _setup(compiled, params, ctx, opts, mode)
    x0 = torch.as_tensor(np.asarray(x0), dtype=compiled.dtype,
                         device=compiled.device)
    res = dc_core(compiled, params, ctx, x0, opts)
    conv = res.converged.cpu().numpy()
    xs = res.x.cpu().numpy()
    sols, counts = _cluster(xs[conv], cluster_tol)
    return FragilityReport(converged=conv, resnorm=res.resnorm.cpu().numpy(),
                           iters=res.iters.cpu().numpy(), x=xs,
                           solutions=sols, counts=counts)


def init_fragility(compiled: CompiledCircuit, n: int = 64, sigma: float = 0.5,
                   seed: int = 0, params=None, ctx: SimSpec = None,
                   opts: NewtonOptions = None, around=None,
                   mode=Modes.DCOP, cluster_tol: float = 1e-4
                   ) -> FragilityReport:
    """Probe DC-initialisation robustness: solve the operating point from
    ``n`` Gaussian-perturbed starting points (``around + sigma·randn``) as
    one lane-batched solve and cluster the distinct solutions found.

    The starts are drawn on the CPU from ``torch.Generator`` seeded with
    ``seed``, so the card and the CPU start from the same points; the JAX
    package draws them with ``jax.random.PRNGKey(seed)``, whose bits cannot
    be reproduced without JAX, so the two packages' starts differ for the
    same seed (:func:`_fragility_from_starts` takes given starts).

    ``around``: centre of the perturbation ball (default zeros, the
    solver's own cold start).  The randomised-restart bootstraps are off
    inside the solve (``opts.restarts=0``), so each sample reports the
    basin its own starting point leads to.
    """
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    center = (torch.zeros(compiled.n_x, dtype=torch.float64) if around is None
              else torch.as_tensor(np.asarray(around), dtype=torch.float64))
    x0 = center[None] + sigma * torch.randn(n, compiled.n_x, generator=gen,
                                            dtype=torch.float64)
    return _fragility_from_starts(compiled, x0.numpy(), params=params,
                                  ctx=ctx, opts=opts, mode=mode,
                                  cluster_tol=cluster_tol)
