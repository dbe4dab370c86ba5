"""Transient analysis over an explicit lane axis (counterpart of
``cedarsim_tpu/analysis/tran.py``).

The JAX package runs the adaptive step loop inside ``lax.while_loop`` and
batches it with ``jax.vmap``.  Here every piece of integrator state carries a
leading lane axis, every lane keeps its own step size, history, breakpoint
index and counters, and every update is masked per lane, so a lane's result
does not depend on the other lanes — the meaning of ``vmap``.  The host
checks "all lanes done" every few step attempts, and each Newton loop runs
until none of its lanes is still iterating.

Method (as in the JAX package): DAE residual F = S(x,t) + dQ(x)/dt.
Charge-form trap (BE starts and after breakpoints) or BE/BDF2, or the
cap-form companion corrector S(x) + C(x)·ẋ; quadratic divided-difference
predictor; LTE from the predictor-corrector difference on the differential
unknowns; breakpoints clamp steps and restart the order; a Newton failure
shrinks h by 4.  ``jac_reuse=1`` is the per-step chord Newton (factor once
per step attempt, exact residuals after) with the full-Newton
``chord_fallback`` rescue behind its ``rescue_after`` gate; ``jac_reuse >=
2`` keeps each lane's (G, C) across step attempts and retries a Newton
failure with a stale Jacobian at the same h with a fresh one.  The chord
iterations run either in the loop below (``newton_impl="xla"``) or in one
launch of the fused chord kernel per step attempt (``"fused"``,
``ops/fused_chord.py``).  On a sparse circuit (``use_sparse_solver``) G and
C are value vectors in the sparse LU's filled pattern, each Newton solve is
``SparseOps.solve`` (the chord factors once per attempt with
``SparseOps.factorize``), C·v is ``SparseOps.matvec``, and there is no
cross-step reuse, as in the JAX package.

A run stops with its integrator state in a checkpoint (``CHECKPOINT_FIELDS``)
that a later run resumes (``tran(resume=)``, ``tran_core(init_state=)``),
so that windows chain; ``TranOptions.store_vars`` keeps only some columns
of the stored waveforms (the checkpoint keeps the whole state).

Delay and latch channel (``CompiledCircuit.n_dly``): each lane keeps a
shift register of its last ``delay_history`` accepted times and delayed
expressions (``t_ring`` [L, KD], ``u_ring`` [L, KD, n_ring]), seeded with
the operating point; every step attempt reads u(t_new − td) from it
(:func:`ring_interp`, ``jnp.interp``'s values) and holds it through
Newton, h stays under min(td)/2, and an accepted step pushes its sample
and updates the latched states (``CompiledCircuit.latch_update``).  A
lookup older than the ring's oldest sample reads that sample, as in the
JAX package; once the ring no longer reaches back to the run's start such
a lookup is counted (``TranSolution.n_ring_underflow``).  Transient noise
(``noise_seed``): ε ~ N(0, pwr/(2h)) per white noise source, the unit draw
fixed by the accepted-step index (row k of :func:`noise_draws`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cedarsim_tpu_torch.core.compile import (CompiledCircuit, default_ctx,
                                             use_sparse_solver)
from cedarsim_tpu_torch.core.context import SimSpec, Modes
from cedarsim_tpu_torch.core.sparse_ops import get_sparse_ops
from cedarsim_tpu_torch.ops import gesp_lu, linalg
from cedarsim_tpu_torch.ops.ad import ad_state
from cedarsim_tpu_torch.ops.rounding import fma_f64
from cedarsim_tpu_torch.ops.fused_chord import (FusedEnvelopeError,
                                                get_fused_plan, split_lanes)
from cedarsim_tpu_torch.analysis.dc import NewtonOptions, solve_dc

#: step attempts between two host checks of "every lane done"; attempts on
#: finished lanes are masked no-ops, so this trades at most this many wasted
#: attempts at the end for fewer host synchronisations
_HOST_CHECK_EVERY = 4


@dataclasses.dataclass(frozen=True)
class TranOptions:
    rtol: float = 1e-3
    atol: float = 1e-6
    trtol: float = 7.0
    #: "trap" (trapezoidal with BE starts), "be", "bdf2" (variable-step,
    #: order 1-2), "bdf3" (the variable-order ladder 1→3: BE on a fresh
    #: history, BDF2 after one accepted step, BDF3 after two), "bdf5" (the
    #: ladder 1→5, Lagrange coefficients over the active nodes, a quartic
    #: predictor from five history points) or "auto": trap for the charge
    #: formulation, bdf2 for the cap formulation.  The order restarts at
    #: breakpoints; bdf3/bdf5's cubic and quartic predictors raise the
    #: error estimate's order one step after the corrector's.
    method: str = "auto"
    max_steps: int = 8192          # output buffer size
    max_newton: int = 12
    newton_reltol: float = 1e-6
    newton_abstol: float = 1e-9
    res_tol: float = 1e-9
    #: Jacobian-only diagonal damping on voltage rows
    jac_shunt: float = 0.0
    #: relative coefficient of the Newton residual check
    res_rel: float = 1e-7
    #: step-size controller: "i" (integral err^(-1/3)) or "pi"
    controller: str = "i"
    #: LTE acceptance deadband: accept steps with err ≤ accept_slack
    accept_slack: float = 1.0
    #: 0 = full Newton every iteration; 1 = per-step chord (assemble and
    #: factor once per step attempt); N >= 2 = cross-step reuse: each lane
    #: keeps its (G, C) for up to N step attempts, refreshing on age, after
    #: a Newton failure with a stale Jacobian (retried at the same h) and
    #: after a breakpoint crossing.  The model walk runs only when some
    #: lane refreshes, which pays on one stream; the full-Newton rescue
    #: (``chord_fallback``) is not used there.
    jac_reuse: int = 0
    #: full-Newton rescue after a failed per-step chord certify
    chord_fallback: bool = True
    #: consecutive Newton-failed attempts before a lane may take the rescue
    rescue_after: int = 5
    #: consecutive LTE rejections before a step is accepted anyway
    stall_accept: int = 12
    h0: float = None               # initial step (default span·1e-6)
    hmax_frac: float = 0.04        # h_max = span·hmax_frac
    hmin_frac: float = 1e-12
    grow: float = 3.0
    shrink: float = 0.2
    bp_restart: float = 0.1        # h multiplier after a breakpoint
    uic: bool = False              # skip operating point, use ICs directly
    #: corrector formulation: "charge", "cap", or "auto" (the cap form
    #: under mixed-precision evaluation, where it keeps the float32 eval
    #: noise relative; else charge; :func:`cap_form_of`)
    formulation: str = "auto"
    #: dense linear solver: "jax" (exact float64 ``torch.linalg``), "mixed"
    #: (float32 GESP kernels + float64 refinement) or "auto" ("mixed" on
    #: CUDA, "jax" on the CPU)
    dense_lu: str = "auto"
    #: chord-iteration engine: "xla" (the loop in ``tran_core``), "fused"
    #: (one fused chord kernel launch per step attempt: cap form,
    #: ``jac_reuse >= 1``) or "auto" (see :func:`resolve_impl`)
    newton_impl: str = "auto"
    #: output buffers grow by whole chunks of this many rows
    chunk_size: int = 64
    #: the stored waveform columns (``.save`` at the engine level): state
    #: indices, or net names on the public ``tran``; None stores all.  The
    #: final state and the checkpoint always carry the whole x.
    store_vars: tuple = None
    #: transient noise: the seed of the per-step white-noise draws through
    #: the devices' noise sources, ε ~ N(0, pwr/(2h)) per source (1/f
    #: sources excluded); None = no noise
    noise_seed: int = None
    #: the history ring's length (accepted samples kept per lane) for the
    #: delayed values of the delay elements and of VA ``absdelay`` in
    #: "history" mode; lookups older than its oldest sample read that
    #: sample
    delay_history: int = 512


def cap_form_of(compiled: CompiledCircuit, opts: TranOptions) -> bool:
    """Whether the corrector is the cap form: ``formulation="cap"``, or
    "auto" on a circuit whose models evaluate in another dtype than its
    state (the JAX package's rule)."""
    return opts.formulation == "cap" or (opts.formulation == "auto"
                                         and compiled.mixed)


def mixed_tran_options() -> TranOptions:
    """The transient's defaults under ``eval_dtype=float32`` (the JAX
    package's): Newton and LTE tolerances above the float32 noise floor,
    the Jacobian shunt, and the per-step chord (``jac_reuse=1``), which
    with the cap form lets "auto" take the fused chord kernel."""
    return TranOptions(newton_reltol=1e-4, newton_abstol=5e-7, res_tol=1e-3,
                       jac_shunt=1e-7, res_rel=3e-5, rtol=1e-2, atol=1e-4,
                       jac_reuse=1)


def resolve_impl(compiled: CompiledCircuit, opts: TranOptions, ctx=None,
                 params=None, batched=True, ad=False):
    """Resolve ``dense_lu``/``newton_impl`` per device, as the JAX package's
    ``auto_tpu_impl`` and its chord pair do, with "on TPU" read as "on
    CUDA".  ``dense_lu``: an unbatched call (one stream, ``batched=False``)
    takes the exact float64 solve under "auto" and under "mixed", since the
    JAX package's chord pair reaches the float32 GESP kernels only inside
    its ``custom_vmap`` rule (``cedarsim_tpu/ops/linalg.py:155-216``); a
    call with a lane axis takes "mixed" under "auto" on CUDA where the GESP
    kernels hold the system in a block's shared memory
    (``gesp_lu.max_n``: n <= 240 on an H100), else "jax" (the exact float64
    solve, as on the CPU), and the GESP kernels under "mixed" at any lane
    count; on CUDA an explicit "mixed" above that n raises, as the JAX
    package's Pallas kernels do (``cedarsim_tpu/ops/pallas_lu.py:287,
    424``), naming the two ways out.
    ``newton_impl`` "auto" is "fused" on CUDA when :func:`auto_newton_impl`
    says so (``ctx`` given), else "xla".  A sparse circuit
    (``use_sparse_solver``) solves with ``SparseOps`` at any lane count on
    any device: "jax" and "xla" ("mixed" is ignored, as the JAX package's
    sparse ``lin_solve`` ignores it), and an explicit "fused" raises, as
    the JAX package's does.
    ``ad``: an input carries AD state (``ops/ad.py::ad_state``:
    "forward" for forward tangents, "grad" when one requires grad).  Then
    "auto" is the exact float64 solve in the chord loop ("jax", "xla"),
    the path the JAX package's sensitivities and monodromy differentiate
    (its unbatched exact solve), and an explicit "mixed" or "fused"
    raises: those kernels have no derivative rule.  A sparse circuit
    takes forward tangents through S1/S2 (``core/sparse_ops.py::
    SparseSolve``) and raises under "grad": the sparse solve has no
    reverse-mode rule, as the transient has none in either package."""
    dl, ni = opts.dense_lu, opts.newton_impl
    if ad:
        if use_sparse_solver(compiled) and ad == "grad":
            raise NotImplementedError(
                "reverse-mode AD (requires_grad) through the transient of a "
                "sparse circuit: the sparse LU (S1/S2) has a forward-mode "
                "rule only, as the transient is differentiated in forward "
                "mode (torch.autograd.forward_ad; the JAX package's jax.jvp "
                "through its while_loop); use forward_ad, or compile with "
                "sparse=False")
        if ni == "fused" or dl == "mixed":
            raise ValueError(
                f"newton_impl={ni!r} / dense_lu={dl!r} under automatic "
                "differentiation: the fused chord kernel and the float32 "
                "GESP kernels have no derivative rule, so a tangent would "
                "be dropped; use 'auto' (the exact float64 solve) or "
                "newton_impl='xla', dense_lu='jax'")
        if ni not in ("xla", "auto") or dl not in ("jax", "auto"):
            raise ValueError(f"unknown newton_impl={ni!r} / dense_lu={dl!r}")
        return dataclasses.replace(opts, dense_lu="jax", newton_impl="xla")
    if use_sparse_solver(compiled):
        if ni == "fused":
            raise ValueError("newton_impl='fused' is dense-path only")
        if ni not in ("xla", "auto") or dl not in ("jax", "mixed", "auto"):
            raise ValueError(f"unknown newton_impl={ni!r} / dense_lu={dl!r}")
        return dataclasses.replace(opts, dense_lu="jax", newton_impl="xla")
    on_card = compiled.device.type == "cuda"
    limit = gesp_lu.max_n(compiled.device) if on_card else None
    if dl == "auto":
        dl = "mixed" if (batched and on_card and compiled.n_x <= limit) \
            else "jax"
    elif dl == "mixed" and not batched:
        dl = "jax"
    elif dl == "mixed" and on_card and compiled.n_x > limit:
        raise ValueError(
            f"dense_lu='mixed': {compiled.n_x} unknowns exceed what the "
            f"GESP kernels hold in a block's shared memory on this card "
            f"(n <= {limit}); use dense_lu='jax' (the exact float64 solve) "
            "or compile the circuit with sparse=True")
    if ni == "auto":
        ni = "xla"
        if compiled.device.type == "cuda" and ctx is not None:
            ni = auto_newton_impl(compiled, opts, ctx, params)
    if ni not in ("xla", "fused") or dl not in ("jax", "mixed"):
        raise ValueError(f"unknown newton_impl={ni!r} / dense_lu={dl!r}")
    return dataclasses.replace(opts, dense_lu=dl, newton_impl=ni)


def auto_newton_impl(compiled: CompiledCircuit, opts: TranOptions, ctx,
                     params=None):
    """"fused" when the corrector is the cap form (:func:`cap_form_of`),
    ``jac_reuse == 1``, the circuit has no delay or latch slots and no
    noise is injected (as the JAX package's ``auto_tpu_impl``), the fused
    plan builds, the
    temperature is one value (the plan bakes it) and every per-lane leaf
    of ``params`` reaches the kernel (``dyn_leaf_safe``); else "xla".
    Only :class:`~cedarsim_tpu_torch.ops.fused_chord.FusedEnvelopeError`
    counts as "outside the envelope": any other failure (an emit, a
    build) propagates."""
    if (not cap_form_of(compiled, opts) or opts.jac_reuse != 1
            or opts.noise_seed is not None or compiled.n_dly):
        return "xla"
    try:
        fused_plan_for(compiled, ctx, params)
    except FusedEnvelopeError:
        return "xla"
    return "fused"


def fused_plan_for(compiled: CompiledCircuit, ctx, params=None):
    """The fused chord plan of a (possibly lane-batched) params tree: built
    from lane 0; raises ``FusedEnvelopeError`` when a leaf that differs
    between lanes would be read by the kernel as a constant, or when the
    temperature is per lane (the emitted walk folds it as a constant)."""
    if isinstance(ctx.temp, torch.Tensor) and ctx.temp.dim() > 0:
        raise FusedEnvelopeError(
            "fused chord: a per-lane temperature would be read by the "
            "kernel as one constant; use newton_impl='xla'")
    base, varying = split_lanes(compiled, params)
    plan = get_fused_plan(compiled, ctx.with_mode(Modes.TRAN), base)
    for key, pn in varying:
        if not plan.dyn_leaf_safe(key, pn):
            raise FusedEnvelopeError(
                f"fused chord: per-lane {key}.{pn} enters the constant "
                "G_lin/C_lin of the kernel; use newton_impl='xla'")
    return plan


def noise_draws(seed, rows, n_eps, device=None):
    """The unit normal draws of transient noise, [rows, n_eps] float64:
    row k is what every lane draws at its accepted-step index k.  Drawn on
    the CPU from a ``torch.Generator`` seeded with ``seed`` and moved to
    ``device``, so that the card and the CPU inject the same numbers."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    xi = torch.randn(rows, n_eps, generator=gen, dtype=torch.float64)
    return xi.to(device) if device is not None else xi


def ring_interp(q, t_ring, u_ring):
    """``jnp.interp(q, t_ring, u_ring[:, j])`` per lane and ring slot,
    value for value: ``q`` [L, R] queries, ``t_ring`` [L, KD] ascending
    (repeated abscissae allowed), ``u_ring`` [L, KD, R] → [L, R], with
    ``jnp.interp``'s operations: the bracket from a right-sided search
    clipped to [1, KD − 1], a zero-width bracket reading its left sample,
    queries outside the samples clamped to the first or last, and the
    interior value f_lo + (Δq/Δt)·Δf rounded once, as XLA's CPU compiler
    contracts it into an FMA (``ops/rounding.py::fma_f64``)."""
    KD = t_ring.shape[1]
    i = torch.searchsorted(t_ring.contiguous(), q.contiguous(),
                           right=True).clamp(1, KD - 1)
    x_lo, x_hi = t_ring.gather(1, i - 1), t_ring.gather(1, i)
    f_lo = u_ring.gather(1, (i - 1)[:, None, :])[:, 0]
    f_hi = u_ring.gather(1, i[:, None, :])[:, 0]
    dx = x_hi - x_lo
    dx0 = dx.abs() <= _INTERP_EPS
    f = torch.where(dx0, f_lo,
                    fma_f64((q - x_lo) / torch.where(dx0, 1.0, dx),
                            f_hi - f_lo, f_lo))
    f = torch.where(q < t_ring[:, :1], u_ring[:, 0], f)
    return torch.where(q > t_ring[:, -1:], u_ring[:, -1], f)


#: ``jnp.interp``'s zero-width bracket: np.spacing(float64 eps)
_INTERP_EPS = float(np.spacing(np.finfo(np.float64).eps))


@dataclasses.dataclass
class TranSolution:
    ts: np.ndarray
    xs: np.ndarray
    xdots: np.ndarray
    converged: bool
    n_accepted: int
    n_rejected: int
    n_newton: int
    compiled: CompiledCircuit
    ctx: SimSpec
    params: dict
    #: step attempts of the lane-batched loop this lane ran in (the same
    #: for every lane of one call; finished lanes sit the last ones out)
    n_attempts: int = 0
    #: the lane's final integrator state (``CHECKPOINT_FIELDS``, numpy);
    #: ``tran(..., resume=sol.checkpoint)`` continues from it
    checkpoint: dict = None
    #: with ``TranOptions.store_vars``: stored name -> column of ``xs``;
    #: None when ``xs`` holds the whole state
    store_map: dict = None
    #: delay-ring lookups older than the ring's oldest sample once the ring
    #: no longer reaches back to the run's start (each read that oldest
    #: sample instead of the history it needed)
    n_ring_underflow: int = 0

    @property
    def t(self):
        return self.ts

    def __getitem__(self, name):
        if self.store_map is not None:
            key = name.lower()
            if key not in self.store_map:
                raise KeyError(
                    f"observable {name!r} was not stored: this run kept "
                    f"store_vars={sorted(self.store_map)}; run without "
                    "store_vars for the whole state")
            return np.asarray(self.xs[:, self.store_map[key]])
        fn = self.compiled.observe(name)
        dev, dt = self.compiled.device, self.compiled.dtype
        x = torch.as_tensor(self.xs, dtype=dt, device=dev)
        xd = torch.as_tensor(self.xdots, dtype=dt, device=dev)
        ctx = self.ctx.at_time(torch.as_tensor(self.ts, dtype=dt,
                                               device=dev))
        return fn(x, xd, ctx, self.params).cpu().numpy()

    def interp(self, name, t_eval):
        return np.interp(t_eval, self.ts, self[name])

    def interp_state(self, t_eval):
        """The whole state linearly interpolated at time(s) ``t_eval``:
        [n_x] for a scalar, [len(t), n_x] for a vector."""
        t = np.asarray(t_eval, dtype=float)
        xs = np.asarray(self.xs)
        return np.stack([np.interp(t, self.ts, xs[:, i])
                         for i in range(xs.shape[1])], axis=-1)


def xdot0_and_mask(compiled, x, ctx, params):
    """(ẋ0, lte_mask) from one model walk at the operating point, per lane:
    ẋ0 the minimum-norm solution of C·ẋ = −S (ridge-regularised normal
    equations), lte_mask 1.0 for unknowns with a nonzero column in C (all
    ones for an all-algebraic circuit).  ``x`` is [n_x] or [L, n_x].  CᵀC
    is ``linalg.normal_matrix`` (O(L·n²) memory, a lane's bits its own),
    λ added to its diagonal in place, the solve ``linalg.solve_lanes``."""
    ctx = ctx.with_mode(Modes.TRAN)
    jacs = compiled.res_jacs_fwd(x, ctx, params)
    S, C = jacs[0], jacs[3]
    del jacs                       # G and Q are not needed
    lam = 1e-12 * (C.abs().amax((-1, -2)) ** 2 + 1e-30)
    A = linalg.normal_matrix(C)
    A.diagonal(dim1=-2, dim2=-1).add_(lam[..., None])     # + λ·I
    xd0 = linalg.solve_lanes(A, -(C * S[..., :, None]).sum(-2))
    m = (C.abs().amax(-2) > 0).to(compiled.dtype)
    mask = torch.where(m.amax(-1, keepdim=True) > 0, m, torch.ones_like(m))
    return xd0, mask


def _consistent_xdot(compiled, x, ctx, params):
    """ẋ0 at the operating point (TRAN-mode model evaluation)."""
    return xdot0_and_mask(compiled, x, ctx, params)[0]


def _differential_mask(compiled, x, ctx, params):
    """1.0 for unknowns with charge/flux dynamics, 0.0 for algebraic ones."""
    return xdot0_and_mask(compiled, x, ctx, params)[1]


#: integrator state that makes a transient resumable: the point, the step
#: size and the history behind the predictor and the BDF corrector (the
#: JAX package's layout); per lane, with a leading lane axis.  A bdf5 run
#: adds its fifth history point (``BDF5_FIELDS``); a checkpoint without it
#: seeds it at the third and caps the ladder at order 4, as the JAX package
#: does on every resume.  A circuit with delay or latch slots adds the
#: latched aux vector and, with ring slots, the history ring
#: (``DELAY_FIELDS``; ``ring_t0`` is the port's own: the time back to which
#: the ring held samples when the run began)
CHECKPOINT_FIELDS = ("t", "h", "x", "xdot", "x1", "x2", "x3", "t1", "t2",
                     "t3", "nhist", "errp")
BDF5_FIELDS = ("x4", "t4")
DELAY_FIELDS = ("latw", "t_ring", "u_ring", "dly_td", "ring_t0")


def blank_checkpoint(x, xdot, h0):
    """A fresh checkpoint at an operating point (no predictor history, step
    ``h0``) to start a chain of windows with ``tran_core(init_state=)``;
    ``x``/``xdot`` may carry a leading lane axis, which the scalar fields
    take."""
    bshape = tuple(x.shape[:-1])
    z = torch.zeros(bshape, dtype=x.dtype, device=x.device)
    return dict(t=z, h=torch.full(bshape, float(h0), dtype=x.dtype,
                                  device=x.device),
                x=x, xdot=xdot, x1=x, x2=x, x3=x, t1=z, t2=z, t3=z,
                nhist=torch.zeros(bshape, dtype=torch.int32,
                                  device=x.device),
                errp=torch.ones(bshape, dtype=x.dtype, device=x.device))


def window_schedules(bps_all, edges):
    """Breakpoint schedules of the windows (edges[k], edges[k+1]], padded
    with inf to one length: each window's interior breakpoints, its end and
    inf (a copy of ``cedarsim_tpu/analysis/tran.py::window_schedules``)."""
    bps_all = np.asarray(bps_all, np.float64)
    win = []
    for a, b in zip(edges[:-1], edges[1:]):
        wb = bps_all[(bps_all > a) & (bps_all < b)]
        win.append(np.concatenate([wb, [b], [np.inf]]))
    L = max(len(w) for w in win)
    return np.stack([np.concatenate([w, np.full(L - len(w), np.inf)])
                     for w in win])


def bdf_alphas(ts, h, k):
    """The order-``k`` BDF coefficients a_j = h·L_j'(ts[0]), j = 0…k, of
    the Lagrange basis over the nodes ``ts`` (ts[0] the new time, then the
    history, newest first; [L] tensors), node gaps clamped away from 0 so
    that a fresh history's lanes stay finite (the order select ignores
    them).  At uniform spacing they are the textbook BDF values."""
    tiny = 1e-300
    out = []
    for j in range(k + 1):
        if j == 0:
            sm = 0.0
            for m in range(1, k + 1):
                sm = sm + 1.0 / (ts[0] - ts[m]).clamp(min=tiny)
            out.append(h * sm)
            continue
        num = h
        for m in range(1, k + 1):
            if m != j:
                num = num * (ts[0] - ts[m]).clamp(min=tiny)
        den = -(ts[0] - ts[j]).clamp(min=tiny)
        for m in range(1, k + 1):
            if m != j:
                dd = ts[j] - ts[m]
                den = den * (dd.clamp(min=tiny) if m > j
                             else dd.clamp(max=-tiny))
        out.append(num / den)
    return out


def _sel(m, a, b):
    """Per-lane select: ``m`` [L] bool over [L, ...] values."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    return torch.where(m.view((-1,) + (1,) * (max(a.dim(), b.dim()) - 1)),
                       a, b)


def tran_core(compiled: CompiledCircuit, params, ctx: SimSpec, x0, xdot0,
              t0, tstop, bps, h0, opts: TranOptions, lte_mask=None,
              init_state=None):
    """Adaptive transient over the lanes of ``x0`` [L, n_x] (or [n_x]).

    ``params`` leaves may carry the lane axis; ``bps`` is the breakpoint
    schedule shared by every lane (sorted, padded with tstop and inf);
    ``lte_mask`` [n_x] or [L, n_x].  ``init_state``: a checkpoint (a
    previous run's ``final``, or :func:`blank_checkpoint`) whose step size
    and predictor history the run resumes with; ``t0``, ``x0`` and
    ``xdot0`` must be the checkpoint's, and ``bps`` hold only breakpoints
    after ``t0``.  Returns ``(ts [L, 1+R], xs [L, 1+R, n_store], xdots, k
    [L], finished [L], n_rejected [L], n_newton [L], n_attempts, final)``:
    row 0 is the initial point, rows 1..k-1 the accepted points of each
    lane, the rows after them hold tstop and the lane's final state,
    ``n_attempts`` counts the batched step attempts and ``final`` is the
    checkpoint (``CHECKPOINT_FIELDS``, [L, ...] tensors) at the end; with
    ring slots it also holds each lane's ``n_ring_underflow``."""
    dt, dev = compiled.dtype, compiled.device
    x0 = torch.as_tensor(x0, dtype=dt, device=dev)
    xdot0 = torch.as_tensor(xdot0, dtype=dt, device=dev)
    opts = resolve_impl(compiled, opts, ctx, params, batched=x0.dim() == 2,
                        ad=ad_state(x0, xdot0, params))
    if x0.dim() == 1:
        x0, xdot0 = x0[None], xdot0[None]
    L, n = x0.shape
    lp = compiled.lane_params(params, L)
    t0, tstop, h0 = float(t0), float(tstop), float(h0)
    span = tstop - t0
    hmax = span * opts.hmax_frac
    hmin = span * opts.hmin_frac
    bps = torch.as_tensor(np.asarray(bps, np.float64), dtype=dt, device=dev)
    if bps.numel() == 0:
        bps = torch.tensor([tstop, np.inf], dtype=dt, device=dev)
    nb = bps.shape[0]
    ctx_t = ctx.with_mode(Modes.TRAN)
    if lte_mask is None:
        lte_mask = torch.ones(n, dtype=dt, device=dev)
    lte_mask = torch.as_tensor(lte_mask, dtype=dt, device=dev)

    if opts.formulation not in ("auto", "charge", "cap"):
        raise ValueError(f"unknown formulation {opts.formulation!r}")
    cap_form = cap_form_of(compiled, opts)
    method = opts.method
    if method == "auto":
        method = "bdf2" if cap_form else "trap"
    if method not in ("trap", "be", "bdf2", "bdf3", "bdf5"):
        raise ValueError(f"unknown integration method {method!r} "
                         "(trap | be | bdf2 | bdf3 | bdf5)")
    if opts.controller not in ("i", "pi"):
        raise ValueError(f"unknown controller {opts.controller!r}")
    n_dly, n_ring, n_lat = compiled.n_dly, compiled.n_ring, compiled.n_lat
    noisy = opts.noise_seed is not None and compiled.n_eps > 0
    fused = None
    if opts.newton_impl == "fused":
        # the envelope of the fused chord kernel, checked before any step
        if not cap_form:
            raise ValueError("newton_impl='fused' requires the cap-form "
                             "corrector (formulation='cap' or mixed-"
                             "precision eval_dtype)")
        if noisy or n_dly:
            raise ValueError("newton_impl='fused': noise injection and "
                             "delay/latch channels are not supported "
                             "in-kernel")
        if opts.jac_reuse < 1:
            raise ValueError("newton_impl='fused' requires jac_reuse >= 1")
        fused = fused_plan_for(compiled, ctx, params)
    sparse = use_sparse_solver(compiled)
    sops = get_sparse_ops(compiled) if sparse else None
    mn = opts.jac_reuse > 0
    # the cross-step cache carries dense (G, C): off on the sparse path,
    # where jac_reuse >= 2 is the per-step chord with its rescue
    mn_cross = opts.jac_reuse > 1 and not sparse
    mixed = opts.dense_lu == "mixed"
    if opts.store_vars is None:
        def proj(v):
            return v
    else:
        sv = torch.as_tensor(np.asarray(opts.store_vars, np.int64),
                             device=dev)

        def proj(v):
            return v[..., sv]
    n_store = n if opts.store_vars is None else len(opts.store_vars)
    # G and C: dense [L, n, n], or value vectors [L, nnz_f] in the sparse
    # LU's filled pattern; the Newton loops below take either
    jac_kind = "sparse" if sparse else True
    if sparse:
        lin_solve, c_apply = sops.solve, sops.matvec

        def damp_J(J):
            return sops.add_diag(J, opts.jac_shunt) if opts.jac_shunt else J
    else:
        lin_solve = linalg.chord_solve_once if mixed else linalg.solve_lanes
        c_apply = linalg.matvec
        nv = compiled.n_nodes + compiled.n_internal
        jsh = opts.jac_shunt * torch.diag(
            (torch.arange(n, device=dev) < nv).to(dt))

        def damp_J(J):
            return J + jsh if opts.jac_shunt else J

    def per_lane(a, like):
        """A per-lane scalar [L] shaped to broadcast against ``like``."""
        return a.view((-1,) + (1,) * (like.dim() - 1))

    def assemble(G, C, c0, a0, beta, h):
        """The corrector Jacobian c0·C/h + G (cap form) or a0·C/h + β·G
        (charge form), damped."""
        if cap_form:
            return damp_J(per_lane(c0, C) * C / per_lane(h, C) + G)
        return damp_J(per_lane(a0, C) * C / per_lane(h, C)
                      + per_lane(beta, G) * G)

    def ctx_at(t):
        return ctx_t.at_time(t)

    # the step attempt's noise inputs and delay/latch slots, held fixed
    # through its Newton iterations
    step_aux = dict(eps=None, dly=None)

    def ev(x, cx, **kw):
        return compiled.evaluate(x, cx, lp, eps=step_aux["eps"],
                                 dly=step_aux["dly"], **kw)

    def fres(x, S, Q, ic, a0, Qhist, Sn, beta, h):
        """Corrector residual and its scale (for the relative test)."""
        if cap_form:
            return ic + S, ic.abs() + S.abs()
        hh = h[:, None]
        f = (a0[:, None] * Q + Qhist) / hh + beta[:, None] * S \
            + (1.0 - beta[:, None]) * Sn
        scale = ((a0[:, None] * Q + Qhist).abs() / hh
                 + (beta[:, None] * S).abs()
                 + ((1.0 - beta[:, None]) * Sn).abs())
        return f, scale

    def converged(dx, xn, f_new, scale, bad):
        res_ok = (f_new.abs() <= opts.res_rel * scale
                  + opts.res_tol).all(-1)
        upd_ok = (dx.abs() <= opts.newton_reltol * xn.abs()
                  + opts.newton_abstol).all(-1)
        return upd_ok & res_ok & ~bad

    def limit(dx):
        bad = ~torch.isfinite(dx).all(-1)
        dx = torch.where(bad[:, None], torch.zeros_like(dx), dx)
        mx = dx.abs().amax(-1)
        return dx * torch.where(mx > 5.0, 5.0 / mx, 1.0)[:, None], bad

    def newton_step(x, t_new, h, a0, Qhist, Sn, beta, c0, xdh, seed):
        """Full Newton from the seed (S, Q, G, C, done, nnwt): every
        iteration re-assembles (G, C).  Lanes entering with done=True do not
        iterate."""
        S, Q, G, C, done, nnwt = seed
        it = torch.zeros(L, dtype=torch.int32, device=dev)
        cx = ctx_at(t_new)
        while True:
            active = ~done & (it < opts.max_newton)
            if not bool(active.any()):
                break
            ic = c_apply(C, (c0[:, None] * x + xdh) / h[:, None]) \
                if cap_form else torch.zeros_like(S)
            f, _ = fres(x, S, Q, ic, a0, Qhist, Sn, beta, h)
            J = assemble(G, C, c0, a0, beta, h)
            dx, bad = limit(lin_solve(J, -f))
            xn = x + dx
            Sn1, Qn1, Gn1, Cn1 = ev(xn, cx, jac=jac_kind)
            icn = c_apply(Cn1, (c0[:, None] * xn + xdh) / h[:, None]) \
                if cap_form else ic
            f_new, scale = fres(xn, Sn1, Qn1, icn, a0, Qhist, Sn, beta, h)
            dn = converged(dx, xn, f_new, scale, bad)
            x = _sel(active, xn, x)
            S, Q = _sel(active, Sn1, S), _sel(active, Qn1, Q)
            G, C = _sel(active, Gn1, G), _sel(active, Cn1, C)
            done = torch.where(active, dn, done)
            it = it + active.to(torch.int32)
            nnwt = nnwt + active.to(torch.int32)
        ok = done & torch.isfinite(x).all(-1)
        return x, S, Q, ok, nnwt

    def fparts(x, cx, c0, xdh, h):
        if cap_form:
            return ev(x, cx, v=(c0[:, None] * x + xdh) / h[:, None])
        S, Q = ev(x, cx)
        return S, Q, torch.zeros_like(S)

    def newton_mod(x, t_new, h, a0, Qhist, Sn, beta, c0, xdh, solve_fn,
                   init_parts, done):
        """Chord Newton with a frozen factored Jacobian and exact
        residuals."""
        S, Q, ic = init_parts
        cx = ctx_at(t_new)
        it = torch.zeros(L, dtype=torch.int32, device=dev)
        nnwt = torch.zeros(L, dtype=torch.int32, device=dev)
        while True:
            active = ~done & (it < opts.max_newton)
            if not bool(active.any()):
                break
            f, _ = fres(x, S, Q, ic, a0, Qhist, Sn, beta, h)
            dx, bad = limit(solve_fn(-f))
            xn = x + dx
            Sn1, Qn1, icn1 = fparts(xn, cx, c0, xdh, h)
            f_new, scale = fres(xn, Sn1, Qn1, icn1, a0, Qhist, Sn, beta, h)
            dn = converged(dx, xn, f_new, scale, bad)
            x = _sel(active, xn, x)
            S, Q, ic = (_sel(active, Sn1, S), _sel(active, Qn1, Q),
                        _sel(active, icn1, ic))
            done = torch.where(active, dn, done)
            it = it + active.to(torch.int32)
            nnwt = nnwt + active.to(torch.int32)
        ok = done & torch.isfinite(x).all(-1)
        return x, S, Q, ok, nnwt

    CH = opts.chunk_size
    cap_rows = -(-opts.max_steps // CH) * CH
    max_tries = 3 * opts.max_steps
    t_end = tstop - 1e-12 * span

    ctx0 = ctx_at(torch.full((L,), t0, dtype=dt, device=dev))
    rs = torch.as_tensor(compiled.ring_slots, device=dev)

    def with_ring(latw, ring):
        """The aux vector: the latched slots of ``latw`` and the ring
        slots' delayed values ``ring``."""
        if not n_lat:
            return ring
        out = latw.clone()
        out[:, rs] = ring
        return out

    def restored(f, shape):
        return torch.as_tensor(init_state[f], dtype=dt, device=dev).expand(
            shape).clone()

    dly_t0 = None
    if n_dly:
        # the ring holds the operating point before t0 (lookups before its
        # first sample clamp to it); a resumed run reads u(t0 − td) from
        # its restored ring, and its latched states from the checkpoint
        latw0 = compiled.latch_init(x0, ctx0, lp=lp)
        if init_state is not None and "latw" in init_state:
            latw0 = restored("latw", (L, n_dly))
        dly_t0 = latw0
        if n_ring:
            u0_d, td0_d = compiled.delay_sources(x0, ctx0, lp=lp)
            if init_state is not None and "t_ring" in init_state:
                KDr = np.asarray(init_state["t_ring"]).shape[-1]
                tr0 = restored("t_ring", (L, KDr))
                ur0 = restored("u_ring", (L, KDr, n_ring))
                ring0 = ring_interp(t0 - td0_d, tr0, ur0)
            else:
                ring0 = u0_d
            dly_t0 = with_ring(latw0, ring0)
    S0, Q0 = compiled.evaluate(x0, ctx0, lp, dly=dly_t0)
    zi = torch.zeros(L, dtype=torch.int32, device=dev)
    c = dict(
        t=torch.full((L,), t0, dtype=dt, device=dev),
        h=torch.full((L,), h0, dtype=dt, device=dev),
        x=x0, xdot=xdot0, Qn=Q0, Qp=Q0, Sn=S0, x1=x0, x2=x0,
        t1=torch.full((L,), t0, dtype=dt, device=dev),
        t2=torch.full((L,), t0, dtype=dt, device=dev),
        x3=x0, t3=torch.full((L,), t0, dtype=dt, device=dev),
        nhist=zi, bpi=zi, k=zi, nrej=zi, nnwt=zi, rrun=zi, nfr=zi,
        ok=torch.ones(L, dtype=torch.bool, device=dev),
        errp=torch.ones(L, dtype=dt, device=dev))
    # the deeper charge history of the higher orders (Qpp at x2, Qppp at
    # x3, Qpppp at x4) and bdf5's fifth history point
    if method in ("bdf3", "bdf5"):
        c.update(Qpp=Q0)
    if method == "bdf5":
        c.update(Qppp=Q0, Qpppp=Q0, x4=x0,
                 t4=torch.full((L,), t0, dtype=dt, device=dev))
    if n_dly:
        c.update(latw=latw0)
    if n_ring:
        KD = opts.delay_history
        c.update(t_ring=torch.full((L, KD), t0, dtype=dt, device=dev),
                 u_ring=u0_d[:, None, :].expand(L, KD, n_ring).clone(),
                 dly_td=td0_d, ring_t0=torch.full((L,), t0, dtype=dt,
                                                  device=dev),
                 nund=zi)
        if init_state is not None and "t_ring" in init_state:
            c.update(t_ring=tr0, u_ring=ur0,
                     dly_td=restored("dly_td", (L, n_ring)))
            c["ring_t0"] = (restored("ring_t0", (L,))
                            if "ring_t0" in init_state
                            else tr0[:, 0].clone())
    if mn_cross:
        # each lane's cached linearization; jage starts past any age so
        # that the first attempt refreshes, jfail forces a refresh at the
        # same h after a Newton failure with a stale Jacobian
        c.update(Gc=torch.zeros(L, n, n, dtype=dt, device=dev),
                 Cc=torch.zeros(L, n, n, dtype=dt, device=dev),
                 jage=torch.full((L,), 1 << 30, dtype=torch.int32,
                                 device=dev),
                 jfail=torch.zeros(L, dtype=torch.bool, device=dev))
    if init_state is not None:
        # step size and predictor history from the checkpoint (t, x and
        # xdot are t0, x0 and xdot0); the charge history at the restored
        # previous points
        deep = method == "bdf5" and all(f in init_state
                                        for f in BDF5_FIELDS)
        for f in CHECKPOINT_FIELDS + (BDF5_FIELDS if deep else ()):
            if f in ("t", "x", "xdot") or f not in init_state:
                continue
            v = torch.as_tensor(
                init_state[f], device=dev,
                dtype=torch.int32 if f == "nhist" else dt)
            c[f] = v.expand((L,) + tuple(c[f].shape[1:])).clone()

        def q_at(i):
            return compiled.evaluate(c[f"x{i}"], ctx_at(c[f"t{i}"]), lp)[1]

        if not n_dly:
            # (with delay slots the charge history stays at the seam's Q0,
            # as in the JAX package: Q at t1 would need the ring rewound)
            c["Qp"] = q_at(1)
            if method in ("bdf3", "bdf5"):
                c["Qpp"] = q_at(2)
            if method == "bdf5":
                c["Qppp"] = q_at(3)
                if deep:
                    c["Qpppp"] = q_at(4)
        if method == "bdf5" and not deep:
            # no fifth point: seed it at the third and hold the ladder at
            # order 4 until the history refills
            c["Qpppp"] = c["Qppp"]
            c["x4"], c["t4"] = c["x3"].clone(), c["t3"].clone()
            c["nhist"] = c["nhist"].clamp(max=3)
    # output rows (accepted points); grown by whole chunks, one spare row
    # at the end receives the masked writes of lanes that did not accept
    rows = 0
    ts_b = xs_b = xd_b = None
    lanes = torch.arange(L, device=dev)
    one = torch.ones(L, dtype=dt, device=dev)
    zero = torch.zeros(L, dtype=dt, device=dev)

    def grow_to(new_rows):
        nonlocal rows, ts_b, xs_b, xd_b
        pad = new_rows - rows
        tsn = torch.full((L, pad + 1), tstop, dtype=dt, device=dev)
        xsn = torch.zeros(L, pad + 1, n_store, dtype=dt, device=dev)
        if ts_b is None:
            ts_b, xs_b, xd_b = tsn, xsn, xsn.clone()
        else:
            ts_b = torch.cat([ts_b[:, :rows], tsn], 1)
            xs_b = torch.cat([xs_b[:, :rows], xsn], 1)
            xd_b = torch.cat([xd_b[:, :rows], xsn.clone()], 1)
        rows = new_rows

    def live(c):
        return ((c["t"] < t_end) & c["ok"]
                & (c["k"] + c["nrej"] < max_tries) & (c["k"] < cap_rows))

    if noisy:
        xi_tab = noise_draws(opts.noise_seed, cap_rows + 1, compiled.n_eps,
                             dev)

    def draw_eps(x, t, h_real, k):
        """White noise for the step of length h from (x, t): ε ~ N(0,
        pwr/(2h)) per source, the unit draw row k of the table (a retry at
        a smaller h rescales the same draw); 1/f sources excluded."""
        pwr, ex = compiled.noise_sources(x, ctx_at(t), params)
        sigma = torch.sqrt(pwr.clamp(min=0.0)
                           / (2.0 * h_real.clamp(min=1e-300))[:, None])
        return xi_tab[k.long()] * sigma * (ex == 0.0)

    def attempt(c):
        lv = live(c)
        t, h, x = c["t"], c["h"], c["x"]
        bi = c["bpi"].clamp(max=nb - 1).long()
        bcur = bps[bi]
        next_bp = torch.where((c["bpi"] >= nb) | (bcur <= t + 1e-12 * span),
                              torch.full_like(t, float("inf")), bcur)
        h_use = torch.minimum(h.clamp(max=hmax),
                              (next_bp - t).clamp(min=hmin))
        if n_ring:
            # h <= min(td)/2: at least two ring samples per delay
            h_use = torch.minimum(
                h_use, (0.5 * c["dly_td"].amin(-1)).clamp(min=hmin))
        h_use = torch.where(next_bp - t - h_use < 0.25 * h_use,
                            next_bp - t, h_use)
        hit_bp = t + h_use >= next_bp - 1e-12 * span
        t_new = torch.where(hit_bp, next_bp, t + h_use)
        h_real = t_new - t

        # predictor
        t1, t2, x1, x2, nh = c["t1"], c["t2"], c["x1"], c["x2"], c["nhist"]
        tiny = 1e-300
        d1 = torch.where((t > t1)[:, None],
                         (x - x1) / (t - t1).clamp(min=tiny)[:, None], 0.0)
        d1b = torch.where((t1 > t2)[:, None],
                          (x1 - x2) / (t1 - t2).clamp(min=tiny)[:, None],
                          0.0)
        d2 = torch.where((t > t2)[:, None],
                         (d1 - d1b) / (t - t2).clamp(min=tiny)[:, None], 0.0)
        x_lin = x + d1 * h_real[:, None]
        x_quad = x_lin + d2 * (h_real * (t_new - t1))[:, None]
        x_pred = torch.where((nh >= 2)[:, None], x_quad,
                             torch.where((nh >= 1)[:, None], x_lin, x))

        def ddiv(ta, tb, ya, yb):
            """(ya − yb)/(ta − tb) where ta > tb, else 0 (a fresh
            history's degenerate node gap)."""
            return torch.where((ta > tb)[:, None],
                               (ya - yb) / (ta - tb).clamp(min=tiny)[:, None],
                               0.0)

        if method in ("bdf3", "bdf5"):
            # cubic Newton-polynomial predictor over (t, x) … (t3, x3): one
            # order above the BDF3 corrector, so the predictor-corrector
            # difference gauges the h⁴ term
            t3, x3 = c["t3"], c["x3"]
            d1c = ddiv(t2, t3, x2, x3)
            d2b = ddiv(t1, t3, d1b, d1c)
            d3 = ddiv(t, t3, d2, d2b)
            x_cub = x_quad + d3 * h_real[:, None] * (t_new - t1)[:, None] \
                * (t_new - t2)[:, None]
            x_pred = torch.where((nh >= 3)[:, None], x_cub, x_pred)
        if method == "bdf5":
            # the quartic continuation through (t4, x4)
            t4, x4 = c["t4"], c["x4"]
            d1d = ddiv(t3, t4, x3, x4)
            d2c = ddiv(t2, t4, d1c, d1d)
            d3b = ddiv(t1, t4, d2b, d2c)
            d4 = ddiv(t, t4, d3, d3b)
            x_quart = x_cub + (d4 * h_real[:, None] * (t_new - t1)[:, None]
                               * (t_new - t2)[:, None]
                               * (t_new - t3)[:, None])
            x_pred = torch.where((nh >= 4)[:, None], x_quart, x_pred)

        use_be = nh == 0
        if method == "bdf2":
            hi = nh >= 1
            r = h_real / (t - t1).clamp(min=tiny)
            a0 = torch.where(hi, (1.0 + 2.0 * r) / (1.0 + r), one)
            a1 = torch.where(hi, -(1.0 + r), -one)
            a2 = torch.where(hi, r * r / (1.0 + r), zero)
            beta = one
        elif method == "bdf3":
            # order 1 + min(nhist, 2); uniform h at order 3 gives
            # (11/6, −3, 3/2, −1/3)
            hr = h_real
            e1 = h_real.clamp(min=tiny)                 # t_new − t
            e2 = (t_new - t1).clamp(min=tiny)
            e3 = (t_new - t2).clamp(min=tiny)
            f12 = (t - t1).clamp(min=tiny)
            f13 = (t - t2).clamp(min=tiny)
            f23 = (t1 - t2).clamp(min=tiny)
            o3 = (hr * (1.0 / e1 + 1.0 / e2 + 1.0 / e3),
                  -hr * e2 * e3 / (e1 * f12 * f13),
                  hr * e1 * e3 / (e2 * f12 * f23),
                  -hr * e1 * e2 / (e3 * f13 * f23))
            o2 = (hr * (1.0 / e1 + 1.0 / e2),
                  -hr * e2 / (e1 * f12),
                  hr * e1 / (e2 * f12))
            hi3, hi2 = nh >= 2, nh >= 1
            a0 = torch.where(hi3, o3[0], torch.where(hi2, o2[0], one))
            a1 = torch.where(hi3, o3[1], torch.where(hi2, o2[1], -one))
            a2 = torch.where(hi3, o3[2], torch.where(hi2, o2[2], zero))
            a3 = torch.where(hi3, o3[3], zero)
            beta = one
        elif method == "bdf5":
            # order 1 + min(nhist, 4); uniform h at order 5 gives
            # (137/60, −5, 5, −10/3, 5/4, −1/5)
            ts_n = (t_new, t, t1, t2, c["t3"], c["t4"])
            lags = [bdf_alphas(ts_n, h_real, k) + [one * 0.0] * (5 - k)
                    for k in (1, 2, 3, 4, 5)]

            def pick(j):
                v = lags[0][j]
                for ki in (2, 3, 4, 5):
                    v = torch.where(nh >= ki - 1, lags[ki - 1][j], v)
                return v

            a0, a1, a2, a3, a4, a5 = (pick(j) for j in range(6))
            beta = one
        elif method == "be":
            a0, a1, a2, beta = one, -one, zero, one
        else:
            a0, a1, a2 = one, -one, zero
            beta = torch.where(use_be, one, 0.5 * one)
        Qhist = a1[:, None] * c["Qn"] + a2[:, None] * c["Qp"]
        if method == "bdf3":
            Qhist = Qhist + a3[:, None] * c["Qpp"]
        elif method == "bdf5":
            Qhist = (Qhist + a3[:, None] * c["Qpp"]
                     + a4[:, None] * c["Qppp"] + a5[:, None] * c["Qpppp"])
        if method == "bdf2":
            c0 = a0
            xdh = a1[:, None] * x + a2[:, None] * x1
        elif method == "bdf3":
            c0 = a0
            xdh = a1[:, None] * x + a2[:, None] * x1 + a3[:, None] * x2
        elif method == "bdf5":
            c0 = a0
            xdh = (a1[:, None] * x + a2[:, None] * x1 + a3[:, None] * x2
                   + a4[:, None] * c["x3"] + a5[:, None] * c["x4"])
        elif method == "be":
            c0 = one
            xdh = -x
        else:
            c0 = torch.where(use_be, one, 2.0 * one)
            xdh = torch.where(use_be[:, None], -x,
                              -(2.0 * x + h_real[:, None] * c["xdot"]))

        more = {}
        step_aux["eps"] = draw_eps(x, t, h_real, c["k"]) if noisy else None
        dly_k = None
        if n_dly:
            dly_k = c["latw"]
            if n_ring:
                # u(t_new − td) from the ring; a lookup older than its
                # oldest sample once the ring no longer reaches back to
                # the run's start is an underflow
                q = t_new[:, None] - c["dly_td"]
                oldest = c["t_ring"][:, :1]
                under = ((q < oldest) & (oldest > c["ring_t0"][:, None]))
                more.update(nund=c["nund"] + torch.where(
                    lv, under.sum(-1), 0).to(torch.int32))
                dly_k = with_ring(c["latw"],
                                  ring_interp(q, c["t_ring"], c["u_ring"]))
        step_aux["dly"] = dly_k
        if mn:
            if mn_cross:
                # the cached (G, C) unless a lane refreshes: the walk runs
                # for all lanes then, and only refreshing lanes take it
                refresh = c["jfail"] | (c["jage"] >= opts.jac_reuse)
                G, C = c["Gc"], c["Cc"]
                if bool((refresh & lv).any()):
                    _, _, Gf, Cf = ev(x_pred, ctx_at(t_new), jac=True)
                    G, C = _sel(refresh, Gf, G), _sel(refresh, Cf, C)
            else:
                S0p, Q0p, G, C = ev(x_pred, ctx_at(t_new), jac=jac_kind)
            J = assemble(G, C, c0, a0, beta, h_real)
            if fused is not None:
                # one fused chord kernel launch for every lane's chord loop
                # (model walks, assembly, direction, tests); the rescue
                # below is unchanged
                xn, Sn_new, Qn_new, nok, nnwt = fused(
                    x_pred, J, fused.s_off(t_new, ctx_t, params), c0,
                    h_real, xdh, t_new, opts, params=params, live=lv)
            else:
                if mn_cross:
                    # (G, C) may be stale: the initial residual is walked
                    init_parts = fparts(x_pred, ctx_at(t_new), c0, xdh,
                                        h_real)
                else:
                    init_parts = (S0p, Q0p,
                                  c_apply(C, (c0[:, None] * x_pred + xdh)
                                          / h_real[:, None])
                                  if cap_form else torch.zeros_like(S0p))
                if sparse:
                    fct = sops.factorize(J)

                    def chord_solve(b):
                        return sops.solve_factorized(fct, J, b)
                elif mixed:
                    fct = linalg.chord_factor(J, nv)

                    def chord_solve(b):
                        return linalg.chord_backsolve(*fct, J, b)
                else:
                    fct = linalg.lu_factor_exact(J)

                    def chord_solve(b):
                        return linalg.lu_solve_exact(*fct, b)
                xn, Sn_new, Qn_new, nok, nnwt = newton_mod(
                    x_pred, t_new, h_real, a0, Qhist, c["Sn"], beta, c0,
                    xdh, chord_solve, init_parts, ~lv)
            if opts.chord_fallback and not mn_cross:
                eligible = c["nfr"] >= opts.rescue_after
                xfin = torch.isfinite(xn).all(-1)
                far = ~((xn - x_pred).abs().amax(-1) <= 5.0)
                from_pred = ~nok & (~xfin | far)
                sx = _sel(from_pred, x_pred, xn)
                sS = _sel(from_pred, S0p, Sn_new)
                sQ = _sel(from_pred, Q0p, Qn_new)
                done0 = nok | ~eligible | ~lv
                xn_r, Sn_r, Qn_r, nok_r, nnwt = newton_step(
                    sx, t_new, h_real, a0, Qhist, c["Sn"], beta, c0, xdh,
                    (sS, sQ, G, C, done0, nnwt))
                res = eligible & ~nok
                xn = _sel(res, xn_r, xn)
                Sn_new = _sel(res, Sn_r, Sn_new)
                Qn_new = _sel(res, Qn_r, Qn_new)
                nok = torch.where(res, nok_r, nok)
        else:
            S0s, Q0s, G0s, C0s = ev(x_pred, ctx_at(t_new), jac=jac_kind)
            xn, Sn_new, Qn_new, nok, nnwt = newton_step(
                x_pred, t_new, h_real, a0, Qhist, c["Sn"], beta, c0, xdh,
                (S0s, Q0s, G0s, C0s, ~lv, torch.zeros_like(c["k"])))

        # LTE error (predictor-corrector difference), differential vars only
        wt = opts.atol + opts.rtol * torch.maximum(xn.abs(), x.abs())
        lerr = (xn - x_pred).abs() / wt * lte_mask
        err = lerr.amax(-1) / opts.trtol
        have_lte = nh >= 2
        stalled = c["rrun"] >= opts.stall_accept
        lte_ok = ~have_lte | (err <= opts.accept_slack)
        accept = nok & (lte_ok | stalled)
        forced = accept & ~lte_ok

        # the step-ratio clamps of variable-step BDF's zero stability,
        # per active order
        if method == "bdf2":
            grow = min(opts.grow, 1.5) * one
        elif method == "bdf3":
            grow = torch.where(nh >= 2, min(opts.grow, 1.3) * one,
                               min(opts.grow, 1.5) * one)
        elif method == "bdf5":
            grow = torch.where(nh >= 3, min(opts.grow, 1.2) * one,
                               torch.where(nh >= 2, min(opts.grow, 1.3) * one,
                                           min(opts.grow, 1.5) * one))
        else:
            grow = opts.grow * one
        # the controller is detached from AD, as in the JAX package: a
        # sensitivity differentiates the realised discretisation, and a
        # tangent through h (via err(x)) would add spurious step-sequence
        # derivatives and put a tangent on ts
        err_ctl = err.detach()
        # order + 1 of the error estimate: h³ with the quadratic predictor,
        # h⁴ / h⁵ once the cubic / quartic one is active
        if method == "bdf3":
            p1 = torch.where(nh >= 3, 4.0 * one, 3.0 * one)
        elif method == "bdf5":
            p1 = torch.where(nh >= 4, 5.0 * one,
                             torch.where(nh >= 3, 4.0 * one, 3.0 * one))
        else:
            p1 = 3.0
        if opts.controller == "pi":
            errp = c["errp"].clamp(min=1e-10)
            err_s = err_ctl.clamp(min=1e-10)
            fac_raw = 0.9 * err_s ** (-0.7 / p1) * errp ** (0.4 / p1)
        else:
            fac_raw = 0.9 * err_ctl ** (-1.0 / p1)
        fac = torch.where(have_lte, torch.minimum(
            fac_raw.clamp(min=opts.shrink), grow), 2.0 * one)
        h_acc = (h_real * fac).clamp(hmin, hmax)
        bpi_acc = torch.searchsorted(bps, t_new + 1e-12 * span,
                                     right=False).to(torch.int32)
        next_int = torch.where(
            bpi_acc >= nb, tstop - t_new,
            bps[bpi_acc.clamp(max=nb - 1).long()] - t_new)
        h_bp = torch.maximum(
            torch.minimum(h_acc * opts.bp_restart,
                          0.05 * next_int.clamp(min=hmin)),
            torch.full_like(h_acc, hmin))
        h_acc = torch.where(hit_bp, h_bp, h_acc)
        h_rej = (h_real * torch.where(nok, torch.maximum(
            0.9 * err_ctl.clamp(min=1.0) ** (-1.0 / 3.0),
            torch.full_like(err_ctl, opts.shrink)), 0.25 * one)
        ).clamp(min=hmin)

        xdot_be = (xn - x) / h_real[:, None]
        if method == "bdf2":
            xdot_n = (a0[:, None] * xn + a1[:, None] * x
                      + a2[:, None] * x1) / h_real[:, None]
        elif method == "bdf3":
            xdot_n = (a0[:, None] * xn + a1[:, None] * x + a2[:, None] * x1
                      + a3[:, None] * x2) / h_real[:, None]
        elif method == "bdf5":
            xdot_n = (a0[:, None] * xn + a1[:, None] * x + a2[:, None] * x1
                      + a3[:, None] * x2 + a4[:, None] * c["x3"]
                      + a5[:, None] * c["x4"]) / h_real[:, None]
        elif method == "be":
            xdot_n = xdot_be
        else:
            xdot_n = torch.where(
                use_be[:, None], xdot_be,
                2.0 * (xn - x) / h_real[:, None] - c["xdot"])

        if mn_cross:
            # a Newton failure with a stale Jacobian keeps h: the retry
            # refreshes it
            stale_fail = ~nok & ~refresh
            h_rej = torch.where(stale_fail, h_real, h_rej)

        ok_cont = accept | (h_rej > hmin * 1.0000001)
        acc = accept & lv
        # output row: accepting lanes write row k, the others the spare row
        row = torch.where(acc, c["k"], torch.full_like(c["k"], rows)).long()
        ts_b[lanes, row] = t_new
        xs_b[lanes, row] = proj(xn)
        xd_b[lanes, row] = proj(xdot_n)
        new_nh = torch.where(hit_bp | forced, torch.zeros_like(nh),
                             (nh + 1).clamp(max=5 if method == "bdf5"
                                            else 3))
        if n_ring:
            # push the accepted sample (the times stay ascending) and the
            # delays of the next lookups
            u_now, td_new = compiled.delay_sources(xn, ctx_at(t_new), lp=lp)
            more.update(
                t_ring=_sel(acc, torch.cat([c["t_ring"][:, 1:],
                                            t_new[:, None]], 1),
                            c["t_ring"]),
                u_ring=_sel(acc, torch.cat([c["u_ring"][:, 1:],
                                            u_now[:, None]], 1),
                            c["u_ring"]),
                dly_td=_sel(acc, td_new, c["dly_td"]),
                ring_t0=c["ring_t0"])
        if n_dly:
            # the latch sites see the accepted solution (transition
            # re-targets its ramp, zi_* samples on its clock)
            latw = c["latw"]
            if n_lat:
                latw = _sel(acc, compiled.latch_update(
                    xn, ctx_at(t_new), dly_k, lp=lp), latw)
            more.update(latw=latw)
        if method in ("bdf3", "bdf5"):
            more.update(Qpp=_sel(acc, c["Qp"], c["Qpp"]))
        if method == "bdf5":
            more.update(Qppp=_sel(acc, c["Qpp"], c["Qppp"]),
                         Qpppp=_sel(acc, c["Qppp"], c["Qpppp"]),
                         x4=_sel(acc, c["x3"], c["x4"]),
                         t4=torch.where(acc, c["t3"], c["t4"]))
        if mn_cross:
            more.update(
                Gc=_sel(lv, G, c["Gc"]), Cc=_sel(lv, C, c["Cc"]),
                jage=torch.where(lv, torch.where(refresh, 1, c["jage"] + 1),
                                 c["jage"]).to(torch.int32),
                # a refresh after a stale failure or a breakpoint crossing
                jfail=torch.where(lv, stale_fail | (acc & hit_bp),
                                  c["jfail"]))
        return dict(
            **more,
            t=torch.where(acc, t_new, t),
            h=torch.where(lv, torch.where(accept, h_acc, h_rej), h),
            x=_sel(acc, xn, x),
            xdot=_sel(acc, xdot_n, c["xdot"]),
            Qn=_sel(acc, Qn_new, c["Qn"]),
            Qp=_sel(acc, c["Qn"], c["Qp"]),
            Sn=_sel(acc, Sn_new, c["Sn"]),
            x1=_sel(acc, x, c["x1"]),
            x2=_sel(acc, c["x1"], c["x2"]),
            x3=_sel(acc, c["x2"], c["x3"]),
            t1=torch.where(acc, t, c["t1"]),
            t2=torch.where(acc, c["t1"], c["t2"]),
            t3=torch.where(acc, c["t2"], c["t3"]),
            nhist=torch.where(acc, new_nh, nh),
            rrun=torch.where(lv, torch.where(accept, 0, c["rrun"] + 1),
                             c["rrun"]).to(torch.int32),
            nfr=torch.where(lv, torch.where(nok, 0, c["nfr"] + 1),
                            c["nfr"]).to(torch.int32),
            errp=torch.where(
                acc & have_lte & ~(hit_bp | forced),
                err_ctl.clamp(min=1e-10),
                torch.where(acc, one, c["errp"])),
            bpi=torch.where(acc, bpi_acc, c["bpi"]),
            k=c["k"] + acc.to(torch.int32),
            nrej=c["nrej"] + (lv & ~accept).to(torch.int32),
            nnwt=c["nnwt"] + torch.where(lv, nnwt, 0).to(torch.int32),
            ok=c["ok"] & (ok_cont | ~lv),
        )

    n_att = 0
    while True:
        if n_att % _HOST_CHECK_EVERY == 0:
            lv = live(c)
            if not bool(lv.any()):
                break
            kmax = int(c["k"].max())
            if kmax + _HOST_CHECK_EVERY > rows:
                grow_to(min(cap_rows, max(rows + CH, 2 * rows)))
        c = attempt(c)
        n_att += 1

    kmax = int(c["k"].max())
    if ts_b is None:
        grow_to(0)
    # rows past a lane's own k: tstop and the lane's final state
    written = torch.arange(kmax, device=dev)[None, :] < c["k"][:, None]
    ts_all = torch.where(written, ts_b[:, :kmax], tstop)
    xs_all = torch.where(written[..., None], xs_b[:, :kmax],
                         proj(c["x"])[:, None, :])
    xd_all = torch.where(written[..., None], xd_b[:, :kmax],
                         proj(c["xdot"])[:, None, :])
    ts_all = torch.cat([torch.full((L, 1), t0, dtype=dt, device=dev),
                        ts_all], 1)
    xs_all = torch.cat([proj(x0)[:, None], xs_all], 1)
    xd_all = torch.cat([proj(xdot0)[:, None], xd_all], 1)
    finished = c["ok"] & (c["t"] >= t_end)
    final = {f: c[f] for f in CHECKPOINT_FIELDS
             + (BDF5_FIELDS if method == "bdf5" else ())
             + tuple(f for f in DELAY_FIELDS if f in c)}
    if n_ring:
        final["n_ring_underflow"] = c["nund"]
    return (ts_all, xs_all, xd_all, c["k"] + 1, finished, c["nrej"],
            c["nnwt"], n_att, final)


def _store_columns(compiled, store_vars):
    """(state indices, stored name -> column) of ``store_vars`` (net names
    or indices), as the JAX package's ``tran`` resolves them."""
    idx, store_map = [], {}
    for col, v in enumerate(store_vars):
        if isinstance(v, str):
            net = compiled.circuit._nets.get(v.lower())
            if net is None or net.is_ground:
                raise ValueError(
                    f"store_vars: {v!r} is not a storable net (ground and "
                    "observables that are not states cannot be stored); "
                    f"nets: {compiled.node_names[:20]}...")
            i = net.index
        else:
            i = int(v)
            if not 0 <= i < compiled.n_x:
                raise ValueError(f"store_vars index {i} out of range "
                                 f"(n_x={compiled.n_x})")
        idx.append(i)
        name = (v.lower() if isinstance(v, str)
                else compiled.node_names[i] if i < len(compiled.node_names)
                else f"x{i}")
        store_map[name] = col
    return tuple(idx), store_map


def save_checkpoint(path, ckpt: dict):
    """Write a transient checkpoint (``sol.checkpoint``) to an ``.npz``
    file (the JAX package's ``save_checkpoint``)."""
    np.savez(path, **{k: torch.as_tensor(v).detach().cpu().numpy()
                      if isinstance(v, torch.Tensor) else np.asarray(v)
                      for k, v in ckpt.items()})


def load_checkpoint(path) -> dict:
    """A checkpoint from :func:`save_checkpoint`'s file, as numpy arrays;
    ``tran(resume=)`` puts them on the compiled circuit's device."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def tran(compiled: CompiledCircuit, tspan, params=None, ctx: SimSpec = None,
         opts: TranOptions = None, dc_opts: NewtonOptions = None, x0=None,
         resume: dict = None):
    """Transient analysis over ``tspan = (t0, tstop)``.

    One lane (params as compiled, ``x0`` None or [n_x]) returns a
    :class:`TranSolution`.  Lanes — ``params`` leaves with a leading lane
    axis and/or ``x0`` [L, n_x] — run together and return one
    ``TranSolution`` per lane.  Without ``x0`` the operating point is
    solved first (``Modes.TRANOP``; per lane when the lanes differ).
    ``resume``: a checkpoint (``sol.checkpoint``, or a dict of [L, ...]
    arrays for lanes) to continue from, with its step size and predictor
    history; the operating point is skipped and ``tspan[0]`` gives way to
    the checkpoint's time."""
    params = compiled.params0 if params is None else params
    if ctx is None:
        ctx = default_ctx(compiled)
    if opts is None:
        opts = (mixed_tran_options() if compiled.mixed
                and compiled.eval_dtype == torch.float32 else TranOptions())
    store_map = None
    if opts.store_vars is not None:
        idx, store_map = _store_columns(compiled, opts.store_vars)
        opts = dataclasses.replace(opts, store_vars=idx)
    dt, dev = compiled.dtype, compiled.device
    t0, tstop = float(tspan[0]), float(tspan[1])
    if resume is not None:
        tr = np.asarray(resume["t"], np.float64).reshape(-1)
        if not (tr == tr[0]).all():
            raise ValueError("checkpoint lanes stand at different times "
                             f"({tr.min()} to {tr.max()})")
        t0 = float(tr[0])
        if t0 >= tstop:
            raise ValueError(f"checkpoint time {t0} is already past "
                             f"tstop={tstop}")
        if "t_ring" in resume and \
                np.asarray(resume["t_ring"]).shape[-1] != opts.delay_history:
            raise ValueError(
                f"checkpoint delay-history ring has "
                f"{np.asarray(resume['t_ring']).shape[-1]} slots but "
                f"TranOptions.delay_history={opts.delay_history}; resume "
                "with the delay_history the checkpoint was saved with")
        x0 = resume["x"]
    span = tstop - t0
    bps = compiled.breakpoints(tstop)
    bps = np.concatenate([bps[bps > t0], [tstop], [np.inf]])
    h0 = opts.h0 if opts.h0 is not None else span * 1e-6
    if len(bps) > 2:
        h0 = min(h0, max(float(bps[0] - t0) * 0.1, span * 1e-9))

    L = None
    if x0 is not None:
        x0 = torch.as_tensor(x0, dtype=dt, device=dev)
        L = x0.shape[0] if x0.dim() == 2 else None
    for key, grp in params.items():
        for pn, v in grp.items():
            if torch.as_tensor(v).dim() == compiled.params0[key][pn].dim() + 1:
                L = torch.as_tensor(v).shape[0]
    batched = L is not None
    opts = resolve_impl(compiled, opts, ctx, params, batched=batched,
                        ad=ad_state(params, x0))
    Lr = L if batched else 1
    converged0 = torch.ones(Lr, dtype=torch.bool, device=dev)
    if x0 is None:
        if opts.uic:
            x0 = torch.zeros(compiled.n_x, dtype=dt, device=dev)
            for name, v in compiled.circuit.ics.items():
                net = compiled.circuit._nets[name]
                if not net.is_ground:
                    x0[net.index] = v
        else:
            xin = None
            if batched:
                xin = torch.zeros(Lr, compiled.n_x, dtype=dt, device=dev)
            res = solve_dc(compiled, params, ctx, x0=xin, opts=dc_opts,
                           mode=Modes.TRANOP)
            x0 = res.x
            converged0 = res.converged.reshape(-1)
    x0b = x0.expand(Lr, compiled.n_x) if x0.dim() == 1 else x0
    ctx_op = ctx.with_mode(Modes.TRANOP).at_time(t0)
    xdot0, lte_mask = xdot0_and_mask(compiled, x0b, ctx_op, params)
    if resume is not None:
        xdot0 = torch.as_tensor(resume["xdot"], dtype=dt,
                                device=dev).expand(Lr, compiled.n_x)
    ts, xs, xd, k, fin, nrej, nnwt, n_att, final = tran_core(
        compiled, params, ctx, x0b, xdot0, t0, tstop, bps, h0, opts,
        lte_mask, init_state=resume)
    ts, xs, xd = ts.cpu().numpy(), xs.cpu().numpy(), xd.cpu().numpy()
    k, fin = k.cpu().numpy(), (fin & converged0).cpu().numpy()
    nrej, nnwt = nrej.cpu().numpy(), nnwt.cpu().numpy()
    final = {f: v.cpu().numpy() for f, v in final.items()}
    nund = final.pop("n_ring_underflow", np.zeros(Lr, np.int64))
    sols = []
    for i in range(Lr):
        pi = params
        if batched:
            pi = {key: {pn: (v[i] if torch.as_tensor(v).dim()
                             == compiled.params0[key][pn].dim() + 1 else v)
                        for pn, v in grp.items()}
                  for key, grp in params.items()}
        ki = int(k[i])
        sols.append(TranSolution(
            ts=ts[i, :ki], xs=xs[i, :ki], xdots=xd[i, :ki],
            converged=bool(fin[i]), n_accepted=ki,
            n_rejected=int(nrej[i]), n_newton=int(nnwt[i]),
            compiled=compiled, ctx=ctx.with_mode(Modes.TRAN), params=pi,
            n_attempts=n_att,
            checkpoint={f: v[i] for f, v in final.items()},
            store_map=store_map, n_ring_underflow=int(nund[i])))
    return sols if batched else sols[0]
