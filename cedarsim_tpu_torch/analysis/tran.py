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
from cedarsim_tpu_torch.ops.fused_chord import (FusedEnvelopeError,
                                                get_fused_plan, split_lanes)
from cedarsim_tpu_torch.analysis.dc import NewtonOptions, solve_dc

_A14 = "ROADMAP A14b"

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
    #: order 1-2) or "auto": trap for the charge formulation, bdf2 for the
    #: cap formulation.  bdf3/bdf5 are ROADMAP A14b.
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
    #: corrector formulation: "charge", "cap", or "auto" (charge: the port
    #: evaluates models in float64 only)
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


def resolve_impl(compiled: CompiledCircuit, opts: TranOptions, ctx=None,
                 params=None, batched=True):
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
    the JAX package's does."""
    dl, ni = opts.dense_lu, opts.newton_impl
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
    """"fused" when the corrector is the cap form, ``jac_reuse == 1``, the
    fused plan builds, the temperature is one value (the plan bakes it)
    and every per-lane leaf of ``params`` reaches the kernel
    (``dyn_leaf_safe``); else "xla".  Only
    :class:`~cedarsim_tpu_torch.ops.fused_chord.FusedEnvelopeError` counts
    as "outside the envelope": any other failure (an emit, a build)
    propagates."""
    if opts.formulation != "cap" or opts.jac_reuse != 1:
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
#: size and the three-point history behind the predictor and the BDF2
#: corrector (``x3``/``t3`` are carried for the JAX package's checkpoint
#: layout, whose BDF3 reads them); per lane, with a leading lane axis
CHECKPOINT_FIELDS = ("t", "h", "x", "xdot", "x1", "x2", "x3", "t1", "t2",
                     "t3", "nhist", "errp")


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
    checkpoint (``CHECKPOINT_FIELDS``, [L, ...] tensors) at the end."""
    dt, dev = compiled.dtype, compiled.device
    x0 = torch.as_tensor(x0, dtype=dt, device=dev)
    xdot0 = torch.as_tensor(xdot0, dtype=dt, device=dev)
    opts = resolve_impl(compiled, opts, ctx, params, batched=x0.dim() == 2)
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
    cap_form = opts.formulation == "cap"
    method = opts.method
    if method == "auto":
        method = "bdf2" if cap_form else "trap"
    if method in ("bdf3", "bdf5"):
        raise NotImplementedError(f"method={method!r} is {_A14}")
    if method not in ("trap", "be", "bdf2"):
        raise ValueError(f"unknown integration method {method!r}")
    if opts.controller not in ("i", "pi"):
        raise ValueError(f"unknown controller {opts.controller!r}")
    fused = None
    if opts.newton_impl == "fused":
        # the envelope of the fused chord kernel, checked before any step
        if not cap_form:
            raise ValueError("newton_impl='fused' requires the cap-form "
                             "corrector (formulation='cap')")
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
            Sn1, Qn1, Gn1, Cn1 = compiled.evaluate(xn, cx, lp, jac=jac_kind)
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
            return compiled.evaluate(
                x, cx, lp, v=(c0[:, None] * x + xdh) / h[:, None])
        S, Q = compiled.evaluate(x, cx, lp)
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

    S0, Q0 = compiled.evaluate(x0, ctx_at(torch.full((L,), t0, dtype=dt,
                                                     device=dev)), lp)
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
        # previous point
        for f in CHECKPOINT_FIELDS:
            if f in ("t", "x", "xdot") or f not in init_state:
                continue
            v = torch.as_tensor(
                init_state[f], device=dev,
                dtype=torch.int32 if f == "nhist" else dt)
            c[f] = v.expand((L,) + tuple(c[f].shape[1:])).clone()
        c["Qp"] = compiled.evaluate(c["x1"], ctx_at(c["t1"]), lp)[1]
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

    def attempt(c):
        lv = live(c)
        t, h, x = c["t"], c["h"], c["x"]
        bi = c["bpi"].clamp(max=nb - 1).long()
        bcur = bps[bi]
        next_bp = torch.where((c["bpi"] >= nb) | (bcur <= t + 1e-12 * span),
                              torch.full_like(t, float("inf")), bcur)
        h_use = torch.minimum(h.clamp(max=hmax),
                              (next_bp - t).clamp(min=hmin))
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

        use_be = nh == 0
        if method == "bdf2":
            hi = nh >= 1
            r = h_real / (t - t1).clamp(min=tiny)
            a0 = torch.where(hi, (1.0 + 2.0 * r) / (1.0 + r), one)
            a1 = torch.where(hi, -(1.0 + r), -one)
            a2 = torch.where(hi, r * r / (1.0 + r), zero)
            beta = one
        elif method == "be":
            a0, a1, a2, beta = one, -one, zero, one
        else:
            a0, a1, a2 = one, -one, zero
            beta = torch.where(use_be, one, 0.5 * one)
        Qhist = a1[:, None] * c["Qn"] + a2[:, None] * c["Qp"]
        if method == "bdf2":
            c0 = a0
            xdh = a1[:, None] * x + a2[:, None] * x1
        elif method == "be":
            c0 = one
            xdh = -x
        else:
            c0 = torch.where(use_be, one, 2.0 * one)
            xdh = torch.where(use_be[:, None], -x,
                              -(2.0 * x + h_real[:, None] * c["xdot"]))

        if mn:
            if mn_cross:
                # the cached (G, C) unless a lane refreshes: the walk runs
                # for all lanes then, and only refreshing lanes take it
                refresh = c["jfail"] | (c["jage"] >= opts.jac_reuse)
                G, C = c["Gc"], c["Cc"]
                if bool((refresh & lv).any()):
                    _, _, Gf, Cf = compiled.evaluate(
                        x_pred, ctx_at(t_new), lp, jac=True)
                    G, C = _sel(refresh, Gf, G), _sel(refresh, Cf, C)
            else:
                S0p, Q0p, G, C = compiled.evaluate(x_pred, ctx_at(t_new),
                                                   lp, jac=jac_kind)
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
                    fct = linalg.chord_factor(J)

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
            S0s, Q0s, G0s, C0s = compiled.evaluate(x_pred, ctx_at(t_new), lp,
                                                   jac=jac_kind)
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

        grow = min(opts.grow, 1.5) if method == "bdf2" else opts.grow
        err_ctl = err
        p1 = 3.0
        if opts.controller == "pi":
            errp = c["errp"].clamp(min=1e-10)
            err_s = err_ctl.clamp(min=1e-10)
            fac_raw = 0.9 * err_s ** (-0.7 / p1) * errp ** (0.4 / p1)
        else:
            fac_raw = 0.9 * err_ctl ** (-1.0 / p1)
        fac = torch.where(have_lte, fac_raw.clamp(opts.shrink, grow),
                          2.0 * one)
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
                             (nh + 1).clamp(max=3))
        cross = {}
        if mn_cross:
            cross = dict(
                Gc=_sel(lv, G, c["Gc"]), Cc=_sel(lv, C, c["Cc"]),
                jage=torch.where(lv, torch.where(refresh, 1, c["jage"] + 1),
                                 c["jage"]).to(torch.int32),
                # a refresh after a stale failure or a breakpoint crossing
                jfail=torch.where(lv, stale_fail | (acc & hit_bp),
                                  c["jfail"]))
        return dict(
            **cross,
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
    final = {f: c[f] for f in CHECKPOINT_FIELDS}
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
    opts = opts or TranOptions()
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
    opts = resolve_impl(compiled, opts, ctx, params, batched=batched)
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
            store_map=store_map))
    return sols if batched else sols[0]
