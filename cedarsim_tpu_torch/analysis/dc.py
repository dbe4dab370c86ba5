"""DC operating point: damped Newton with gmin-stepping and source-stepping
continuation, plus randomized-restart bootstrap (counterpart of
``cedarsim_tpu/analysis/dc.py``).

The JAX package runs the whole strategy as one ``lax.scan`` over a static
schedule of (gshunt, sourcefac, reset-kind, is-final) rows, only to save TPU
compile time.  Here the same schedule is a host loop, and each rung's Newton
iteration runs over an explicit lane axis with per-lane done masks: a lane's
result does not depend on the other lanes, as under ``jax.vmap``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cedarsim_tpu_torch.core.compile import CompiledCircuit, default_ctx
from cedarsim_tpu_torch.core.context import SimSpec, Modes
from cedarsim_tpu_torch.ops import linalg


@dataclasses.dataclass(frozen=True)
class NewtonOptions:
    max_iter: int = 60
    #: per-unknown update tolerance: |dx| <= reltol·|x| + abstol
    reltol: float = 1e-4
    abstol: float = 1e-9
    #: residual tolerance (KCL in amps / branch eq in volts)
    res_tol: float = 1e-9
    #: max Newton update per unknown per iteration (voltage limiting)
    max_step: float = 5.0
    #: global iterate bound |x_i| <= x_limit (SPICE-style node limiting)
    x_limit: float = 1e3
    #: Jacobian-only diagonal shunt (inexact Newton damping)
    jac_shunt: float = 0.0
    #: gmin continuation ladder length (decades from gmin_start)
    gmin_steps: int = 10
    gmin_start: float = 1e-2
    #: source stepping points
    src_steps: int = 8
    #: randomized restarts
    restarts: int = 4


@dataclasses.dataclass
class DCResult:
    x: torch.Tensor          # [n_x] or [L, n_x]
    converged: torch.Tensor  # [] or [L] bool
    iters: torch.Tensor
    resnorm: torch.Tensor
    compiled: CompiledCircuit = None
    ctx: SimSpec = None
    params: dict = None

    def __getitem__(self, name):
        """Named observable at the operating point (one value per lane for
        a batched result)."""
        if self.compiled is None:
            raise TypeError("this DCResult carries no circuit context")
        fn = self.compiled.observe(name)
        return fn(self.x, torch.zeros_like(self.x), self.ctx, self.params)


def default_newton_options(compiled) -> NewtonOptions:
    """Defaults for float64 model evaluation (the only eval precision the
    port has)."""
    return NewtonOptions()


# reset kinds in the continuation schedule
_KEEP, _FROM_X0, _FROM_ZERO, _FROM_RANDOM = 0, 1, 2, 3


def _schedule(opts: NewtonOptions):
    """Static continuation schedule: (gshunt, srcfac, reset, final)."""
    rows = [(0.0, 1.0, _FROM_X0, True)]                      # plain attempt
    for g in np.logspace(np.log10(opts.gmin_start), -14.0, opts.gmin_steps):
        rows.append((float(g), 1.0, _KEEP, False))           # gmin ladder
    rows.append((0.0, 1.0, _KEEP, True))                     # polish
    lams = np.linspace(0.1, 1.0, opts.src_steps)
    for i, lam in enumerate(lams):
        rows.append((0.0, float(lam), _FROM_ZERO if i == 0 else _KEEP,
                     False))
    rows.append((0.0, 1.0, _KEEP, True))                     # polish
    for _ in range(opts.restarts):
        rows.append((0.0, 1.0, _FROM_RANDOM, True))          # bootstraps
    return rows


def dc_core(compiled: CompiledCircuit, params, ctx: SimSpec, x0,
            opts: NewtonOptions, ic_mask=None, ic_vals=None,
            generator=None) -> DCResult:
    """DC solve with continuation over lanes: ``x0`` is [L, n_x] (or [n_x]
    for one lane); ``params`` leaves may carry the lane axis.  Restart draws
    come from ``generator`` (default: a fresh one seeded with 1234), one
    draw per restart rung shared by every lane."""
    dt, dev = compiled.dtype, compiled.device
    x0 = torch.as_tensor(x0, dtype=dt, device=dev)
    single = x0.dim() == 1
    x0 = x0[None] if single else x0
    L, n = x0.shape
    lp = compiled.lane_params(params, L)
    nv = compiled.n_nodes + compiled.n_internal
    vmask = (torch.arange(n, device=dev) < nv).to(dt)
    base_g = ctx.gmin
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(1234)
    eye = torch.eye(n, dtype=dt, device=dev)

    def res_jac(x, gshunt, srcfac):
        c = ctx.replace(sourcefac=ctx.sourcefac * srcfac)
        S, _, G, _ = compiled.evaluate(x, c, lp, jac=True)
        f = S + (gshunt + base_g) * vmask * x
        J = G + eye * ((gshunt + base_g + opts.jac_shunt) * vmask)
        if ic_mask is not None:
            f = f * (1.0 - ic_mask) + ic_mask * (x - ic_vals)
            J = J * (1.0 - ic_mask)[:, None] + torch.diag(ic_mask)
        return f, J

    def newton(x_init, run, gshunt, srcfac):
        """Damped Newton over the lanes in ``run`` [L] bool; the others are
        returned untouched with ok False."""
        x = x_init
        f, J = res_jac(x, gshunt, srcfac)
        done = torch.zeros(L, dtype=torch.bool, device=dev)
        it = torch.zeros(L, dtype=torch.int32, device=dev)
        while True:
            active = run & ~done & (it < opts.max_iter)
            if not bool(active.any()):
                break
            dx = linalg.solve(J, -f)
            bad = ~torch.isfinite(dx).all(-1)
            dx = torch.where(bad[:, None], torch.zeros_like(dx), dx)
            mx = dx.abs().amax(-1)
            dx = dx * torch.where(mx > opts.max_step, opts.max_step / mx,
                                  1.0)[:, None]
            xn = (x + dx).clamp(-opts.x_limit, opts.x_limit)
            fn, Jn = res_jac(xn, gshunt, srcfac)
            dn = ((dx.abs() <= opts.reltol * xn.abs() + opts.abstol).all(-1)
                  & (fn.abs() <= opts.res_tol).all(-1) & ~bad)
            a2 = active[:, None]
            x = torch.where(a2, xn, x)
            f = torch.where(a2, fn, f)
            J = torch.where(active[:, None, None], Jn, J)
            done = torch.where(active, dn, done)
            it = it + active.to(torch.int32)
        ok = done & torch.isfinite(x).all(-1)
        return x, ok, it, f.abs().amax(-1)

    x = x0
    best_x = x0
    best_ok = torch.zeros(L, dtype=torch.bool, device=dev)
    best_fn = torch.full((L,), float("inf"), dtype=dt, device=dev)
    iters = torch.zeros(L, dtype=torch.int32, device=dev)
    for g, lam, reset, final in _schedule(opts):
        if reset == _FROM_RANDOM:
            xr = torch.randn(n, generator=generator, dtype=dt,
                             device=dev) * 1e-7
        if bool(best_ok.all()):
            continue           # every lane converged: the rungs are skips
        run = ~best_ok
        x_init = {_KEEP: lambda: x, _FROM_X0: lambda: x0,
                  _FROM_ZERO: lambda: torch.zeros_like(x),
                  _FROM_RANDOM: lambda: xr.expand(L, n)}[reset]()
        xn, ok, it, fn = newton(x_init, run, g, lam)
        # never carry a diverged iterate into the next rung
        sane = torch.isfinite(xn).all(-1) & (xn.abs().amax(-1)
                                             < opts.x_limit)
        xn = torch.where((ok | sane)[:, None], xn, x_init)
        # skipped lanes (already converged) keep their carry
        x = torch.where(run[:, None], xn, x)
        ok = ok & run
        fn = torch.where(run, fn, torch.full_like(fn, float("inf")))
        iters = iters + torch.where(run, it, torch.zeros_like(it))
        win = ok & ~best_ok if final else torch.zeros_like(ok)
        best_x = torch.where(win[:, None], xn, best_x)
        best_fn = torch.where(win, fn, best_fn)
        best_ok = best_ok | win
    x_out = torch.where(best_ok[:, None], best_x, x)
    if single:
        return DCResult(x_out[0], best_ok[0], iters[0], best_fn[0])
    return DCResult(x_out, best_ok, iters, best_fn)


def ic_arrays(compiled: CompiledCircuit):
    """(mask, vals) tensors for the circuit's ``.ic`` pins (zeros if none)."""
    mask = np.zeros(compiled.n_x)
    vals = np.zeros(compiled.n_x)
    for name, v in compiled.circuit.ics.items():
        net = compiled.circuit._nets[name]
        if not net.is_ground:
            mask[net.index] = 1.0
            vals[net.index] = v
    return (torch.as_tensor(mask, dtype=compiled.dtype,
                            device=compiled.device),
            torch.as_tensor(vals, dtype=compiled.dtype,
                            device=compiled.device))


def solve_dc(compiled: CompiledCircuit, params=None, ctx: SimSpec = None,
             x0=None, opts: NewtonOptions = None, mode=Modes.DCOP,
             use_ics=None) -> DCResult:
    """Solve the DC operating point.  ``params`` defaults to the compiled
    nominal values.  ``use_ics``: pin ``.ic``'d nodes during the solve
    (default: only for the transient operating point)."""
    opts = opts or default_newton_options(compiled)
    params = compiled.params0 if params is None else params
    ctx = (default_ctx(compiled) if ctx is None else ctx).with_mode(mode)
    if use_ics is None:
        use_ics = mode == Modes.TRANOP
    use_ics = use_ics and bool(compiled.circuit.ics)
    mask, vals = ic_arrays(compiled)
    if x0 is None:
        x0 = torch.zeros(compiled.n_x, dtype=compiled.dtype,
                         device=compiled.device)
        for name, v in compiled.circuit.nodesets.items():
            net = compiled.circuit._nets.get(name)
            if net is not None and not net.is_ground:
                x0[net.index] = v
        x0 = torch.where(mask > 0, vals, x0) if use_ics else x0
    res = dc_core(compiled, params, ctx, x0, opts,
                  ic_mask=mask if use_ics else None, ic_vals=vals)
    res.compiled, res.ctx, res.params = compiled, ctx, params
    return res
