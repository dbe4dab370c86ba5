"""Parameter sensitivities (counterpart of
``cedarsim_tpu/analysis/sensitivity.py``).

DC: exact implicit differentiation at the solved operating point.  F(x*, p)
= 0, so the adjoint form takes one solve Gᵀλ = ∂obs/∂x and then dobs/dp =
∂obs/∂p − λᵀ·∂F/∂p, the two vector-Jacobian products by
``torch.autograd.grad`` on the residuals and on the observable with the
parameter leaves requiring grad.

Transient: forward-mode AD (``torch.autograd.forward_ad``) through the
explicit-lane integrator ``tran_core``, as the JAX package's ``jax.jvp``
through its ``lax.while_loop``.  The host control flow reads only primals;
the step controller is detached (``tran_core``), so the derivative is that
of the realised discretisation; under AD the chord loop takes the exact
float64 solve (``tran.resolve_impl``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from cedarsim_tpu_torch.analysis.dc import solve_dc
from cedarsim_tpu_torch.core.compile import (CompiledCircuit, default_ctx,
                                             ensure_dynamic)
from cedarsim_tpu_torch.core.context import Modes, SimSpec
from cedarsim_tpu_torch.ops import linalg
from cedarsim_tpu_torch.ops.ad import ForwardTangents


def _obs_dx(obs, x, ctx, params):
    """∂obs/∂x [n_x] at (x, ẋ = 0)."""
    xx = x.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        y = obs(xx, torch.zeros_like(xx), ctx, params)
        if not y.requires_grad:
            return torch.zeros_like(x)
        g, = torch.autograd.grad(y, xx, allow_unused=True)
    return torch.zeros_like(x) if g is None else g


def _with_grad_leaves(compiled, params, wrt):
    """A copy of ``params`` whose leaves named in ``wrt`` are fresh tensors
    that require grad, and {name: (leaf, instance index)}."""
    new = {key: dict(grp) for key, grp in params.items()}
    leaves, out = {}, {}
    for name in wrt:
        key, j, pname = compiled.param_loc(name)
        if (key, pname) not in leaves:
            v = torch.as_tensor(new[key][pname], dtype=compiled.dtype,
                                device=compiled.device)
            leaves[(key, pname)] = v.detach().clone().requires_grad_(True)
            new[key][pname] = leaves[(key, pname)]
        out[name] = (leaves[(key, pname)], j)
    return new, out


def dc_sensitivity(compiled: CompiledCircuit, observable: str, wrt: list,
                   params=None, ctx: SimSpec = None, opts=None,
                   mode=Modes.DCOP):
    """d(observable)/d(param) for each dotted param name in ``wrt``.

    Returns (value, {name: gradient}) as 0-d tensors.  The adjoint form:
    one linear solve in all, then one vector-Jacobian product each on the
    residuals and on the observable."""
    return _dc_adjoint(compiled, observable, wrt, params, ctx, opts,
                       mode)[:2]


def _dc_adjoint(compiled, observable, wrt, params, ctx, opts, mode):
    """:func:`dc_sensitivity`'s (value, gradients) and the operating point
    x, G = ∂S/∂x and e = ∂obs/∂x it took them at."""
    compiled = ensure_dynamic(compiled, wrt)
    params = compiled.params0 if params is None else params
    ctx = (default_ctx(compiled) if ctx is None else ctx).with_mode(mode)
    x = solve_dc(compiled, params, ctx, opts=opts, mode=mode).x.detach()
    obs = compiled.observe(observable)
    G, _ = compiled.jacobians(x, ctx, params)
    e = _obs_dx(obs, x, ctx, params)
    lam = linalg.solve(G.T, e)
    p, locs = _with_grad_leaves(compiled, params, wrt)
    leaves = list({id(lf): lf for lf, _ in locs.values()}.values())
    with torch.enable_grad():
        S, _ = compiled.residuals(x, ctx, p)
        dF = torch.autograd.grad((S * lam).sum(), leaves, allow_unused=True)
        y = obs(x, torch.zeros_like(x), ctx, p)
        dO = (torch.autograd.grad(y, leaves, allow_unused=True)
              if y.requires_grad else [None] * len(leaves))
    by_leaf = {id(lf): (f, o) for lf, f, o in zip(leaves, dF, dO)}
    out = {}
    for name, (leaf, j) in locs.items():
        f, o = by_leaf[id(leaf)]
        fj = torch.zeros((), dtype=x.dtype, device=x.device) if f is None \
            else f[j]
        oj = torch.zeros_like(fj) if o is None else o[j]
        out[name] = oj - fj
    return y.detach(), out, x, G, e


def _carry_tangent(compiled, params, wrt):
    """``params`` with the leaf of ``wrt`` (one instance's param) carrying
    a unit forward tangent at that instance (call inside a dual level)."""
    key, j, pname = compiled.param_loc(wrt)
    v = torch.as_tensor(params[key][pname], dtype=compiled.dtype,
                        device=compiled.device)
    tan = torch.zeros_like(v)
    tan[j] = 1.0
    new = dict(params)
    new[key] = dict(new[key])
    new[key][pname] = fwAD.make_dual(v, tan)
    return new


def tran_sensitivity(compiled, observable: str, wrt: str, tspan, t_eval,
                     params=None, ctx=None, opts=None):
    """d(observable at ``t_eval``)/d(param ``wrt``) by forward-mode AD
    through the whole adaptive transient.  As in the JAX package the
    operating point, ẋ0, the LTE mask and the breakpoints are taken at the
    nominal params, outside the differentiated run, and the value at
    ``t_eval`` is the linear interpolation of x and ẋ between the accepted
    points around it.  Returns (value, derivative) as 0-d tensors."""
    from cedarsim_tpu_torch.analysis.tran import (TranOptions, tran_core,
                                                  xdot0_and_mask)
    compiled = ensure_dynamic(compiled, [wrt])
    params = compiled.params0 if params is None else params
    ctx = default_ctx(compiled) if ctx is None else ctx
    opts = opts or TranOptions(max_steps=4096)
    t0, tstop = float(tspan[0]), float(tspan[1])
    op = solve_dc(compiled, params, ctx, mode=Modes.TRANOP)
    ctx_op = ctx.with_mode(Modes.TRANOP).at_time(t0)
    xd0, mask = xdot0_and_mask(compiled, op.x, ctx_op, params)
    bps = compiled.breakpoints(tstop)
    bps = np.concatenate([bps[bps > t0], [tstop], [np.inf]])
    obs = compiled.observe(observable)
    te = float(t_eval)
    with fwAD.dual_level(), ForwardTangents():
        p = _carry_tangent(compiled, params, wrt)
        ts, xs, xds = tran_core(compiled, p, ctx, op.x, xd0, t0, tstop,
                                bps, (tstop - t0) * 1e-6, opts, mask)[:3]
        ts, xs, xds = ts[0], xs[0], xds[0]
        tq = torch.as_tensor(te, dtype=ts.dtype, device=ts.device)
        i = int(torch.searchsorted(fwAD.unpack_dual(ts).primal, tq)
                .clamp(1, ts.shape[0] - 1))
        w = ((tq - ts[i - 1])
             / torch.clamp(ts[i] - ts[i - 1], min=1e-300)).clamp(0.0, 1.0)
        x_at = xs[i - 1] * (1 - w) + xs[i] * w
        xd_at = xds[i - 1] * (1 - w) + xds[i] * w
        y = obs(x_at, xd_at, ctx.with_mode(Modes.TRAN).at_time(te), p)
        v, dv = fwAD.unpack_dual(y)
    if dv is None:
        dv = torch.zeros_like(v)
    return v, dv


def tf(compiled, out: str, src: str, params=None, ctx=None, opts=None):
    """DC transfer function (SPICE ``.TF``): the small-signal gain
    d(out)/d(src) and the output resistance at the observed node.  ``src``
    is a V/I source instance name.  Returns dict(gain=, rout=, value=)."""
    compiled = ensure_dynamic(compiled, [f"{src}.dc"])
    value, g, x, G, e = _dc_adjoint(compiled, out, [f"{src}.dc"], params,
                                    ctx, opts, Modes.DCOP)
    # rout at the JAX package's context for it: without a ctx that is
    # ``SimSpec.make``'s, which differs from the sensitivity's (the
    # netlist's options) only where the netlist sets gmin or temp; there
    # the operating point is solved again
    c = (SimSpec.make(mode=Modes.DCOP) if ctx is None
         else ctx.with_mode(Modes.DCOP))
    if c != (default_ctx(compiled) if ctx is None else ctx).with_mode(
            Modes.DCOP):
        params_ = compiled.params0 if params is None else params
        x = solve_dc(compiled, params_, c, opts=opts, mode=Modes.DCOP).x
        G, _ = compiled.jacobians(x, c, params_)
        e = _obs_dx(compiled.observe(out), x, c, params_)
    # a unit test current into the observed node(s): dx = G⁻¹e, rout = eᵀdx
    rout = e @ linalg.solve(G, e)
    return dict(gain=g[f"{src}.dc"], rout=rout, value=value)
