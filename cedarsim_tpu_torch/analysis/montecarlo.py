"""Monte-Carlo DC sweeps (counterpart of
``cedarsim_tpu/analysis/montecarlo.py``).

The reference's Monte-Carlo is ``agauss`` sampling at elaboration from
``spec.rng`` (``spectre_env.jl:178-187``), one circuit build per sample,
solved one after another.  Here the scatter is a params tree with a
leading lane axis and every sample solves at once in the lane-batched
``dc_core``: :func:`scatter_params` draws Gaussian parameter scatter from a
``torch.Generator`` seeded with ``seed`` (on the CPU, so that the card and
the CPU draw the same numbers), and :func:`statistics_params` elaborates a
netlist under one ``mc_seed`` per lane (its ``agauss``/``gauss``/``aunif``/
``unif`` draws) and stacks the parameters that differ.  ``jax.random`` and
``torch.Generator`` give different streams: the same seed draws other
numbers here than in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from cedarsim_tpu_torch import config
from cedarsim_tpu_torch.core.compile import (CompiledCircuit,
                                             compile_circuit, default_ctx,
                                             ensure_dynamic)
from cedarsim_tpu_torch.core.context import SimSpec, Modes
from cedarsim_tpu_torch.analysis.dc import (NewtonOptions, DCResult,
                                            dc_core, dc_from_nominal,
                                            default_newton_options, solve_dc)
from cedarsim_tpu_torch.analysis.sweeps import as_compiled


def scatter_params(compiled: CompiledCircuit, n: int, dist: dict, seed=0):
    """(compiled', batched params): every param named in ``dist`` gets n
    Gaussian samples.  ``dist`` maps a dotted ("x1.m1.vto") or bare
    ("vto") name to sigma (absolute) or ("rel", fraction).  The draws come
    from one ``torch.Generator`` seeded with ``seed``, name by name in
    sorted order: [n] for a dotted name, [n, n_inst] for a bare one."""
    compiled = ensure_dynamic(compiled, list(dist))
    gen = torch.Generator().manual_seed(int(seed))
    dt, dev = compiled.dtype, compiled.device

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=dt).to(dev)

    params = {k: {pn: v.expand((n,) + tuple(v.shape))
                  for pn, v in g.items()}
              for k, g in compiled.params0.items()}
    for name, spec in sorted(dist.items()):
        rel = isinstance(spec, tuple) and spec[0] == "rel"
        sigma = spec[1] if rel else spec
        if "." in name:
            gkey, j, pname = compiled.param_loc(name)
            base = compiled.params0[gkey][pname][j]
            s = sigma * base if rel else sigma
            col = params[gkey][pname].clone()
            col[:, j] = base + s * normal((n,))
            params[gkey] = {**params[gkey], pname: col}
        else:
            pname = name.lower()
            hit = False
            for gkey in compiled.group_order:
                if pname in compiled.params0[gkey]:
                    base = compiled.params0[gkey][pname]      # [n_inst]
                    s = sigma * base if rel else sigma
                    samples = base[None] + s * normal((n, base.shape[0]))
                    params[gkey] = {**params[gkey], pname: samples}
                    hit = True
            if not hit:
                raise KeyError(f"no instance has parameter {pname!r}")
    return compiled, params


def _ctx_for(compiled, ctx, mode):
    return (default_ctx(compiled) if ctx is None else ctx).with_mode(mode)


def mc_dc(circuit, n: int, dist: dict, seed=0, ctx: SimSpec = None,
          opts: NewtonOptions = None, mode=Modes.DCOP, warm_start=True,
          device=None) -> DCResult:
    """n Monte-Carlo DC operating points solved together (see
    :func:`mc_solve`).  ``circuit``: a compiled circuit, or a ``Circuit``
    compiled here on ``device`` (by default the CUDA card)."""
    compiled = as_compiled(circuit, device)
    opts = opts or default_newton_options(compiled)
    ctx = _ctx_for(compiled, ctx, mode)
    compiled, bp = scatter_params(compiled, n, dist, seed)
    return mc_solve(compiled, bp, ctx, opts, mode, warm_start)


def mc_solve(compiled: CompiledCircuit, bp, ctx: SimSpec = None,
             opts: NewtonOptions = None, mode=Modes.DCOP,
             warm_start=True) -> DCResult:
    """Solve a params tree ``bp`` with a leading lane axis in one batched
    DC.  ``warm_start`` (default): the nominal point is solved once with
    the whole continuation ladder, then every lane runs a light ladder from
    it; the lanes that fail run again with the whole ladder from zero (the
    JAX package's ``_mc_solve``)."""
    opts = opts or default_newton_options(compiled)
    ctx = _ctx_for(compiled, ctx, mode)
    n = next(iter(next(iter(bp.values())).values())).shape[0]
    dt, dev = compiled.dtype, compiled.device

    def attach(r):
        r.compiled, r.ctx, r.params = compiled, ctx, bp
        return r

    zeros = torch.zeros(n, compiled.n_x, dtype=dt, device=dev)
    if not warm_start:
        return attach(dc_core(compiled, bp, ctx, zeros, opts))
    nominal = solve_dc(compiled, compiled.params0, ctx, opts=opts, mode=mode)
    res = dc_from_nominal(compiled, bp, ctx, nominal.x, opts)
    ok = res.converged
    if bool(ok.all()):
        return attach(res)
    # the robust second pass for the failed lanes only
    bad = torch.nonzero(~ok).reshape(-1)
    bp_bad = {k: {pn: v[bad] for pn, v in g.items()} for k, g in bp.items()}
    res2 = dc_core(compiled, bp_bad, ctx, zeros[bad], opts)
    x, conv = res.x.clone(), ok.clone()
    iters, resnorm = res.iters.clone(), res.resnorm.clone()
    x[bad], conv[bad] = res2.x, res2.converged
    iters[bad], resnorm[bad] = res2.iters, res2.resnorm
    return attach(DCResult(x, conv, iters, resnorm))


def statistics_params(netlist, n, include_paths=(), seed=0, temp=27.0,
                      device=None):
    """Elaborate ``netlist`` (AST) under the n Monte-Carlo seeds seed ..
    seed + n - 1 (its ``agauss``/``gauss``/``aunif``/``unif`` draws), and
    assemble one params tree with a leading lane axis over one compiled
    circuit (on ``device``, by default the CUDA card).  The varied device
    parameters are found by comparing the elaborations, declared dynamic
    and stacked per lane.  Raises if a seed changes the circuit's
    structure (a draw flipping an ``.if`` branch)."""
    from cedarsim_tpu_torch.frontend.elaborate import elaborate
    device = config.resolve_device(device)
    ckts = [elaborate(netlist, include_paths=include_paths,
                      mc_seed=seed + i, temp=temp) for i in range(n)]
    base = ckts[0]
    sig = [(i.name, type(i.model).__name__, getattr(i.model, "name", ""))
           for i in base.instances]
    insts_by_lane = []
    varying = set()
    for lane, c in enumerate(ckts):
        s = [(i.name, type(i.model).__name__, getattr(i.model, "name", ""))
             for i in c.instances]
        if s != sig:
            raise ValueError(
                f"statistics seed {seed + lane} changed the circuit "
                "structure — per-seed topology variation cannot batch")
        insts_by_lane.append({i.name: i for i in c.instances})
        if lane:
            for i0, ic in zip(base.instances, c.instances):
                for pn, v0 in i0.params.items():
                    if not np.array_equal(np.asarray(v0),
                                          np.asarray(ic.params[pn])):
                        varying.add(f"{i0.name}.{pn}".lower())
    compiled = compile_circuit(
        base, device=device, dynamic_params=sorted(
            v[:-6] if v.endswith("$given") else v for v in varying))
    bp = {}
    for key in compiled.group_order:
        grp = compiled.groups[key]
        bp[key] = {}
        for pn, v in compiled.params0[key].items():
            if pn == "$mult":
                bp[key][pn] = v.expand((n,) + tuple(v.shape))
                continue
            stacked = np.stack([
                np.stack([np.asarray(insts_by_lane[lane][inst.name]
                                     .params[pn], np.float64)
                          for inst in grp.instances])
                for lane in range(n)])
            bp[key][pn] = torch.as_tensor(stacked, dtype=compiled.dtype,
                                          device=compiled.device)
    return compiled, bp


def mc_statistics(netlist, n, include_paths=(), seed=0, ctx: SimSpec = None,
                  opts: NewtonOptions = None, mode=Modes.DCOP,
                  warm_start=True, temp=27.0, device=None) -> DCResult:
    """n Monte-Carlo DC points over the netlist's ``agauss``-style draws,
    solved together: per-seed elaboration on the host, one compile (on
    ``device``, by default the CUDA card) and one batched solve."""
    compiled, bp = statistics_params(netlist, n, include_paths, seed, temp,
                                     device)
    return mc_solve(compiled, bp, ctx, opts, mode, warm_start)
