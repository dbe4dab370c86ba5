"""Sweep combinators and batched DC sweeps (counterpart of
``cedarsim_tpu/analysis/sweeps.py``).

The combinators (``Sweep``, ``ProductSweep``, ``TandemSweep``,
``SerialSweep``, ``sweepify``), ``split_axes`` and ``find_param_ranges``
import no JAX and are copies of the JAX package's (the copy rule of
ROADMAP "Decisions"): their iterator semantics are the reference's
(``sweeps.jl:40-354``).  Execution is the port's own: the sweep points are
stacked into one params tree with a leading lane axis and solve together in
the lane-batched ``dc_core`` (every lane independent of the others, the
meaning of the JAX package's ``vmap``), on the circuit's device.  The
reserved name ``"temp"`` sweeps the temperature (Celsius) as a per-lane
``SimSpec.temp``.
"""

from __future__ import annotations

import itertools

import torch

from cedarsim_tpu_torch import config
from cedarsim_tpu_torch.core.circuit import Circuit
from cedarsim_tpu_torch.core.compile import (CompiledCircuit,
                                             compile_circuit, default_ctx,
                                             ensure_dynamic)
from cedarsim_tpu_torch.core.context import SimSpec, Modes
from cedarsim_tpu_torch.analysis.dc import (NewtonOptions, DCResult,
                                            dc_core, default_newton_options)

class AbstractSweep:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    @property
    def names(self):
        raise NotImplementedError


class Sweep(AbstractSweep):
    def __init__(self, name, values):
        self.name = name
        self.values = list(values)

    def __iter__(self):
        for v in self.values:
            yield {self.name: v}

    def __len__(self):
        return len(self.values)

    @property
    def names(self):
        return [self.name]


class ProductSweep(AbstractSweep):
    def __init__(self, *sweeps):
        self.sweeps = [sweepify(s) for s in sweeps]

    def __iter__(self):
        for combo in itertools.product(*self.sweeps):
            d = {}
            for c in combo:
                d.update(c)
            yield d

    def __len__(self):
        n = 1
        for s in self.sweeps:
            n *= len(s)
        return n

    @property
    def names(self):
        return [n for s in self.sweeps for n in s.names]


class TandemSweep(AbstractSweep):
    def __init__(self, *sweeps):
        self.sweeps = [sweepify(s) for s in sweeps]
        lens = {len(s) for s in self.sweeps}
        if len(lens) != 1:
            raise ValueError("TandemSweep requires equal-length sweeps")

    def __iter__(self):
        for combo in zip(*self.sweeps):
            d = {}
            for c in combo:
                d.update(c)
            yield d

    def __len__(self):
        return len(self.sweeps[0])

    @property
    def names(self):
        return [n for s in self.sweeps for n in s.names]


class SerialSweep(AbstractSweep):
    def __init__(self, *sweeps):
        self.sweeps = [sweepify(s) for s in sweeps]

    def __iter__(self):
        for s in self.sweeps:
            yield from s

    def __len__(self):
        return sum(len(s) for s in self.sweeps)

    @property
    def names(self):
        seen = []
        for s in self.sweeps:
            for n in s.names:
                if n not in seen:
                    seen.append(n)
        return seen


def sweepify(obj):
    """Shorthand coercion (reference ``sweepify``, sweeps.jl:349-354):
    dict of name→values → ProductSweep of Sweeps; (name, values) tuple →
    Sweep; AbstractSweep passes through."""
    if isinstance(obj, AbstractSweep):
        return obj
    if isinstance(obj, dict):
        return ProductSweep(*[Sweep(k, v) for k, v in obj.items()])
    if isinstance(obj, tuple) and len(obj) == 2:
        return Sweep(obj[0], obj[1])
    raise TypeError(f"cannot sweepify {obj!r}")


# ------------------------------------------------------------------ batching

def as_compiled(circuit, device=None) -> CompiledCircuit:
    """``circuit`` if it is compiled, else compiled on ``device`` (by
    default the CUDA card; without one, pass ``device="cpu"``)."""
    if isinstance(circuit, CompiledCircuit):
        return circuit
    if not isinstance(circuit, Circuit):
        raise TypeError(f"expected a Circuit or a CompiledCircuit, got "
                        f"{type(circuit).__name__}")
    return compile_circuit(circuit, device=device)


def stack_trees(trees):
    """One params tree with a leading lane axis from per-lane trees."""
    return {key: {pn: torch.stack([torch.as_tensor(t[key][pn])
                                   for t in trees])
                  for pn in trees[0][key]}
            for key in trees[0]}


def batch_params(compiled: CompiledCircuit, sweep, params=None):
    """Stack a sweep into one params tree whose leaves gain a leading axis
    of len(sweep).  Returns (compiled, batched params, points): ``compiled``
    may be a variant compiled again with the swept params dynamic.  The
    reserved name "temp" is skipped (it batches the ``SimSpec``, see
    :func:`dc_sweep`)."""
    sweep = sweepify(sweep)
    compiled = ensure_dynamic(
        compiled, [n for n in sweep.names if n.lower() != "temp"])
    base = compiled.params0 if params is None else params
    points = list(sweep)
    trees = []
    for pt in points:
        p = base
        for name, v in pt.items():
            if v is None or name.lower() == "temp":
                continue
            p = compiled.set_param(p, name, v)
        trees.append(p)
    return compiled, stack_trees(trees), points


def dc_sweep(circuit, sweep, params=None, ctx: SimSpec = None,
             opts: NewtonOptions = None, mode=Modes.DCOP,
             device=None) -> DCResult:
    """Batched DC sweep: every point solves at once in the lane-batched
    ``dc_core`` (the reference's ``dc!.(CircuitSweep(...))`` made
    parallel).  ``circuit``: a compiled circuit, or a ``Circuit`` compiled
    here on ``device`` (by default the CUDA card).  The reserved sweep name
    "temp" sweeps the temperature (Celsius) as a per-lane ``SimSpec.temp``,
    the T axis of PVT.  The result carries its circuit, context and params,
    so that ``res["node"]`` gives one value per point."""
    compiled = as_compiled(circuit, device)
    opts = opts or default_newton_options(compiled)
    ctx = (default_ctx(compiled) if ctx is None else ctx).with_mode(mode)
    compiled, bp, points = batch_params(compiled, sweep, params)
    n_pts = len(points)
    x0 = torch.zeros(n_pts, compiled.n_x, dtype=compiled.dtype,
                     device=compiled.device)
    if any("temp" in (k.lower() for k in pt) for pt in points):
        temps = [next((v for k, v in pt.items() if k.lower() == "temp"),
                      float(ctx.temp) - config.T_ZERO_C) + config.T_ZERO_C
                 for pt in points]
        ctx = ctx.replace(temp=torch.as_tensor(
            temps, dtype=compiled.dtype, device=compiled.device))
    res = dc_core(compiled, bp, ctx, x0, opts)
    res.compiled, res.ctx, res.params = compiled, ctx, bp
    return res


def split_axes(sweep, outer_names):
    """Split a sweep into (outer, inner) sweeps by parameter name — the
    reference's split for host-level outer loops vs batched inner sweeps
    (the reference's src/sweeps.jl:80-128).  Returns (outer, inner) where
    either may be None if it would be empty."""
    sweep = sweepify(sweep)
    outer_names = {n.lower() for n in outer_names}

    def collect(s):
        if isinstance(s, Sweep):
            return [s]
        if not isinstance(s, ProductSweep):
            # Splitting a zip (Tandem) or concat (Serial) by axis would
            # silently turn it into a cartesian product — the reference's
            # split only accepts products (sweeps.jl:98-105).
            raise ValueError(
                f"split_axes requires a ProductSweep of plain Sweeps, "
                f"got {type(s).__name__}")
        return [x for sub in s.sweeps for x in collect(sub)]

    leaves = collect(sweep)
    outer = [s for s in leaves if s.name.lower() in outer_names]
    inner = [s for s in leaves if s.name.lower() not in outer_names]
    mk = lambda ls: (None if not ls  # noqa: E731
                     else ls[0] if len(ls) == 1 else ProductSweep(*ls))
    return mk(outer), mk(inner)


def data_sweep(circuit, name=None):
    """A TandemSweep over the rows of the netlist ``.data`` block ``name``
    (the first block when None), as the elaborator recorded them.  Its
    columns address netlist ``.param`` names: run each point by
    re-elaboration (``simulate(..., params=point)``)."""
    for cmd, args, kw in circuit.directives:
        if cmd == "data" and (name is None
                              or args[0].lower() == str(name).lower()):
            _, cols, rows = args
            return TandemSweep(*[
                Sweep(c, [r[i] for r in rows]) for i, c in enumerate(cols)])
    raise KeyError(f".data block {name!r} not found")


def find_param_ranges(sweep):
    """{parameter name: (min, max, count)} over every leaf Sweep — the
    reference's sweep summary (the reference's src/sweeps.jl:507-546)."""
    sweep = sweepify(sweep)
    out = {}

    def walk(s):
        if isinstance(s, Sweep):
            vals = list(s.values)
            key = s.name
            if key in out:
                lo, hi, n = out[key]
                out[key] = (min(lo, min(vals)), max(hi, max(vals)),
                            n + len(vals))
            else:
                out[key] = (min(vals), max(vals), len(vals))
            return
        for sub in s.sweeps:
            walk(sub)

    walk(sweep)
    return out
