"""Sweeps sharded over ranks of ``torch.distributed`` (counterpart of
``cedarsim_tpu/parallel/mesh.py``).

The JAX package shards a sweep's stacked parameter pytree (leading points
axis) over a ``jax.sharding.Mesh``.  Here a mesh is a process group: each
rank takes its contiguous slice of the padded points, runs the port's own
lane-batched solver on its device (``dc_core`` for DC, ``tran`` for the
transient, which picks the fused chord kernel or the GESP pair as it does
for one process), and the results come back to every rank by
``all_gather``.  Per-point solves are independent, so the gather is the
only collective.

Two of the reference's faults are not carried over: its sharded transient
builds the fused plan from the compiled params (``mesh.py:158``), and keys
its program cache without the plan's context (``mesh.py:190``).  Here the
lane params go to ``tran``, which builds the plan from them and refuses a
per-lane constant, and nothing is cached outside ``tran``'s own plan cache,
whose key holds the temperature and the params.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from cedarsim_tpu_torch import config
from cedarsim_tpu_torch.analysis.dc import (DCResult, NewtonOptions, dc_core,
                                            default_newton_options, solve_dc)
from cedarsim_tpu_torch.analysis.sweeps import batch_params, sweepify
from cedarsim_tpu_torch.core.compile import (CompiledCircuit, compile_circuit,
                                             default_ctx)
from cedarsim_tpu_torch.core.context import Modes, SimSpec


@dataclasses.dataclass
class Mesh:
    """A process group over which sweeps shard: this rank's ``rank`` of
    ``size``, its ``device`` and the group's ``backend`` ("nccl" on cards,
    "gloo" on the CPU or for ranks that share one card)."""
    group: object
    size: int
    rank: int
    device: torch.device
    backend: str

    def bounds(self, n):
        """[lo, hi) of this rank's slice of ``n`` points (``n`` a multiple
        of ``size``)."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def all_gather(self, t):
        """Every rank's ``t`` (the same shape on every rank) concatenated
        along the first axis, on ``t``'s device.  Under gloo the buffers go
        through host memory; bools travel as uint8."""
        if self.size == 1:
            return t
        dtype = t.dtype
        src = t.to(torch.uint8) if dtype == torch.bool else t
        if self.backend != "nccl":
            src = src.cpu()
        src = src.contiguous()
        bufs = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(bufs, src, group=self.group)
        out = torch.cat(bufs).to(t.device)
        return out.to(torch.bool) if dtype == torch.bool else out


def make_mesh(n_devices=None, device=None, backend=None) -> Mesh:
    """The mesh of this process's ranks.  ``device``: the CUDA card by
    default (rank r on ``cuda:(r % device_count)``), "cpu" for gloo ranks
    on the host; ``backend``: "nccl" on cards and "gloo" on the CPU by
    default.  ``backend="gloo"`` with cards is how two ranks share one
    card (NCCL refuses two ranks on one device); results then go through
    host memory.  There is no fallback: a card asked for without one, or
    NCCL without its library, raises.

    The process group comes from ``torch.distributed`` when it is already
    initialised, else from the environment (``RANK``, ``WORLD_SIZE`` and
    ``CEDARSIM_MESH_INIT``, a ``file://`` rendezvous, as ``RankPool`` and
    ``dryrun_multichip`` set them; ``env://`` when that is unset), else it
    is a world of one, whose rendezvous is an in-process store.  ``n_devices``, when given, must be the world's
    size."""
    want = torch.device("cuda" if device is None else device)
    if want.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: a CUDA mesh was asked for and this process sees no "
            "CUDA card; pass device='cpu' for gloo ranks on the host")
    if want.type not in ("cuda", "cpu"):
        raise ValueError(f"make_mesh: unsupported device {want}")
    backend = backend or ("nccl" if want.type == "cuda" else "gloo")
    if backend == "nccl":
        if want.type != "cuda":
            raise ValueError("make_mesh: NCCL needs CUDA devices")
        if not dist.is_nccl_available():
            raise RuntimeError("make_mesh: this torch build has no NCCL")
    elif backend != "gloo":
        raise ValueError(f"make_mesh: unknown backend {backend!r}")
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
            dist.init_process_group(
                backend,
                init_method=os.environ.get("CEDARSIM_MESH_INIT", "env://"),
                world_size=int(os.environ["WORLD_SIZE"]),
                rank=int(os.environ["RANK"]))
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0)
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(
            f"make_mesh: {n_devices} ranks asked for, but the process group "
            f"has {size}; start one process per rank (RankPool, "
            "dryrun_multichip)")
    if dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group runs "
                         f"{dist.get_backend()}, not {backend}")
    if want.type == "cuda":
        index = want.index if want.index is not None \
            else rank % torch.cuda.device_count()
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    return Mesh(dist.group.WORLD, size, rank, dev, backend)


def _same_device(a, b):
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    return a.type != "cuda" or (a.index or 0) == (b.index or 0)


def _mesh_for(compiled, mesh):
    mesh = mesh or make_mesh(device=compiled.device)
    if not _same_device(compiled.device, mesh.device):
        raise ValueError(f"the circuit is compiled on {compiled.device} but "
                         f"this rank's mesh device is {mesh.device}")
    return mesh


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def pad_batch(tree, multiple: int):
    """Every leaf's leading axis padded up to a multiple of ``multiple`` by
    repeating its last point (each rank takes an equal slice); returns
    (padded tree, original n)."""
    n = _leaves(tree)[0].shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return tree, n

    def _pad(x):
        x = torch.as_tensor(x)
        return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    return _tree_map(_pad, tree), n


def _lane_tree(compiled, params, L):
    """``params`` with every leaf given the lane axis (a leaf without one
    repeated over the ``L`` lanes)."""
    out = {}
    for key, grp in params.items():
        out[key] = {}
        for pn, v in grp.items():
            v = torch.as_tensor(v, dtype=compiled.dtype,
                                device=compiled.device)
            if v.dim() == compiled.params0[key][pn].dim():
                v = v.expand((L,) + tuple(v.shape))
            out[key][pn] = v
    return out


def _temps(compiled, ctx, points):
    """``ctx`` with a per-point ``temp`` when the sweep names "temp" (as
    ``dc_sweep`` does), else ``ctx``."""
    if not any("temp" in (k.lower() for k in pt) for pt in points):
        return ctx
    temps = [next((v for k, v in pt.items() if k.lower() == "temp"),
                  float(ctx.temp) - config.T_ZERO_C) + config.T_ZERO_C
             for pt in points]
    return ctx.replace(temp=torch.as_tensor(temps, dtype=compiled.dtype,
                                            device=compiled.device))


def _ctx_slice(ctx, size, lo, hi):
    """``ctx`` for lanes [lo, hi) of the points padded to a multiple of
    ``size`` (a per-point temperature is padded like the params)."""
    if isinstance(ctx.temp, torch.Tensor) and ctx.temp.dim() == 1:
        return ctx.replace(temp=pad_batch(ctx.temp, size)[0][lo:hi])
    return ctx


def dc_sweep_sharded(compiled: CompiledCircuit, sweep, mesh: Mesh = None,
                     params=None, ctx: SimSpec = None,
                     opts: NewtonOptions = None,
                     mode=Modes.DCOP) -> DCResult:
    """Batched DC sweep sharded over the mesh's ranks: each rank solves
    its slice of the points with the lane-batched ``dc_core`` from zeros,
    and every rank returns the ``DCResult`` of all the points.  The name
    "temp" sweeps the temperature, as in ``dc_sweep``."""
    mesh = _mesh_for(compiled, mesh)
    opts = opts or default_newton_options(compiled)
    ctx = (default_ctx(compiled) if ctx is None else ctx).with_mode(mode)
    compiled, bp, points = batch_params(compiled, sweep, params)
    ctx = _temps(compiled, ctx, points)
    bp, n = pad_batch(bp, mesh.size)
    lo, hi = mesh.bounds(_leaves(bp)[0].shape[0])
    mine = _tree_map(lambda v: v[lo:hi], bp)
    x0 = torch.zeros(hi - lo, compiled.n_x, dtype=compiled.dtype,
                     device=compiled.device)
    res = dc_core(compiled, mine, _ctx_slice(ctx, mesh.size, lo, hi), x0, opts)
    return DCResult(mesh.all_gather(res.x)[:n],
                    mesh.all_gather(res.converged)[:n],
                    mesh.all_gather(res.iters)[:n],
                    mesh.all_gather(res.resnorm)[:n])


@dataclasses.dataclass
class TranSweepResult:
    """Batched transient sweep output, leading axis the sweep point, as
    numpy arrays.  ``ts``/``xs``/``xdots`` are [n, K(, n_x)] with K the
    longest lane's accepted points; a lane's rows past its own
    ``n_accepted`` repeat its final state, so ``np.interp`` over
    ``ts[lane]`` stays monotone."""
    ts: np.ndarray          # [n, K]
    xs: np.ndarray          # [n, K, n_x]
    xdots: np.ndarray       # [n, K, n_x]
    finished: np.ndarray    # [n] bool
    n_accepted: np.ndarray  # [n]
    n_rejected: np.ndarray  # [n]
    n_newton: np.ndarray    # [n]


def _pad_rows(a, K):
    """[k, ...] → [K, ...] repeating the last row."""
    return np.concatenate([a, np.repeat(a[-1:], K - a.shape[0], 0)]) \
        if a.shape[0] < K else a


def tran_sweep_sharded(compiled: CompiledCircuit, sweep, tspan,
                       mesh: Mesh = None, params=None, ctx: SimSpec = None,
                       opts=None, dc_opts: NewtonOptions = None,
                       x0=None) -> TranSweepResult:
    """Batched transient sweep sharded over the mesh's ranks: each rank
    runs its slice of the points as the lanes of one ``tran`` call (which
    resolves ``newton_impl``/``dense_lu`` as for one process: on a card
    the fused chord kernel when the plan admits the lanes, else the GESP
    pair), and every rank returns the :class:`TranSweepResult` of all
    the points.

    ``sweep=None`` takes a prebuilt batched params tree through
    ``params`` (leaves with a leading points axis; a leaf without one is
    shared).  ``x0``: a warm start for the per-lane operating points ([n_x],
    usually the nominal operating point, or [n, n_x]): each lane's point
    is solved from it (``Modes.TRANOP``) before its transient, and a lane
    whose operating point fails is not ``finished``.  Without ``x0`` the
    operating points are ``tran``'s own."""
    from cedarsim_tpu_torch.analysis.tran import TranOptions, tran
    mesh = _mesh_for(compiled, mesh)
    opts = opts or TranOptions()
    ctx = default_ctx(compiled) if ctx is None else ctx
    if sweep is None:
        if params is None:
            raise ValueError("sweep=None needs a prebuilt batched params "
                             "tree via params=")
        L = max((torch.as_tensor(v).shape[0] for key, grp in params.items()
                 for pn, v in grp.items()
                 if torch.as_tensor(v).dim()
                 == compiled.params0[key][pn].dim() + 1), default=None)
        if L is None:
            raise ValueError("sweep=None: no leaf of params carries a "
                             "points axis")
        bp, points = _lane_tree(compiled, params, L), [{}] * L
    else:
        compiled, bp, points = batch_params(compiled, sweepify(sweep),
                                            params)
    ctx = _temps(compiled, ctx, points)
    bp, n = pad_batch(bp, mesh.size)
    npad = _leaves(bp)[0].shape[0]
    lo, hi = mesh.bounds(npad)
    mine = _tree_map(lambda v: v[lo:hi], bp)
    ctx_r = _ctx_slice(ctx, mesh.size, lo, hi)
    op_ok = None
    if x0 is not None:
        x0 = torch.as_tensor(x0, dtype=compiled.dtype,
                             device=compiled.device)
        x0b = x0.expand(npad, compiled.n_x) if x0.dim() == 1 \
            else pad_batch(x0, mesh.size)[0]
        op = solve_dc(compiled, mine, ctx_r, x0=x0b[lo:hi], opts=dc_opts,
                      mode=Modes.TRANOP)
        x0, op_ok = op.x, op.converged.cpu().numpy()
    sols = tran(compiled, tspan, params=mine, ctx=ctx_r, opts=opts,
                dc_opts=dc_opts, x0=x0)
    K = mesh.all_gather(torch.as_tensor(
        [max(s.n_accepted for s in sols)], dtype=torch.int64,
        device=compiled.device))
    K = int(K.max())
    fin = np.asarray([s.converged for s in sols])
    if op_ok is not None:
        fin = fin & op_ok

    def gathered(a, dtype=None):
        t = torch.as_tensor(np.asarray(a), dtype=dtype,
                            device=compiled.device)
        return mesh.all_gather(t).cpu().numpy()[:n]

    return TranSweepResult(
        ts=gathered([_pad_rows(s.ts, K) for s in sols]),
        xs=gathered([_pad_rows(s.xs, K) for s in sols]),
        xdots=gathered([_pad_rows(s.xdots, K) for s in sols]),
        finished=gathered(fin, torch.bool),
        n_accepted=gathered([s.n_accepted for s in sols], torch.int64),
        n_rejected=gathered([s.n_rejected for s in sols], torch.int64),
        n_newton=gathered([s.n_newton for s in sols], torch.int64))


def run_sharded(analysis, circuit, sweep, *args, mesh=None,
                compile_kw=None, **kw):
    """One rank's part of a sharded sweep, for ``RankPool.call``: the
    ``Circuit`` compiled on this rank's mesh device with ``compile_kw``,
    then ``dc_sweep_sharded`` (``analysis="dc"``) or
    ``tran_sweep_sharded`` ("tran") with ``args`` and ``kw``; a DC result
    comes back as numpy arrays (x, converged, iters, resnorm)."""
    mesh = mesh or current_mesh()
    comp = compile_circuit(circuit, device=mesh.device, **(compile_kw or {}))
    if analysis == "dc":
        r = dc_sweep_sharded(comp, sweep, mesh, *args, **kw)
        return tuple(v.cpu().numpy() for v in
                     (r.x, r.converged, r.iters, r.resnorm))
    if analysis == "tran":
        return tran_sweep_sharded(comp, sweep, *args, mesh=mesh, **kw)
    raise ValueError(f"run_sharded: unknown analysis {analysis!r}")


#: the mesh a ``RankPool`` worker made at start-up
_MESH = None


def current_mesh():
    """The mesh a ``RankPool`` worker joined at start-up."""
    if _MESH is None:
        raise RuntimeError("no mesh: call make_mesh, or run inside a "
                           "RankPool worker")
    return _MESH
