"""First-call and steady-state profiling (counterpart of
``cedarsim_tpu/utils/profiling.py``).

The JAX package splits a call's compile latency into XLA's trace, lower
and compile phases and counts the traced program's jaxpr equations, the
op-count regression metric.  PyTorch runs eagerly and has none of those
phases, so the port reports what stands for them:

* ``first_call_s`` (for ``trace_s + lower_s + compile_s``): the wall time
  of the first call, which includes whatever it builds on first use (a
  fused plan, an ``nvcc`` build of a kernel library);
* ``aten_ops`` and ``aten_histogram`` (for ``jaxpr_eqns`` and
  ``jaxpr_primitives``): the aten operations one call dispatches, counted
  by a ``TorchDispatchMode`` (every operation that reaches a kernel, views
  and copies included), by name; the histogram sums to the total;
* on a CUDA card, ``cuda_kernels``, ``cuda_launches`` and
  ``cuda_device_s`` (for ``flops``/``bytes_accessed``, XLA's cost model of
  the program): the device kernels of one call, their launches and their
  device time, from ``torch.profiler``'s CUDA activity.  They are absent
  on the CPU.

``profile_run`` gives the mean wall time of ``iters`` calls after one
warm-up, with ``torch.cuda.synchronize`` around them on a card.
"""

from __future__ import annotations

import collections
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _CountOps(TorchDispatchMode):
    """Counts every aten operation dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _on_cuda(args):
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def _sync(cuda):
    if cuda:
        torch.cuda.synchronize()


def profile_compile(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` three times and report the first call's
    wall time, the aten operations of one call and, when an argument lies
    on a CUDA card, the device kernels of one call.  ``fn`` is returned
    under ``"compiled"`` (the JAX package returns its compiled executable
    there), so that ``profile_run(rep["compiled"], *args)`` reads as
    there."""
    cuda = _on_cuda(args) or _on_cuda(kwargs.values())
    out = {}
    _sync(cuda)
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _sync(cuda)
    out["first_call_s"] = time.perf_counter() - t0
    mode = _CountOps()
    with mode:
        fn(*args, **kwargs)
    out["aten_ops"] = sum(mode.counts.values())
    out["aten_histogram"] = dict(mode.counts.most_common())
    if cuda:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args, **kwargs)
            torch.cuda.synchronize()
        kernels = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                n, us = kernels.get(ev.name, (0, 0.0))
                kernels[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
        out["cuda_kernels"] = {k: {"launches": n, "device_s": us * 1e-6}
                               for k, (n, us) in kernels.items()}
        out["cuda_launches"] = sum(n for n, _ in kernels.values())
        out["cuda_device_s"] = sum(us for _, us in kernels.values()) * 1e-6
    out["compiled"] = fn
    return out


def profile_run(fn, *args, iters=3) -> dict:
    """Steady-state wall time of ``fn(*args)``: one warm-up call, then the
    mean of ``iters`` timed calls (synchronising the card around them when
    an argument lies on one)."""
    cuda = _on_cuda(args)
    fn(*args)
    _sync(cuda)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(cuda)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "per_sec": (1.0 / dt) if dt > 0 else float("inf")}
