"""Source waveforms (PWL / PULSE) and their breakpoints — counterpart of
``cedarsim_tpu/devices/waveforms.py``.

Evaluations are branchless torch over a batch of instances; breakpoint
enumeration stays on the host in numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def pwl_value(ts, ys, t):
    """Piecewise-linear value at time ``t``, ends held — the arithmetic of
    ``jnp.interp`` (which the JAX package uses) written out in torch.
    ``ts``/``ys``: ``[P]`` (shared by the batch) or ``[B, P]``; ``t``: ``[B]``."""
    P = ts.shape[-1]
    tb = t.reshape(-1, 1)
    if ts.dim() == 1:
        i = torch.searchsorted(ts, t.contiguous(), right=True)
        i = i.clamp(1, P - 1)
        x0, x1, f0, f1 = ts[i - 1], ts[i], ys[i - 1], ys[i]
        first_t, last_t, first_f, last_f = ts[0], ts[-1], ys[0], ys[-1]
    else:
        i = torch.searchsorted(ts.contiguous(), tb.contiguous(), right=True)
        i = i.clamp(1, P - 1)
        x0 = ts.gather(1, i - 1)[:, 0]
        x1 = ts.gather(1, i)[:, 0]
        f0 = ys.gather(1, i - 1)[:, 0]
        f1 = ys.gather(1, i)[:, 0]
        first_t, last_t, first_f, last_f = ts[:, 0], ts[:, -1], ys[:, 0], \
            ys[:, -1]
    dx = x1 - x0
    eps = float(np.spacing(np.finfo(np.float64).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f0, f0 + ((t - x0) / torch.where(dx0, 1.0, dx))
                    * (f1 - f0))
    f = torch.where(t < first_t, first_f, f)
    return torch.where(t > last_t, last_f, f)


def _where(c, a, b):
    if isinstance(c, torch.Tensor):
        return torch.where(c, a, b)
    return a if c else b


def _floor(a, lo):
    return a.clamp(min=lo) if isinstance(a, torch.Tensor) else max(a, lo)


def pulse_value(v1, v2, td, tr, tf, pw, per, t):
    """SPICE PULSE(v1 v2 td tr tf pw per) at time ``t`` (a ``[B]`` tensor),
    periodic; the instant of a discontinuity belongs to the next segment."""
    tr = _floor(tr, 1e-15)
    tf = _floor(tf, 1e-15)
    periodic = per > 0
    tc = _where(periodic,
                torch.remainder(t - td, _where(periodic, per, 1.0)), t - td)
    rise = v1 + (v2 - v1) * tc / tr
    fall = v2 + (v1 - v2) * (tc - tr - pw) / tf
    val = torch.where(
        tc < tr, rise,
        torch.where(tc < tr + pw, v2, torch.where(tc < tr + pw + tf, fall,
                                                  v1)))
    return torch.where(t < td, v1, val)


# ---------------------------------------------------------------- breakpoints

def pwl_breakpoints(ts, tstop):
    ts = np.asarray(ts, dtype=np.float64)
    return ts[(ts > 0) & (ts < tstop)]


def pulse_breakpoints(v1, v2, td, tr, tf, pw, per, tstop):
    edges = np.array([0.0, tr, tr + pw, tr + pw + tf])
    if not np.isfinite(per) or per <= 0:
        pts = td + edges
    else:
        n = int(np.floor((tstop - td) / per)) + 1 if tstop > td else 0
        pts = (td + np.arange(max(n, 0) + 1)[:, None] * per
               + edges[None, :]).ravel()
    return pts[(pts > 0) & (pts < tstop)]
