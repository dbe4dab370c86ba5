"""Source waveforms (PWL / PULSE / SIN / EXP) and their breakpoints —
counterpart of ``cedarsim_tpu/devices/waveforms.py``.

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


def sin_value(vo, va, freq, td, theta, phase_deg, t):
    """SPICE SIN(vo va freq td theta phase): damped sine after delay td."""
    ph = phase_deg * (np.pi / 180.0)
    active = vo + va * torch.exp(-(t - td) * theta) * torch.sin(
        2.0 * np.pi * freq * (t - td) + ph)
    quiescent = vo + va * (torch.sin(ph) if isinstance(ph, torch.Tensor)
                           else np.sin(ph))
    return torch.where(t < td, quiescent, active)


def exp_value(v1, v2, td1, tau1, td2, tau2, t):
    """SPICE EXP(v1 v2 td1 tau1 td2 tau2)."""
    rise = v1 + (v2 - v1) * (1.0 - torch.exp(-(t - td1) / tau1))
    fall = rise + (v1 - v2) * (1.0 - torch.exp(-(t - td2) / tau2))
    return torch.where(t < td1, v1, torch.where(t < td2, rise, fall))


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


def sin_breakpoints(td, tstop):
    return np.array([td]) if 0 < td < tstop else np.empty(0)


def exp_breakpoints(td1, td2, tstop):
    pts = np.array([td1, td2])
    return pts[(pts > 0) & (pts < tstop)]
