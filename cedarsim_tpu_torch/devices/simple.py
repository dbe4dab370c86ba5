"""Built-in SPICE devices of the slice — counterpart of
``cedarsim_tpu/devices/simple.py`` for ``Resistor``, ``Capacitor``,
``VSource``, ``VSourcePWL`` and ``VSourcePULSE``.  The other built-in devices
are still to be ported (ROADMAP A14); the elaborator raises for them.

Each ``eval`` is the JAX package's stamp over a batch of instances: ``lv``
entries are ``[B]`` tensors or Duals, parameters are floats or ``[B]``
tensors (``[B, P]`` / ``[P]`` for a PWL point list).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cedarsim_tpu_torch import config
from cedarsim_tpu_torch.core.context import Modes
from cedarsim_tpu_torch.core.dual import val
from cedarsim_tpu_torch.devices.base import DeviceModel
from cedarsim_tpu_torch.devices import waveforms as wf


def _where(c, a, b):
    if isinstance(c, torch.Tensor):
        return torch.where(c, a, b)
    return a if c else b


class Resistor(DeviceModel):
    terminals = ("p", "n")
    n_noise = 1
    params = dict(r=None, rsh=0.0, l=0.0, w=1e-6, short=0.0, narrow=0.0,
                  tc1=0.0, tc2=0.0, tnom=27.0)
    given_params = ("r",)

    @staticmethod
    def resistance(p, ctx=None):
        den = p["w"] - p["narrow"]
        den = _where(abs(den) < 1e-15, 1e-15, den)
        r_sheet = p["rsh"] * (p["l"] - p["short"]) / den
        r = _where(p["r$given"] > 0, p["r"], r_sheet)
        if ctx is not None:
            dt = (ctx.temp - config.T_ZERO_C) - p["tnom"]
            r = r * (1.0 + p["tc1"] * dt + p["tc2"] * dt * dt)
        floor = _where(r < 0, -1e-12, 1e-12)
        return _where(abs(r) < 1e-12, floor, r)

    @staticmethod
    def eval(lv, p, ctx, eps):
        g = 1.0 / Resistor.resistance(p, ctx)
        i = g * (lv[0] - lv[1])
        return [i, -i], [0.0, 0.0]

    @classmethod
    def prepare(cls, raw):
        raw = dict(raw)
        if raw.get("r") is None:
            raw.pop("r", None)
        if "r" not in raw and not raw.get("rsh"):
            raise ValueError(
                "resistor needs either r= or a sheet resistance rsh=")
        p = super().prepare(raw)
        if p["r"] is None:
            p["r"] = 0.0
        return p


class Capacitor(DeviceModel):
    terminals = ("p", "n")
    params = dict(c=0.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        q = p["c"] * (lv[0] - lv[1])
        return [0.0, 0.0], [q, -q]


def _source_value(p, ctx, wave, like):
    """Mode-dependent source value (DC in DCOP/AC unless only a waveform
    was given, the waveform at t=0 in TRANOP, at ctx.time in TRAN), times
    the source-stepping factor."""
    dc = p["dc"]
    if wave is None:
        v = dc
    else:
        zero = torch.zeros_like(like)
        if ctx.mode in (Modes.DCOP, Modes.AC):
            v = _where(p["dc$given"] > 0, dc, wave(zero))
        elif ctx.mode == Modes.TRANOP:
            v = wave(zero)
        else:
            t = ctx.time
            if not isinstance(t, torch.Tensor):
                t = torch.full_like(like, t)
            v = wave(t)
    return v * ctx.sourcefac


class _VSourceBase(DeviceModel):
    terminals = ("p", "n")
    n_branch = 1

    @classmethod
    def _wave(cls, p):
        return None

    @classmethod
    def eval_with_wave(cls, lv, p, ctx, eps):
        vp, vn, ib = lv[0], lv[1], lv[2]
        v = _source_value(p, ctx, cls._wave(p), val(ib))
        return [ib, -ib, vp - vn - v], [0.0, 0.0, 0.0]


class VSource(_VSourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0)
    given_params = ("dc",)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return VSource.eval_with_wave(lv, p, ctx, eps)


class VSourcePWL(_VSourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0, ts=(), ys=())
    given_params = ("dc",)

    @classmethod
    def group_key(cls, inst_params):
        return f"{cls.__name__}[{len(inst_params['ts'])}]"

    @classmethod
    def _wave(cls, p):
        return lambda t: wf.pwl_value(p["ts"], p["ys"], t)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return VSourcePWL.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return wf.pwl_breakpoints(p["ts"], tstop)


class VSourcePULSE(_VSourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0, v1=0.0, v2=0.0, td=0.0,
                  tr=1e-15, tf=1e-15, pw=math.inf, per=math.inf)
    given_params = ("dc",)

    @classmethod
    def _wave(cls, p):
        return lambda t: wf.pulse_value(
            p["v1"], p["v2"], p["td"], p["tr"], p["tf"], p["pw"], p["per"], t)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return VSourcePULSE.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return wf.pulse_breakpoints(
            float(p["v1"]), float(p["v2"]), float(p["td"]), float(p["tr"]),
            float(p["tf"]), float(np.minimum(p["pw"], 1e30)),
            float(np.minimum(p["per"], 1e30)) if np.isfinite(p["per"])
            else np.inf, tstop)
