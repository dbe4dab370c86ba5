"""Built-in SPICE devices — counterpart of ``cedarsim_tpu/devices/simple.py``:
R, C, L, coupled L (K), the V and I sources (DC, PWL, PULSE, SIN, EXP), the
controlled sources (E, G, H, F), the switches (S, W), the junction diode,
the open and short circuits, the nonlinear R and C factories and the
transmission lines (``TLine``, ``LTRALine``), whose delayed waves ride the
integrator's delay ring (``n_delay`` aux inputs, ``delays``).

Each ``eval`` is the JAX package's stamp over a batch of instances: ``lv``
entries are ``[B]`` tensors or Duals, parameters are floats or ``[B]``
tensors (``[B, P]`` / ``[P]`` for a PWL point list).  Every operation that
the JAX package differentiates takes the same rule here (``core/dual.py``:
``jax.numpy``'s rules for the built-ins), so the local Jacobians agree to
round-off.  The resistor's thermal and the diode's shot noise enter as
``eps[0]`` in their current (only when the noise analysis passes ``eps``),
and the V and I sources give their ``ac``/``acphase`` drive to the AC
analysis (``ac_rhs``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cedarsim_tpu_torch import config
from cedarsim_tpu_torch.core.context import Modes
from cedarsim_tpu_torch.core import dual as D
from cedarsim_tpu_torch.core.dual import val
from cedarsim_tpu_torch.devices.base import DeviceModel
from cedarsim_tpu_torch.devices import waveforms as wf


def _limexp(x, lim=40.0):
    """exp with a linear continuation beyond ``lim`` (the built-ins' own
    40, not the Verilog-A ``limexp``'s 80): keeps Newton finite for large
    junction voltages."""
    return D.limexp(x, lim)


class Resistor(DeviceModel):
    terminals = ("p", "n")
    n_noise = 1
    params = dict(r=None, rsh=0.0, l=0.0, w=1e-6, short=0.0, narrow=0.0,
                  tc1=0.0, tc2=0.0, tnom=27.0)
    given_params = ("r",)

    @staticmethod
    def resistance(p, ctx=None):
        den = p["w"] - p["narrow"]
        den = D.where(abs(den) < 1e-15, 1e-15, den)
        r_sheet = p["rsh"] * (p["l"] - p["short"]) / den
        r = D.where(p["r$given"] > 0, p["r"], r_sheet)
        if ctx is not None:
            dt = (ctx.temp - config.T_ZERO_C) - p["tnom"]
            r = r * (1.0 + p["tc1"] * dt + p["tc2"] * dt * dt)
        floor = D.where(r < 0, -1e-12, 1e-12)
        return D.where(abs(r) < 1e-12, floor, r)

    @staticmethod
    def eval(lv, p, ctx, eps):
        g = 1.0 / Resistor.resistance(p, ctx)
        i = g * (lv[0] - lv[1])
        if eps is not None:
            i = i + eps[0]
        return [i, -i], [0.0, 0.0]

    @classmethod
    def noise(cls, lv, p, ctx):
        """Thermal noise 4kT/|R|."""
        r = cls.resistance(p, ctx)
        return [4.0 * config.K_BOLTZMANN * ctx.temp / abs(r)], [0.0]

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


class Inductor(DeviceModel):
    terminals = ("p", "n")
    n_branch = 1
    params = dict(l=0.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn, il = lv[0], lv[1], lv[2]
        # branch eq: (vp - vn) - d/dt (L·i) = 0
        return [il, -il, vp - vn], [0.0, 0.0, -p["l"] * il]


class CoupledInductors(DeviceModel):
    """Two magnetically coupled inductors (SPICE K element): the elaborator
    replaces the two L instances with one 4-terminal device.
    v1 = d/dt(L1·i1 + M·i2), v2 = d/dt(M·i1 + L2·i2), M = k·sqrt(L1·L2)."""
    terminals = ("p1", "n1", "p2", "n2")
    n_branch = 2
    params = dict(l1=0.0, l2=0.0, k=0.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp1, vn1, vp2, vn2, i1, i2 = lv[0], lv[1], lv[2], lv[3], lv[4], lv[5]
        m = p["k"] * D.sqrt(p["l1"] * p["l2"])
        return ([i1, -i1, i2, -i2, vp1 - vn1, vp2 - vn2],
                [0.0, 0.0, 0.0, 0.0, -(p["l1"] * i1 + m * i2),
                 -(m * i1 + p["l2"] * i2)])


def _ac_phasor(p):
    """``ac · e^(j·acphase·π/180)``: a Python complex, or a complex tensor
    where ``ac`` or ``acphase`` is a tensor."""
    mag, ph = p["ac"], p["acphase"] * (math.pi / 180.0)
    if isinstance(mag, torch.Tensor) or isinstance(ph, torch.Tensor):
        like = mag if isinstance(mag, torch.Tensor) else ph
        mag = torch.as_tensor(mag, dtype=like.dtype, device=like.device)
        ph = torch.as_tensor(ph, dtype=like.dtype, device=like.device)
        return torch.complex(mag * torch.cos(ph), mag * torch.sin(ph))
    return complex(mag * math.cos(ph), mag * math.sin(ph))


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
            v = D.where(p["dc$given"] > 0, dc, wave(zero))
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

    @classmethod
    def ac_rhs(cls, p):
        return [0.0, 0.0, _ac_phasor(p)]


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


class VSourceSIN(_VSourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0, vo=0.0, va=0.0, freq=0.0,
                  td=0.0, theta=0.0, phase=0.0)
    given_params = ("dc",)

    @classmethod
    def _wave(cls, p):
        return lambda t: wf.sin_value(
            p["vo"], p["va"], p["freq"], p["td"], p["theta"], p["phase"], t)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return VSourceSIN.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return wf.sin_breakpoints(float(p["td"]), tstop)


class VSourceEXP(_VSourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0, v1=0.0, v2=0.0, td1=0.0,
                  tau1=1e-9, td2=1e30, tau2=1e-9)
    given_params = ("dc",)

    @classmethod
    def _wave(cls, p):
        return lambda t: wf.exp_value(p["v1"], p["v2"], p["td1"], p["tau1"],
                                      p["td2"], p["tau2"], t)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return VSourceEXP.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return wf.exp_breakpoints(float(p["td1"]), float(p["td2"]), tstop)


class _ISourceBase(DeviceModel):
    terminals = ("p", "n")

    @classmethod
    def _wave(cls, p):
        return None

    @classmethod
    def eval_with_wave(cls, lv, p, ctx, eps):
        i = _source_value(p, ctx, cls._wave(p), val(lv[0]))
        return [i, -i], [0.0, 0.0]

    @classmethod
    def ac_rhs(cls, p):
        b = _ac_phasor(p)
        return [-b, b]


class ISource(_ISourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0)
    given_params = ("dc",)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return ISource.eval_with_wave(lv, p, ctx, eps)


class ISourcePWL(_ISourceBase):
    params = VSourcePWL.params
    given_params = ("dc",)

    @classmethod
    def group_key(cls, inst_params):
        return f"{cls.__name__}[{len(inst_params['ts'])}]"

    @classmethod
    def _wave(cls, p):
        return VSourcePWL._wave(p)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return ISourcePWL.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return VSourcePWL.breakpoints(p, tstop)


class ISourcePULSE(_ISourceBase):
    params = VSourcePULSE.params
    given_params = ("dc",)

    @classmethod
    def _wave(cls, p):
        return VSourcePULSE._wave(p)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return ISourcePULSE.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return VSourcePULSE.breakpoints(p, tstop)


class ISourceEXP(_ISourceBase):
    params = VSourceEXP.params
    given_params = ("dc",)

    @classmethod
    def _wave(cls, p):
        return VSourceEXP._wave(p)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return ISourceEXP.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return VSourceEXP.breakpoints(p, tstop)


class ISourceSIN(_ISourceBase):
    params = VSourceSIN.params
    given_params = ("dc",)

    @classmethod
    def _wave(cls, p):
        return VSourceSIN._wave(p)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return ISourceSIN.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return VSourceSIN.breakpoints(p, tstop)


# --------------------------------------------------------- controlled sources

class VCVS(DeviceModel):
    """E element: V(p,n) = gain·V(cp,cn)."""
    terminals = ("p", "n", "cp", "cn")
    n_branch = 1
    params = dict(gain=1.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn, vcp, vcn, ib = lv[0], lv[1], lv[2], lv[3], lv[4]
        return ([ib, -ib, 0.0, 0.0, vp - vn - p["gain"] * (vcp - vcn)],
                [0.0] * 5)


class VCCS(DeviceModel):
    """G element: I(p→n) = gm·V(cp,cn)."""
    terminals = ("p", "n", "cp", "cn")
    params = dict(gm=1.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        i = p["gm"] * (lv[2] - lv[3])
        return [i, -i, 0.0, 0.0], [0.0] * 4


class CCVS(DeviceModel):
    """H element: V(p,n) = r·I(ctrl_vsource).  The control is a gathered
    branch-current unknown (n_control=1, resolved by the compiler)."""
    terminals = ("p", "n")
    n_branch = 1
    n_control = 1
    params = dict(r=1.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn, ib, ictrl = lv[0], lv[1], lv[2], lv[3]
        return [ib, -ib, vp - vn - p["r"] * ictrl], [0.0] * 3


class CCCS(DeviceModel):
    """F element: I(p→n) = f·I(ctrl_vsource)."""
    terminals = ("p", "n")
    n_control = 1
    params = dict(f=1.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        i = p["f"] * lv[2]
        return [i, -i], [0.0, 0.0]


class VSwitch(DeviceModel):
    """S element: voltage-controlled switch (.model sw ron/roff/vt/vh) with
    a smoothstep interpolation of the log-conductance between states."""
    terminals = ("p", "n", "cp", "cn")
    params = dict(ron=1.0, roff=1e12, vt=0.0, vh=0.0)

    @staticmethod
    def _g(ctrl, p):
        vh = D.maximum(p["vh"], 1e-6)
        x = D.minimum(D.maximum((ctrl - p["vt"]) / (2.0 * vh) + 0.5, 0.0),
                      1.0)                       # jnp.clip
        t = x * x * (3.0 - 2.0 * x)
        ln_g = D.log(1.0 / p["roff"]) + t * (
            D.log(1.0 / p["ron"]) - D.log(1.0 / p["roff"]))
        return D.exp(ln_g)

    @staticmethod
    def eval(lv, p, ctx, eps):
        i = VSwitch._g(lv[2] - lv[3], p) * (lv[0] - lv[1])
        return [i, -i, 0.0, 0.0], [0.0] * 4


class ISwitch(DeviceModel):
    """W element: current-controlled switch (control = a V-source branch
    current)."""
    terminals = ("p", "n")
    n_control = 1
    params = dict(ron=1.0, roff=1e12, it=0.0, ih=0.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        g = VSwitch._g(lv[2], dict(ron=p["ron"], roff=p["roff"],
                                   vt=p["it"], vh=p["ih"]))
        i = g * (lv[0] - lv[1])
        return [i, -i], [0.0, 0.0]


# --------------------------------------------------------------------- diode

def qdep(v, cj, vj, mj, fc):
    """Depletion charge for C(v) = cj/(1-v/vj)^mj, linearized past fc·vj
    (standard SPICE; the diode's, the MOSFET's junctions' and the BJT's)."""
    below = cj * vj / (1 - mj) * (
        1.0 - D.power(D.maximum(1.0 - v / vj, 1e-6), 1 - mj))
    f1 = vj / (1 - mj) * (1.0 - D.power(1 - fc, 1 - mj))
    f2 = D.power(1 - fc, -(1 + mj))
    above = cj * (f1 + f2 * ((1 - fc * (1 + mj)) * (v - fc * vj)
                             + 0.5 * mj / vj * (v * v - fc * fc * vj * vj)))
    return D.where(val(v) < val(fc * vj), below, above)


class Diode(DeviceModel):
    """Berkeley-style junction diode: exponential forward region,
    saturation reverse region, exponential breakdown beyond -bv; depletion
    (cj0/vj/m/fc) and diffusion (tt) charge."""
    terminals = ("p", "n")
    n_noise = 1
    params = dict(**{"is": 1e-14}, n=1.0, cj0=0.0, vj=1.0, m=0.5, fc=0.5,
                  tt=0.0, bv=math.inf, ibv=1e-3, area=1.0,
                  eg=1.11, xti=3.0, tnom=27.0)
    given_params = ("bv",)

    @staticmethod
    def isat_t(p, ctx):
        """IS(T) = IS·(T/Tnom)^(XTI/N)·exp(EG/(N·Vt)·(T/Tnom − 1))."""
        tnom = p["tnom"] + config.T_ZERO_C
        tr = ctx.temp / tnom
        return (p["is"] * p["area"] * D.power(tr, p["xti"] / p["n"])
                * D.exp(p["eg"] / (p["n"] * ctx.vt) * (tr - 1.0)))

    @staticmethod
    def eval(lv, p, ctx, eps):
        v = lv[0] - lv[1]
        vte = p["n"] * ctx.vt
        isat = Diode.isat_t(p, ctx)
        i_fwd = isat * (_limexp(v / vte) - 1.0)
        # breakdown (only if bv given): current pulls v back above -bv
        i_brk = -isat * _limexp(-(p["bv"] + v) / vte)
        use_brk = _and(p["bv$given"] > 0, val(v) < val(-p["bv"]))
        i = D.where(use_brk, i_brk, i_fwd) + ctx.gmin * v
        if eps is not None:
            i = i + eps[0]
        cj0 = p["cj0"] * p["area"]
        q = qdep(v, cj0, p["vj"], p["m"], p["fc"]) + p["tt"] * i_fwd
        return [i, -i], [q, -q]

    @classmethod
    def noise(cls, lv, p, ctx):
        """Shot noise 2q|I| of the forward current."""
        v = lv[0] - lv[1]
        vte = p["n"] * ctx.vt
        i = cls.isat_t(p, ctx) * (_limexp(v / vte) - 1.0)
        return [2.0 * config.Q_CHARGE * abs(i)], [0.0]


def _and(a, b):
    """Logical and of two tests, each a Python bool or a bool tensor."""
    if not isinstance(a, torch.Tensor):
        return b if a else False
    if not isinstance(b, torch.Tensor):
        return a if b else False
    return a & b


# ------------------------------------------------------- functional devices

class OpenCircuit(DeviceModel):
    """Two terminals, no contribution."""
    terminals = ("p", "n")
    params = {}

    @staticmethod
    def eval(lv, p, ctx, eps):
        return [0.0, 0.0], [0.0, 0.0]


class ShortCircuit(DeviceModel):
    """Ideal short: V(p) − V(n) = 0 through a branch-current unknown."""
    terminals = ("p", "n")
    n_branch = 1
    params = {}

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn, i = lv[0], lv[1], lv[2]
        return [i, -i, vp - vn], [0.0] * 3


def nonlinear_resistor(f, name="NonlinearResistor"):
    """Device-class factory: two-terminal element with I = f(V(p,n)); ``f``
    takes a tensor or a Dual (write it with ``core/dual.py``'s functions
    where it needs more than arithmetic)."""
    class _NLR(DeviceModel):
        terminals = ("p", "n")
        params = {}

        @staticmethod
        def eval(lv, p, ctx, eps):
            i = f(lv[0] - lv[1])
            return [i, -i], [0.0, 0.0]

    _NLR.__name__ = _NLR.__qualname__ = name
    return _NLR


def nonlinear_capacitor(f, name="NonlinearCapacitor"):
    """Device-class factory: two-terminal element with charge Q =
    f(V(p,n))."""
    class _NLC(DeviceModel):
        terminals = ("p", "n")
        params = {}

        @staticmethod
        def eval(lv, p, ctx, eps):
            q = f(lv[0] - lv[1])
            return [0.0, 0.0], [q, -q]

    _NLC.__name__ = _NLC.__qualname__ = name
    return _NLC


# ------------------------------------------------------ transmission lines

def _two_port_stamp(y11, y12):
    """The 4-terminal (p1, n1, p2, n2) stamp [n_f, 4, 4] of a symmetric
    two-port's Y11, Y12 [n_f]."""
    Y2 = torch.stack([torch.stack([y11, y12], -1),
                      torch.stack([y12, y11], -1)], -2)
    T = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]],
                     dtype=Y2.dtype, device=Y2.device)
    return T @ Y2 @ T.T


class TLine(DeviceModel):
    """Lossless transmission line (SPICE T element) by Branin's method of
    characteristics: each port is a Thevenin Z0 source driven by the far
    port's wave one line delay ago,

        V1 − Z0·I1 = E1,  E1(t) = V2(t−td) + Z0·I2(t−td)
        V2 − Z0·I2 = E2,  E2(t) = V1(t−td) + Z0·I1(t−td),

    the delayed waves read from the integrator's history ring (``n_delay``
    aux inputs).  At the operating point the line is a DC short (the E
    waves read the live far port); in AC the branch rows pin I = 0 and the
    exact two-port Y(f) (``ac_admittance``) carries the physics."""
    terminals = ("p1", "n1", "p2", "n2")
    n_branch = 2
    n_delay = 2
    params = dict(z0=50.0, td=1e-9)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp1, vn1, vp2, vn2, i1, i2 = lv[0], lv[1], lv[2], lv[3], lv[4], lv[5]
        z0 = p["z0"]
        if ctx.mode == Modes.AC:
            return [0.0, 0.0, 0.0, 0.0, i1, i2], [0.0] * 6
        if ctx.mode in (Modes.DCOP, Modes.TRANOP):
            e1 = (vp2 - vn2) + z0 * i2
            e2 = (vp1 - vn1) + z0 * i1
        else:
            e1, e2 = eps[0], eps[1]
        return ([i1, -i1, i2, -i2, (vp1 - vn1) - z0 * i1 - e1,
                 (vp2 - vn2) - z0 * i2 - e2], [0.0] * 6)

    @classmethod
    def delays(cls, lv, p, ctx):
        """(u_now, td): the waves the far ports see one delay later."""
        vp1, vn1, vp2, vn2, i1, i2 = lv[0], lv[1], lv[2], lv[3], lv[4], lv[5]
        z0 = p["z0"]
        return ([(vp2 - vn2) + z0 * i2, (vp1 - vn1) + z0 * i1],
                [p["td"], p["td"]])

    @classmethod
    def echo_delays(cls, p):
        """A waveform corner re-emerges (and re-reflects) every line delay:
        the breakpoint echo period."""
        return [float(p["td"])]

    @classmethod
    def ac_admittance(cls, p):
        """The exact lossless two-port, θ = ω·td: Y11 = Y22 = −j·cot(θ)/Z0,
        Y12 = Y21 = j/(Z0·sin θ), |sin θ| floored at 1e-9 (a resonance
        stays finite)."""
        z0, td = float(p["z0"]), float(p["td"])

        def yfun(f):
            th = 2.0 * math.pi * f * td
            sn = torch.sin(th)
            sn = torch.where(sn.abs() < 1e-9,
                             torch.where(sn < 0, -1e-9, 1e-9), sn)
            cd = torch.complex128
            y11 = (-1j) * (torch.cos(th) / (sn * z0)).to(cd)
            y12 = 1j * (1.0 / (sn * z0)).to(cd)
            return _two_port_stamp(y11, y12)
        return yfun


class LTRALine(DeviceModel):
    """A lossy RLCG transmission-line section (SPICE O element, LTRA
    model), with series totals R = rtot, L = ltot and shunt totals G =
    gtot, C = ctot; the elaborator cascades sections of a lossy line.  The
    transient is Branin's waves (as :class:`TLine`) with the attenuation
    α = exp(−R/(2·Z0) − G·Z0/2), a −gc shunt at each wave node and a series
    lump ρ at each port sized so that the DC path resistance is exactly R,
    and G/2 across each port.  AC stamps the exact RLCG two-port, Y11 =
    coth(γ)/Zc, Y12 = −1/(Zc·sinh γ)."""
    terminals = ("p1", "n1", "p2", "n2")
    n_branch = 2
    n_delay = 2
    params = dict(rtot=0.0, ltot=250e-9, gtot=0.0, ctot=100e-12)

    @staticmethod
    def _derived(p):
        z0 = D.sqrt(p["ltot"] / p["ctot"])
        alpha = D.exp(-p["rtot"] / (2.0 * z0) - p["gtot"] * z0 / 2.0)
        # the attenuated wave pair's DC π-equivalent
        rs_w = z0 * (1.0 - alpha * alpha) / (2.0 * alpha)
        gc = (1.0 - alpha) / (z0 * (1.0 + alpha))
        rho = D.maximum(0.0, (p["rtot"] - rs_w) / 2.0)
        return z0, alpha, rho, gc

    @staticmethod
    def _waves(lv, p):
        """z0, α, the wave-node voltages U_k behind the ρ lumps and the
        line currents iL_k with the −gc compensation shunt."""
        vp1, vn1, vp2, vn2, i1, i2 = lv[0], lv[1], lv[2], lv[3], lv[4], lv[5]
        z0, alpha, rho, gc = LTRALine._derived(p)
        u1 = (vp1 - vn1) - rho * i1
        u2 = (vp2 - vn2) - rho * i2
        return z0, alpha, u1, u2, i1 + gc * u1, i2 + gc * u2

    @staticmethod
    def eval(lv, p, ctx, eps):
        i1, i2 = lv[4], lv[5]
        if ctx.mode == Modes.AC:
            return [0.0, 0.0, 0.0, 0.0, i1, i2], [0.0] * 6
        z0, alpha, u1, u2, il1, il2 = LTRALine._waves(lv, p)
        g2 = p["gtot"] / 2.0
        if ctx.mode in (Modes.DCOP, Modes.TRANOP):
            e1 = alpha * (u2 + z0 * il2)
            e2 = alpha * (u1 + z0 * il1)
        else:
            e1, e2 = alpha * eps[0], alpha * eps[1]
        vd1 = lv[0] - lv[1]
        vd2 = lv[2] - lv[3]
        return ([i1 + g2 * vd1, -(i1 + g2 * vd1), i2 + g2 * vd2,
                 -(i2 + g2 * vd2), u1 - z0 * il1 - e1, u2 - z0 * il2 - e2],
                [0.0] * 6)

    @classmethod
    def delays(cls, lv, p, ctx):
        """(u_now, td): the outgoing waves at each wave node, before the
        attenuation (``eval`` applies α)."""
        z0, _alpha, u1, u2, il1, il2 = cls._waves(lv, p)
        td = D.sqrt(p["ltot"] * p["ctot"])
        return [u2 + z0 * il2, u1 + z0 * il1], [td, td]

    @classmethod
    def echo_delays(cls, p):
        return [math.sqrt(float(p["ltot"]) * float(p["ctot"]))]

    @classmethod
    def ac_admittance(cls, p):
        """The exact RLCG two-port Y(f) (4-terminal stamp), Re γ clipped to
        [0, 300] and |sinh|, |tanh| floored at 1e-12."""
        r, l = float(p["rtot"]), float(p["ltot"])
        g, c = float(p["gtot"]), float(p["ctot"])

        def yfun(f):
            s = 2j * math.pi * f.to(torch.complex128)
            zs = r + s * l
            yp = g + s * c
            gl = torch.sqrt(zs * yp)
            gl = torch.complex(gl.real.clamp(0.0, 300.0), gl.imag)
            sh = torch.sinh(gl)
            sh = torch.where(sh.abs() < 1e-12,
                             torch.full_like(sh, 1e-12), sh)
            th = torch.tanh(gl)
            th = torch.where(th.abs() < 1e-12,
                             torch.full_like(th, 1e-12), th)
            yc = torch.sqrt(yp / zs)
            return _two_port_stamp(yc / th, -yc / sh)
        return yfun
