"""MOSFET level 1 (Shichman–Hodges) — counterpart of
``cedarsim_tpu/devices/mos.py``, the built-in MOS model for ``.model ...
nmos/pmos level=1``.

Symmetric drain/source formulation (a branchless swap on the sign of vds),
channel-length modulation, body effect, overlap gate charges and junction
depletion charges.  PMOS is the same class with ``ptype=-1`` (a polarity
flip), so the N and P devices of a netlist evaluate as one group.  Every
operation takes the JAX package's differentiation rule (``core/dual.py``),
and the eval records as device code for the fused chord kernel
(``va/emit.py``): tests read values (``val``), never tangents.
"""

from __future__ import annotations

from cedarsim_tpu_torch.core import dual as D
from cedarsim_tpu_torch.core.dual import val
from cedarsim_tpu_torch.devices.base import DeviceModel
from cedarsim_tpu_torch.devices.simple import _limexp, qdep


class Mos1(DeviceModel):
    terminals = ("d", "g", "s", "b")
    params = dict(
        ptype=1.0,      # +1 NMOS, -1 PMOS (set by elaborator from model type)
        vto=0.0, kp=2e-5, gamma=0.0, phi=0.6, lam=0.0,
        w=100e-6, l=100e-6, ld=0.0,
        cgso=0.0, cgdo=0.0, cgbo=0.0,
        cbd=0.0, cbs=0.0, pb=0.8, mj=0.5, fc=0.5,
        **{"is": 1e-14},
        tox=0.0, nsub=0.0, u0=0.0,   # accepted, only used if kp not given
        rd=0.0, rs=0.0,              # accepted, currently ignored
    )
    given_params = ("kp",)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vd, vg, vs, vb = lv[0], lv[1], lv[2], lv[3]
        sgn = p["ptype"]
        # polarity flip: PMOS analyzed as NMOS in flipped coordinates
        vd_, vg_, vs_, vb_ = sgn * vd, sgn * vg, sgn * vs, sgn * vb

        # symmetric swap so vds >= 0
        rev = val(vd_) < val(vs_)
        vhi = D.maximum(vd_, vs_)
        vlo = D.minimum(vd_, vs_)
        vds = vhi - vlo
        vgs = vg_ - vlo
        vbs = vb_ - vlo

        kp = D.where(p["kp$given"] > 0, p["kp"], 2e-5)
        leff = D.maximum(p["l"] - 2.0 * p["ld"], 1e-9)
        beta = kp * p["w"] / leff
        phi = D.maximum(p["phi"], 1e-3)
        # body effect (sqrt clamped for forward body bias)
        sqarg = D.sqrt(D.maximum(phi - vbs, 1e-6))
        # SPICE sign convention: PMOS vto is negative; in the flipped
        # (NMOS-equivalent) frame the threshold is sgn·vto
        vth = sgn * p["vto"] + p["gamma"] * (sqarg - D.sqrt(phi))
        vgst = vgs - vth
        clm = 1.0 + p["lam"] * vds
        id_tri = beta * (vgst - 0.5 * vds) * vds * clm
        id_sat = 0.5 * beta * vgst * vgst * clm
        ido = D.where(val(vgst) <= 0.0, 0.0,
                      D.where(val(vds) < val(vgst), id_tri, id_sat))
        # un-swap and un-flip; add gmin for convergence
        ids = sgn * D.where(rev, -ido, ido) + ctx.gmin * (vd - vs)

        # gate overlap charges (linear)
        w = p["w"]
        qgs = p["cgso"] * w * (vg - vs)
        qgd = p["cgdo"] * w * (vg - vd)
        qgb = p["cgbo"] * leff * (vg - vb)

        def qjunc(v, cj):
            return qdep(v, cj, p["pb"], p["mj"], p["fc"])

        # bulk junctions; charge on the bulk plate: q_b = +qjunc
        qbd = sgn * qjunc(sgn * (vb - vd), p["cbd"])
        qbs = sgn * qjunc(sgn * (vb - vs), p["cbs"])
        # junction leakage diodes b-d, b-s
        vt = ctx.vt
        ibd = sgn * (p["is"] * (_limexp(sgn * (vb - vd) / vt) - 1.0)) \
            + ctx.gmin * (vb - vd)
        ibs = sgn * (p["is"] * (_limexp(sgn * (vb - vs) / vt) - 1.0)) \
            + ctx.gmin * (vb - vs)

        i_d = ids - ibd
        i_s = -ids - ibs
        i_b = ibd + ibs
        q_d = -qgd - qbd
        q_g = qgs + qgd + qgb
        q_s = -qgs - qbs
        q_b = -qgb + qbd + qbs
        return [i_d, 0.0, i_s, i_b], [q_d, q_g, q_s, q_b]
