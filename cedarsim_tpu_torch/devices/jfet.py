"""JFET (SPICE level-1 Shichman–Hodges) and MESFET (Statz), the J and Z
element letters — counterpart of ``cedarsim_tpu/devices/jfet.py``.

Both are 3-terminal (d, g, s) with a symmetric drain/source swap, gate
junction diodes and depletion charges, and a polarity flag so N and P
devices evaluate as one group, as :class:`~cedarsim_tpu_torch.devices.mos.
Mos1` does.
"""

from __future__ import annotations

from cedarsim_tpu_torch.core import dual as D
from cedarsim_tpu_torch.core.dual import val
from cedarsim_tpu_torch.devices.base import DeviceModel
from cedarsim_tpu_torch.devices.simple import _limexp, qdep

_FET_PARAMS = dict(ptype=1.0, cgs=0.0, cgd=0.0, pb=1.0, fc=0.5,
                   **{"is": 1e-14}, n=1.0,
                   rd=0.0, rs=0.0)     # accepted, currently ignored


def _swap(lv, sgn):
    """(vd, vg, vs, rev, vds, vgs): the symmetric drain/source swap in the
    polarity-flipped frame."""
    vd, vg, vs = lv[0], lv[1], lv[2]
    vd_, vg_, vs_ = sgn * vd, sgn * vg, sgn * vs
    rev = val(vd_) < val(vs_)
    vhi = D.maximum(vd_, vs_)
    vlo = D.minimum(vd_, vs_)
    return vd, vg, vs, rev, vhi - vlo, vg_ - vlo


def _finish(p, ctx, sgn, vd, vg, vs, rev, ido):
    """Un-swap the channel current, add the gate junctions (diode current
    and 0.5-graded depletion charge) and return the rows."""
    ids = sgn * D.where(rev, -ido, ido) + ctx.gmin * (vd - vs)
    vt = ctx.vt * p["n"]
    vgs_j = sgn * (vg - vs)
    vgd_j = sgn * (vg - vd)
    igs = sgn * (p["is"] * (_limexp(vgs_j / vt) - 1.0)) \
        + ctx.gmin * (vg - vs)
    igd = sgn * (p["is"] * (_limexp(vgd_j / vt) - 1.0)) \
        + ctx.gmin * (vg - vd)
    qgs = sgn * qdep(vgs_j, p["cgs"], p["pb"], 0.5, p["fc"])
    qgd = sgn * qdep(vgd_j, p["cgd"], p["pb"], 0.5, p["fc"])
    return ([ids - igd, igs + igd, -ids - igs],
            [-qgd, qgs + qgd, -qgs])


class Jfet(DeviceModel):
    """SPICE JFET (NJF/PJF, Shichman–Hodges): square-law channel with
    channel-length modulation, gate-source/gate-drain junction diodes and
    0.5-graded depletion capacitances.  ``area`` scales beta/is/caps
    (applied by the elaborator from the card's area factor)."""
    terminals = ("d", "g", "s")
    params = dict(vto=-2.0, beta=1e-4, lam=0.0, **_FET_PARAMS)

    @staticmethod
    def eval(lv, p, ctx, eps):
        sgn = p["ptype"]
        vd, vg, vs, rev, vds, vgs = _swap(lv, sgn)
        # depletion-mode threshold: vto keeps its sign for both polarities
        vgst = vgs - p["vto"]
        clm = 1.0 + p["lam"] * vds
        id_tri = p["beta"] * vds * (2.0 * vgst - vds) * clm
        id_sat = p["beta"] * vgst * vgst * clm
        ido = D.where(val(vgst) <= 0.0, 0.0,
                      D.where(val(vds) < val(vgst), id_tri, id_sat))
        return _finish(p, ctx, sgn, vd, vg, vs, rev, ido)


class Mesfet(DeviceModel):
    """SPICE MESFET (NMF/PMF, Statz et al. 1987): ids =
    beta·vgst²/(1+b·vgst) · (1−(1−alpha·vds/3)³)·(1+lambda·vds) for
    vds < 3/alpha, saturating beyond; the JFET's gate junctions."""
    terminals = ("d", "g", "s")
    params = dict(vto=-2.0, beta=2.5e-3, b=0.3, alpha=2.0, lam=0.0,
                  **_FET_PARAMS)

    @staticmethod
    def eval(lv, p, ctx, eps):
        sgn = p["ptype"]
        vd, vg, vs, rev, vds, vgs = _swap(lv, sgn)
        vgst = vgs - p["vto"]
        kq = p["beta"] * vgst * vgst / (1.0 + p["b"] * vgst)
        cut = 1.0 - p["alpha"] * vds / 3.0
        shape = D.where(val(cut) > 0.0, 1.0 - cut * cut * cut, 1.0)
        ido = D.where(val(vgst) <= 0.0, 0.0,
                      kq * shape * (1.0 + p["lam"] * vds))
        return _finish(p, ctx, sgn, vd, vg, vs, rev, ido)
