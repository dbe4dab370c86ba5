"""Bipolar junction transistor, Gummel–Poon (SPICE ``.model ... npn/pnp``)
— counterpart of ``cedarsim_tpu/devices/bjt.py``.

Ideal and leakage junction diodes, Early and high-injection base-charge
modulation (q1/q2/qb), depletion (cje/cjc/cjs) and diffusion (tf/tr)
charges.  PNP is a polarity flip, so NPN and PNP evaluate as one group.
Collector and base shot noise enter as ``eps[0]`` and ``eps[1]`` when the
noise analysis passes them; the emitter row takes them as the JAX
package's ``eval`` does (``ie = −(ic + ib) − eps[0] − eps[1]``, with ``ic``
and ``ib`` already holding them).
"""

from __future__ import annotations

from cedarsim_tpu_torch import config
from cedarsim_tpu_torch.core import dual as D
from cedarsim_tpu_torch.devices.base import DeviceModel
from cedarsim_tpu_torch.devices.simple import _limexp, qdep


def _inv_or_zero(v, floor):
    """1/max(v, floor) where v > 0, else 0 (a 0-valued vaf/ikf: infinite)."""
    return D.where(v > 0, 1.0 / D.maximum(v, floor), 0.0)


class Bjt(DeviceModel):
    terminals = ("c", "b", "e", "s")
    n_noise = 2   # collector + base shot noise
    params = dict(
        ptype=1.0,   # +1 NPN, -1 PNP
        **{"is": 1e-16}, bf=100.0, br=1.0, nf=1.0, nr=1.0,
        vaf=0.0, var=0.0, ikf=0.0, ikr=0.0,       # 0 = infinite (not given)
        ise=0.0, isc=0.0, ne=1.5, nc=2.0,
        cje=0.0, vje=0.75, mje=0.33,
        cjc=0.0, vjc=0.75, mjc=0.33,
        cjs=0.0, vjs=0.75, mjs=0.0,
        tf=0.0, tr=0.0, fc=0.5, area=1.0,
    )

    @staticmethod
    def eval(lv, p, ctx, eps):
        vc, vb, ve, vs = lv[0], lv[1], lv[2], lv[3]
        sgn = p["ptype"]
        vbe = sgn * (vb - ve)
        vbc = sgn * (vb - vc)
        vsc = sgn * (vs - vc)
        vt = ctx.vt
        a = p["area"]
        isat = p["is"] * a

        ibe1 = isat * (_limexp(vbe / (p["nf"] * vt)) - 1.0)
        ibc1 = isat * (_limexp(vbc / (p["nr"] * vt)) - 1.0)
        iben = p["ise"] * a * (_limexp(vbe / (p["ne"] * vt)) - 1.0)
        ibcn = p["isc"] * a * (_limexp(vbc / (p["nc"] * vt)) - 1.0)

        # base charge qb (Early + high injection)
        inv_vaf = _inv_or_zero(p["vaf"], 1e-30)
        inv_var = _inv_or_zero(p["var"], 1e-30)
        inv_ikf = D.where(p["ikf"] > 0, 1.0 / D.maximum(p["ikf"] * a, 1e-30),
                          0.0)
        inv_ikr = D.where(p["ikr"] > 0, 1.0 / D.maximum(p["ikr"] * a, 1e-30),
                          0.0)
        q1 = 1.0 / D.maximum(1.0 - vbc * inv_vaf - vbe * inv_var, 1e-4)
        q2 = ibe1 * inv_ikf + ibc1 * inv_ikr
        qb = 0.5 * q1 * (1.0 + D.sqrt(1.0 + 4.0 * D.maximum(q2, 0.0)))

        ict = (ibe1 - ibc1) / qb
        ib = ibe1 / p["bf"] + iben + ibc1 / p["br"] + ibcn \
            + ctx.gmin * (vbe + vbc)
        ic = ict - ibc1 / p["br"] - ibcn - ctx.gmin * vbc
        if eps is None:
            ie = -(ic + ib)
        else:
            ib = ib + eps[1]
            ic = ic + eps[0]
            ie = -(ic + ib) - eps[0] - eps[1]

        # charges
        qbe = qdep(vbe, p["cje"] * a, p["vje"], p["mje"], p["fc"]) \
            + p["tf"] * ibe1 / qb
        qbc = qdep(vbc, p["cjc"] * a, p["vjc"], p["mjc"], p["fc"]) \
            + p["tr"] * ibc1
        qsc = qdep(vsc, p["cjs"] * a, p["vjs"], D.maximum(p["mjs"], 1e-3),
                   p["fc"]) * D.where(p["cjs"] > 0, 1.0, 0.0)

        return ([sgn * ic, sgn * ib, sgn * ie, 0.0],
                [sgn * (-qbc - qsc), sgn * (qbe + qbc), sgn * (-qbe),
                 sgn * qsc])

    @classmethod
    def noise(cls, lv, p, ctx):
        """Shot noise 2q|I| of the collector transport current and of the
        ideal base current."""
        vc, vb, ve = lv[0], lv[1], lv[2]
        sgn = p["ptype"]
        vbe = sgn * (vb - ve)
        vbc = sgn * (vb - vc)
        vt = ctx.vt
        isat = p["is"] * p["area"]
        ibe1 = isat * (_limexp(vbe / (p["nf"] * vt)) - 1.0)
        ibc1 = isat * (_limexp(vbc / (p["nr"] * vt)) - 1.0)
        return ([2.0 * config.Q_CHARGE * abs(ibe1 - ibc1),
                 2.0 * config.Q_CHARGE * abs(ibe1 / p["bf"])], [0.0, 0.0])
