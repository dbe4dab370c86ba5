"""The port's Verilog-A interpreter on the BSIM4-class model against the JAX
package's: (S, Q) and the local Jacobians (G, C) at a grid of bias points.

The port carries the tangents as dual numbers; the JAX side takes
``jax.jacfwd`` under ``jax.vmap``.  Cards: the one of tests/test_bsim4.py and
the DFF benchmark's own nch_5p0 / pch_5p0.  Tolerance: rtol 1e-10 with an
absolute floor of 1e-18 A (A/V) for currents and conductances and 1e-24 C
(F) for charges and capacitances.
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.models import bsim4_class as jax_bsim4
from cedarsim_tpu_torch.core.compile import _stack_rows
from cedarsim_tpu_torch.core.dual import Dual
from cedarsim_tpu_torch.models import bsim4_class as torch_bsim4
from cedarsim_tpu_torch.va.codegen import load_va

DFF_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                       "gf180_dff")

# the card of tests/test_bsim4.py
NCARD = dict(
    TOXE=4.1e-9, NDEP=3.5e17, VTH0=0.47, K1=0.55, K2=0.03, K3=10.0,
    W0=1e-6, LPE0=2e-8, DVT0=1.5, DVT1=0.45, DVT2=-0.1,
    ETA0=0.02, ETAB=-0.03, DSUB=0.5, NFACTOR=1.2, VOFF=-0.09,
    U0=320.0, UA=1.2e-9, UB=2.0e-18, UC=-5e-11, VSAT=9e4,
    A0=1.1, AGS=0.25, KETA=-0.05, DELTA=0.01,
    RDSW=180.0, PRWG=0.4, PRWB=-0.2,
    PCLM=1.2, PDIBLC1=0.08, PDIBLC2=0.006, DROUT=0.5,
    PSCBE1=4.5e8, PSCBE2=1e-6, ALPHA0=1e-8, BETA0=18.0,
    XJ=1.6e-7, CGSO=3.5e-10, CGDO=3.5e-10, CGBO=1e-11,
    CJS=9.5e-4, MJS=0.38, PBS=0.75, CJSWS=2.5e-10, MJSWS=0.25,
    JSS=1.5e-6, KT1=-0.25, UTE=-1.6, AT=3.5e4, KF=1e-25,
    W=1e-6, L=0.18e-6, AS=0.5e-12, AD=0.5e-12, PS=3e-6, PD=3e-6,
)


def _bias_grid(vmax, sign):
    vd = [-0.15 * vmax, 0.03 * vmax, 0.35 * vmax, vmax]
    vg = [-0.1 * vmax, 0.15 * vmax, 0.35 * vmax, 0.7 * vmax, vmax]
    vs = [0.0, 0.1 * vmax]
    vb = [0.0, -0.25 * vmax]
    pts = np.array(list(itertools.product(vd, vg, vs, vb)), np.float64)
    return sign * pts


def _dff_cards():
    """Prepared instance params of one NMOS and one PMOS of the DFF."""
    with open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")) as f:
        text = f.read()
    ckt = J.elaborate(J.parse_spice(text, file="dff_tb_bsim4.cir"),
                      include_paths=[DFF_DIR])
    out = {}
    for inst in ckt.instances:
        if inst.model.__name__ != "VA_bsim4":
            continue
        kind = "nch" if inst.params["TYPE"] > 0 else "pch"
        out.setdefault(kind, inst)
    return out


def _jax_eval(p, ctx, V, W=None):
    cls = jax_bsim4(0)
    eps = jnp.zeros(cls.n_noise)

    def f(lv, w):
        pp = dict(p) if w is None else {**p, "W": w}
        s, q = cls.eval(lv, pp, ctx, eps)
        return (s, q), (s, q)

    w_in = None if W is None else jnp.asarray(W)
    (Js, Jq), (s, q) = jax.vmap(jax.jacfwd(f, has_aux=True),
                                in_axes=(0, None if W is None else 0))(
        jnp.asarray(V), w_in)
    return [np.asarray(a) for a in (s, q, Js, Jq)]


def _torch_eval(p, ctx, V, W=None):
    cls = torch_bsim4(0)
    N, K = V.shape
    Vt = torch.from_numpy(V)
    eye = torch.eye(K, dtype=torch.float64)
    lv = [Dual(Vt[:, k], eye[:, k:k + 1].expand(K, N)) for k in range(K)]
    pp = dict(p) if W is None else {**p, "W": torch.from_numpy(W)}
    s_rows, q_rows = cls.eval(lv, pp, ctx, None)
    s, ds = _stack_rows(s_rows, N, K, torch.float64, torch.device("cpu"))
    q, dq = _stack_rows(q_rows, N, K, torch.float64, torch.device("cpu"))
    return [a.numpy() for a in (s, q, ds, dq)]


def _check(ours, ref):
    for name, a, b, floor in zip("SQGC", ours, ref,
                                 (1e-18, 1e-24, 1e-18, 1e-24)):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=floor,
                                   err_msg=name)


@pytest.mark.parametrize("card", ["test_bsim4", "nch_5p0", "pch_5p0"])
def test_bsim4_matches_jax(card):
    if card == "test_bsim4":
        p_j = jax_bsim4(0).prepare(NCARD)
        p_t = torch_bsim4(0).prepare(NCARD)
        V = _bias_grid(1.8, 1.0)
    else:
        inst = _dff_cards()[card[:3]]
        p_j = dict(inst.params)
        raw = {k: v for k, v in inst.params.items() if not k.endswith(
            "$given") and inst.params.get(k + "$given", 0.0) > 0}
        p_t = torch_bsim4(0).prepare(raw)
        V = _bias_grid(5.0, 1.0 if card.startswith("n") else -1.0)
    assert p_t == p_j
    ref = _jax_eval(p_j, J.SimSpec.make(), V)
    ours = _torch_eval(p_t, T.SimSpec.make(), V)
    _check(ours, ref)


def test_bsim4_per_lane_width_takes_the_merge_path():
    """W as a per-entry tensor (the slice's per-lane scatter): every
    W-dependent branch merges both sides with torch.where."""
    p = torch_bsim4(0).prepare(NCARD)
    V = _bias_grid(1.8, 1.0)
    W = np.linspace(0.5e-6, 3e-6, len(V))
    ref = _jax_eval(p, J.SimSpec.make(), V, W=W)
    ours = _torch_eval(p, T.SimSpec.make(), V, W=W)
    _check(ours, ref)


def test_unported_va_operator_raises():
    src = """
module valp(inp, out);
  inout inp, out;
  electrical inp, out;
  parameter real tau = 1e-3;
  analog V(out) <+ laplace_nd(V(inp), {1.0}, {1.0, tau});
endmodule
"""
    with pytest.raises(NotImplementedError, match="A14"):
        load_va(src)
