"""The port's shooting PSS (``cedarsim_tpu_torch/analysis/pss.py``) against
the JAX package's on the CPU, on ``tests/test_pss.py``'s circuits (without
its 400-period brute-force transient).

- Sine-driven RC: both packages converge in the same number of Newton
  iterations to the same x0 (within 1e-9 V), and the orbit is the AC
  phasor response within the JAX test's 5e-3.
- Diode peak rectifier: the same iterations and x0 within 1e-8 V, the
  residual norms within 1e-3 relative of each other, and the monodromy M =
  ∂Φ/∂x0 at the converged x0, from the port's forward-AD run of n lanes,
  within 1e-7 of the largest entry of the JAX package's ``jax.jacfwd``
  through its ``tran_core`` (the same accepted steps; the chord loops
  part in their last bits).
- A circuit with a history-mode delay element raises, as in the JAX
  package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis import pss as jpss
from cedarsim_tpu.analysis.tran import (tran_core as jtran_core,
                                        _consistent_xdot, _differential_mask)
from cedarsim_tpu.core.context import Modes as JModes
from cedarsim_tpu_torch.analysis import pss as tpss


def _driven(P, kind):
    """The JAX test's circuits on package ``P``."""
    f0 = 1e6
    ckt = P.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    if kind == "rc":
        ckt.add(P.VSourceSIN, "V1", (vin, ckt.gnd),
                dict(vo=0.0, va=1.0, freq=f0))
        ckt.add(P.Resistor, "R1", (vin, vout), dict(r=1e3))
        ckt.add(P.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    else:
        ckt.add(P.VSourceSIN, "V1", (vin, ckt.gnd),
                dict(vo=0.0, va=2.0, freq=f0))
        ckt.add(P.Diode, "D1", (vin, vout), {"is": 1e-14, "n": 1.0})
        ckt.add(P.Resistor, "RL", (vout, ckt.gnd), dict(r=100e3))
        ckt.add(P.Capacitor, "CL", (vout, ckt.gnd), dict(c=1e-9))
    kw = {} if P is J else dict(device="cpu")
    return P.compile_circuit(ckt, **kw), 1.0 / f0


def test_driven_rc_matches_the_jax_package_and_the_phasor():
    kw = dict(opts=dict(max_steps=4096, rtol=1e-5, atol=1e-9), tol=1e-7)
    res = {}
    for P, mod in ((J, jpss), (T, tpss)):
        comp, period = _driven(P, "rc")
        res[P] = mod.pss(comp, period, ctx=P.SimSpec.make(gmin=1e-15),
                         opts=P.TranOptions(**kw["opts"]), tol=kw["tol"])
    rj, rt = res[J], res[T]
    assert rt.converged and rj.converged
    assert rt.iters == rj.iters
    assert np.abs(rt.x0 - np.asarray(rj.x0)).max() < 1e-9
    f0, R, C = 1e6, 1e3, 1e-9
    w = 2 * np.pi * f0
    H = 1.0 / (1.0 + 1j * w * R * C)
    tgrid = np.linspace(0.05 / f0, 0.95 / f0, 24)
    v = np.interp(tgrid, rt.solution.ts, rt.solution["vout"])
    exact = np.abs(H) * np.sin(w * tgrid + np.angle(H))
    assert np.abs(v - exact).max() < 5e-3


def _jax_monodromy(comp, period, ctx, opts, x0):
    """``jax.jacfwd`` of the JAX package's one-period map at ``x0`` (its
    ``pss``'s ``mono_jit``, rebuilt here at one point)."""
    params = comp.params0
    d = comp.dtype
    op = J.solve_dc(comp, params, ctx, mode=JModes.TRANOP)
    ctx_op = ctx.with_mode(JModes.TRANOP)
    mask = _differential_mask(comp, op.x, ctx_op, params)
    bps = np.concatenate([comp.breakpoints(period), [period], [np.inf]])

    def phi(x):
        xd0 = _consistent_xdot(comp, x, ctx_op, params)
        out = jtran_core(comp, params, ctx, x, xd0, jnp.asarray(0.0, d),
                         jnp.asarray(period, d), jnp.asarray(bps, d),
                         jnp.asarray(period * 1e-4, d), opts, mask)
        return out[7]["x"]

    return np.asarray(jax.jit(jax.jacfwd(phi))(jnp.asarray(x0, d)))


def test_rectifier_iterates_and_monodromy_match_the_jax_package():
    ctxs = {J: J.SimSpec.make(gmin=1e-12), T: T.SimSpec.make(gmin=1e-12)}
    res, comps = {}, {}
    for P, mod in ((J, jpss), (T, tpss)):
        comps[P], period = _driven(P, "rect")
        res[P] = mod.pss(comps[P], period, ctx=ctxs[P],
                         opts=P.TranOptions(max_steps=4096), tol=1e-6)
    rj, rt = res[J], res[T]
    assert rt.converged and rj.converged
    assert rt.iters == rj.iters > 1
    assert np.abs(rt.x0 - np.asarray(rj.x0)).max() < 1e-8
    assert rt.resnorm == pytest.approx(rj.resnorm, rel=1e-3)
    Mj = _jax_monodromy(comps[J], period, ctxs[J],
                        J.TranOptions(max_steps=4096), rt.x0)
    _, _, monodromy = tpss._shooting_maps(comps[T], period,
                                          comps[T].params0, ctxs[T],
                                          T.TranOptions(max_steps=4096))
    Mt = monodromy(torch.as_tensor(rt.x0)).numpy()
    scale = np.abs(Mj).max()
    assert scale > 0.1                    # the load node's decay per period
    assert np.abs(Mt - Mj).max() <= 1e-7 * scale, (Mt, Mj)


def test_history_delay_raises():
    comp = T.compile_circuit(T.load_spice(
        "* line\nV1 a 0 SIN(0 1 1meg)\nR1 a b 50\n"
        "T1 b 0 c 0 Z0=50 TD=10n\nR2 c 0 50\n"), device="cpu")
    assert comp.n_dly
    with pytest.raises(NotImplementedError, match="delay"):
        tpss.pss(comp, 1e-6)
