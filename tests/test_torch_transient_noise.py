"""Transient noise in the port (``TranOptions(noise_seed=)``: ε ~ N(0,
pwr/(2h)) per white noise source, the unit draw row k of
``analysis/tran.py::noise_draws`` at accepted step k) against the JAX
package on the CPU, the circuits of ``tests/test_transient_noise.py``.

- kT/C: a resistor's thermal noise on a capacitor settles to a variance
  within 0.6–1.4·kT/C over t > 20τ (the JAX test's gate).
- The same seed gives the same waveform; another seed another one; no
  seed is the noiseless run.
- With the JAX package's draws injected (``noise_draws`` replaced by
  ``jax.random.normal(fold_in(PRNGKey(seed), k))`` for each k), the port's
  waveform equals the JAX package's ``tran(noise_seed=7)`` within 1e-9 V
  with equal counts.
- Noise injection keeps a run off the fused engine ("auto" takes the
  chord path; an explicit "fused" raises, as in the JAX package).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.analysis import tran as ttran

R, C = 1e5, 1e-13
TAU = R * C


def _rc(P, source=False):
    ckt = P.Circuit()
    vout = ckt.net("vout")
    if source:
        ckt.add(P.VSource, "V1", (ckt.net("vin"), ckt.gnd), dict(dc=1.0))
        ckt.add(P.Resistor, "R1", (ckt.net("vin"), vout), dict(r=R))
    else:
        ckt.add(P.Resistor, "R1", (vout, ckt.gnd), dict(r=R))
    ckt.add(P.Capacitor, "C1", (vout, ckt.gnd), dict(c=C))
    if P is J:
        return J.compile_circuit(ckt)
    return T.compile_circuit(ckt, device="cpu")


def _opts(P, seed, span, max_steps):
    return P.TranOptions(noise_seed=seed, h0=TAU / 8,
                         hmax_frac=(TAU / 8) / span, rtol=10.0, atol=10.0,
                         max_steps=max_steps, method="be")


def _run(P, seed, span=40 * TAU, max_steps=2048):
    ctx = P.SimSpec.make(gmin=1e-15)
    return P.tran(_rc(P), (0.0, span), ctx=ctx,
                  opts=_opts(P, seed, span, max_steps))


def test_ktc_equilibrium_variance():
    sol = _run(T, 7, span=400 * TAU, max_steps=8192)
    assert sol.converged
    v = sol["vout"]
    var = float(np.var(v[sol.ts > 20 * TAU]))
    ktc = T.config.K_BOLTZMANN * (T.config.T_ZERO_C + 27.0) / C
    assert 0.6 * ktc < var < 1.4 * ktc, (var, ktc)


def test_reproducible_and_seed_dependent():
    a, b, c2 = _run(T, 1), _run(T, 1), _run(T, 2)
    assert np.array_equal(a["vout"], b["vout"])
    assert not np.array_equal(a["vout"], c2["vout"])
    quiet = T.tran(_rc(T, source=True), (0.0, 1e-6),
                   ctx=T.SimSpec.make(gmin=1e-15))
    assert quiet.converged
    assert abs(float(quiet.interp("vout", 1e-6)) - 1.0) < 1e-3


def test_jax_draws_give_the_jax_waveform(monkeypatch):
    seed = 7
    key = jax.random.PRNGKey(seed)

    def jax_draws(s, rows, n_eps, device=None):
        assert s == seed
        ks = jnp.arange(rows)
        xi = jax.vmap(lambda k: jax.random.normal(
            jax.random.fold_in(key, k), (n_eps,), jnp.float64))(ks)
        return torch.as_tensor(np.asarray(xi), device=device)

    monkeypatch.setattr(ttran, "noise_draws", jax_draws)
    st = _run(T, seed)
    sj = _run(J, seed)
    assert st.converged and sj.converged
    assert (st.n_accepted, st.n_rejected, st.n_newton) == \
        (sj.n_accepted, sj.n_rejected, sj.n_newton)
    np.testing.assert_allclose(st.ts, sj.ts, rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(st.xs, sj.xs, rtol=0.0, atol=1e-9)
    assert np.std(st["vout"]) > 1e-5          # the noise is there


def test_noise_stays_off_the_fused_engine():
    comp = _rc(T)
    ctx = T.SimSpec.make(gmin=1e-15)
    opts = T.TranOptions(noise_seed=3, formulation="cap", jac_reuse=1)
    assert ttran.auto_newton_impl(comp, opts, ctx) == "xla"
    with pytest.raises(ValueError, match="noise injection"):
        T.tran(comp, (0.0, 4 * TAU), ctx=ctx, opts=T.TranOptions(
            noise_seed=3, formulation="cap", jac_reuse=1,
            newton_impl="fused"))
