"""The port's DC-initialisation probe (``cedarsim_tpu_torch/analysis/
fragility.py``) against the JAX package's on the CPU.

The JAX package draws its starts with ``jax.random``, which the port cannot
reproduce, so each test draws the starts once with numpy from a fixed seed
and gives the same starts to both: the port's ``_fragility_from_starts``
(one lane-batched ``dc_core``) and the JAX package's ``dc_core`` under
``jax.vmap`` with the restarts off, as its ``init_fragility`` runs it.

- Lane by lane: the same converged flags and Newton iterations, the
  solutions within 1e-9 V and the residual norms within 1e-9 A.
- The same clusters (the JAX package's ``_cluster`` on its own solutions):
  the same counts, the representatives within 1e-9 V.
- ``initialization_norm`` within 1e-12 of the JAX package's at the
  operating point and off it.
- The circuits: the cubic bistable node (three basins), a resistive
  divider (one), and a cross-coupled level-1 CMOS latch (its two stable
  states and the metastable point).
"""

import dataclasses

import numpy as np
import pytest

import jax

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis import fragility as jfrag
from cedarsim_tpu.analysis.dc import dc_core as jdc_core
from cedarsim_tpu.analysis.dc import default_newton_options as jdefault
from cedarsim_tpu.core.compile import default_ctx as jdefault_ctx
from cedarsim_tpu.core.context import Modes as JModes
from cedarsim_tpu_torch.analysis import fragility as tfrag


def _bistable(P):
    if P is J:
        from cedarsim_tpu.devices import nonlinear_resistor
    else:
        from cedarsim_tpu_torch.devices import nonlinear_resistor
    NLR = nonlinear_resistor(lambda v: 1e-3 * (v * v * v - v))
    ckt = P.Circuit()
    v = ckt.net("v")
    ckt.add(NLR, "N1", (v, ckt.gnd), {})
    kw = {} if P is J else dict(device="cpu")
    return P.compile_circuit(ckt, **kw)


DIVIDER = "* divider\nV1 top 0 3\nR1 top mid 1k\nR2 mid 0 1k\n.end\n"

LATCH = """cross-coupled level-1 latch
VDD vdd 0 3.3
M1p a b vdd vdd pmos W=20u L=1u
M1n a b 0 0 nmos W=10u L=1u
M2p b a vdd vdd pmos W=20u L=1u
M2n b a 0 0 nmos W=10u L=1u
.model nmos nmos level=1 vto=0.7 kp=100u gamma=0.4 lambda=0.05
.model pmos pmos level=1 vto=-0.8 kp=40u gamma=0.5 lambda=0.05
.end
"""


def _comp(P, which):
    if which == "bistable":
        return _bistable(P)
    kw = {} if P is J else dict(device="cpu")
    return P.compile_circuit(P.load_spice(DIVIDER if which == "divider"
                                          else LATCH), **kw)


def _jax_from_starts(comp, x0):
    """The JAX package's ``init_fragility`` solve and clustering from given
    starts."""
    ctx = jdefault_ctx(comp).with_mode(JModes.DCOP)
    opts = dataclasses.replace(jdefault(comp), restarts=0)
    res = jax.jit(jax.vmap(
        lambda x: jdc_core(comp, comp.params0, ctx, x, opts)))(x0)
    conv = np.asarray(res.converged)
    xs = np.asarray(res.x)
    sols, counts = jfrag._cluster(xs[conv], 1e-4)
    return dict(converged=conv, x=xs, iters=np.asarray(res.iters),
                resnorm=np.asarray(res.resnorm), solutions=sols,
                counts=counts)


@pytest.mark.parametrize("which,n,sigma,basins", [
    ("bistable", 48, 1.0, 3), ("divider", 16, 2.0, 1),
    ("latch", 24, 2.0, 3)])
def test_same_starts_give_the_jax_packages_lanes_and_clusters(
        which, n, sigma, basins):
    tc, jc = _comp(T, which), _comp(J, which)
    rng = np.random.default_rng(7)
    x0 = sigma * rng.standard_normal((n, tc.n_x))
    rt = tfrag._fragility_from_starts(tc, x0)
    rj = _jax_from_starts(jc, x0)
    assert np.array_equal(rt.converged, rj["converged"])
    assert rt.converged.all()
    assert np.array_equal(rt.iters, rj["iters"])
    assert np.abs(rt.x - rj["x"]).max() < 1e-9
    assert np.abs(rt.resnorm - rj["resnorm"]).max() < 1e-9
    assert rt.n_solutions == len(rj["solutions"]) == basins, rt.summary()
    assert np.array_equal(rt.counts, rj["counts"])
    assert np.abs(rt.solutions - rj["solutions"]).max() < 1e-9


def test_init_fragility_draws_reproducible_starts():
    comp = _comp(T, "bistable")
    a = tfrag.init_fragility(comp, n=48, sigma=1.0, seed=3)
    b = tfrag.init_fragility(comp, n=48, sigma=1.0, seed=3)
    assert np.array_equal(a.x, b.x)
    assert a.n_solutions == 3 and a.converged_frac == 1.0
    vs = sorted(float(s[comp.node_names.index("v")]) for s in a.solutions)
    assert np.allclose(vs, [-1.0, 0.0, 1.0], atol=1e-5)
    assert "3 distinct operating point" in a.summary()


def test_initialization_norm_equals_the_jax_packages():
    tc, jc = _comp(T, "bistable"), _comp(J, "bistable")
    op = T.solve_dc(tc)
    x = op.x.numpy().copy()
    iv = tc.node_names.index("v")
    off = x.copy()
    off[iv] += 0.5
    for state in (x, off):
        assert tfrag.initialization_norm(tc, state) == pytest.approx(
            jfrag.initialization_norm(jc, state), abs=1e-12)
    assert tfrag.initialization_norm(tc, x) < 1e-10
    assert tfrag.initialization_norm(tc, off) > 1e-5
