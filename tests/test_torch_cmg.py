"""BSIM-CMG 107 in the port (``cedarsim_tpu_torch/models/bsimcmg107/``,
``frontend/spectre.py``, the elaborator's CMG binder) against the JAX
package on the CPU.

- ``tests/test_bsimcmg.py``'s three fast cases: the prepared card
  (``devtype=1, nfin=2``) equal to the JAX package's ``prepare`` value for
  value (more than 1,500 entries), terminals, internal nodes and noise
  sources equal; ``.hdl "bsimcmg.va"`` with no include path resolving to
  the port's own copy; the common-source DC's vout within 1e-12 V of the
  JAX package's, and (S, Q, G, C) at the JAX package's operating point
  within 1e-12 of the JAX package's model evaluated op by op, relative
  to each array's largest entry.
- The Spectre deck: ``parse_mixed`` of ``tests/data/asap7/7nm_TT.scs``
  gives the same statements (models, their types and parameters) in both
  packages.
- A level-72 card binds the CMG class (``DEVTYPE`` 1 for nmos, 0 for
  pmos), as do the two ASAP7 forms: ``mneg ... nmos_lvt`` on a Spectre
  ``model ... bsimcmg`` card and the DFF's ``X... bsimcmg devtype=1``.
- The ASAP7 CMG inverter's noise (the reference's circuit on the in-repo
  deck): √PSD within rtol 1e-6 of the ngspice table (the reference's
  gate).
- ROADMAP C8: the port's PSD and the JAX package's part by ~3e-9
  relative, with or without the operating point solved to 1e-9 relative
  (C4's cure; here it moves the PSD by under a thousandth of the gap).
  Every input of the PSD agrees (G, C, ∂S/∂eps and the noise
  sources' powers and exponents against the JAX package's op by op, 1e-12
  of each array's largest entry; the two operating points within 1e-15
  V).  The PSD computed from the port's inputs through numpy's complex
  solve agrees with the same computed from the JAX package's inputs to
  1e-13; the port's own (``torch.linalg.solve``) parts from numpy's by
  less than cond(A)·eps, cond(A) reaching 2.4e8 at q's rail.  The JAX
  package's own PSD needs its ~75 s noise compile, which the suite does
  not pay here.
- ROADMAP C8 also: the CMG ring's counts part from the JAX package's
  after operating points ~5e-17 V apart; at the operating point the
  port's S equals the JAX package's op-by-op evaluation to 1e-20 of its
  largest entry and Q, G, C to round-off (its compiled S differs by
  1.5e-16: C2's class, the JAX compiler's).
- The emitted CMG walk (``va/emit.py``, what B1 runs on the CMG plan),
  built as host code with ``g++``, against the eager walk on the DFF's
  lanes at perturbed biases: within rtol 1e-9 (absolute floors 1e-18 A,
  1e-24 C), as ``tests/test_torch_emit.py`` holds BSIM4's.

The JAX package's CMG module compiles once here (its DC solve); its model
walks run op by op.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.core.context import Modes as JModes
from cedarsim_tpu.frontend import spectre as j_spectre
from cedarsim_tpu.models import bsimcmg_class as j_cmg
from cedarsim_tpu_torch.benchmarks import kernel_times as kt
from cedarsim_tpu_torch.benchmarks import netlists
from cedarsim_tpu_torch.frontend import spectre as t_spectre
from cedarsim_tpu_torch.models import bsimcmg_class as t_cmg
from tests.cmg_ring_counts import ring
from tests.data_cmg_inverter_noise_ngspice import NGSPICE_CMG_INV_NOISE

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "cedarsim_tpu_torch")
ASAP7_DIR = os.path.join(REPO, "tests", "data", "asap7")
DECK = os.path.join(ASAP7_DIR, "7nm_TT.scs")
#: the ngspice gate (the reference's, tests/test_noise_pdk_goldens.py)
NGSPICE_RTOL = 1e-6
#: (S, Q, G, C) and the noise inputs against the JAX package op by op,
#: relative to each array's largest entry
EVAL_RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_prepared_card_equals_the_jax_packages():
    tc, jc = t_cmg(), j_cmg()
    assert tc.terminals == jc.terminals == ("d", "g", "s", "e")
    assert tc.n_internal == jc.n_internal == 2
    assert tc.n_noise == jc.n_noise >= 4
    pt = tc.prepare({"devtype": 1, "nfin": 2})
    pj = jc.prepare({"devtype": 1, "nfin": 2})
    assert len(pt) > 1500
    assert set(pt) == set(pj)
    assert pt["NFIN"] == 2.0 and pt["NFIN$given"] == 1.0
    assert pt["DEVTYPE"] == 1.0
    bad = [k for k in pt if not (float(pt[k]) == float(pj[k]) or (
        np.isnan(float(pt[k])) and np.isnan(float(pj[k]))))]
    assert not bad, bad[:10]


def test_hdl_resolves_to_the_ports_copy():
    from cedarsim_tpu_torch.frontend.elaborate import Elaborator
    from cedarsim_tpu_torch.models import BSIMCMG107_DIR
    p = Elaborator()._resolve_file("bsimcmg.va", None)
    assert os.path.realpath(p) == os.path.realpath(
        os.path.join(BSIMCMG107_DIR, "bsimcmg.va"))
    assert os.path.commonpath([os.path.realpath(p),
                               os.path.realpath(PKG)]) == \
        os.path.realpath(PKG)


def _common_source(pkg, cls):
    ckt = pkg.Circuit()
    vdd, out, g = ckt.net("vdd"), ckt.net("out"), ckt.net("g")
    ckt.add(pkg.VSource, "VDD", (vdd, ckt.gnd), dict(dc=1.0))
    ckt.add(pkg.VSource, "VG", (g, ckt.gnd), dict(dc=0.9))
    ckt.add(pkg.Resistor, "RL", (vdd, out), dict(r=10e3))
    ckt.add(cls, "M1", (out, g, ckt.gnd, ckt.gnd), dict())
    return ckt


def test_common_source_dc_equals_the_jax_packages():
    """Both operating points are solved to ``reltol=1e-9, abstol=1e-15``
    (C4's cure): at the default ``reltol=1e-4`` each DC stops at an iterate
    whose last digits differ between runs, so the gap was the stopping
    rule's, not the models'.  The bounds are derived from the circuit:

    - S at the operating point is the KCL residue of branch currents of up
      to the supply current I (5e-5 A) that cancel to the gmin terms
      (1e-12 A), so its round-off is eps·I, not eps·max|S|: S is held to
      ``EVAL_RTOL`` of max(I, max|S|) (relative to max|S| alone the same
      one-ulp difference of an internal current reads 7e-9, the failure
      this bound replaces);
    - the two operating points then differ by G⁻¹ times the difference of
      the two residual functions, so vout is held to
      ‖(G⁻¹)_out,:‖₁ · ``EVAL_RTOL`` · I (9.5e-13 V here); what each
      tight solve leaves is second order in its last update."""
    nopts = dict(gmin_steps=4, src_steps=3, restarts=1, reltol=1e-9,
                 abstol=1e-15)
    ct = T.compile_circuit(_common_source(T, t_cmg()), device="cpu")
    cj = J.compile_circuit(_common_source(J, j_cmg()))
    rt = T.solve_dc(ct, opts=T.NewtonOptions(**nopts))
    rj = J.solve_dc(cj, opts=J.NewtonOptions(**nopts))
    assert bool(rt.converged) and bool(rj.converged)
    i = ct.node_names.index("out")
    vt, vj = float(rt.x[i]), float(np.asarray(rj.x)[i])
    assert 0.1 < vt < 0.9
    xj = np.asarray(rj.x)
    ctx_t = T.SimSpec.make().with_mode("dcop")
    ctx_j = J.SimSpec.make().with_mode(JModes.DCOP)
    port = [a.numpy() for a in ct.res_jacs_fwd(torch.as_tensor(xj), ctx_t)]
    ref = [np.asarray(a) for a in cj.res_jacs_fwd(jnp.asarray(xj), ctx_j)]
    # the supply current: the largest branch-current unknown
    i_supply = float(np.abs(xj[ct.n_nodes + ct.n_internal:]).max())
    assert 1e-5 < i_supply < 1e-4
    s_scale = max(i_supply, float(np.abs(ref[0]).max()))
    assert float(np.abs(port[0] - ref[0]).max()) <= EVAL_RTOL * s_scale, "S"
    for name, a, b in zip("QGC", port[1:], ref[1:]):
        assert _rel(a, b) <= EVAL_RTOL, name
    g_inv = np.linalg.inv(ref[2])
    v_bound = float(np.abs(g_inv[i]).sum()) * EVAL_RTOL * i_supply
    assert abs(vt - vj) <= v_bound, (abs(vt - vj), v_bound)


def _statements(sp, text):
    nl = sp.parse_mixed(text, file=DECK, start_lang="spectre")
    return [(type(s).__name__, getattr(s, "name", None),
             getattr(s, "mtype", None), repr(getattr(s, "params", None)))
            for s in nl.statements]


def test_spectre_deck_parses_as_in_the_jax_package():
    with open(DECK) as f:
        text = f.read()
    mine, ref = _statements(t_spectre, text), _statements(j_spectre, text)
    assert mine == ref
    models = [s for s in mine if s[0] == "Model"]
    assert len(models) >= 2 and {m[2] for m in models} == {"bsimcmg"}


def _bound(text, include_paths=()):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ckt = T.elaborate(T.parse_spice(text), include_paths=include_paths)
    return {i.name: i for i in ckt.instances}


@pytest.mark.parametrize("mtype, devtype", [("nmos", 1.0), ("pmos", 0.0)])
def test_level72_card_binds_the_cmg_class(mtype, devtype):
    """The card that raised naming ROADMAP A12 before the slice."""
    insts = _bound(f"* cmg\nV1 a 0 1.0\nR1 a 0 1k\nM1 a a 0 0 cmod\n"
                   f".model cmod {mtype} level=72 nfin=3\n.end\n")
    m1 = insts["m1"]
    assert m1.model is t_cmg()
    assert m1.params["DEVTYPE"] == devtype and m1.params["NFIN"] == 3.0


def test_both_asap7_forms_bind_the_cmg_class():
    insts = _bound(netlists.CMG_INVERTER_NOISE, [ASAP7_DIR])
    assert insts["mneg"].model is t_cmg()
    assert insts["mneg"].params["DEVTYPE"] == 1.0
    assert insts["mpos"].params["DEVTYPE"] == 0.0
    dff = os.path.join(REPO, "benchmarks", "gf180_dff")
    with open(os.path.join(dff, "dff_tb_cmg.cir")) as f:
        insts = _bound(f.read(), [dff])
    cmg = [i for i in insts.values()
           if i.model.__name__ == t_cmg().__name__ == "VA_bsimcmg"]
    assert len(cmg) == 30
    assert {i.params["DEVTYPE"] for i in cmg} == {0.0, 1.0}


@pytest.fixture(scope="module")
def inverter():
    freqs, ref = np.array(NGSPICE_CMG_INV_NOISE).T
    comp = T.compile_circuit(T.elaborate(
        T.parse_spice(netlists.CMG_INVERTER_NOISE),
        include_paths=[ASAP7_DIR]), device="cpu")
    ns = T.noise(comp, "q", freqs, ctx=T.SimSpec.make(gmin=1e-15))
    return comp, freqs, ref, ns


@pytest.fixture(scope="module")
def jax_inverter():
    return J.compile_circuit(J.elaborate(
        J.parse_spice(netlists.CMG_INVERTER_NOISE),
        include_paths=[ASAP7_DIR]))


def test_inverter_noise_within_the_ngspice_gate(inverter):
    _, _, ref, ns = inverter
    got = np.sqrt(np.abs(ns.psd))
    assert np.all(np.isfinite(got))
    assert np.allclose(got, ref, rtol=NGSPICE_RTOL, atol=0.0)


def _psd_numpy(G, C, Je, pwr, ex, freqs, i_out):
    e = np.zeros(G.shape[0])
    e[i_out] = 1.0
    out = []
    for f in freqs:
        y = np.linalg.solve((G + 2j * np.pi * f * C).conj().T, e)
        out.append(np.sum(np.abs(y.conj() @ Je) ** 2 * pwr * f ** (-ex)))
    return np.array(out)


def _cond_eps(comp, freqs):
    """cond(G + jωC)·eps at the port's operating point, the largest over
    ``freqs``: how far two correct solves of the adjoint systems may
    part."""
    x = torch.as_tensor(T.solve_dc(comp, ctx=T.SimSpec.make(gmin=1e-15)).x)
    _, _, G, C = comp.res_jacs_fwd(
        x, T.SimSpec.make(gmin=1e-15).with_mode(T.Modes.AC))
    A = G.numpy()[None] + 2j * np.pi * freqs[:, None, None] * C.numpy()[None]
    return float(np.linalg.cond(A).max()) * np.finfo(np.float64).eps


def test_c8_noise_inputs_equal_and_the_gap_is_the_solve(inverter,
                                                        jax_inverter):
    comp, freqs, _, ns = inverter
    cj = jax_inverter
    x = torch.as_tensor(T.solve_dc(comp, ctx=T.SimSpec.make(gmin=1e-15)).x)
    c_t = T.SimSpec.make(gmin=1e-15).with_mode(T.Modes.AC)
    c_j = J.SimSpec.make(gmin=1e-15).with_mode(JModes.AC)
    xj = jnp.asarray(x.numpy())
    G, C = cj.jacobians(xj, c_j, cj.params0)
    import jax
    Je = jax.jacfwd(lambda e: cj.residuals(xj, c_j, cj.params0, eps=e)[0])(
        jnp.zeros(cj.n_eps, cj.dtype))
    ref = [np.asarray(a) for a in (G, C, Je,
                                   *cj.noise_sources(xj, c_j, cj.params0))]
    _, _, Gt, Ct = comp.res_jacs_fwd(x, c_t)
    port = [a.numpy() for a in (Gt, Ct, comp.eps_jacobian(x, c_t),
                                *comp.noise_sources(x, c_t))]
    for name, a, b in zip(("G", "C", "Jeps", "pwr", "exp"), port, ref):
        assert _rel(a, b) <= EVAL_RTOL, name
    i_out = comp.x_names.index("q")
    p_port = _psd_numpy(*port, freqs, i_out)
    p_ref = _psd_numpy(*ref, freqs, i_out)
    assert np.max(np.abs(p_port / p_ref - 1.0)) <= 1e-13
    # the port's PSD (torch.linalg.solve) against numpy's on the same
    # inputs: apart by less than cond(A)·eps
    gap = np.max(np.abs(ns.psd / p_port - 1.0))
    assert gap < _cond_eps(comp, freqs)
    # not C4's class: the operating point solved to 1e-9 relative moves
    # the port's PSD by far less than the gap
    polished = T.noise(comp, "q", freqs, ctx=T.SimSpec.make(gmin=1e-15),
                       dc_opts=T.NewtonOptions(reltol=1e-9, abstol=1e-15))
    assert np.max(np.abs(polished.psd / ns.psd - 1.0)) < 1e-3 * gap


@pytest.mark.skipif(not os.environ.get("CEDARSIM_RUN_SLOW"),
                    reason="slow: the JAX package's CMG noise compile "
                           "(~75 s); set CEDARSIM_RUN_SLOW=1")
def test_c8_noise_psd_equals_the_jax_packages(inverter, jax_inverter):
    """ROADMAP C8: the port's PSD against the JAX package's ``noise()`` on
    the same circuit and deck, within 2·cond(A)·eps (the PSD is |y|² of
    an adjoint solve, each correct to cond(A)·eps; cond(A) reaches 2.4e8
    at q's rail, so the bound is ~1e-7; measured 3.06e-9)."""
    comp, freqs, _, ns = inverter
    ref = J.noise(jax_inverter, "q", freqs, ctx=J.SimSpec.make(gmin=1e-15))
    p_ref = np.asarray(ref.psd)
    assert np.all(np.isfinite(p_ref)) and p_ref.shape == ns.psd.shape
    gap = float(np.max(np.abs(np.asarray(ns.psd) / p_ref - 1.0)))
    assert gap <= 2.0 * _cond_eps(comp, freqs)


def test_c8_ring_eval_equals_the_jax_packages_op_by_op():
    """ROADMAP C8: the ring's counts over 0-0.5 ns part (1,706 / 558 /
    5,439 accepted / rejected / Newton in the port; the JAX package's move
    between its own runs, 1,703 / 559 / 5,431 and 1,709 / 560 / 5,452,
    ``tests/cmg_ring_counts.py``) from operating points ~5e-17 V apart.  At the
    operating point, the port's S equals the JAX package's model evaluated
    op by op to 1e-20 of its largest entry (8e-28 A of 3.1e-4), and Q, G
    and C to round-off (1e-15); the JAX package's compiled (``jax.jit``)
    S differs from its own op-by-op one by 4.6e-20 A there, a property of
    the JAX compiler, not of the port, so it is recorded (C2's class) and
    not asserted."""
    ct = T.compile_circuit(ring(T, t_cmg()), device="cpu")
    cj = J.compile_circuit(ring(J, j_cmg()))
    x = T.solve_dc(ct, mode="tranop", opts=T.NewtonOptions(
        gmin_steps=2, src_steps=2, restarts=0)).x
    for mode in ("tranop", "tran"):
        port = [a.numpy() for a in ct.res_jacs_fwd(
            x, T.SimSpec.make().with_mode(mode))]
        ref = [np.asarray(a) for a in cj.res_jacs_fwd(
            jnp.asarray(x.numpy()), J.SimSpec.make().with_mode(mode))]
        for name, a, b, tol in zip("SQGC", port, ref,
                                   (1e-20, 1e-15, 1e-15, 1e-15)):
            assert _rel(a, b) <= tol, (mode, name)


def test_emitted_cmg_walk_matches_the_eager_walk(tmp_path):
    from tests.test_torch_emit import _check, _emitted_vs_eager, _host_build
    comp, ctx, pb, x0 = kt.dff_lanes(torch, T, "cpu", lanes=2, leg="cmg")
    key = [k for k in comp.group_order if "bsimcmg" in k.lower()][0]
    ctx = ctx.with_mode("tran")
    lib = _host_build(tmp_path, comp, key, ctx)
    rng = np.random.default_rng(11)
    L = 4
    params = {k: dict(g) for k, g in comp.params0.items()}
    params[key]["NFIN"] = comp.params0[key]["NFIN"][None, :] * \
        torch.as_tensor(np.linspace(0.9, 1.1, L))[:, None]
    x = np.repeat(x0[1].numpy()[None], L, 0)
    x[:, :comp.n_nodes] += rng.uniform(-0.3, 0.3, (L, comp.n_nodes))
    v = rng.normal(size=(L, comp.n_x)) * 1e9
    t = np.linspace(0.0, 7e-7, L)
    _check(*_emitted_vs_eager(lib, comp, key, ctx, x, v, t, params))
