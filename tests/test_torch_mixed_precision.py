"""The port's mixed-precision evaluation tier (``compile_circuit(...,
eval_dtype=torch.float32)``: the device models in float32, states, time,
step control and solves in float64) against the JAX package's
(``eval_dtype=jnp.float32``) on the CPU.

- The default does not move: ``eval_dtype`` is ``dtype`` unless asked,
  the Newton and transient defaults are the float64 ones, "auto" is the
  charge form; ``ensure_dynamic`` and the sparse plan's CPU compile keep
  the eval dtype.
- Under float32 evaluation: ``default_newton_options`` field for field
  the JAX package's (``reltol=1e-3, abstol=5e-7, res_tol=1e-3,
  x_limit=100, jac_shunt=1e-7``), the transient's defaults the JAX
  package's (``tran`` with ``opts=None``, ``analysis/tran.py:1486-1500``
  there), "auto" the cap form and BDF2, the op cache keyed on the eval
  dtype.  Every public top-level name of the JAX package is the port's
  (``Net``, ``GROUND``, ``config``, the checkpoint files).
- (S, Q, G, C) of the BSIM4 DFF, the level-1 DFF and the ASAP7 BSIM-CMG
  inverter at their float64 operating points, in TRANOP and TRAN mode:
  the port's float32 walk against the JAX package's within the JAX
  package's own float32 error (its distance from the float64 walk), with
  4 float32 ulps as the floor, relative to each array's largest entry;
  the port's float32 walk against its float64 walk within twice that.
  The walks are float32: the port's G parts from its float64 G.
- The DFFs' TRANOP points under the float32 defaults: both packages
  converge, within 8 float32 ulps of the largest node voltage (the
  level-1 DFF's latch settles in the other state than in float64, in both
  packages).
- ``tests/test_tline.py``'s mixed-precision line (float32 evaluation
  through the delay channel, cap-form BDF2, chord Newton), twinned: its
  closed-form gates on the port's run, and the port's waveform at the
  gates' times within 1e-4 V of the JAX package's.
- The 6-cell level-1 chain forced sparse under float32 evaluation: its
  operating point within 1e-6 V of the same circuit's dense solve, and
  within 16 float32 ulps of its largest node voltage of the JAX package's
  sparse one (both Newton runs take 121 iterations and end 6.1e-6 V
  apart on a 5 V node; the float64 point's latch is another state).
- AC of the BSIM4 DFF (``netlists.dff_ac_noise``: AC 1 on the supply) at
  its float32 operating point, where the float32 rounding of the rails
  puts several devices' drains exactly on their sources (``vds =
  abs(vds_r)``: the walk takes JAX's derivative +1 there, in float32 and
  float64 alike, ROADMAP C17): the solution within the bounds the test
  states of the JAX package's.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis import dc as jdc
from cedarsim_tpu_torch.analysis import tran as ttran
from cedarsim_tpu_torch.benchmarks import netlists
from cedarsim_tpu_torch.core import dual as D
from cedarsim_tpu_torch.core.compile import use_sparse_solver
from cedarsim_tpu_torch.utils import artifacts

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DFF_DIR = os.path.join(REPO, "benchmarks", "gf180_dff")
ASAP7_DIR = os.path.join(REPO, "tests", "data", "asap7")
EPS32 = float(np.finfo(np.float32).eps)
F32 = dict(T=torch.float32, J=jnp.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _compile(P, text, include, file, eval_dtype=None, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ckt = P.elaborate(P.parse_spice(text, file=file),
                          include_paths=include)
    if P is T:
        kw["device"] = "cpu"
    return P.compile_circuit(ckt, eval_dtype=eval_dtype, **kw)


def _read(name):
    with open(os.path.join(DFF_DIR, name)) as f:
        return f.read()


CIRCUITS = {
    "bsim4_dff": (lambda: _read("dff_tb_bsim4.cir"), [DFF_DIR],
                  "dff_tb_bsim4.cir"),
    "lv1_dff": (lambda: _read("dff_tb.cir"), [DFF_DIR], "dff_tb.cir"),
    "cmg_inverter": (lambda: netlists.CMG_INVERTER_NOISE, [ASAP7_DIR],
                     "inverter_cmg.cir"),
}


@pytest.fixture(scope="module")
def compiled():
    """Per circuit: (port float32, port float64, JAX float32)."""
    cache = {}

    def get(name):
        if name not in cache:
            text, inc, file = CIRCUITS[name]
            text = text()
            cache[name] = (
                _compile(T, text, inc, file, torch.float32),
                _compile(T, text, inc, file),
                _compile(J, text, inc, file, jnp.float32))
        return cache[name]
    return get


# ------------------------------------------------------------- defaults

def test_the_default_does_not_move(compiled):
    ct, c64, _ = compiled("lv1_dff")
    assert c64.eval_dtype == c64.dtype == torch.float64 and not c64.mixed
    assert ct.eval_dtype == torch.float32 and ct.mixed
    assert T.default_newton_options(c64) == T.NewtonOptions()
    opts = T.TranOptions()
    assert not ttran.cap_form_of(c64, opts)
    assert ttran.cap_form_of(ct, opts)
    assert ttran.cap_form_of(c64, T.TranOptions(formulation="cap"))
    assert not ttran.cap_form_of(ct, T.TranOptions(formulation="charge"))
    # a variant compiled again keeps the eval dtype
    assert T.ensure_dynamic(ct, ["w"]).eval_dtype == torch.float32
    assert T.ensure_dynamic(c64, ["w"]).eval_dtype == torch.float64
    ctx = T.SimSpec.make()
    assert artifacts.op_key(ct, ct.params0, ctx, "dcop") != \
        artifacts.op_key(c64, c64.params0, ctx, "dcop")


def test_float32_defaults_equal_the_jax_packages(compiled):
    ct, _, cj = compiled("lv1_dff")
    mine, ref = T.default_newton_options(ct), jdc.default_newton_options(cj)
    for f in ("reltol", "abstol", "res_tol", "x_limit", "jac_shunt",
              "max_iter", "gmin_steps", "src_steps"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert (mine.reltol, mine.abstol, mine.res_tol, mine.x_limit,
            mine.jac_shunt) == (1e-3, 5e-7, 1e-3, 100.0, 1e-7)
    # the transient's: the JAX package's tran() with opts=None
    want = J.TranOptions(newton_reltol=1e-4, newton_abstol=5e-7,
                         res_tol=1e-3, jac_shunt=1e-7, res_rel=3e-5,
                         rtol=1e-2, atol=1e-4, jac_reuse=1)
    got = ttran.mixed_tran_options()
    for f in ("newton_reltol", "newton_abstol", "res_tol", "jac_shunt",
              "res_rel", "rtol", "atol", "jac_reuse", "method",
              "formulation", "max_newton", "trtol"):
        assert getattr(got, f) == getattr(want, f), f


def test_top_level_names_are_the_jax_packages():
    """Every public name of ``cedarsim_tpu``'s top level (its classes,
    functions and ``config``) is the port's too, in ``__all__``: with
    ``Net``, ``GROUND``, ``config`` and the checkpoint files, nothing
    is missing."""
    names = [n for n in vars(J) if not n.startswith("_")
             and (type(getattr(J, n)).__name__ != "module" or n == "config")]
    assert {"Net", "GROUND", "config", "save_checkpoint",
            "load_checkpoint"} <= set(names)
    assert [n for n in names if n not in T.__all__] == []
    assert T.GROUND.is_ground and T.config.real_dtype == torch.float64


# ------------------------------------------------- the float32 walk itself

@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_walk_matches_the_jax_packages(compiled, name):
    ct, c64, cj = compiled(name)
    x = T.solve_dc(c64, ctx=T.SimSpec.make(gmin=1e-15), mode="tranop").x
    for mode in ("tranop", "tran"):
        ctx_t = T.SimSpec.make(gmin=1e-15).with_mode(mode).at_time(1e-9)
        ctx_j = J.SimSpec.make(gmin=1e-15).with_mode(mode).at_time(1e-9)
        port = [a.numpy() for a in ct.res_jacs_fwd(x, ctx_t)]
        p64 = [a.numpy() for a in c64.res_jacs_fwd(x, ctx_t)]
        ref = [np.asarray(a) for a in cj.res_jacs_fwd(
            jnp.asarray(x.numpy()), ctx_j)]
        for k, (a, b, c) in enumerate(zip(port, ref, p64)):
            what = f"{mode} {'SQGC'[k]}"
            assert a.dtype == np.float64, what
            jax_err = _rel(b, c)
            assert _rel(a, b) <= max(jax_err, 4 * EPS32), what
            assert _rel(a, c) <= max(2 * jax_err, 4 * EPS32), what
        assert _rel(port[2], p64[2]) > 0.0      # the walk was float32


@pytest.mark.parametrize("name", ["bsim4_dff", "lv1_dff"])
def test_dff_operating_point_matches_the_jax_packages(compiled, name):
    ct, _, cj = compiled(name)
    rt = T.solve_dc(ct, ctx=T.SimSpec.make(gmin=1e-15), mode="tranop")
    rj = J.solve_dc(cj, ctx=J.SimSpec.make(gmin=1e-15), mode="tranop")
    assert bool(rt.converged) and bool(np.asarray(rj.converged))
    xj = np.asarray(rj.x)
    scale = float(np.abs(xj[:ct.n_nodes]).max())
    assert float(np.abs(rt.x.numpy() - xj).max()) <= 8 * EPS32 * scale


# ------------------------------------------------- the delay channel

def _line(P):
    ckt = P.Circuit()
    vin, a, b = ckt.net("vin"), ckt.net("a"), ckt.net("b")
    ckt.add(P.VSourcePULSE, "V1", (vin, ckt.gnd),
            dict(v1=0.0, v2=2.0, td=10e-9, tr=0.5e-9, tf=0.5e-9,
                 pw=200e-9, per=1e-3))
    ckt.add(P.Resistor, "RS", (vin, a), dict(r=50.0))
    ckt.add(P.TLine, "T1", (a, ckt.gnd, b, ckt.gnd), dict(z0=50.0, td=25e-9))
    ckt.add(P.Resistor, "RL", (b, ckt.gnd), dict(r=50.0))
    kw = {"device": "cpu"} if P is T else {}
    return P.compile_circuit(ckt, eval_dtype=F32["T" if P is T else "J"],
                             **kw)


def test_tline_mixed_precision_eval():
    """``tests/test_tline.py::test_tline_mixed_precision_eval`` on the
    port, and against the JAX package's run."""
    opts = dict(max_steps=16384, jac_reuse=1, newton_reltol=1e-4,
                newton_abstol=5e-7, res_tol=1e-3, jac_shunt=1e-7,
                res_rel=3e-5, rtol=1e-3, atol=1e-5)
    ct, cj = _line(T), _line(J)
    assert ct.eval_dtype == torch.float32
    st = T.tran(ct, (0.0, 120e-9), opts=T.TranOptions(**opts))
    sj = J.tran(cj, (0.0, 120e-9), opts=J.TranOptions(**opts))
    assert st.converged and sj.converged and st.n_ring_underflow == 0
    assert abs(float(st.interp("b", 30e-9))) < 0.02
    assert abs(float(st.interp("b", 60e-9)) - 1.0) < 0.02
    assert abs(float(st.interp("a", 70e-9)) - 1.0) < 0.02
    for node, t in (("b", 30e-9), ("b", 60e-9), ("a", 70e-9)):
        assert abs(float(st.interp(node, t))
                   - float(sj.interp(node, t))) <= 1e-4, (node, t)


# --------------------------------------------------------- sparse path

def test_chain_forced_sparse_under_float32():
    ctx_t, ctx_j = T.SimSpec.make(gmin=1e-15), J.SimSpec.make(gmin=1e-15)
    sp = netlists.chain(6, sparse=True, device="cpu",
                        eval_dtype=torch.float32)
    dense = netlists.chain(6, sparse=False, device="cpu",
                           eval_dtype=torch.float32)
    assert use_sparse_solver(sp) and not use_sparse_solver(dense)
    cj = _compile(J, netlists.chain_netlist(6), [DFF_DIR], "chain.cir",
                  jnp.float32, sparse=True)
    x_sp = T.solve_dc(sp, ctx=ctx_t, mode="tranop")
    x_de = T.solve_dc(dense, ctx=ctx_t, mode="tranop")
    x_j = J.solve_dc(cj, ctx=ctx_j, mode="tranop")
    assert bool(x_sp.converged) and bool(x_de.converged)
    assert float((x_sp.x - x_de.x).abs().max()) <= 1e-6
    scale = float(x_sp.x.abs().max())
    assert float(np.abs(x_sp.x.numpy() - np.asarray(x_j.x)).max()) <= \
        16 * EPS32 * scale


# ------------------------------------------------------------------- AC

def test_dff_ac_under_float32():
    """At the DFF's float32 operating point several BSIM4 devices sit at
    vds = 0 exactly (their drain rounds to the rail of their source),
    where ``vds = abs(vds_r)`` (``bsim4.va:452``) takes JAX's derivative
    +1 (``core/dual.py::absolute``; sign(0) = 0 there parted the AC by
    56 % at 1 kHz, ROADMAP C17).  The AC solution within the stated
    bounds of the JAX package's, relative to its largest entry per
    frequency (1e-6 up to 1 MHz, 1e-4 at 100 MHz, 1e-2 at 1-10 GHz: there
    C's float32 spread, 1.6e-3 of its largest entry between the two
    walks, weighs in); the walk over float64 values takes the same +1 at
    those ties."""
    text = netlists.dff_ac_noise(1)
    ct = _compile(T, text, [DFF_DIR], "dff_ac.cir", torch.float32)
    cj = _compile(J, text, [DFF_DIR], "dff_ac.cir", jnp.float32)
    freqs = np.array([1e3, 1e6, 1e8, 1e9, 1e10])
    bounds = np.array([1e-6, 1e-6, 1e-4, 1e-2, 1e-2])
    ctx_t = T.SimSpec.make(gmin=1e-15)
    aj = J.ac(cj, freqs, ctx=J.SimSpec.make(gmin=1e-15))
    vj = np.asarray(aj.v)
    assert np.all(np.abs(vj).max(-1) > 0.0)          # the supply drives it
    at = T.ac(ct, freqs, ctx=ctx_t)
    vt = at.v.numpy()
    assert vt.shape == vj.shape and np.all(np.isfinite(vt))
    err = np.abs(vt - vj).max(-1) / np.abs(vj).max(-1)
    assert np.all(err <= bounds), err
    # the devices at an exact float32 tie of drain and source
    key = [k for k in ct.group_order if "bsim4" in k.lower()][0]
    grp = ct.groups[key]
    xf = np.concatenate([at.op_x.float().numpy(), [0.0]])
    assert any(xf[grp.var_idx[j, 0]] == xf[grp.var_idx[j, 2]]
               for j in range(len(grp.instances)))
    for dt, want in ((torch.float32, [1.0, 1.0, -1.0]),
                     (torch.float64, [1.0, 1.0, -1.0])):
        y = D.absolute(D.Dual(torch.tensor([0.0, 2.0, -2.0], dtype=dt),
                              torch.ones(3, dtype=dt)))
        assert y.d.tolist() == want, dt
