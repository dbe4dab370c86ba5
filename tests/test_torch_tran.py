"""The port's transient (cedarsim_tpu_torch/analysis/tran.py) against closed
forms and against the JAX package's ``tran``.

- RC step: the closed form one τ after the edge (5e-3 V), and the JAX
  package's run with the same options (1e-8 V, same step counts) for the
  charge-form trap, BE and the cap-form BDF2.
- gf180 DFF, 0-120 ns: two lanes (nominal W and W·1.01) through the mixed
  chord path (plain GESP kernels on the CPU) against the JAX package's
  one-lane runs of the same W with the exact solver: every node within
  1e-3 V at ten times, accepted steps within 10 %; the nominal lane equals
  a solo run of the port to 1e-12 V (lane independence).
- gf180 DFF, 0-1 ns from the smoke's per-lane warm DC at W·0.99 and
  nominal (ROADMAP Queue C, C1, C19): the port's mixed path finishes both
  lanes with no chord solve on a boosted factor and none non-finite (a
  lane whose factor in J's own row order rounds a pivot to 0 is factored
  again in the source row order), with the reference's accepted and
  rejected steps on the lane where the reference boosts no pivot; every
  float32 factor of that run is bitwise the Pallas factor in interpret
  mode; the exact chord beside it; and the JAX package's own mixed path
  (its Pallas kernels in interpret mode) on the same input, with its
  counts and its boosted factors and non-finite substitutions per lane
  (``tests/mixed_path_counts.py`` prints the counts over any window).
- The package never imports JAX (a fresh interpreter), on the RC step, on
  a VA diode through the fused chord path, and in the dense-LU bench's
  module.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis.tran import TranOptions as JTranOptions

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DFF_DIR = os.path.join(REPO, "benchmarks", "gf180_dff")


def _rc(P):
    ckt = P.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(P.VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=0.0, v2=3.3, td=1e-6, tr=1e-9, tf=1e-9, pw=4e-6,
                 per=10e-6))
    ckt.add(P.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(P.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    # the port's compile runs on the card unless told otherwise
    return P.compile_circuit(ckt, **({"device": "cpu"} if P is T else {}))


def test_rc_closed_form_mixed():
    # one lane as a batch ([1, n_x]): the mixed path (an unbatched stream
    # takes the exact solve under "mixed", as the JAX package's does)
    comp = _rc(T)
    x0 = T.solve_dc(comp, mode="tranop").x[None]
    sol, = T.tran(comp, (0.0, 20e-6), opts=T.TranOptions(dense_lu="mixed"),
                  x0=x0)
    assert sol.converged
    want = 3.3 * (1.0 - np.exp(-1.0))
    assert abs(sol.interp("vout", 2.001e-6) - want) < 5e-3


@pytest.mark.parametrize("method, formulation", [
    ("auto", "auto"), ("be", "charge"), ("bdf2", "cap")])
def test_rc_matches_jax(method, formulation):
    kw = dict(method=method, formulation=formulation, jac_reuse=1,
              dense_lu="jax", newton_impl="xla")
    sj = J.tran(_rc(J), (0.0, 20e-6), opts=JTranOptions(**kw))
    st = T.tran(_rc(T), (0.0, 20e-6), opts=T.TranOptions(**kw))
    assert st.converged and sj.converged
    assert (st.n_accepted, st.n_rejected, st.n_newton) == \
        (sj.n_accepted, sj.n_rejected, sj.n_newton)
    # same steps; step sizes agree to rounding of the controller, and the
    # states at those times to that shift times the slope (3.3 V per µs)
    np.testing.assert_allclose(st.ts, sj.ts, rtol=1e-8, atol=0)
    np.testing.assert_allclose(st.xs, sj.xs, rtol=0, atol=1e-8)
    # first-order BE misses the closed form by 0.07 V in both packages
    if method != "be":
        assert abs(st.interp("vout", 2.001e-6)
                   - 3.3 * (1.0 - np.exp(-1.0))) < 5e-3


def _dff_text():
    with open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")) as f:
        return f.read()


#: the chip smoke's options over a shorter window; the mixed path's float32
#: GESP factor needs the Jacobian-only shunt (see PERF.md)
_OPTS = dict(max_steps=8192, jac_reuse=1, newton_impl="xla",
             accept_slack=1.5)


def test_dff_lanes_mixed_vs_jax():
    tstop = 120e-9
    scale = (1.0, 1.01)
    cj = J.compile_circuit(J.elaborate(
        J.parse_spice(_dff_text(), file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]))
    kj = [k for k in cj.group_order if "bsim4" in k.lower()][0]
    refs = []
    for f in scale:
        pj = dict(cj.params0)
        pj[kj] = dict(pj[kj], W=pj[kj]["W"] * f)
        refs.append(J.tran(cj, (0.0, tstop), params=pj,
                           ctx=J.SimSpec.make(gmin=1e-15),
                           opts=JTranOptions(dense_lu="jax", **_OPTS)))
    ct = T.compile_circuit(T.elaborate(
        T.parse_spice(_dff_text(), file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]), device="cpu")
    ctx = T.SimSpec.make(gmin=1e-15)
    key = [k for k in ct.group_order if "bsim4" in k.lower()][0]
    sc = torch.tensor(scale, dtype=torch.float64)
    pb = {k: dict(g) for k, g in ct.params0.items()}
    pb[key]["W"] = ct.params0[key]["W"][None, :] * sc[:, None]
    opts = T.TranOptions(dense_lu="mixed", jac_shunt=1e-9, **_OPTS)
    lanes = T.tran(ct, (0.0, tstop), params=pb, ctx=ctx, opts=opts)
    t_chk = np.linspace(5e-9, tstop, 10)
    for lane, sj in zip(lanes, refs):
        assert sj.converged and lane.converged
        ref = sj.interp_state(t_chk)[:, :ct.n_nodes]
        got = np.stack([np.interp(t_chk, lane.ts, lane.xs[:, i])
                        for i in range(ct.n_nodes)], -1)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
        assert abs(lane.n_accepted - sj.n_accepted) <= 0.1 * sj.n_accepted
    nominal = lanes[0]
    # lane independence: the nominal lane equals the port run alone, as a
    # batch of one lane (the mixed path; one stream takes the exact solve)
    p1 = {k: {pn: v[None] for pn, v in g.items()}
          for k, g in ct.params0.items()}
    solo, = T.tran(ct, (0.0, tstop), params=p1, ctx=ctx, opts=opts)
    assert solo.n_accepted == nominal.n_accepted
    np.testing.assert_allclose(nominal.xs[:, :ct.n_nodes],
                               solo.xs[:, :ct.n_nodes], rtol=0, atol=1e-12)


#: per lane (W·0.99, nominal): accepted, rejected, Newton iterations over
#: 0-1 ns of the port's mixed path (plain kernels on the CPU: the factor
#: rounding each update once, the substitution each term twice) and of the
#: JAX package's mixed path (Pallas in interpret mode), both from the port's
#: per-lane warm DC.  Since ROADMAP C17 that start differs from the one
#: before by at most 1.2e-16 V, and from it the factor in J's own row
#: order rounds the pivot of clkn's KCL row (3e-8 of its row, under
#: float32's resolution: every supply node's KCL precedes its source's
#: branch row) to 0 on both packages' paths.  The JAX package's boosts it
#: on the W·0.99 lane (``REFERENCE_1NS_FAULTS``: boosted factors and
#: non-finite substitutions there) and takes a rejected step; the port
#: factors such a lane again in the source row order (ROADMAP C19), so
#: that no chord solve runs on a boosted factor: on the nominal lane, where
#: the reference boosts nothing, the two take the same accepted and
#: rejected steps.  From the start before C17: the port 38 / 1 / 82 and
#: 36 / 0 / 35, the reference 38 / 1 / 55 and 36 / 0 / 35.
PORT_1NS = [(39, 2, 97), (36, 0, 35)]
REFERENCE_1NS = [(38, 1, 49), (36, 0, 40)]
REFERENCE_1NS_FAULTS = [(1, 11), (0, 0)]
#: lanes that the port's run factors again in the source row order
PORT_1NS_REORDERED = 2


@pytest.fixture(scope="module")
def dff_mixed_1ns():
    """The port's mixed path on the 2-lane DFF over 0-1 ns (cell A's
    options, from the per-lane warm DC), recording every float32 factor
    (input and packed LU) and counting the chord factors with a boosted
    pivot (those that the chord solves use), the lanes factored again,
    the chord solves and the non-finite solves.  Returns (solutions,
    factors, counts, inputs)."""
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    from cedarsim_tpu_torch.ops import gesp_lu, linalg
    dff = kt.dff_lanes(torch, T, "cpu", lanes=2)
    comp, ctx, pb, x0 = dff
    factor, backsolve = gesp_lu.lu_factor_gesp_f32, linalg.chord_backsolve
    chord_factor = linalg.chord_factor
    factors = []
    seen = dict(boosted=0, solves=0, nonfinite=0)

    def lu_factor_gesp_f32(A):
        LU = factor(A)
        factors.append((A.clone(), LU))
        return LU

    def chord_factor_counted(J, *args):
        LU, perm, r = chord_factor(J, *args)
        seen["boosted"] += int((LU.diagonal(dim1=-2, dim2=-1).abs()
                                <= 1e-20).any(-1).sum())
        return LU, perm, r

    def chord_backsolve(*args):
        x = backsolve(*args)
        seen["solves"] += x.shape[0]
        seen["nonfinite"] += int((~torch.isfinite(x)).any(-1).sum())
        return x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gesp_lu, "lu_factor_gesp_f32", lu_factor_gesp_f32)
        mp.setattr(linalg, "chord_factor", chord_factor_counted)
        mp.setattr(linalg, "chord_backsolve", chord_backsolve)
        mp.setattr(linalg, "reordered", 0)
        sols = T.tran(comp, (0.0, 1e-9), params=pb, ctx=ctx, x0=x0,
                      opts=T.TranOptions(**kt.XLA_OPTS))
        seen["reordered"] = linalg.reordered
    return sols, factors, seen, dff


def test_dff_mixed_path_float32_margin(dff_mixed_1ns):
    """ROADMAP Queue C, C1 and C19: the DFF's first nanosecond from the
    per-lane warm DC of the smoke's W scatter at two lanes (W·0.99 and
    nominal), cell A's options.  With the factor rounding each update once
    (as the Pallas factor does under XLA), the port's mixed path finishes
    both lanes, no chord solve runs on a factor with a boosted pivot and
    none is non-finite; it takes the counts ``PORT_1NS``, the reference's
    accepted and rejected steps on the lane where the reference boosts no
    pivot.  The lanes whose factor in J's own order rounds a pivot to 0
    are factored again in the source row order; without that (the factor
    in J's own order alone, as the JAX package's) the same run boosts
    pivots and takes non-finite solves.  The exact float64 chord finishes
    both lanes with no rejected step."""
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    from cedarsim_tpu_torch.ops import linalg
    sols, _, seen, (comp, ctx, pb, x0) = dff_mixed_1ns
    assert [(s.converged, s.n_accepted, s.n_rejected, s.n_newton)
            for s in sols] == [(True, *c) for c in PORT_1NS]
    clean = [i for i, f in enumerate(REFERENCE_1NS_FAULTS) if f == (0, 0)]
    assert clean == [1]
    assert [PORT_1NS[i][:2] for i in clean] == \
        [REFERENCE_1NS[i][:2] for i in clean]
    assert seen["boosted"] == 0
    assert seen["solves"] > 100 and seen["nonfinite"] == 0
    assert seen["reordered"] == PORT_1NS_REORDERED
    # J's own row order alone: the factor boosts and the solves overflow
    natural = dict(boosted=0, nonfinite=0)
    chord_factor, backsolve = linalg.chord_factor, linalg.chord_backsolve

    def own_order(J, *args):
        LU, perm, r = chord_factor(J)
        natural["boosted"] += int((LU.diagonal(dim1=-2, dim2=-1).abs()
                                   <= 1e-20).any(-1).sum())
        return LU, perm, r

    def counted(*args):
        x = backsolve(*args)
        natural["nonfinite"] += int((~torch.isfinite(x)).any(-1).sum())
        return x
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linalg, "chord_factor", own_order)
        mp.setattr(linalg, "chord_backsolve", counted)
        T.tran(comp, (0.0, 1e-9), params=pb, ctx=ctx, x0=x0,
               opts=T.TranOptions(**kt.XLA_OPTS))
    assert natural["boosted"] > 0 and natural["nonfinite"] > 0
    exact = T.tran(comp, (0.0, 1e-9), params=pb, ctx=ctx, x0=x0,
                   opts=T.TranOptions(**dict(kt.XLA_OPTS, dense_lu="auto")))
    assert all(s.converged and s.n_rejected == 0 for s in exact)


def test_dff_chord_factors_are_bitwise_pallas(dff_mixed_1ns):
    """Every float32 GESP factor of the port's 2-lane DFF run over 0-1 ns
    (the plain factor on the CPU) is bitwise the JAX package's Pallas
    factor (``lu_factor_batched_sublane_f32``, interpret mode) on the same
    input, but for the sign of some zeros: the Pallas kernel applies each
    step's update to the whole matrix with masked zeros (``A - 0 * u``),
    which turns a -0.0 outside the trailing block into +0.0 where the
    product is +0.0; the port updates the trailing block only."""
    import jax.numpy as jnp
    from cedarsim_tpu.ops.pallas_lu import lu_factor_batched_sublane_f32
    _, factors, _, _ = dff_mixed_1ns
    assert len(factors) >= 30
    for A, LU in factors:
        lu_t = LU.numpy()
        lu_j = np.asarray(lu_factor_batched_sublane_f32(
            jnp.asarray(A.numpy()), interpret=True))
        differ = lu_t.view(np.int32) != lu_j.view(np.int32)
        assert ((lu_t == 0) & (lu_j == 0))[differ].all()


def test_dff_mixed_path_reference_finishes_both_lanes(monkeypatch,
                                                      dff_mixed_1ns):
    """ROADMAP Queue C against the reference: the JAX package's own mixed
    chord path (its Pallas GESP factor and substitution in interpret mode,
    switched on by ``cedarsim_tpu.ops.linalg._MIXED_INTERPRET``) on the
    margin test's input: the DFF from the port's per-lane warm DC at W·0.99
    and nominal, cell A's options, 0-1 ns, the two lanes vmapped through
    ``tran_core`` as ``bench.py`` runs them.  The reference finishes both
    lanes with the counts ``REFERENCE_1NS``; per lane, its factors with a
    pivot boosted to 1e-20 and its substitutions with a non-finite entry
    are ``REFERENCE_1NS_FAULTS`` (the W·0.99 lane's factor in J's own row
    order rounds a pivot to 0, as the port's does, ROADMAP C19)."""
    import jax
    import jax.numpy as jnp
    from cedarsim_tpu.analysis.tran import (_consistent_xdot,
                                            _differential_mask, tran_core)
    from cedarsim_tpu.ops import linalg as jlinalg
    from cedarsim_tpu.ops import pallas_lu
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    # the port's per-lane warm DC, as the margin test's fixture made it
    _, _, _, x0_t = dff_mixed_1ns[3]
    cj = J.compile_circuit(J.elaborate(
        J.parse_spice(_dff_text(), file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]))
    key = [k for k in cj.group_order if "bsim4" in k.lower()][0]
    pb = jax.tree.map(lambda a: jnp.repeat(a[None], 2, 0), cj.params0)
    pb[key] = dict(pb[key], W=pb[key]["W"] * jnp.asarray([0.99, 1.0])[:, None])
    ctx = J.SimSpec.make(gmin=1e-15)
    opts = JTranOptions(**kt.XLA_OPTS)
    assert opts.dense_lu == "mixed" and opts.newton_impl == "xla"
    x0 = jnp.asarray(x0_t.numpy())
    ctx_op = ctx.with_mode("tranop").at_time(0.0)
    xd0 = jax.vmap(lambda x, p: _consistent_xdot(cj, x, ctx_op, p))(x0, pb)
    mask = jax.vmap(lambda x, p: _differential_mask(cj, x, ctx_op, p))(
        x0, pb)
    # the schedule and first step of J.tran / T.tran over 0-1 ns
    tstop = 1e-9
    bps = cj.breakpoints(tstop)
    bps = np.concatenate([bps[bps > 0.0], [tstop], [np.inf]])
    h0 = tstop * 1e-6
    if len(bps) > 2:
        h0 = min(h0, max(float(bps[0]) * 0.1, tstop * 1e-9))
    d = cj.dtype
    monkeypatch.setattr(jlinalg, "_MIXED_INTERPRET", True)
    # per lane: the factors with a boosted pivot and the substitutions with
    # a non-finite entry, read from the Pallas kernels' outputs
    faults = np.zeros((2, 2), dtype=int)
    factor = pallas_lu.lu_factor_batched_sublane_f32
    subst = pallas_lu.lu_subst_batched_sublane_f32

    def add(col):
        def f(hit):
            faults[:, col] += np.asarray(hit).astype(int)
        return f

    def factor_seen(A, **kw):
        LU = factor(A, **kw)
        jax.debug.callback(add(0), (jnp.abs(jnp.diagonal(
            LU, axis1=-2, axis2=-1)) <= 1e-20).any(-1))
        return LU

    def subst_seen(LU, b, **kw):
        x = subst(LU, b, **kw)
        jax.debug.callback(add(1), (~jnp.isfinite(x)).any(-1))
        return x
    monkeypatch.setattr(pallas_lu, "lu_factor_batched_sublane_f32",
                        factor_seen)
    monkeypatch.setattr(pallas_lu, "lu_subst_batched_sublane_f32",
                        subst_seen)
    run = jax.jit(jax.vmap(lambda p, x, xd, m: tran_core(
        cj, p, ctx, x, xd, jnp.asarray(0.0, d), jnp.asarray(tstop, d),
        jnp.asarray(bps, d), jnp.asarray(h0, d), opts, m)))
    _, _, _, k, fin, nrej, nnwt, final = run(pb, x0, xd0, mask)
    jax.effects_barrier()
    counts = list(zip(np.asarray(k).tolist(), np.asarray(nrej).tolist(),
                      np.asarray(nnwt).tolist()))
    assert np.asarray(fin).all(), counts
    np.testing.assert_allclose(np.asarray(final["t"]), tstop, rtol=1e-12)
    assert counts == REFERENCE_1NS
    assert [tuple(f) for f in faults.tolist()] == REFERENCE_1NS_FAULTS


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.abspath(REPO)!r})\n"
        "import cedarsim_tpu_torch as T\n"
        "ckt = T.Circuit()\n"
        "a, b = ckt.net('a'), ckt.net('b')\n"
        "ckt.add(T.VSourcePULSE, 'V1', (a, ckt.gnd), dict(v1=0.0, v2=1.0, "
        "td=1e-6, tr=1e-9, tf=1e-9, pw=4e-6, per=10e-6))\n"
        "ckt.add(T.Resistor, 'R1', (a, b), dict(r=1e3))\n"
        "ckt.add(T.Capacitor, 'C1', (b, ckt.gnd), dict(c=1e-9))\n"
        "sol = T.tran(T.compile_circuit(ckt, device='cpu'), (0.0, 5e-6))\n"
        "assert sol.converged\n"
        # the fused chord path (its plain version on the CPU) with a VA
        # diode emitted as C++ by the plan
        "from cedarsim_tpu_torch.va.codegen import load_va\n"
        "d = load_va('module dd(a, c); inout a, c; electrical a, c; "
        "analog I(a, c) <+ 1e-14 * (limexp(V(a, c) / $vt) - 1.0); "
        "endmodule')['dd']\n"
        "ckt.add(d, 'D1', (b, ckt.gnd), {})\n"
        "sol = T.tran(T.compile_circuit(ckt, device='cpu'), (0.0, 5e-6), "
        "opts=T.TranOptions(formulation='cap', jac_reuse=1, "
        "newton_impl='fused'))\n"
        "assert sol.converged and 0.0 < sol.interp('b', 4e-6) < 0.9\n"
        # the dense-LU bench and its kernels' modules
        "import cedarsim_tpu_torch.benchmarks.lu_bench\n"
        # the built-in device library, the behavioral sources and the
        # netlist front door, each card through simulate() on the CPU
        "import cedarsim_tpu_torch.devices.mos, cedarsim_tpu_torch.devices."
        "bjt, cedarsim_tpu_torch.devices.jfet\n"
        "import cedarsim_tpu_torch.frontend.behavioral\n"
        "from cedarsim_tpu_torch.benchmarks import netlists\n"
        "r = T.simulate(netlists.ALL_CARDS.replace('.tran 1n 50n', '.op'), "
        "device='cpu')\n"
        "assert bool(r['op'].converged)\n"
        # sweeps, Monte-Carlo and the PVT harness: a .dc card through
        # simulate(), a Monte-Carlo DC and the harness's modules
        "from cedarsim_tpu_torch.analysis import sweeps, montecarlo\n"
        "import cedarsim_tpu_torch.benchmarks.pvt_sweep\n"
        "r = T.simulate('* d\\nv1 a 0 1\\nr1 a b 1k\\nr2 b 0 1k\\n"
        ".dc v1 0 1 0.5\\n', device='cpu')\n"
        "assert bool(r['dc'].converged.all())\n"
        "m = montecarlo.mc_dc(r['compiled'], 4, {'r1.r': ('rel', 0.1)}, "
        "seed=1)\n"
        "assert bool(m.converged.all())\n"
        # the sharded sweeps, their rank workers and the dry-run child
        "import cedarsim_tpu_torch.parallel\n"
        "import cedarsim_tpu_torch.parallel.worker\n"
        "import cedarsim_tpu_torch.parallel.dryrun_child\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m.startswith('cedarsim_tpu.') or m == "
        "'cedarsim_tpu' for m in sys.modules)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
