"""The rest of the port's transient (ROADMAP A7) against the JAX package on
the CPU in float64: stored columns (``TranOptions.store_vars``), the
checkpoint (``sol.checkpoint``, ``tran(resume=)``, ``blank_checkpoint``,
``window_schedules``, ``tran_core(init_state=)``) and cross-step Jacobian
reuse (``jac_reuse >= 2``).

- ``store_vars``: the same stored columns and values as the JAX package's,
  the names mapped as its ``store_map``; an unstored name raises.
- Two windows chained by checkpoint (the README's level-1 inverter, 0-9 ns
  then to 20 ns): each window's accepted, rejected and Newton counts equal
  the JAX package's chained windows, and the output within 1e-6 V; the RC
  step chained through a checkpoint meets its closed form.
- ``resume`` past tstop raises, as ``tests/test_checkpoint.py`` asserts;
  that file's ``.npz`` round trip (``save_checkpoint``,
  ``load_checkpoint``) twinned.
- ``jac_reuse=4`` (one stream, and lanes): the JAX package's accepted,
  rejected and Newton counts.
- ``tran_core`` over two windows from ``blank_checkpoint`` equals the JAX
  package's windows (the PVT harness's chaining).
"""

import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis import tran as jtran
from cedarsim_tpu_torch.analysis import tran as ttran
from cedarsim_tpu_torch.benchmarks import netlists


def _inverter(P):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ckt = P.elaborate(P.parse_spice(netlists.README_INVERTER))
    return P.compile_circuit(ckt, **({"device": "cpu"} if P is T else {}))


def _rc(P):
    ckt = P.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(P.VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=0.0, v2=3.3, td=1e-6, tr=1e-9, tf=1e-9, pw=4e-6,
                 per=10e-6))
    ckt.add(P.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(P.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    return P.compile_circuit(ckt, **({"device": "cpu"} if P is T else {}))


def _counts(s):
    return (bool(s.converged), s.n_accepted, s.n_rejected, s.n_newton)


@pytest.fixture(scope="module")
def inverters():
    return _inverter(J), _inverter(T)


def test_store_vars_matches_jax(inverters):
    cj, ct = inverters
    kw = dict(store_vars=("out", "in"), dense_lu="jax")
    sj = J.tran(cj, (0.0, 2e-8), opts=J.TranOptions(**kw))
    st = T.tran(ct, (0.0, 2e-8), opts=T.TranOptions(**kw))
    assert _counts(st) == _counts(sj)
    assert st.xs.shape == np.asarray(sj.xs).shape == (st.n_accepted, 2)
    assert st.store_map == sj.store_map == {"out": 0, "in": 1}
    np.testing.assert_allclose(st.xs, np.asarray(sj.xs), rtol=0, atol=1e-9)
    np.testing.assert_allclose(st["out"], np.asarray(sj["out"]), rtol=0,
                               atol=1e-9)
    # the whole state stays in the checkpoint
    assert st.checkpoint["x"].shape == (ct.n_x,)
    with pytest.raises(KeyError, match="not stored"):
        st["vdd"]
    with pytest.raises(ValueError, match="storable"):
        T.tran(ct, (0.0, 1e-9), opts=T.TranOptions(store_vars=("0",)))


def test_two_windows_match_jax(inverters):
    cj, ct = inverters
    kw = dict(dense_lu="jax")
    j1 = J.tran(cj, (0.0, 9e-9), opts=J.TranOptions(**kw))
    j2 = J.tran(cj, (0.0, 2e-8), opts=J.TranOptions(**kw),
                resume=j1.checkpoint)
    t1 = T.tran(ct, (0.0, 9e-9), opts=T.TranOptions(**kw))
    assert set(t1.checkpoint) == set(ttran.CHECKPOINT_FIELDS) \
        == set(j1.checkpoint)
    t2 = T.tran(ct, (0.0, 2e-8), opts=T.TranOptions(**kw),
                resume=t1.checkpoint)
    assert (_counts(t1), _counts(t2)) == (_counts(j1), _counts(j2))
    assert t2.ts[0] == pytest.approx(9e-9)
    for t in np.linspace(9.5e-9, 2e-8, 6):
        assert abs(float(t2.interp("out", t)) - float(j2.interp("out", t))) \
            <= 1e-6
    with pytest.raises(ValueError, match="past"):
        T.tran(ct, (0.0, 5e-9), resume=t1.checkpoint)


def test_rc_resume_continues_the_physics():
    c = _rc(T)
    s1 = T.tran(c, (0.0, 2e-6))
    assert s1.converged and abs(float(s1.checkpoint["t"]) - 2e-6) < 1e-8
    s2 = T.tran(c, (0.0, 8e-6), resume=s1.checkpoint)
    assert s2.converged
    for t in (3e-6, 4.9e-6):
        exact = 3.3 * (1 - math.exp(-(t - 1.0005e-6) / 1e-6))
        assert abs(float(s2.interp("vout", t)) - exact) < 0.02


def test_checkpoint_file_round_trip_matches_jax(tmp_path):
    """``tests/test_checkpoint.py``'s round trip through an ``.npz`` file
    (``save_checkpoint``/``load_checkpoint``): the same fields come back as
    arrays, the resumed segment continues the physics (within 0.02 V of
    the closed form and of the run over the whole span) from the saved
    time, and with the JAX package's counts; the JAX package reads the
    port's file."""
    c, cj = _rc(T), _rc(J)
    s1 = T.tran(c, (0.0, 2e-6))
    path = tmp_path / "seg1.npz"
    T.save_checkpoint(path, s1.checkpoint)
    ck = T.load_checkpoint(path)
    assert set(ck) == set(s1.checkpoint)
    assert all(isinstance(v, np.ndarray) for v in ck.values())
    for f, v in s1.checkpoint.items():
        np.testing.assert_array_equal(ck[f], np.asarray(v))
    s2 = T.tran(c, (0.0, 8e-6), resume=ck)
    ref = T.tran(c, (0.0, 8e-6))
    assert s2.converged and s2.ts[0] >= 2e-6 - 1e-9
    for t in (3e-6, 4.9e-6):
        exact = 3.3 * (1 - math.exp(-(t - 1.0005e-6) / 1e-6))
        assert abs(float(s2.interp("vout", t)) - exact) < 0.02
        assert abs(float(s2.interp("vout", t))
                   - float(ref.interp("vout", t))) < 0.02
    j1 = J.tran(cj, (0.0, 2e-6))
    j2 = J.tran(cj, (0.0, 8e-6), resume=J.load_checkpoint(path))
    assert _counts(s2) == _counts(j2) and _counts(s1) == _counts(j1)


@pytest.mark.parametrize("lanes", [None, 2])
def test_jac_reuse_matches_jax(inverters, lanes):
    """Cross-step reuse (jac_reuse=4, full refresh on a stale failure),
    one stream and two lanes (kp scaled 1.0 and 1.1): the JAX package's
    counts for every lane."""
    cj, ct = inverters
    kw = dict(jac_reuse=4, dense_lu="jax", max_steps=4096)
    if lanes is None:
        sj = [J.tran(cj, (0.0, 2e-8), opts=J.TranOptions(**kw))]
        st = [T.tran(ct, (0.0, 2e-8), opts=T.TranOptions(**kw))]
    else:
        from cedarsim_tpu.core.compile import ensure_dynamic as jdyn
        from cedarsim_tpu_torch.core.compile import ensure_dynamic as tdyn
        cj, ct = jdyn(cj, ["kp"]), tdyn(ct, ["kp"])
        sc = (1.0, 1.1)
        sj = []
        for f in sc:
            pj = {k: dict(g) for k, g in cj.params0.items()}
            for k, g in pj.items():
                if "kp" in g:
                    g["kp"] = g["kp"] * f
            sj.append(J.tran(cj, (0.0, 2e-8), params=pj,
                             opts=J.TranOptions(**kw)))
        pt = {k: {pn: v.expand((2,) + tuple(v.shape)) for pn, v in g.items()}
              for k, g in ct.params0.items()}
        for k, g in pt.items():
            if "kp" in g:
                g["kp"] = ct.params0[k]["kp"][None] * torch.tensor(
                    sc, dtype=torch.float64)[:, None]
        st = T.tran(ct, (0.0, 2e-8), params=pt, opts=T.TranOptions(**kw))
    assert [_counts(s) for s in st] == [_counts(s) for s in sj]
    for s, r in zip(st, sj):
        for t in (3e-9, 7e-9, 1.5e-8):
            assert abs(float(s.interp("out", t)) - float(r.interp("out", t))) \
                <= 1e-6


def test_tran_core_windows_match_jax(inverters):
    """Two windows of ``tran_core`` chained from ``blank_checkpoint`` over
    ``window_schedules`` (the PVT harness's chain), with ``store_vars``:
    each window's counts equal the JAX package's, q within 1e-6 V."""
    cj, ct = inverters
    tstop, h0 = 2e-8, 7e-13
    edges = np.linspace(0.0, tstop, 3)
    bps = ct.breakpoints(tstop)
    np.testing.assert_array_equal(bps, cj.breakpoints(tstop))
    win_t = ttran.window_schedules(bps, edges)
    win_j = jtran.window_schedules(bps, edges)
    np.testing.assert_array_equal(win_t, win_j)
    io = ct.node_names.index("out")
    kw = dict(dense_lu="jax", newton_impl="xla", store_vars=(io,),
              max_steps=1024)
    ctx_t, ctx_j = T.SimSpec.make(), J.SimSpec.make()
    op_t = T.solve_dc(ct, ctx=ctx_t, mode="tranop")
    op_j = J.solve_dc(cj, ctx=ctx_j, mode="tranop")
    x_t = op_t.x[None]
    xd_t, m_t = ttran.xdot0_and_mask(ct, x_t, ctx_t.with_mode("tranop"),
                                     ct.params0)
    st_t = ttran.blank_checkpoint(x_t, xd_t, h0)
    ctx_op = ctx_j.with_mode("tranop")
    xd_j = jtran._consistent_xdot(cj, op_j.x, ctx_op, cj.params0)
    m_j = jtran._differential_mask(cj, op_j.x, ctx_op, cj.params0)
    st_j = jtran.blank_checkpoint(op_j.x, xd_j, h0)
    d = cj.dtype
    run = jax.jit(lambda x, xd, ist, a, b, w: jtran.tran_core(
        cj, cj.params0, ctx_j, x, xd, a, b, w, jnp.asarray(h0, d),
        J.TranOptions(**kw), m_j, init_state=ist))
    for k in range(2):
        out_t = ttran.tran_core(ct, ct.params0, ctx_t, st_t["x"],
                                st_t["xdot"], edges[k], edges[k + 1],
                                win_t[k], h0, T.TranOptions(**kw), m_t,
                                init_state=st_t)
        out_j = run(st_j["x"], st_j["xdot"], st_j, jnp.asarray(edges[k], d),
                    jnp.asarray(edges[k + 1], d), jnp.asarray(win_j[k], d))
        kt_, kj = int(out_t[3][0]), int(out_j[3])
        assert (bool(out_t[4][0]), kt_, int(out_t[5][0]), int(out_t[6][0])) \
            == (bool(out_j[4]), kj, int(out_j[5]), int(out_j[6]))
        assert out_t[1].shape[-1] == 1
        q_t = np.interp(edges[k + 1] * 0.999, out_t[0][0, :kt_].numpy(),
                        out_t[1][0, :kt_, 0].numpy())
        q_j = np.interp(edges[k + 1] * 0.999, np.asarray(out_j[0])[:kj],
                        np.asarray(out_j[1])[:kj, 0])
        assert abs(q_t - q_j) <= 1e-6
        st_t, st_j = out_t[8], out_j[7]
