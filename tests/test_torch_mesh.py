"""The port's sharded sweeps (cedarsim_tpu_torch/parallel/) against the JAX
package's (cedarsim_tpu/parallel/mesh.py) on the CPU.

The port runs on 2 and 3 gloo ranks (child processes, one ``RankPool`` of
each size for the module), the JAX package on its 8-device virtual CPU
mesh (tests/conftest.py):

- the divider DC sweep at 11 points (no world size divides it): within
  1e-7 V of the closed form and within 1e-12 V of the JAX package's;
  with R1's tc1 and "temp" swept too (9 points), bitwise the port's
  unsharded ``dc_sweep`` (the JAX package's sharded sweep skips "temp");
- the RC charge with a distinct τ a lane: every lane within 5e-3 V of its
  closed form, the JAX package's accepted and rejected steps per lane,
  and its waveform within 1e-9 V;
- a second span gets its own time grid (the reference's tspan
  regression);
- the RC case of ``test_pallas_lu.py`` on ``dense_lu="mixed"``, through
  the GESP pair's plain versions: the closed form, and the JAX package's
  per-lane counts on its Pallas kernels in interpret mode;
- the reference's two faults, port only: a non-default C in ``params``
  reaches the fused plan (plain version) and a second temperature gets a
  plan of its own, each run equal to the port's unsharded ``tran``;
- ``dryrun_multichip(2, device="cpu")``'s three gates;
- a world of one equals the plain lane-batched ``tran``: equal counts per
  lane and |Δx| <= 1e-12 V;
- no fallback: a CUDA mesh without a card raises.

Every rank returns the whole result; the tests hold the ranks' results
bitwise equal.
"""

import numpy as np
import pytest
import torch

import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.parallel import RankPool, dryrun_multichip
from cedarsim_tpu_torch.parallel.mesh import (make_mesh, run_sharded,
                                              tran_sweep_sharded, pad_batch)

R2S = np.linspace(500.0, 4000.0, 11)       # 11: not a multiple of 2 or 3
RS = np.linspace(500.0, 2200.0, 8)
WORLDS = (2, 3)


def _divider(P, tc1=0.0):
    ckt = P.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(P.VSource, "V1", (vin, ckt.gnd), dict(dc=5.0))
    ckt.add(P.Resistor, "R1", (vin, vout), dict(r=1000.0, tc1=tc1))
    ckt.add(P.Resistor, "R2", (vout, ckt.gnd), dict(r=1000.0))
    return ckt


def _rc(P, c=1e-9, dc_only=False):
    ckt = P.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    if dc_only:
        ckt.add(P.VSource, "V1", (vin, ckt.gnd), dict(dc=1.0))
    else:
        ckt.add(P.VSourcePULSE, "V1", (vin, ckt.gnd),
                dict(v1=0.0, v2=2.0, td=1e-6, tr=1e-9, tf=1e-9, pw=8e-6,
                     per=20e-6))
    ckt.add(P.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(P.Capacitor, "C1", (vout, ckt.gnd), dict(c=c))
    return ckt


def _closed_form(res, iv, rs, c=1e-9, t_probe=3e-6):
    got = np.asarray([np.interp(t_probe, np.asarray(res.ts)[k],
                                np.asarray(res.xs)[k, :, iv])
                      for k in range(len(rs))])
    want = 2.0 * (1 - np.exp(-(t_probe - 1e-6 - 0.5e-9)
                             / (np.asarray(rs) * c)))
    return got, want


def _same_on_every_rank(results):
    first = results[0]
    for r in results[1:]:
        if isinstance(first, tuple):
            for a, b in zip(first, r):
                np.testing.assert_array_equal(a, b)
        else:
            for f in ("ts", "xs", "xdots", "finished", "n_accepted",
                      "n_rejected", "n_newton"):
                np.testing.assert_array_equal(getattr(first, f),
                                              getattr(r, f))
    return first


@pytest.fixture(scope="module")
def pools():
    out = {}
    try:
        for n in WORLDS:
            out[n] = RankPool(n, device="cpu", threads=1)
        yield out
    finally:
        for p in out.values():
            p.close()


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's sharded sweeps on its 8-device CPU mesh, once."""
    import cedarsim_tpu as J
    from cedarsim_tpu.parallel.mesh import (make_mesh as jmesh,
                                            dc_sweep_sharded as jdc,
                                            tran_sweep_sharded as jtran)
    mesh = jmesh()
    assert mesh.size == 8, mesh
    div = J.compile_circuit(_divider(J), dynamic_params=["r"])
    rc = J.compile_circuit(_rc(J), dynamic_params=["r"])
    rcdc = J.compile_circuit(_rc(J, dc_only=True), dynamic_params=["r"])
    rs_span = np.linspace(800.0, 1200.0, 8)
    return dict(
        dc=jdc(div, J.Sweep("R2.r", R2S), mesh),
        iv_div=div.node_names.index("vout"),
        rc=jtran(rc, J.Sweep("R1.r", RS), (0.0, 6e-6), mesh),
        iv_rc=rc.node_names.index("vout"),
        span=[jtran(rcdc, J.Sweep("R1.r", rs_span), (0.0, t), mesh)
              for t in (1e-6, 5e-6)],
        rs_span=rs_span)


@pytest.mark.parametrize("world", WORLDS)
def test_dc_sweep_sharded_divider(pools, jax_ref, world):
    x, conv, iters, resn = _same_on_every_rank(pools[world].call(
        run_sharded, "dc", _divider(T), T.Sweep("R2.r", R2S),
        compile_kw=dict(dynamic_params=["r"])))
    assert x.shape[0] == len(R2S) and conv.all()
    iv = jax_ref["iv_div"]
    want = 5.0 * R2S / (1000.0 + R2S)
    assert np.abs(x[:, iv] - want).max() < 1e-7
    assert np.abs(x - np.asarray(jax_ref["dc"].x)).max() < 1e-12
    # "temp" sweeps the temperature per point, as dc_sweep does (9
    # points, R1 with tc1): equal to the port's unsharded dc_sweep
    ckt = _divider(T, tc1=0.002)
    sw = T.ProductSweep(T.Sweep("R2.r", R2S[:3]),
                        T.Sweep("temp", [27.0, 77.0, 127.0]))
    xt = _same_on_every_rank(pools[world].call(
        run_sharded, "dc", ckt, sw,
        compile_kw=dict(dynamic_params=["r"])))[0]
    ref = T.dc_sweep(T.compile_circuit(ckt, device="cpu",
                                       dynamic_params=["r"]), sw)
    np.testing.assert_array_equal(xt, ref.x.numpy())
    assert np.ptp(xt[:3, iv]) > 0.1


@pytest.mark.parametrize("world", WORLDS)
def test_tran_sweep_sharded_rc_physics(pools, jax_ref, world):
    res = _same_on_every_rank(pools[world].call(
        run_sharded, "tran", _rc(T), T.Sweep("R1.r", RS), (0.0, 6e-6),
        compile_kw=dict(dynamic_params=["r"])))
    assert res.finished.all()
    iv = jax_ref["iv_rc"]
    got, want = _closed_form(res, iv, RS)
    assert np.abs(got - want).max() < 5e-3
    assert abs(got[0] - got[-1]) > 0.05
    ref = jax_ref["rc"]
    np.testing.assert_array_equal(res.n_accepted, np.asarray(ref.n_accepted))
    np.testing.assert_array_equal(res.n_rejected, np.asarray(ref.n_rejected))
    jgot, _ = _closed_form(ref, iv, RS)
    assert np.abs(got - jgot).max() < 1e-9
    for k, m in enumerate(res.n_accepted):
        np.testing.assert_allclose(res.ts[k, :m], np.asarray(ref.ts)[k, :m],
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_tran_sweep_sharded_respects_new_tspan(pools, jax_ref, world):
    rs = jax_ref["rs_span"]
    for tstop, ref in zip((1e-6, 5e-6), jax_ref["span"]):
        res = _same_on_every_rank(pools[world].call(
            run_sharded, "tran", _rc(T, dc_only=True), T.Sweep("R1.r", rs),
            (0.0, tstop), compile_kw=dict(dynamic_params=["r"])))
        assert res.finished.all()
        assert abs(res.ts.max() - tstop) < 1e-12
        assert abs(res.ts.max() - np.asarray(ref.ts).max()) < 1e-12
        np.testing.assert_array_equal(res.n_accepted,
                                      np.asarray(ref.n_accepted))


def test_rc_on_the_mixed_dense_lu(pools, monkeypatch):
    """``test_pallas_lu.py``'s RC case: ``dense_lu="mixed"`` runs the
    GESP pair's plain versions on the CPU; the closed form, and the JAX
    package's counts on its Pallas kernels in interpret mode."""
    from cedarsim_tpu.ops import linalg
    monkeypatch.setattr(linalg, "_MIXED_INTERPRET", True)
    import cedarsim_tpu as J
    from cedarsim_tpu.analysis.tran import TranOptions as JOpts
    from cedarsim_tpu.parallel.mesh import (make_mesh as jmesh,
                                            tran_sweep_sharded as jtran)
    rc = J.compile_circuit(_rc(J), dynamic_params=["r"])
    ref = jtran(rc, J.Sweep("R1.r", RS), (0.0, 6e-6), jmesh(),
                opts=JOpts(dense_lu="mixed", jac_reuse=1))
    res = _same_on_every_rank(pools[2].call(
        run_sharded, "tran", _rc(T), T.Sweep("R1.r", RS), (0.0, 6e-6),
        compile_kw=dict(dynamic_params=["r"]),
        opts=T.TranOptions(dense_lu="mixed", jac_reuse=1)))
    assert res.finished.all()
    got, want = _closed_form(res, rc.node_names.index("vout"), RS)
    assert np.abs(got - want).max() < 5e-3
    np.testing.assert_array_equal(res.n_accepted, np.asarray(ref.n_accepted))
    np.testing.assert_array_equal(res.n_rejected, np.asarray(ref.n_rejected))


def _diode_rc(c):
    """A pulsed RC whose node also feeds a diode to ground: the diode is
    a nonlinear group, so the fused plan holds the R and C as its
    constants and walks the diode in the kernel."""
    ckt = _rc(T, c=c)
    ckt.add(T.Diode, "D1", (ckt.net("vout"), ckt.gnd),
            {"is": 1e-14, "n": 1.0})
    return ckt


FUSED = T.TranOptions(newton_impl="fused", formulation="cap", jac_reuse=1)


def _unsharded(comp, sweep, params=None, ctx=None):
    from cedarsim_tpu_torch.analysis.sweeps import batch_params
    comp, bp, _ = batch_params(comp, sweep, params)
    return comp, T.tran(comp, (0.0, 6e-6), params=bp, ctx=ctx, opts=FUSED)


def _equal_to(res, sols):
    np.testing.assert_array_equal(res.n_accepted,
                                  [s.n_accepted for s in sols])
    for k, s in enumerate(sols):
        np.testing.assert_array_equal(res.xs[k, :s.n_accepted], s.xs)


def test_fused_plan_takes_the_lane_params():
    """Reference fault ``mesh.py:158``: the fused plan built from the
    compiled params would hold C = 1 nF.  Here a non-default C = 2 nF in
    ``params`` reaches it: the lanes charge with τ = r·2 nF and equal the
    port's unsharded ``tran`` of the same params."""
    comp = T.compile_circuit(_diode_rc(1e-9), device="cpu",
                             dynamic_params=["V1.v2", "c"])
    params = comp.set_param(comp.params0, "C1.c", 2e-9)
    amps = np.asarray([1.0, 1.5, 2.0, 2.5])
    mesh = make_mesh(device="cpu")
    res = tran_sweep_sharded(comp, T.Sweep("V1.v2", amps), (0.0, 6e-6),
                             mesh, params=params, opts=FUSED)
    assert res.finished.all()
    assert comp._fused_plans            # the run went through the plan
    comp2, sols = _unsharded(comp, T.Sweep("V1.v2", amps), params)
    _equal_to(res, sols)
    # the diode clamps the node near 0.6-0.7 V; before it conducts the
    # charge follows τ = r·C of the non-default C
    iv = comp2.node_names.index("vout")
    t = 1e-6 + 0.5e-9 + 0.05e-6
    got = np.asarray([np.interp(t, res.ts[k], res.xs[k, :, iv])
                      for k in range(len(amps))])
    want = amps * (1 - np.exp(-(t - 1e-6 - 0.5e-9) / (1000.0 * 2e-9)))
    assert np.abs(got - want).max() < 2e-3 * amps.max()
    other = amps * (1 - np.exp(-(t - 1e-6 - 0.5e-9) / (1000.0 * 1e-9)))
    assert np.abs(got - other).min() > 10 * np.abs(got - want).max()


def test_a_second_temperature_gets_its_own_plan():
    """Reference fault ``mesh.py:190``: its cache key leaves out the
    context, so a second temperature replays the first one's constants.
    Here each temperature's sharded run equals its own unsharded
    ``tran``, and the two differ."""
    comp = T.compile_circuit(_diode_rc(1e-9), device="cpu",
                             dynamic_params=["V1.v2"])
    amps = np.asarray([1.0, 2.0])
    mesh = make_mesh(device="cpu")
    runs = []
    for temp_c in (27.0, 125.0):
        ctx = T.SimSpec.make(temp_c=temp_c)
        res = tran_sweep_sharded(comp, T.Sweep("V1.v2", amps), (0.0, 6e-6),
                                 mesh, ctx=ctx, opts=FUSED)
        _equal_to(res, _unsharded(comp, T.Sweep("V1.v2", amps),
                                  ctx=ctx)[1])
        runs.append(res)
    assert len(comp._fused_plans) == 2     # one plan a temperature
    iv = comp.node_names.index("vout")
    assert abs(runs[0].xs[1, -1, iv] - runs[1].xs[1, -1, iv]) > 1e-3


def test_dryrun_multichip_on_gloo_ranks():
    line = dryrun_multichip(2, device="cpu")
    assert line.startswith("dryrun_multichip(2): 4 DFF operating points "
                           "converged and 2 sharded transients finished")
    worst = float(line.split("worst lane error ")[1].split()[0])
    assert worst < 5e-3


def test_world_of_one_is_lane_batched_tran():
    comp = T.compile_circuit(_rc(T), device="cpu", dynamic_params=["r"])
    mesh = make_mesh(device="cpu")
    assert mesh.size == 1
    res = tran_sweep_sharded(comp, T.Sweep("R1.r", RS), (0.0, 6e-6), mesh)
    from cedarsim_tpu_torch.analysis.sweeps import batch_params
    comp2, bp, _ = batch_params(comp, T.Sweep("R1.r", RS))
    sols = T.tran(comp2, (0.0, 6e-6), params=bp)
    np.testing.assert_array_equal(res.n_accepted,
                                  [s.n_accepted for s in sols])
    np.testing.assert_array_equal(res.n_rejected,
                                  [s.n_rejected for s in sols])
    for k, s in enumerate(sols):
        assert np.abs(res.xs[k, :s.n_accepted] - s.xs).max() <= 1e-12
        # rows past a lane's end repeat its final state
        assert (res.ts[k, s.n_accepted:] == s.ts[-1]).all()
    padded, n = pad_batch({"a": {"b": torch.arange(5.0)}}, 3)
    assert n == 5 and padded["a"]["b"].tolist() == [0, 1, 2, 3, 4, 4]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal")
def test_no_fallback_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        RankPool(2)
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        make_mesh(device="cpu", backend="nccl")
