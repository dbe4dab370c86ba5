"""One rank of :func:`cedarsim_tpu_torch.parallel.dryrun_multichip`
(counterpart of ``cedarsim_tpu/parallel/dryrun_child.py``).

``python -m cedarsim_tpu_torch.parallel.dryrun_child N [DEVICE BACKEND]``
with ``RANK``, ``WORLD_SIZE`` and ``CEDARSIM_MESH_INIT`` in its
environment joins an ``N``-rank group and runs the three gates of the
sharded sweeps, each rank its slice:

- the level-1 DFF (``benchmarks/gf180_dff/dff_tb.cir``): a sweep of the
  NMOS threshold ``vto``, two points a rank, every operating point
  converged;
- its sharded transient over 0-2 ns, one point a rank, every lane
  finished;
- an RC charge with a distinct τ = r·1 nF a lane, two lanes a rank: every
  lane within 5e-3 V of its own closed form at 3 µs, and the lanes apart
  by more than 0.05 V, so that a gather that permutes or clobbers lanes
  cannot pass.

Rank 0 prints one summary line.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def gates(mesh=None):
    """The three gates on ``mesh`` (by default a ``RankPool`` worker's);
    returns the summary line."""
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.parallel.mesh import (current_mesh,
                                                  dc_sweep_sharded,
                                                  tran_sweep_sharded)
    mesh = mesh or current_mesh()
    n = mesh.size
    dff_dir = os.path.join(REPO, "benchmarks", "gf180_dff")
    with open(os.path.join(dff_dir, "dff_tb.cir")) as f:
        nl = T.parse_spice(f.read(), file="dff_tb.cir")
    comp = T.compile_circuit(T.elaborate(nl, include_paths=[dff_dir]),
                             device=mesh.device)
    dc_opts = T.NewtonOptions(gmin_steps=3, src_steps=2, restarts=1)
    vtos = np.linspace(0.75, 0.85, 2 * n)
    res = dc_sweep_sharded(comp, T.Sweep("vto", vtos), mesh, opts=dc_opts)
    ok = res.converged.cpu().numpy()
    assert ok.shape == (len(vtos),), ok.shape
    assert ok.all(), f"sharded sweep failed to converge: {ok}"

    tres = tran_sweep_sharded(
        comp, T.Sweep("vto", vtos[:n]), (0.0, 2e-9), mesh,
        opts=T.TranOptions(max_steps=256, chunk_size=32), dc_opts=dc_opts)
    assert tres.finished.all(), f"sharded transient failed: {tres.finished}"

    ckt = T.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(T.VSourcePULSE, "V1", (vin, ckt.gnd),
            dict(v1=0.0, v2=2.0, td=1e-6, tr=1e-9, tf=1e-9, pw=8e-6,
                 per=20e-6))
    ckt.add(T.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(T.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    rc = T.compile_circuit(ckt, dynamic_params=["r"], device=mesh.device)
    rs = np.linspace(500.0, 2200.0, 2 * n)
    worst, spread = rc_gate(rc, rs, mesh)
    return (f"dryrun_multichip({n}): {len(vtos)} DFF operating points "
            f"converged and {len(tres.finished)} sharded transients finished "
            f"({int(tres.n_accepted.sum())} steps) on {n} {mesh.backend} "
            f"ranks ({mesh.device.type}); closed-form RC gate over "
            f"{len(rs)} distinct-tau lanes: worst lane error {worst:.2e} V "
            f"(bound 5e-3), lane spread {spread:.3f} V")


def rc_gate(rc, rs, mesh, **kw):
    """The RC charge swept over ``R1.r`` = ``rs`` on ``mesh`` (``kw`` to
    ``tran_sweep_sharded``): (worst lane error, lane spread) at 3 µs,
    asserted below 5e-3 V and above 0.05 V."""
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.parallel.mesh import tran_sweep_sharded
    rres = tran_sweep_sharded(rc, T.Sweep("R1.r", rs), (0.0, 6e-6), mesh,
                              **kw)
    assert rres.finished.all(), "RC gate lanes unfinished"
    iv = rc.node_names.index("vout")
    t_probe = 3e-6
    got = np.asarray([np.interp(t_probe, rres.ts[k], rres.xs[k, :, iv])
                      for k in range(len(rs))])
    want = 2.0 * (1 - np.exp(-(t_probe - 1e-6 - 0.5e-9)
                             / (np.asarray(rs) * 1e-9)))
    worst = float(np.abs(got - want).max())
    spread = float(abs(got[0] - got[-1]))
    assert worst < 5e-3, f"per-lane closed-form error {worst}"
    assert spread > 0.05, "lanes identical: the sweep was not applied"
    return worst, spread


def lv1_cell(cell, tstop, mesh=None):
    """Cell D ("D": the GESP pair) or E ("E": the fused chord kernel) of
    the level-1 DFF, the 256 lanes of ``kernel_times.lv1_lanes``, over
    0-``tstop``, sharded on ``mesh`` (by default a ``RankPool``
    worker's); each lane's operating point is solved from zeros, as
    ``lv1_lanes`` solves it.  Returns (``TranSweepResult``, this rank's
    kernel launches)."""
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    from cedarsim_tpu_torch.ops import fused_chord as fc
    from cedarsim_tpu_torch.ops import gesp_lu
    from cedarsim_tpu_torch.parallel.mesh import (current_mesh,
                                                  tran_sweep_sharded)
    mesh = mesh or current_mesh()
    comp, ctx, pb, _ = kt.lv1_lanes(torch, T, mesh.device, op=False)
    opts = T.TranOptions(**(kt.LV1_FUSED_OPTS if cell == "E"
                            else kt.LV1_XLA_OPTS))
    zeros = torch.zeros(kt.LV1_LANES, comp.n_x, dtype=comp.dtype,
                        device=mesh.device)
    counters = (fc.fused_chord, gesp_lu.lu_factor_gesp_f32,
                gesp_lu.lu_subst_gesp_f32)
    for k in counters:
        k.launches = 0
    res = tran_sweep_sharded(comp, None, (0.0, tstop), mesh, params=pb,
                             ctx=ctx, opts=opts, x0=zeros)
    return res, {k.__name__: k.launches for k in counters}


def main(argv):
    from cedarsim_tpu_torch.parallel.mesh import make_mesh
    n = int(argv[0])
    device = argv[1] if len(argv) > 1 else None
    backend = argv[2] if len(argv) > 2 else None
    mesh = make_mesh(n, device=device, backend=backend)
    line = gates(mesh)
    if mesh.rank == 0:
        print(line)


if __name__ == "__main__":
    main(sys.argv[1:])
