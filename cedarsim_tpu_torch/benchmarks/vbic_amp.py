"""Cell V: the VBIC common-emitter amplifier through the public ``tran()``.

The reference's bipolar amplifier (``netlists.VBIC_AMP``: a 1 mV 500 Hz
drive into a BC546B-class transistor, here on a VBIC level-4 card with
self-heating, 12 unknowns) at 32 lanes, AREA scaled per lane by
``linspace(0.99, 1.01)`` with the middle lane nominal (the scatter of
every leg, ``kernel_times.dff_lanes``), ``gmin=1e-12`` as the reference
test uses, over its whole window 0-6 ms.  The gate is the reference's own
cross-method check (``tests/test_bipolar_amplifier.py``), on every lane:
the output's amplitude over 4-6 ms within 25 % of |AC gain at 500 Hz| ×
1 mV, the gain from ``ac`` at each lane's operating point.  Two engines:

* ``fused`` (``kernel_times.FUSED_OPTS``): the cap form, ``jac_reuse=1``
  and ``newton_impl="fused"``, B1 on the VBIC plan (the VBIC walk emitted
  as CUDA and built by nvcc at first launch), one launch per batched step
  attempt;
* ``xla`` (``XLA_OPTS``): the chord path with ``dense_lu="auto"``, which
  on a card with a lane axis is the float32 GESP pair B2/B3, and a
  Jacobian-only shunt of 1e-9 on the voltage rows.

    python -m cedarsim_tpu_torch.benchmarks.vbic_amp --engine fused
    python -m cedarsim_tpu_torch.benchmarks.vbic_amp --engine xla
    python -m cedarsim_tpu_torch.benchmarks.vbic_amp --device cpu \\
        --lanes 2 --tstop 2e-4

prints one JSON line: lanes, n_x, set-up (compile, operating points, AC
gains; for ``fused`` on a card also the plan, emit and nvcc seconds), the
``tran`` wall, the counts over all lanes, the kernels' launches in that
call, the gate's worst relative amplitude error (null when the window ends
before 6 ms) and, on a card, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

#: the reference test's window and the lanes of the cell
TSTOP = 6e-3
LANES = 32
#: the drive's amplitude and frequency, the window the amplitude is read
#: over and the gate (the reference test's)
DRIVE_V = 1e-3
DRIVE_HZ = 500.0
AMP_WINDOW = (4e-3, 6e-3)
AMP_RTOL = 0.25
GMIN = 1e-12
#: V-xla: the reference test's transient options (its buffer of 16384
#: rows) on the per-step chord path, with the Jacobian-only shunt of the
#: other chord-path cells (``kernel_times.LV1_XLA_OPTS``): the thermal
#: node's KCL row holds only the switched branch's current (I mode), so
#: its diagonal is 0, and without the shunt the no-pivot float32 factor
#: boosts that pivot to 1e-20 and its solves miss by 1e3-1e4 relative
XLA_OPTS = dict(max_steps=16384, jac_reuse=1, newton_impl="xla",
                dense_lu="auto", jac_shunt=1e-9)


def setup(lanes=LANES, device=None):
    """The amplifier compiled on ``device`` with AREA dynamic, its lanes
    (AREA × ``linspace(0.99, 1.01)``, the middle lane nominal), each
    lane's transient operating point and its |AC gain| at ``DRIVE_HZ``
    from the DC operating point.  Returns ((compiled, ctx, per-lane
    params, per-lane initial states, gains [lanes]), seconds)."""
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.config import resolve_device
    t0 = time.perf_counter()
    dev = resolve_device(device)
    comp = T.compile_circuit(T.elaborate(T.parse_spice(netlists.VBIC_AMP)),
                             device=dev, dynamic_params=("area",))
    ctx = T.SimSpec.make(gmin=GMIN)
    key = [k for k in comp.group_order if "vbic" in k.lower()][0]
    sc = np.linspace(0.99, 1.01, lanes)
    sc[lanes // 2] = 1.0
    pb = {k: {pn: v.expand((lanes,) + tuple(v.shape))
              for pn, v in grp.items()} for k, grp in comp.params0.items()}
    pb[key] = dict(pb[key])
    pb[key]["AREA"] = comp.params0[key]["AREA"][None, :] * torch.as_tensor(
        sc, dtype=comp.dtype, device=dev)[:, None]
    x0 = torch.zeros(lanes, comp.n_x, dtype=comp.dtype, device=dev)
    op = T.solve_dc(comp, pb, ctx, mode="tranop", x0=x0)
    if not bool(op.converged.all()):
        raise AssertionError("amplifier operating points did not converge")
    gains = []
    for lane in range(lanes):
        pl = {k: {pn: v[lane] for pn, v in grp.items()}
              for k, grp in pb.items()}
        r = T.ac(comp, [DRIVE_HZ], params=pl, ctx=ctx)
        gains.append(abs(complex(np.asarray(r["out"])[0])))
    return (comp, ctx, pb, op.x, np.asarray(gains)), \
        time.perf_counter() - t0


def gate(sols, gains, tstop):
    """The reference's check on every lane: finite waveforms, the lane
    finished, and the output's amplitude over ``AMP_WINDOW`` within
    ``AMP_RTOL`` of its |gain| × ``DRIVE_V``.  Raises on a miss; returns
    the worst relative error, or None when the window ends before
    ``AMP_WINDOW``'s end."""
    for lane, sol in enumerate(sols):
        if not (sol.converged and np.isfinite(sol.xs).all()):
            raise AssertionError(f"amplifier lane {lane} did not finish")
    if tstop < AMP_WINDOW[1]:
        return None
    tg = np.linspace(*AMP_WINDOW, 600)
    worst, bad = 0.0, []
    for lane, (sol, g) in enumerate(zip(sols, gains)):
        v = np.interp(tg, sol.ts, sol["out"])
        amp = (v.max() - v.min()) / 2.0
        err = abs(amp - g * DRIVE_V) / (g * DRIVE_V)
        worst = max(worst, err)
        if not err < AMP_RTOL:
            bad.append((lane, amp, g * DRIVE_V))
    if bad:
        raise AssertionError(f"amplitude gate failed (lane, amp, want): "
                             f"{bad}")
    return worst


def run(engine="fused", tstop=TSTOP, device=None, amp=None, dense_lu=None,
        plan=None, lanes=LANES):
    """Run cell V through ``engine`` ("fused" or "xla") over 0-``tstop``
    and gate it; ``amp``: the lanes from :func:`setup` (made here
    otherwise), ``dense_lu`` overrides the engine's, ``plan``: the fused
    plan already built.  Every kernel count is set to 0 just before the
    call and read just after.  Returns the result dict (the solutions
    under ``"sols"``)."""
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.analysis.tran import fused_plan_for, resolve_impl
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    from cedarsim_tpu_torch.ops import fused_chord as fc
    from cedarsim_tpu_torch.ops import gesp_lu
    setup_s = 0.0
    if amp is None:
        amp, setup_s = setup(lanes, device)
    comp, ctx, pb, x0, gains = amp
    on_card = comp.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()
    opts = dict(kt.FUSED_OPTS if engine == "fused" else XLA_OPTS)
    if dense_lu is not None:
        opts["dense_lu"] = dense_lu
    impl = resolve_impl(comp, T.TranOptions(**opts), ctx, pb)
    fused = {}
    if engine == "fused" and on_card:
        t0 = time.perf_counter()
        plan = plan or fused_plan_for(comp, ctx, pb)
        plan_s = time.perf_counter() - t0
        info = plan.build()
        fused = dict(
            plan_s=plan_s, emit_s=info["emit_seconds"],
            nvcc_s=info["nvcc_seconds"],
            nodes={key: {"hoisted": e.n_pre, "walk": e.n_walk,
                         "hoisted_values": e.n_hoist, "bytes": len(e.text)}
                   for key, e in plan.emitted})
    counters = (fc.fused_chord, gesp_lu.lu_factor_gesp_f32,
                gesp_lu.lu_subst_gesp_f32)
    for f in counters:
        f.launches = 0
    sync()
    t0 = time.perf_counter()
    sols = T.tran(comp, (0.0, tstop), params=pb, ctx=ctx, x0=x0,
                  opts=T.TranOptions(**opts))
    sync()
    wall = time.perf_counter() - t0
    launches = dict(zip(("fused", "factor", "subst"),
                        (f.launches for f in counters)))
    worst = gate(sols, gains, tstop)
    n = len(sols)
    return dict(
        engine=engine, lanes=n, n_x=comp.n_x, device=str(comp.device),
        dense_lu=impl.dense_lu, newton_impl=impl.newton_impl, tstop=tstop,
        setup_s=setup_s, **fused, wall_s=wall, transients_per_s=n / wall,
        gain_nominal=float(gains[n // 2]), worst_amp_rel_err=worst,
        accepted=sum(s.n_accepted for s in sols),
        rejected=sum(s.n_rejected for s in sols),
        newton=sum(s.n_newton for s in sols), attempts=sols[0].n_attempts,
        launches=launches, card=kt.smi() if on_card else None, sols=sols)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", default="fused", choices=["fused", "xla"])
    ap.add_argument("--tstop", type=float, default=TSTOP)
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rec = run(args.engine, args.tstop, args.device, lanes=args.lanes)
    rec.pop("sols")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
