"""Cell G: ``bench.py``'s BSIM-CMG DFF leg through the public ``tran()``;
cells B-f32 and G-f32: ``bench.py``'s accelerator configuration of both
DFF legs, models evaluated in float32.

The CMG leg of the JAX package's benchmark (``bench.py:99-103``):
``benchmarks/gf180_dff/dff_tb_cmg.cir``, 30 BSIM-CMG 107 FinFETs through
``models_cmg.spice`` (85 unknowns), NFIN scaled per lane by
``linspace(0.99, 1.01)`` with the middle lane nominal, each lane from its
own warm DC (``kernel_times.dff_lanes(leg="cmg")``), at 32 lanes (the JAX
package's lane count for this leg on its chip, ``bench.py:100``) over
0-700 ns, gated on ``golden_cmg.json`` as ``bench.py`` gates it
(``kernel_times.gate_golden``: the nominal lane within 0.05 V of every
point inside the window, every lane at 150, 250 and 700 ns).  Two
engines, both with the leg's tolerances:

* ``fused`` (``kernel_times.CMG_FUSED_OPTS``): the cap form,
  ``jac_reuse=1`` and ``newton_impl="fused"``, B1 on the CMG plan (the
  BSIM-CMG walk emitted as CUDA and built by nvcc at first launch); one
  launch per batched step attempt;
* ``xla`` (``kernel_times.CMG_XLA_OPTS``): the chord path with
  ``dense_lu="auto"``, which on a card with a lane axis is the float32
  GESP pair B2/B3 (85 unknowns are within ``gesp_lu.max_n``).

Float32 evaluation (``--eval-dtype float32``): the JAX package's benchmark
builds both legs with ``eval_dtype=float32`` whenever it runs on its chip
(``bench.py:14-19,119-126,181``).  The leg is compiled with
``eval_dtype=torch.float32`` (states, time, step control and solves stay
float64), each lane's warm DC under the float32 Newton defaults
(``bench.py:221-240``), and run on the fused engine with the formulation
left "auto" (the cap form and BDF2 under float32 evaluation): B1's
float32 form, the walk emitted over ``float``, with the rescue's full
Newton on B2/B3.  Cell B-f32 is ``--leg bsim4`` (``dff_tb_bsim4.cir``, W
per lane, 128 lanes, ``golden_bsim4.json``), cell G-f32 the CMG leg.
Every run also reports ``bench.py``'s ``race_lane_agreement``
(``kernel_times.race_lane_agreement``).

    python -m cedarsim_tpu_torch.benchmarks.cmg_dff --engine fused
    python -m cedarsim_tpu_torch.benchmarks.cmg_dff --engine xla \\
        --tstop 6e-8
    python -m cedarsim_tpu_torch.benchmarks.cmg_dff --device cpu \\
        --tstop 2e-9
    python -m cedarsim_tpu_torch.benchmarks.cmg_dff --leg bsim4 \\
        --eval-dtype float32
    python -m cedarsim_tpu_torch.benchmarks.cmg_dff --eval-dtype float32 \\
        --tstop 2.6e-7

prints one JSON line: leg, lanes, n_x, eval dtype, set-up (the leg's
compile, operating point and per-lane warm DC; for ``fused`` also the
plan, emit and nvcc seconds, the library's entry and ptxas's lines), the
``tran`` wall, the counts over all lanes, the kernels' launches in that
call, the gate's worst error (null when no golden point lies inside the
window), the race agreement and, on a card, the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: the legs' window (the goldens' last point is at 700 ns)
TSTOP = 7e-7


def options(engine="fused", leg="cmg", mixed=False):
    """The transient options of ``leg`` on ``engine``: the fused engine's
    (``kernel_times.CMG_FUSED_OPTS``, or cell B's ``FUSED_OPTS`` for
    BSIM4), with the formulation left "auto" under float32 evaluation
    (``mixed``: ``bench.py``'s accelerator set), or cell G-xla's
    (``CMG_XLA_OPTS``)."""
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    if engine == "xla":
        if leg != "cmg" or mixed:
            raise ValueError("the xla engine runs cell G only")
        return dict(kt.CMG_XLA_OPTS)
    opts = dict(kt.CMG_FUSED_OPTS if leg == "cmg" else kt.FUSED_OPTS)
    if mixed:
        del opts["formulation"]
    return opts


def setup(lanes=None, device=None, leg="cmg", eval_dtype=None):
    """The leg's lanes (``kernel_times.dff_lanes``, models evaluated in
    ``eval_dtype``; by default the JAX package's lane count for the leg on
    its chip) and the seconds they took: ((compiled, ctx, per-lane params,
    per-lane initial states), seconds)."""
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    from cedarsim_tpu_torch.config import resolve_device
    t0 = time.perf_counter()
    lanes = kt.LEGS[leg]["tpu_nb"] if lanes is None else lanes
    dff = kt.dff_lanes(torch, T, resolve_device(device), lanes=lanes,
                       leg=leg, eval_dtype=eval_dtype)
    return dff, time.perf_counter() - t0


def run(engine="fused", tstop=TSTOP, device=None, dff=None, dense_lu=None,
        plan=None, leg="cmg"):
    """Run ``leg`` (cell G, or B-f32/G-f32 on lanes compiled for float32
    evaluation) through ``engine`` ("fused" or "xla") over 0-``tstop`` and
    gate it; ``dff``: the lanes from :func:`setup` (the leg's float64 lanes
    made here otherwise), ``dense_lu`` overrides the engine's, ``plan``:
    the fused plan already built.  Every kernel count is set to 0 just
    before the call and read just after.  Returns the result dict (the
    solutions under ``"sols"``)."""
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.analysis.tran import fused_plan_for, resolve_impl
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    from cedarsim_tpu_torch.ops import fused_chord as fc
    from cedarsim_tpu_torch.ops import gesp_lu
    setup_s = 0.0
    if dff is None:
        dff, setup_s = setup(device=device, leg=leg)
    comp, ctx, pb, x0 = dff
    on_card = comp.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()
    opts = options(engine, leg, comp.mixed)
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
            nvcc_s=info["nvcc_seconds"], entry=plan.entry,
            ptxas=[ln.strip() for ln in info["log"].splitlines()
                   if any(w in ln for w in ("registers", "spill",
                                            "stack frame"))],
            smem_bytes=plan.smem_bytes, threads=plan.threads,
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
    gold = kt.golden(T, leg)
    worst = kt.gate_golden(sols, gold, comp.n_x, tstop)
    n = len(sols)
    return dict(
        engine=engine, leg=leg, lanes=n, n_x=comp.n_x,
        device=str(comp.device), eval_dtype=str(comp.eval_dtype),
        dense_lu=impl.dense_lu, newton_impl=impl.newton_impl,
        jac_shunt=impl.jac_shunt, tstop=tstop, setup_s=setup_s,
        **fused, wall_s=wall, transients_per_s=n / wall,
        worst_golden_err=worst, golden_tolerance=gold["tolerance"],
        race_lane_agreement=kt.race_lane_agreement(sols, gold, tstop),
        accepted=sum(s.n_accepted for s in sols),
        rejected=sum(s.n_rejected for s in sols),
        newton=sum(s.n_newton for s in sols), attempts=sols[0].n_attempts,
        launches=launches, card=kt.smi() if on_card else None, sols=sols)


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", default="fused", choices=["fused", "xla"])
    ap.add_argument("--leg", default="cmg", choices=["cmg", "bsim4"])
    ap.add_argument("--eval-dtype", default="float64",
                    choices=["float64", "float32"])
    ap.add_argument("--tstop", type=float, default=TSTOP)
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dff, setup_s = setup(args.lanes, args.device, args.leg,
                         getattr(torch, args.eval_dtype))
    rec = run(args.engine, args.tstop, dff=dff, leg=args.leg)
    rec.update(setup_s=setup_s)
    rec.pop("sols")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
