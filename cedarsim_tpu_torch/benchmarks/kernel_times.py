"""Device time and call time per launch of every CUDA kernel of the port,
at the shapes of its path.

    python -m cedarsim_tpu_torch.benchmarks.kernel_times [--out FILE]
    python cedarsim_tpu_torch/benchmarks/kernel_times.py --tree DIR
    python -m cedarsim_tpu_torch.benchmarks.kernel_times --factor
    python -m cedarsim_tpu_torch.benchmarks.kernel_times --b1

Two times per kernel, both from CUDA events on the card:

* ``device_ms``: 100 wrapper calls captured in one CUDA graph (the wrappers
  launch on the current stream, which is the capturing one, and the graph's
  pool takes their outputs), the graph replayed between two events, divided
  by the calls.  Nothing of the host runs between the launches, so this is
  the card's time per launch.
* ``call_ms``: a Python loop of wrapper calls between two events, divided
  by the calls, the least of five such loops (the host's clock is shared
  with other work): the host's checks, allocation and ctypes call
  included, as the solvers call the wrapper.

The shapes: B1 (``fused_chord``) on the gf180 DFF at 8 lanes and B1' at one
lane (the nominal one), both on the smoke's phase-6 inputs (the per-lane
warm DC, nodes perturbed by a seeded 0.05 V, a BE start at h = 1e-12); B1
on the level-1 DFF's plan (``Mos1`` emitted, ``lv1_lanes``) at 256 lanes
and at 8, on the same kind of inputs from the per-lane operating points of
its vto scatter (``--lv1`` times only these two); B2
and B3 at [8, 25, 25] on seeded dominant systems; B4 and B5 at the
dense-LU bench's [512, 25] and [64, 122], beside ``torch.linalg.solve_ex``
in float32 on the same systems (the same x within the bench's gates), and
over an n-sweep at the bench's batch sizes (``SWEEP``: n in {8, 16, 25, 32}
at B = 512, {33, 64, 96, 122, 240} at B = 64), each also per elimination
step (device µs / n); B2 over its own n-sweep at the transient's lane count
(``FACTOR_SWEEP``: n in {8, 16, 25, 32, 33, 64, 122, 240} at B = 8) on
seeded dominant systems, with B4 on the same systems beside it (B4's
elimination is B2's plus b), each also per elimination step.
``solve_ex`` cannot be captured in a CUDA graph, so its device time is the
sum of its CUDA kernels' times per call in a ``torch.profiler`` trace of 50
calls (``profiler_device_ms``).

``--tree DIR`` imports ``cedarsim_tpu_torch`` from another checkout (for
instance the parent commit unpacked with ``git archive``), so that two
designs are timed by the same code on one card; its kernels build into that
checkout's own ``build/``.  ``--dump FILE`` saves each kernel's outputs on
these inputs (numpy ``.npz``); ``--compare FILE`` reports, per kernel,
whether its outputs are bitwise equal to those saved there and their
largest difference relative to the saved outputs' largest magnitude.
``--dense`` times B4 and B5 alone (bench shapes and sweep), ``--factor``
B2's sweep alone (with B4 beside it), ``--lv1`` B1 on the level-1 plan
alone, ``--b1`` B1 on cell B's plan (8 lanes) and on cell G's CMG plan
(32 lanes) alone, with each library's registers, stack and spills.
``--sass`` adds, for each kernel of
the GESP and pivoting libraries, the count of its floating-point SASS
instructions by opcode (``cuobjdump -sass``): whether an update compiled
to a fused multiply-add (``FFMA``) or to a product and a sum.
``--fused-sass FILE`` only builds cell B's fused plan (float64, 8 lanes)
and writes its library's machine code (``cuobjdump -sass``) to FILE,
with the sha256 of the library and of that text in the JSON: run it once
with ``--tree`` on the parent and once without to see whether a change
to ``csrc/fused_chord.cu`` left the float64 kernel's code as it was.  One JSON
object is printed, with the card's name and power limit; ``--out`` also
writes it to a file.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

#: wrapper calls captured in one graph, and the graph's timed replays
GRAPH_CALLS = 100
GRAPH_REPLAYS = 10
#: timed loops of ``call_ms``, of which the least is taken
CALL_ROUNDS = 5
#: calls of a library function traced by ``profiler_device_ms``
PROFILED_CALLS = 50
#: (B, n) of the dense solves' n-sweep: the bench's two batch sizes, n on
#: both sides of the one-warp regime's edge (32) and up to the largest n a
#: block's shared memory holds (240)
SWEEP = ((512, 8), (512, 16), (512, 25), (512, 32), (64, 33), (64, 64),
         (64, 96), (64, 122), (64, 240))
#: lanes of the DFF transient and the per-lane W scatter (bench.py:217-225)
N_LANES = 8
#: (B, n) of the GESP factor's n-sweep (B2): the transient's lane count, n
#: on both sides of the one-warp regime's edge and up to 240
FACTOR_SWEEP = tuple((N_LANES, n) for n in (8, 16, 25, 32, 33, 64, 122,
                                              240))
#: cell A, the mixed chord path of chip_smoke.py's phase 5: the charge-form
#: trap of bench.py::dff_batched_leg's CPU reference mode; the GESP factor
#: has no pivoting, so a Jacobian-only shunt on the voltage rows keeps the
#: node-first MNA pivots away from exact cancellation (PERF.md)
XLA_OPTS = dict(max_steps=8192, jac_reuse=1, dense_lu="mixed",
                newton_impl="xla", accept_slack=1.5, jac_shunt=1e-9)
#: ``bench.py``'s two DFF legs (``bench.py:93-103``; a copy, since the port
#: does not import ``bench.py``): testbench, golden, the group and the
#: parameter scattered per lane, the leg's tolerances and the JAX
#: package's lane count for it on its chip
LEGS = {
    "bsim4": dict(tb="dff_tb_bsim4.cir", golden="golden_bsim4.json",
                  group="bsim4", param="W", tpu_nb=128,
                  tpu_opts=dict(newton_reltol=1e-4, newton_abstol=5e-7,
                                res_tol=1e-3, jac_shunt=1e-7, res_rel=3e-5,
                                rtol=1e-2, atol=1e-4)),
    "cmg": dict(tb="dff_tb_cmg.cir", golden="golden_cmg.json",
                group="bsimcmg", param="NFIN", tpu_nb=32,
                tpu_opts=dict(newton_reltol=3e-4, newton_abstol=2e-6,
                              res_tol=3e-3, jac_shunt=1e-7, res_rel=1e-4,
                              rtol=2e-2, atol=3e-4)),
}
#: cell G, the CMG leg at the JAX package's lane count on its chip
#: (``bench.py:100``): G-fused, B1 on the CMG plan (cell B's configuration
#: with the leg's tolerances), and G-xla, the chord path through
#: ``dense_lu="auto"`` (the GESP kernels B2/B3 on a card).  G-xla's
#: Jacobian-only shunt is 1e-4, not the leg's 1e-7: at 1e-7 the no-pivot
#: float32 factor loses an internal node's pivot of the CMG Jacobian at
#: h = 1e-12 (the mixed chord solve's error passes 1e6 relative,
#: ``tests/test_torch_cmg_dff.py``), and the chord loop stalls (ROADMAP
#: Queue C)
CMG_LANES = LEGS["cmg"]["tpu_nb"]
CMG_FUSED_OPTS = dict(max_steps=8192, jac_reuse=1, formulation="cap",
                      newton_impl="fused", dense_lu="mixed",
                      **LEGS["cmg"]["tpu_opts"])
CMG_XLA_OPTS = dict(max_steps=8192, jac_reuse=1, newton_impl="xla",
                    dense_lu="auto",
                    **dict(LEGS["cmg"]["tpu_opts"], jac_shunt=1e-4))
#: cell B, the fused engine's options of chip_smoke.py's phase 7 (the JAX
#: package's fused configuration, bench.py:96-98, accept_slack 1.0)
FUSED_OPTS = dict(max_steps=8192, jac_reuse=1, formulation="cap",
                  newton_impl="fused", dense_lu="mixed",
                  **LEGS["bsim4"]["tpu_opts"])


#: the level-1 DFF leg (bench.py:541-617): the JAX package's lane count on
#: its chip, and the per-lane vto scatter ``linspace(0.99, 1.01)``
LV1_LANES = 256
#: cell D, the mixed chord path on the level-1 DFF: cell A's chord
#: configuration (charge-form trap, ``jac_reuse=1``) with the leg's
#: ``max_steps``; the no-pivot float32 factor needs the Jacobian-only shunt
#: here too (without it the 2-lane CPU run over 0-150 ns takes 429
#: rejected steps for the exact solve's 68, PERF.md)
LV1_XLA_OPTS = dict(max_steps=16384, jac_reuse=1, dense_lu="mixed",
                    newton_impl="xla", jac_shunt=1e-9)
#: cell E, the fused configuration (cell B's options) on the level-1 DFF
LV1_FUSED_OPTS = dict(FUSED_OPTS, max_steps=16384)


def call_ms(fn, reps, rounds=CALL_ROUNDS):
    """ms per call of a Python loop of ``reps`` calls of ``fn`` between two
    CUDA events, after three warm-up calls: the least of ``rounds``
    loops."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(rounds):
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / reps)
    return best


def device_ms(fn, calls=GRAPH_CALLS, replays=GRAPH_REPLAYS):
    """ms per launch on the card: ``calls`` calls of ``fn`` captured in one
    CUDA graph after three warm-up calls (the build, the shared-memory
    opt-in and any plan are done by then), replayed ``replays`` times
    between two events.  The capture is thread-local, so a build thread
    loading a library beside it does not break it."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (calls * replays)


def profiler_device_ms(fn, calls=PROFILED_CALLS):
    """ms of device time per call of ``fn``, for a function that a CUDA
    graph cannot capture: the durations of the CUDA kernels and copies in a
    ``torch.profiler`` trace of ``calls`` calls (after three warm-up
    calls), summed and divided by the calls.  Raises if the trace holds no
    device activity (the profiler cannot see the card)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us * 1e-3 / calls


def library_times(fn, reps):
    """A PyTorch library call timed as a yardstick (the port never calls
    it): ``call_ms``; ``device_ms`` by CUDA-graph replay where the call can
    be captured, else by ``profiler_device_ms``; and how the device time
    was taken ("graph", "profiler", or the reason it was not)."""
    import torch
    out = dict(call_ms=call_ms(fn, reps), device_ms=None)
    try:
        out.update(device_ms=device_ms(fn), device_by="graph")
    except (RuntimeError, NotImplementedError) as e:
        torch.cuda.synchronize()
        graph_error = str(e).splitlines()[0][:200]
        try:
            out.update(device_ms=profiler_device_ms(fn),
                       device_by="profiler", graph_error=graph_error)
        except (RuntimeError, NotImplementedError) as e2:
            out.update(device_by=f"not measured: {graph_error}; "
                       f"{str(e2).splitlines()[0][:200]}")
    return out


def dominant_systems(rng, B, n):
    """Random, row-equilibrated, diagonally dominant systems (float64 A
    [B, n, n] and b [B, n])."""
    A = rng.standard_normal((B, n, n))
    A += (n + 8) * np.eye(n)
    A /= np.abs(A).max(-1, keepdims=True)
    b = rng.standard_normal((B, n))
    return A, b


def dff_lanes(torch, T, dev, lanes=N_LANES, leg="bsim4", eval_dtype=None):
    """A DFF leg's testbench (``LEGS[leg]``) compiled on ``dev`` (models
    evaluated in ``eval_dtype``, by default float64), its transient
    operating point and the per-lane warm DC of the leg's scatter (its
    parameter times ``linspace(0.99, 1.01)``, the middle lane nominal;
    ``default_newton_options``, the float32 set under float32 evaluation,
    as ``bench.py:221-240``).  Returns (compiled, ctx, per-lane params,
    per-lane initial states)."""
    from cedarsim_tpu_torch.analysis.dc import dc_from_nominal
    cfg = LEGS[leg]
    dff_dir = os.path.join(_repo(T), "benchmarks", "gf180_dff")
    with open(os.path.join(dff_dir, cfg["tb"])) as f:
        nl = T.parse_spice(f.read(), file=cfg["tb"])
    comp = T.compile_circuit(T.elaborate(nl, include_paths=[dff_dir]),
                             device=dev, eval_dtype=eval_dtype)
    ctx = T.SimSpec.make(gmin=1e-15)
    op = T.solve_dc(comp, ctx=ctx, mode="tranop")
    if not bool(op.converged):
        raise AssertionError(f"DFF ({leg}) operating point did not converge")
    key = [k for k in comp.group_order if cfg["group"] in k.lower()][0]
    sc = np.linspace(0.99, 1.01, lanes)
    sc[lanes // 2] = 1.0
    scatter = torch.as_tensor(sc, dtype=comp.dtype, device=dev)
    pb = {k: {pn: v.expand((lanes,) + tuple(v.shape))
              for pn, v in grp.items()} for k, grp in comp.params0.items()}
    pb[key] = dict(pb[key])
    pn = cfg["param"]
    pb[key][pn] = comp.params0[key][pn][None, :] * scatter[:, None]
    warm = dc_from_nominal(comp, pb, ctx.with_mode("tranop"), op.x,
                           T.default_newton_options(comp))
    if not bool(warm.converged.all()):
        raise AssertionError("per-lane warm DC did not converge")
    return comp, ctx, pb, warm.x


def golden(T, leg="bsim4"):
    """The leg's golden (``benchmarks/gf180_dff/golden_*.json``)."""
    with open(os.path.join(_repo(T), "benchmarks", "gf180_dff",
                           LEGS[leg]["golden"])) as f:
        return json.load(f)


#: the DFF legs' golden tolerance (bench.py GOLDEN_TOL)
GOLDEN_TOL = 0.05
#: the golden points inside the 401 ns race (450 and 550 ns)
RACE_IDX = (2, 3)


def gate_golden(sols, gold, n_x, tstop=float("inf")):
    """``bench.py``'s gate on the lanes of a DFF leg, at the golden points
    up to ``tstop``: every lane finished with finite waveforms of ``n_x``
    unknowns, the nominal (middle) lane within ``GOLDEN_TOL`` of every
    point, every lane at the points outside the 401 ns race (the third and
    fourth).  Raises on a miss; returns the worst error, or None when no
    golden point lies inside the window."""
    worst, errs = None, []
    nominal = len(sols) // 2
    for lane, sol in enumerate(sols):
        if not sol.converged:
            raise AssertionError(f"lane {lane} did not finish")
        if not (np.isfinite(sol.xs).all() and sol.xs.shape[1] == n_x):
            raise AssertionError(f"lane {lane}: bad waveform")
        for j, (t_ns, g) in enumerate(zip(gold["samples_ns"], gold["q"])):
            if t_ns * 1e-9 > tstop:
                continue
            if j in RACE_IDX and lane != nominal:
                continue        # the race points gate only the nominal lane
            err = abs(float(sol.interp("q", t_ns * 1e-9)) - g)
            worst = err if worst is None else max(worst, err)
            if err > GOLDEN_TOL:
                errs.append((lane, t_ns, err))
    if errs:
        raise AssertionError(f"golden gate failed (lane, ns, err): {errs}")
    return worst


def race_lane_agreement(sols, gold, tstop):
    """``bench.py``'s share of the scattered lanes within ``GOLDEN_TOL``
    of the golden at the race points inside the window (None when none
    is)."""
    idx = [j for j in RACE_IDX if gold["samples_ns"][j] * 1e-9 <= tstop]
    if not idx:
        return None
    agree, n = 0, 0
    for lane, sol in enumerate(sols):
        if lane == len(sols) // 2:
            continue
        for j in idx:
            q = float(sol.interp("q", gold["samples_ns"][j] * 1e-9))
            agree += abs(q - gold["q"][j]) <= GOLDEN_TOL
            n += 1
    return agree / max(n, 1)


def lv1_lanes(torch, T, dev, lanes=LV1_LANES, op=True):
    """The level-1 DFF testbench (``dff_tb.cir``, ``models_lv1.spice``)
    compiled on ``dev`` with ``vto`` dynamic, its lanes' vto scaled by
    ``linspace(0.99, 1.01)``, and each lane's transient operating point
    (solved from zeros; None without ``op``).  Returns (compiled, ctx,
    per-lane params, per-lane initial states)."""
    dff_dir = os.path.join(_repo(T), "benchmarks", "gf180_dff")
    with open(os.path.join(dff_dir, "dff_tb.cir")) as f:
        nl = T.parse_spice(f.read(), file="dff_tb.cir")
    comp = T.compile_circuit(T.elaborate(nl, include_paths=[dff_dir]),
                             device=dev, dynamic_params=("vto",))
    ctx = T.SimSpec.make(gmin=1e-15)
    sc = torch.linspace(0.99, 1.01, lanes, dtype=comp.dtype, device=dev)
    pb = {k: {pn: v.expand((lanes,) + tuple(v.shape))
              for pn, v in grp.items()} for k, grp in comp.params0.items()}
    pb["Mos1"] = dict(pb["Mos1"])
    pb["Mos1"]["vto"] = comp.params0["Mos1"]["vto"][None, :] * sc[:, None]
    if not op:
        return comp, ctx, pb, None
    op = T.solve_dc(comp, pb, ctx, mode="tranop",
                    x0=torch.zeros(lanes, comp.n_x, dtype=comp.dtype,
                                   device=dev))
    if not bool(op.converged.all()):
        raise AssertionError("level-1 DFF operating points did not converge")
    return comp, ctx, pb, op.x


def _repo(T):
    return os.path.dirname(os.path.dirname(os.path.abspath(T.__file__)))


#: the leading coefficient a0 = 1 + 1/2 + … + 1/k of a uniform-step BDF
#: corrector of order k (cells E-bdf3 and E-bdf5)
BDF_A0 = {k: sum(1.0 / j for j in range(1, k + 1)) for k in (3, 5)}


#: B1's float32 form against its float32 plain version after the same
#: number of chord iterations: float32 ulps of each output's largest entry
#: (the kernel's expf/logf/powf and PyTorch's float32 kernels part in
#: their last bits, and the CMG DFF's chord, cond(J/r) ~2e10, carries that
#: to 31 ulps of xn: 3.72e-6 relative at [32, 85], h = 1e-11, in PR 18's
#: smoke)
F32_ULPS = 64
#: Newton tolerances no update or residual meets (each test asks for
#: |dx| or |f| <= -1): every chord runs to ``max_newton``
NO_CONVERGENCE = dict(newton_reltol=0.0, newton_abstol=-1.0, res_rel=0.0,
                      res_tol=-1.0)


def check_fused_f32(torch, fc, plan, args, opts):
    """B1's float32 form against its float32 plain version on ``args``:
    two launches bitwise equal, every lane's chord converged in both under
    ``opts`` (each certified by its own residual and update tests); then
    both again with ``max_newton`` k, the largest count either took, and
    tolerances no iterate meets (``NO_CONVERGENCE``), so that every lane
    of both takes exactly k iterations: xn, S and Q of every lane within
    ``F32_ULPS`` float32 ulps of their largest entries (S of its scale at
    the predictor, the currents it is summed from).  A wrong walk, ic term
    or residual moves the iterates, so it shows at k whatever the
    convergence tests said; last-bit differences of the float32 walks move
    a lane's converged count (an ill-conditioned chord's, the CMG DFF's,
    by several iterations), so the converged points are not compared.
    Raises on a miss; returns (the relative errors at k, k, the lanes held,
    the lanes whose converged counts differ and the largest difference,
    xn's largest error at k), and the kernel's converged outputs."""
    import dataclasses
    k1 = fc.fused_chord(plan, *args, opts)
    k2 = fc.fused_chord(plan, *args, opts)
    p = fc.fused_chord_plain(plan, *args, opts)
    s_scale = float(fc.fused_chord_plain(
        plan, *args, dataclasses.replace(opts, max_newton=0))[1]
        .abs().max())
    torch.cuda.synchronize()
    if not all(torch.equal(u, w) for u, w in zip(k1, k2)):
        raise AssertionError("two launches of the float32 form differ")
    if not (bool(k1[3][:, 0].all()) and bool(p[3][:, 0].all())):
        raise AssertionError(f"a chord failed: kernel {k1[3].tolist()}, "
                             f"plain {p[3].tolist()}")
    k = int(torch.maximum(k1[3][:, 1], p[3][:, 1]).max())
    fixed = dataclasses.replace(opts, max_newton=k, **NO_CONVERGENCE)
    kk = fc.fused_chord(plan, *args, fixed)
    pk = fc.fused_chord_plain(plan, *args, fixed)
    torch.cuda.synchronize()
    if not (bool((kk[3][:, 1] == k).all()) and bool((pk[3][:, 1] == k)
                                                   .all())):
        raise AssertionError(f"not every lane took {k} iterations: kernel "
                             f"{kk[3][:, 1].tolist()}, plain "
                             f"{pk[3][:, 1].tolist()}")
    rtol = F32_ULPS * float(torch.finfo(torch.float32).eps)
    rel = {}
    for name, u, w in zip(("xn", "S", "Q"), kk[:3], pk[:3]):
        scale = float(w.abs().max())
        if name == "S":
            scale = max(scale, s_scale)
        rel[name] = float((u - w).abs().max()) / max(scale, 1e-300)
        if not rel[name] <= rtol:
            raise AssertionError(f"{name} after {k} iterations: relative "
                                 f"error {rel[name]:.3g} > {rtol:.3g}")
    differ = k1[3][:, 1] != p[3][:, 1]
    return dict(
        rel=rel, rtol=rtol, fixed_count=k, lanes_held=int(kk[0].shape[0]),
        lanes_other_count=int(differ.sum()),
        max_count_diff=int((k1[3][:, 1] - p[3][:, 1]).abs().max()),
        xn_abs=float((kk[0] - pk[0]).abs().max())), k1


def fused_args(torch, T, plan, dff, h, lanes=None, opts=None, order=1,
               pert=0.05):
    """The fused kernel's inputs on the DFF's lanes (all, or the slice
    ``lanes``): a step ``h`` from the warm state, the node unknowns
    perturbed by a seeded ``pert`` V (0.05) so that the chord loop
    iterates; a BE
    start (J = C/h + G + the Jacobian shunt at the predictor), or with
    ``order`` k a uniform-step BDFk step whose history sits at the warm
    state (c0 = a0 = ``BDF_A0[k]``, the history combination −a0·x0,
    J = a0·C/h + G + the shunt); ``opts``: the transient's options
    (default ``FUSED_OPTS``)."""
    comp, ctx, pb, x0 = dff
    dev = x0.device
    opts = T.TranOptions(**(FUSED_OPTS if opts is None else opts))
    ctx_t = ctx.with_mode("tran")
    L, n = x0.shape
    dx = np.zeros((L, n))
    dx[:, :comp.n_nodes] = np.random.default_rng(0).uniform(
        -pert, pert, (L, comp.n_nodes))
    x_pred = x0 + torch.as_tensor(dx, dtype=comp.dtype, device=dev)
    if lanes is not None:
        pb = {k: {pn: v[lanes] for pn, v in g.items()} for k, g in pb.items()}
        x0, x_pred = x0[lanes], x_pred[lanes]
        L = x0.shape[0]
    nv = comp.n_nodes + comp.n_internal
    shunt = opts.jac_shunt * torch.diag(
        (torch.arange(n, device=dev) < nv).to(comp.dtype))
    t = torch.full((L,), h, dtype=comp.dtype, device=dev)
    _, _, G, C = comp.res_jacs_fwd(x_pred, ctx_t.at_time(t), pb)
    if order == 1:
        J, c0, xdh = C / h + G + shunt, 1.0, -x0
    else:
        c0 = BDF_A0[order]
        J, xdh = c0 * C / h + G + shunt, -c0 * x0
    return plan.inputs(x_pred, J, plan.s_off(t, ctx_t, pb),
                       torch.full((L,), c0, dtype=comp.dtype, device=dev),
                       torch.full_like(t, h), xdh, t, pb), opts


def measure(torch, T, dev, which="all"):
    """({kernel: {shape, device_ms, call_ms}} for B1, B1', B2-B5 at their
    paths' shapes, B1 on the level-1 plan, B2 (and B4 beside it) over
    ``FACTOR_SWEEP``, B4 and B5 over ``SWEEP`` and ``solve_ex`` at the
    bench's shapes; nvcc's register and spill lines per library; each
    kernel's outputs).  ``which``: "all", "dense" (B4 and B5 alone),
    "factor" (B2's sweep alone), "lv1" (B1 on the level-1 plan alone) or
    "b1" (B1 on cell B's plan at 8 lanes and on cell G's CMG plan at
    ``CMG_LANES``, each at h = 1e-12 with its leg's fused options, and
    their libraries' ptxas lines)."""
    from cedarsim_tpu_torch.benchmarks import lu_bench
    from cedarsim_tpu_torch.ops import gesp_lu, pivot_lu
    out, results = {}, {}

    def put(name, shape, fn, reps, **extra):
        res = fn()
        results[name] = [t.cpu().numpy() for t in
                         (res if isinstance(res, tuple) else (res,))]
        out[name] = dict(shape=list(shape), device_ms=device_ms(fn),
                         call_ms=call_ms(fn, reps), **extra)

    logs = {"gesp_lu": gesp_lu.build()["log"],
            "pivot_lu": pivot_lu.build()["log"]}
    if which in ("all", "factor"):
        for B, nf in FACTOR_SWEEP:
            A, b = dominant_systems(np.random.default_rng(nf), B, nf)
            A32 = torch.as_tensor(A, dtype=torch.float32, device=dev)
            b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
            for key, fn in (
                    ("B2 gesp_factor_f32",
                     lambda: gesp_lu.lu_factor_gesp_f32(A32)),
                    ("B4 gesp_solve_f32",
                     lambda: gesp_lu.lu_solve_gesp_f32(A32, b32))):
                name = f"{key} {B}x{nf}"
                put(name, (B, nf), fn, 50)
                out[name]["device_us_per_step"] = \
                    out[name]["device_ms"] * 1e3 / nf
    if which in ("all", "lv1"):
        from cedarsim_tpu_torch.analysis.tran import fused_plan_for
        from cedarsim_tpu_torch.ops import fused_chord as fc
        lv1 = lv1_lanes(torch, T, dev)
        plan = fused_plan_for(*lv1[:3])
        logs["fused_chord_lv1"] = plan.build()["log"]
        for B in (LV1_LANES, N_LANES):
            args, opts = fused_args(torch, T, plan, lv1, 1e-12,
                                    lanes=slice(0, B))
            put(f"B1 fused_chord_f64 lv1 {B}x{lv1[0].n_x}",
                (B, lv1[0].n_x),
                lambda a=args, o=opts: fc.fused_chord(plan, *a, o), 50)
    if which == "b1":
        from cedarsim_tpu_torch.analysis.tran import fused_plan_for
        from cedarsim_tpu_torch.ops import fused_chord as fc
        for leg, lanes, opts_leg in (("bsim4", N_LANES, FUSED_OPTS),
                                     ("cmg", CMG_LANES, CMG_FUSED_OPTS)):
            dff = dff_lanes(torch, T, dev, lanes=lanes, leg=leg)
            plan = fused_plan_for(*dff[:3])
            logs[f"fused_chord {leg}"] = plan.build()["log"]
            args, opts = fused_args(torch, T, plan, dff, 1e-12,
                                    opts=opts_leg)
            put(f"B1 fused_chord_f64 {leg}", (lanes, dff[0].n_x),
                lambda a=args, o=opts, p=plan: fc.fused_chord(p, *a, o),
                50 if leg == "bsim4" else 20)
    if which == "all":
        from cedarsim_tpu_torch.analysis.tran import fused_plan_for
        from cedarsim_tpu_torch.ops import fused_chord as fc
        dff = dff_lanes(torch, T, dev)
        plan = fused_plan_for(*dff[:3])
        logs["fused_chord"] = plan.build()["log"]
        n = dff[0].n_x
        args, opts = fused_args(torch, T, plan, dff, 1e-12)
        put("B1 fused_chord_f64", (N_LANES, n),
            lambda: fc.fused_chord(plan, *args, opts), 50)
        one = slice(N_LANES // 2, N_LANES // 2 + 1)
        args1, _ = fused_args(torch, T, plan, dff, 1e-12, lanes=one)
        put("B1' fused_chord_f64", (1, n),
            lambda: fc.fused_chord(plan, *args1, opts), 50)
        A, b = dominant_systems(np.random.default_rng(1), N_LANES, 25)
        A32 = torch.as_tensor(A, dtype=torch.float32, device=dev)
        b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
        LU = gesp_lu.lu_factor_gesp_f32(A32)
        put("B2 gesp_factor_f32", A32.shape,
            lambda: gesp_lu.lu_factor_gesp_f32(A32), 200)
        put("B3 gesp_subst_f32", A32.shape,
            lambda: gesp_lu.lu_subst_gesp_f32(LU, b32), 200)
    library = {}
    dense = () if which in ("factor", "lv1", "b1") else \
        lu_bench.SHAPES + tuple(
        s for s in SWEEP if s not in lu_bench.SHAPES)
    for B, nb in dense:
        A, b = lu_bench.make_systems(B, nb)
        A32 = torch.as_tensor(A, dtype=torch.float32, device=dev)
        b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
        bench = (B, nb) in lu_bench.SHAPES
        reps = 200 if bench else 50
        for key, fn in (("B4 gesp_solve_f32", gesp_lu.lu_solve_gesp_f32),
                        ("B5 pivot_solve_f32", pivot_lu.lu_solve_pivot_f32)):
            name = f"{key} {B}x{nb}"
            put(name, (B, nb), lambda fn=fn: fn(A32, b32), reps)
            out[name]["device_us_per_step"] = \
                out[name]["device_ms"] * 1e3 / nb
        if bench:
            library[f"solve_ex_f32 {B}x{nb}"] = dict(
                shape=[B, nb], **library_times(
                    lambda: torch.linalg.solve_ex(A32, b32), reps))
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if any(w in ln for w in ("Function properties",
                                          "registers", "spill"))]
             for k, v in logs.items()}
    return out, library, ptxas, results


#: the SASS opcodes ``sass_counts`` reports
SASS_OPS = ("FFMA", "FMUL", "FADD", "MUFU.RCP", "SHFL", "BAR")


def _sass(path):
    """``cuobjdump -sass`` of a built library."""
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def fused_sass(torch, T, dev, out):
    """Cell B's fused plan (float64; the header does not depend on the
    lanes' W) built, its library's SASS written to ``out``; returns the
    library's path, its sha256 and the SASS text's.  Only the package's
    entry points are called, so ``--tree`` may name an older checkout."""
    import hashlib
    from cedarsim_tpu_torch.analysis.tran import fused_plan_for
    cfg = LEGS["bsim4"]
    dff_dir = os.path.join(_repo(T), "benchmarks", "gf180_dff")
    with open(os.path.join(dff_dir, cfg["tb"])) as f:
        nl = T.parse_spice(f.read(), file=cfg["tb"])
    comp = T.compile_circuit(T.elaborate(nl, include_paths=[dff_dir]),
                             device=dev)
    plan = fused_plan_for(comp, T.SimSpec.make(gmin=1e-15), comp.params0)
    path = plan.build()["path"]
    text = _sass(path)
    with open(out, "w") as f:
        f.write(text)
    with open(path, "rb") as f:
        lib = hashlib.sha256(f.read()).hexdigest()
    return dict(library=path, library_sha256=lib,
                sass_sha256=hashlib.sha256(text.encode()).hexdigest(),
                sass_lines=text.count("\n"))


def sass_counts(path):
    """{kernel (mangled name): {opcode: count}} of a built library's
    machine code, from ``cuobjdump -sass`` (opcodes in ``SASS_OPS``; a
    prefix match, so FADD counts FADD.FTZ too)."""
    import re
    text = _sass(path)
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            op = m.group(1)
            for key in SASS_OPS:
                if op == key or op.startswith(key + "."):
                    out[name][key] += 1
    return out


def _rel_diff(a, ref):
    """Largest |a - ref| over the finite entries of ``ref``, relative to
    its largest finite magnitude (inf where the shapes differ)."""
    if a.shape != ref.shape:
        return float("inf")
    a, ref = a.astype(np.float64), ref.astype(np.float64)
    fin = np.isfinite(ref)
    if not fin.any():
        return 0.0
    return float(np.abs(a - ref)[fin].max()
                 / max(np.abs(ref[fin]).max(), 1e-300))


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="import cedarsim_tpu_torch from this "
                    "checkout instead of the one this file is in")
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--dump", help="save the kernels' outputs here (.npz)")
    ap.add_argument("--compare", help="report which kernels' outputs are "
                    "bitwise equal to those saved in this .npz")
    ap.add_argument("--dense", action="store_true",
                    help="time only the dense solves B4 and B5")
    ap.add_argument("--sass", action="store_true",
                    help="count each GESP and pivoting kernel's "
                    "floating-point SASS instructions by opcode")
    ap.add_argument("--factor", action="store_true",
                    help="time only the GESP factor B2 over its n-sweep, "
                    "with B4 beside it")
    ap.add_argument("--lv1", action="store_true",
                    help="time only B1 on the level-1 DFF's plan")
    ap.add_argument("--b1", action="store_true",
                    help="time only B1 (float64) on cell B's and cell G's "
                    "plans")
    ap.add_argument("--fused-sass", metavar="FILE",
                    help="only build cell B's fused plan and write its "
                    "library's SASS to FILE")
    args = ap.parse_args(argv)
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..")
    sys.path.insert(0, os.path.abspath(args.tree or here))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    import cedarsim_tpu_torch as T
    dev = torch.device("cuda", 0)
    if args.fused_sass:
        res = {"tree": _repo(T), "card": smi(),
               **fused_sass(torch, T, dev, args.fused_sass)}
        print(json.dumps(res), flush=True)
        return res
    which = ("dense" if args.dense else "factor" if args.factor
             else "lv1" if args.lv1 else "b1" if args.b1 else "all")
    times, library, ptxas, results = measure(torch, T, dev, which)
    flat = {f"{k}#{i}": a for k, v in results.items()
            for i, a in enumerate(v)}
    res = {"tree": _repo(T), "card": smi(), "kernels": times,
           "library": library, "ptxas": ptxas}
    if args.sass:
        from cedarsim_tpu_torch.ops import gesp_lu, pivot_lu
        res["sass"] = {m.__name__.rsplit(".", 1)[-1]:
                       sass_counts(m.build()["path"])
                       for m in (gesp_lu, pivot_lu)}
    if args.dump:
        np.savez(args.dump, **flat)
    if args.compare:
        other = np.load(args.compare)
        res["bitwise_equal_to"] = {
            "file": args.compare,
            "kernels": {k: all(f"{k}#{i}" in other.files and np.array_equal(
                a, other[f"{k}#{i}"]) for i, a in enumerate(v))
                for k, v in results.items()},
            "max_rel_diff": {k: max(_rel_diff(a, other[f"{k}#{i}"])
                                    for i, a in enumerate(v))
                             for k, v in results.items()
                             if all(f"{k}#{i}" in other.files
                                    for i in range(len(v)))}}
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return res


if __name__ == "__main__":
    main()
