#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises, so the exit code is not
0 and no result line is printed).  A line printed while a child process of
the smoke ran, or after one ran since the line before, gives
``beside_children_s``: for each child, the seconds since the previous line
during which it ran, so that a wall taken beside another process on the
card says so.

1. device  — requires CUDA; prints the card's name and power limit; full
   float32 matmuls (no TF32).
2. build   — compiles every CUDA source of the checkout at once, one nvcc
   each: the GESP LU kernels, the pivoting LU kernel and the fused chord
   kernel with the BSIM4 model emitted from the DFF's plan (the DFF is set
   up on the card first).
3. kernels — the GESP factor (B2) and substitution (B3) bitwise equal to
   their plain PyTorch versions on the card (random, equilibrated,
   diagonally dominant inputs from a fixed numpy seed; n from 8 to 240,
   with B = 8, 16 and 256 at n = 25 (the DFF cells' and the PVT xla
   run's shapes), n = 32 and 33
   on both sides of the factor's one-warp regime and n = 32, 33, 64, 96
   and 122 reaching each of the substitution's rows-per-lane paths; each kernel's two launches bitwise equal); the
   mixed chord solve against float64 ``torch.linalg.solve``; kernel, plain
   and library-call times at the DFF transient's shape.
4. rc      — the RC step circuit against its closed form.
5. slice   — the gf180 DFF BSIM4 testbench (parse → elaborate → compile
   on the card → transient operating point → per-lane warm DC) as an 8-lane
   transient with a per-lane W scatter through the mixed chord path
   (``newton_impl="xla"``) over 0-160 ns (``CELL_A_TSTOP``; 0-700 ns
   before phase 19 needed the time), gated on the benchmark's golden Q
   level at 150 ns; both GESP kernels must have launched, and the step
   counts must be cell A's (``CELL_A``).  It also counts how near the
   systems run to float32's edge (``MixedMargin``; the wall includes its
   few small reductions per solve).
   repeat  — that path over 0-60 ns twice in this process and once in each
   of two child processes with other string-hash seeds (started after
   phase 3, so that they run beside phases 4-5 and no other process
   shares the card while phase 3 times its kernels): bitwise equal.
6. fused_kernel — the fused chord kernel against its plain version on the
   DFF's lanes (seeded 0.05 V perturbation, BE start, two step sizes):
   equal (ok, Newton count), xn/S/Q within 1e-9, two launches bitwise
   equal; kernel and plain times at 8 lanes and at one (B1'), emit and
   nvcc seconds, ptxas registers and spills, the model walk's hoisted and
   per-evaluation node counts.
7. fused_slice — the DFF through the public ``tran()`` with
   ``newton_impl="fused"`` (the JAX package's fused configuration), gated
   like phase 5; one fused launch per batched step attempt; the step
   counts must be cell B's (``CELL_B``).
8. lu_bench — the dense solve kernels B4 (fused GESP) and B5 (partial
   pivoting) bitwise equal to their plain versions at (B, n) in {(1, 25),
   (37, 11), (512, 25), (8, 32), (8, 33), (64, 122), (4, 240)} (both sides
   of the edge between the one-warp and the one-block regime) and a
   pivot-forcing case (two launches bitwise equal); then the dense-LU bench
   (``cedarsim_tpu_torch.
   benchmarks.lu_bench``) at full width, every gate passing, with both
   kernels launched; then each kernel's, its plain version's, its library
   call's (``torch.linalg.solve_ex`` in float32 for both) and B2+B3's time
   per launch at the bench's two shapes.

9. lv1_single — ``bench.py``'s level-1 DFF leg (``dff_tb.cir``, the
   level-1 MOSFETs of ``models_lv1.spice``) as one stream through the
   public ``tran`` over 0-260 ns (``LV1_SHORT_TSTOP``; 0-700 ns before
   phase 19) with ``SimSpec.make(gmin=1e-15)`` and ``max_steps=16384``,
   gated at ``bench.py:554-557`` inside its window (q within 0.05 V of 0
   at 150 and 250 ns).  One stream takes the exact
   float64 solve under "auto" and "mixed", as the JAX package's unbatched
   chord pair does (``cedarsim_tpu/ops/linalg.py:155``); no GESP kernel
   may launch.
10. lv1_mixed (cell D) — the leg at the JAX package's 256 lanes, vto
   scaled per lane by ``linspace(0.99, 1.01)``, each lane from its own
   operating point, through the mixed chord path (``newton_impl="xla"``,
   ``kernel_times.LV1_XLA_OPTS``) over 0-260 ns (0-700 ns before phase
   19): every lane passes the gate at 150 and 250 ns, both GESP kernels
   launch and the fused kernel does not; the counts must be cell D's
   (``CELL_D``).
11. lv1_fused_kernel — (run after phase 18, once phase 19's child has
   ended, so that no other process shares the card while it times) the
   fused chord kernel on the level-1 plan (``Mos1``
   emitted) against its plain version on the 256 lanes, as phase 6;
   kernel, plain and bound times at 256 and 8 lanes; ptxas registers and
   spills of the ``Mos1`` build.
12. lv1_fused (cell E) — the 256 lanes through the fused configuration
   (``kernel_times.LV1_FUSED_OPTS``) over the whole 0-700 ns: the gate on
   every lane, one fused launch per step attempt, and cell E's counts
   (``CELL_E``).
   lv1_repeat — cells D and E over 0-60 ns twice each: bitwise equal.
13. simulate — ``simulate()`` on the card: the README's inverter and a
   netlist with every newly bound card (``benchmarks/netlists.py``), each
   against the same call with ``device="cpu"``: the operating point within
   1e-9 V and every node's waveform at five times within 1e-6 V.
14. sweeps — on the card against the same call on the CPU: ``dc_sweep``
   of the divider over a ``ProductSweep`` and of a ``tc1`` divider over
   temperature, ``mc_dc`` of 256 points and a ``.dc`` card through
   ``simulate``: every point within 1e-9 V.
15. pvt — ``benchmarks/pvt_sweep.run_chunked``: the BSIM4 DFF over a
   256-point W × VDD grid in one chunk of 256 lanes, 0-700 ns in two
   windows chained by checkpoint, through the engine ``resolve_impl`` gives
   a batched call on the card, which must be the fused kernel (B1): every
   lane through the gate (q at 699 ns within 0.1 V of its own supply,
   after the rescue ladder if a lane needs it), one B1 launch per step
   attempt, the lanes per rescue tier printed, and the counts
   ``CELL_P``.  It runs on the harness object (``pvt_sweep.PVT``) built
   before the kernels' build, whose one fused plan is the plan phase 16
   checks.
16. pvt_fused_kernel — (run after phase 11) B1 on the PVT plan (W and VDD
   per lane) against its plain version at [256, 25] on the PVT lanes'
   operating points, as phase 6; its times, bound and ptxas lines.
17. pvt_xla — the harness with ``impl="xla"`` (B2/B3, ``dense_lu=
   "mixed"``): 16 points over 0-100 ns (``PVT_XLA_TSTOP``), both GESP
   kernels launched, B1 not,
   every count equal to the same call with ``device="cpu"`` (the kernels'
   plain versions), run here after it.
18. ac_noise — AC and noise through ``simulate`` on the card, no
   hand-written kernel launched (all five counts stay 0: the complex
   solve is ``torch.linalg.solve``, as the JAX package's is outside
   Pallas): the BSIM4 DFF AC/noise deck (``benchmarks/netlists.py::
   dff_ac_noise``, 751 frequencies, supply to q) against the same call
   with ``device="cpu"``: operating points within 1e-9 V, the AC solution
   within 1e-10 of its largest entry per frequency, the PSD within 1e-9
   relative; the gf180 inverter noise deck with the structural gates of
   ``tests/test_noise_pdk_goldens.py`` (plateau flat to 0.5 % below 1 MHz,
   √PSD slope −1 ± 0.01 over 1e12-1e15 Hz, corner in 1e9-1e11 Hz); an RC
   low-pass, |H| = 1/√2 at 1/(2πRC) within 1e-9 and the integrated noise
   √(kT/C) within 1 %.  Its line gives the walls of the two ``simulate``
   calls (card, CPU; ``.ac`` and ``.noise`` share one operating point),
   the set-up (parse, compile, operating point), the AC and the noise
   wall about that operating point (``x_op``; each ending in a
   synchronise), the eps Jacobian walk, and the batched complex solve at
   [751, 25, 25] (call and device time).
19. sparse — the JAX package's large-circuit transient on the card
   through its entry point (``cedarsim_tpu_torch/benchmarks/
   chain_transient.py::run``), in a child process started after phase 8
   that runs beside phases 9-18 (each process host-bound on its own core;
   the walls of both include the sharing, which each of those phases'
   lines gives as ``beside_children_s``), every kernel count from 0 in
   that process just before it and read just after: the 40-cell
   gf180 BSIM4 shift register, 452 unknowns, compiled with
   ``sparse="auto"``, which must take the sparse Newton path; its
   operating point (``solve_dc(mode="tranop")``, ``max_step=1.0,
   gmin_steps=14``) and the transient over 0-200 ns, one stream,
   ``jac_reuse=1``: the four gates (d1 within 0.1 V of 5 V at 100 ns, d2
   at 150 ns, d3 at 199 ns, d2 within 0.1 V of 0 at 199 ns), the counts
   ``CELL_F`` (the JAX package's CPU run's), at least one
   S1 launch per step attempt (the rescue adds its own), no GESP,
   dense-solve or fused launch; set-up, wall, counts and launches
   printed.  Then, in the main process after phase 16: its plan (built
   on the card, the probe on the CPU)
   bitwise the plan of the same circuit compiled on the CPU, its levels
   and filled values printed; the operating point against the dense DC on
   the card within 1e-9 V; ẋ0 of the chain at that point (``tran.
   xdot0_and_mask``), its peak device memory above what was allocated
   before it under ``XDOT0_PEAK_LIMIT`` (ROADMAP C7; the normal matrix's
   own and the n³ bytes of the broadcast product it replaced beside it);
   ROADMAP C6's witness (``c6_chain``: the 21-cell level-1 chain, 243
   unknowns, at 2 lanes over 0-1 ns through ``dense_lu="auto"``, which
   resolves to the exact solve, while an explicit "mixed" raises naming
   its two ways out: no kernel launched, each lane bitwise the one stream,
   within 1e-9 V of the CPU from the same operating point); the chain
   with a lane axis (2 lanes from the
   operating point over 0-1 ns: S1/S2 at 2 lanes, no dense kernel), each
   lane bitwise the one stream; and the sparse factor (S1,
   ``sparse_lu.factor``) and solve (S2, ``sparse_lu.solve_factored``) on
   the chain's equilibrated Jacobian at that operating point, at 1 and 8
   lanes: bitwise their plain versions, two launches bitwise equal; each
   one's device time (CUDA-graph replay) and call time, the plain
   version's, the dense library call on the same systems
   (``torch.linalg.lu_factor``/``lu_solve``, float64 [L, 452, 452]) and
   the bound.

The line before the last is the card's name and power limit from
``nvidia-smi``; before it, one JSON line with each kernel's route, source,
the TPU kernel it replaces, launches on its path (B1 in phase 7 and, on
the level-1 plan, in phase 12, on the PVT plan in phase 15; B2/B3 in phase
5, in phase 10 and in phase 17; B4/B5 in phase 8; S1/S2 in phase 19,
which name no TPU kernel: ``replaces`` is null and ``jax_counterpart`` the
XLA function they take the place of), error, times and its bound: the
larger of the
bytes it must move over 3.35 TB/s and its operations over the card's peak
for their type, both counted from this run's inputs.  The times
(``benchmarks/kernel_times.py``): ``call_ms`` (= ``ms``), a Python loop of
wrapper calls between two events, per call, the least of five loops;
``device_ms``, 100 wrapper calls captured in one CUDA graph and replayed,
per launch; the plain version's call time; and one PyTorch library call
computing the same function where there is one, timed both ways
(``library_ms``, ``library_device_ms``; a call that a CUDA graph cannot
capture, as ``solve_ex``, has its device time from its kernels in a
``torch.profiler`` trace, and ``library_device_by`` says which).  B2's
entry names its design; ``kernel_times.py --factor`` times it over its
n-sweep (n = 8-240 at B = 8) beside B4, and ``--sass`` shows which updates
compiled to fused multiply-adds.  The last line is ``{"ok": true,
"device": {...}}``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
from cedarsim_tpu_torch.benchmarks import kernel_times as kt  # noqa: E402

DFF_DIR = os.path.join(REPO, "benchmarks", "gf180_dff")
#: golden tolerance of the DFF benchmark (bench.py GOLDEN_TOL)
GOLDEN_TOL = 0.05
#: lanes of the transient and the per-lane W scatter (bench.py:217-225)
N_LANES = kt.N_LANES
#: cell A's and cell B's step counts over all lanes (accepted, rejected,
#: Newton, attempts) on the card: every kernel is bitwise its plain
#: version, so these move only with the code (cell A's since the
#: substitution rounds each product and difference on its own, PERF.md)
#: cell A's window: 0-160 ns, past the first golden sample (150 ns), since
#: phase 19 needs the time (the full 0-700 ns runs in cell B); its counts
#: over that window were recorded on the card (0-700 ns: 11478, 1107,
#: 28560, 1580)
CELL_A_TSTOP = 1.6e-7
CELL_A = (3086, 279, 7475, 428)
CELL_B = (4832, 1291, 16754, 776)
#: cells D and E, the level-1 DFF at 256 lanes through the mixed chord path
#: and the fused engine (accepted, rejected, Newton, attempts over all
#: lanes); cell D over 0-260 ns (``LV1_SHORT_TSTOP``; over 0-700 ns it was
#: 384556, 57104, 1024766, 1740), cell E over 0-700 ns
CELL_D = (164482, 23578, 435608, 744)
CELL_E = (161553, 30938, 505888, 756)
#: the PVT sweep (phase 15): 256 points, one chunk, two windows (accepted,
#: rejected, Newton over all lanes, batched step attempts over both
#: windows), and the 16-point run through the GESP kernels over
#: 0-``PVT_XLA_TSTOP`` (phase 17; its counts are those of the same call on
#: the CPU)
PVT_POINTS = 256
PVT_SEGMENTS = 2
CELL_P = (158702, 38472, 532508, 816)
PVT_XLA_POINTS = 16
PVT_XLA_TSTOP = 1e-7
#: the level-1 leg's gate (bench.py:554-557): (ns, level) of q
LV1_GATE = ((150.0, 0.0), (250.0, 0.0), (700.0, 5.0))
LV1_TSTOP = 7e-7
#: the window of the level-1 single stream (phase 9) and of cell D (phase
#: 10): 0-260 ns, past the gates at 150 and 250 ns (cell E keeps 0-700 ns)
LV1_SHORT_TSTOP = 2.6e-7
LV1_LANES = kt.LV1_LANES
#: the repeat window of cells D and E (past the first clock edge, where q
#: first switches)
LV1_REPEAT_TSTOP = 6e-8
#: simulate() on the card against the same call on the CPU
SIM_DC_TOL = 1e-9
SIM_WAVE_TOL = 1e-6
#: the mixed chord solve (float32 GESP + two float64 refinement passes)
#: against float64 torch.linalg.solve on well-conditioned systems
CHORD_RTOL = 1e-10
#: the fused chord kernel against its plain version: the same float64 loop
#: (no FMA contraction), other summation orders in the row sums
FUSED_RTOL = 1e-9
#: phase 18: card against CPU on the DFF AC/noise deck, and the RC gates
AC_RTOL = 1e-10
PSD_RTOL = 1e-9
RC_H_TOL = 1e-9
KTC_RTOL = 0.01
#: H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): memory bytes/s
#: and operations/s outside the tensor cores by type
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}


def bound(nbytes, ops, dtype):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lu_ops(n, B, kind):
    """Operations of the dense LU kernels on B systems of n unknowns, a
    multiply-add counted as two: the factor's multipliers and trailing
    updates, the substitution's row sums and divisions, the fused solves'
    elimination of b, and the pivoting solve's |A[i, k]| and comparison of
    each candidate row."""
    m = np.arange(n)                       # rows below the pivot per step
    factor = int((m + 2 * m * m).sum())
    subst = 2 * n * (n - 1) + n
    elim_b = n * (n - 1)
    back = n * (n - 1) + n
    per = {"factor": factor, "subst": subst,
           "gesp_solve": factor + elim_b + back,
           "pivot_solve": factor + elim_b + back + n * (n + 1)}[kind]
    return B * per


#: the script's start, for each line's seconds since it (``t_s``)
T_START = time.perf_counter()


#: the smoke's child processes, [name, start, end] on the smoke's clock
#: (end None while one runs), and when the last line was printed: each
#: line gives the seconds since the line before it during which a child
#: ran (``beside_children_s``), so that a wall taken while another process
#: shared the card and the host says so
CHILD_SPANS = []
LAST_LINE_T = [0.0]


def track_child(name, proc):
    """Record ``proc``'s span under ``name`` in ``CHILD_SPANS``."""
    import threading
    span = [name, time.perf_counter() - T_START, None]
    CHILD_SPANS.append(span)

    def wait():
        proc.wait()
        span[2] = time.perf_counter() - T_START
    threading.Thread(target=wait, daemon=True).start()


def log(phase, **kw):
    now = time.perf_counter() - T_START
    beside = {}
    for name, t0, t1 in CHILD_SPANS:
        overlap = min(now, now if t1 is None else t1) - max(LAST_LINE_T[0],
                                                             t0)
        if overlap > 0:
            beside[name] = overlap
    if beside:
        kw["beside_children_s"] = beside
    LAST_LINE_T[0] = now
    print(json.dumps({"phase": phase, **kw, "t_s": now}), flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bitwise(torch, a, b):
    """The same float32 bits (NaNs included), not only equal values."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def phase_kernels(torch, gesp_lu, linalg, dev):
    rng = np.random.default_rng(0)
    n_max = 240          # [A | b] at stride 241: 232,320 B of 232,448
    abs_err = {"factor": 0.0, "subst": 0.0}
    checked = []
    for B, n in [(1, 25), (8, 8), (8, 25), (37, 25), (128, 25),
                 (PVT_XLA_POINTS, 25), (LV1_LANES, 25), (8, 32), (8, 33), (8, 64), (8, 96),
                 (8, 122), (4, n_max)]:
        A, b = kt.dominant_systems(rng, B, n)
        A32 = torch.as_tensor(A, dtype=torch.float32, device=dev)
        b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
        LU_k = gesp_lu.lu_factor_gesp_f32(A32)
        LU_k2 = gesp_lu.lu_factor_gesp_f32(A32)
        LU_p = gesp_lu.lu_factor_gesp_f32_plain(A32)
        x_k = gesp_lu.lu_subst_gesp_f32(LU_p, b32)
        x_k2 = gesp_lu.lu_subst_gesp_f32(LU_p, b32)
        x_p = gesp_lu.lu_subst_gesp_f32_plain(LU_p, b32)
        torch.cuda.synchronize()
        for name, k, k2, p in (("factor", LU_k, LU_k2, LU_p),
                               ("subst", x_k, x_k2, x_p)):
            if not bitwise(torch, k, k2):
                raise AssertionError(f"{name} B={B} n={n}: two launches "
                                     "differ")
            if not bool(torch.isfinite(k).all()):
                raise AssertionError(f"{name} B={B} n={n}: non-finite")
            if not bitwise(torch, k, p):
                err = float((k - p).abs().max())
                raise AssertionError(f"{name} B={B} n={n}: not bitwise its "
                                     f"plain version (largest difference "
                                     f"{err:.3g})")
            if n == 25 and B == N_LANES:
                abs_err[name] = float((k - p).abs().max())
        checked.append([B, n])
        # the mixed chord solve on float64 systems vs torch.linalg.solve
        J = torch.as_tensor(A, dtype=torch.float64, device=dev)
        b64 = torch.as_tensor(b, dtype=torch.float64, device=dev)
        x_m = linalg.chord_solve_once(J, b64)
        x_e = torch.linalg.solve(J, b64)
        rel = float((x_m - x_e).abs().max() / x_e.abs().max())
        if rel > CHORD_RTOL:
            raise AssertionError(f"chord solve B={B} n={n}: relative error "
                                 f"{rel:.3g} > {CHORD_RTOL}")
    # times at the transient's shape: B = lanes, n = 25 unknowns; beside
    # each kernel, one PyTorch call computing the same function (timed
    # here only: the port never calls it)
    B, n = N_LANES, 25
    A, b = kt.dominant_systems(rng, B, n)
    A32 = torch.as_tensor(A, dtype=torch.float32, device=dev)
    b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
    LU = gesp_lu.lu_factor_gesp_f32(A32)
    ident = torch.arange(1, n + 1, dtype=torch.int32,
                         device=dev).expand(B, n).contiguous()

    def factor():
        return gesp_lu.lu_factor_gesp_f32(A32)

    def subst():
        return gesp_lu.lu_subst_gesp_f32(LU, b32)

    # (device ms, call ms, plain ms, library call ms, library device ms,
    # how the library's device time was taken)
    times = {
        "factor": (kt.device_ms(factor), kt.call_ms(factor, 200),
                   kt.call_ms(
                       lambda: gesp_lu.lu_factor_gesp_f32_plain(A32), 20),
                   *library_ms(lambda: torch.linalg.lu_factor_ex(
                       A32, pivot=False), 200)),
        "subst": (kt.device_ms(subst), kt.call_ms(subst, 200),
                  kt.call_ms(
                      lambda: gesp_lu.lu_subst_gesp_f32_plain(LU, b32), 20),
                  *library_ms(lambda: torch.linalg.lu_solve(
                      LU, ident, b32[..., None]), 200)),
    }
    bounds = {"factor": bound(8 * B * n * n, lu_ops(n, B, "factor"),
                              "float32"),
              "subst": bound(4 * B * n * (n + 2), lu_ops(n, B, "subst"),
                             "float32")}
    log("kernels", bitwise_equal_to_plain=checked,
        max_abs_err_dff_shape=abs_err,
        ms_device_call_plain_library_call_device_by={
            k: list(v) for k, v in times.items()},
        bound_ms=bounds, shape=[B, n, n])
    return abs_err, times, bounds


def library_ms(fn, reps):
    """(call ms, device ms, how the device time was taken) of a PyTorch
    library call (a yardstick only: the port never calls it), from
    ``kt.library_times``: the device time by CUDA-graph replay, or, for a
    call that a graph cannot capture (``solve_ex``), from its kernels in a
    ``torch.profiler`` trace; None with the reason where neither works."""
    t = kt.library_times(fn, reps)
    if "graph_error" in t:
        log("library_call_not_captured", error=t["graph_error"],
            device_by=t["device_by"])
    return t["call_ms"], t["device_ms"], t["device_by"]


def phase_rc(T, dev):
    ckt = T.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(T.VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=0.0, v2=3.3, td=1e-6, tr=1e-9, tf=1e-9, pw=4e-6,
                 per=10e-6))
    ckt.add(T.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(T.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    comp = T.compile_circuit(ckt, device=dev)
    t0 = time.perf_counter()
    sol = T.tran(comp, (0.0, 20e-6))
    wall = time.perf_counter() - t0
    t_tau = 1e-6 + 1e-9 + 1e-6          # one tau after the edge
    got = float(sol.interp("vout", t_tau))
    want = 3.3 * (1.0 - np.exp(-1.0))
    if not sol.converged or abs(got - want) > 5e-3:
        raise AssertionError(f"RC: converged={sol.converged}, vout={got} "
                             f"vs {want}")
    log("rc", vout=got, want=want, accepted=sol.n_accepted,
        rejected=sol.n_rejected, wall_s=wall)


def dff_setup(torch, T, dev):
    """The DFF testbench compiled on the card, its transient operating
    point and the per-lane warm DC of the W scatter.  Returns (comp, ctx,
    per-lane params, per-lane initial states, golden, set-up seconds)."""
    with open(os.path.join(DFF_DIR, "golden_bsim4.json")) as f:
        golden = json.load(f)
    t0 = time.perf_counter()
    comp, ctx, pb, x0 = kt.dff_lanes(torch, T, dev)
    return comp, ctx, pb, x0, golden, time.perf_counter() - t0


def gate_golden(sols, golden, n_x, windows_ns=None):
    """The benchmark's gate: every lane finished with finite waveforms,
    the nominal lane within GOLDEN_TOL of every golden point, every lane at
    the points outside the 401 ns race.  Returns the worst error."""
    worst, errs = 0.0, []
    for lane, sol in enumerate(sols):
        if not sol.converged:
            raise AssertionError(f"lane {lane} did not finish")
        if not (np.isfinite(sol.xs).all() and sol.xs.shape[1] == n_x):
            raise AssertionError(f"lane {lane}: bad waveform")
        for j, (t_ns, g) in enumerate(zip(golden["samples_ns"],
                                          golden["q"])):
            if windows_ns is not None and t_ns not in windows_ns:
                continue
            if j in (2, 3) and lane != N_LANES // 2:
                continue        # the race points gate only the nominal lane
            err = abs(float(sol.interp("q", t_ns * 1e-9)) - g)
            worst = max(worst, err)
            if err > GOLDEN_TOL:
                errs.append((lane, t_ns, err))
    if errs:
        raise AssertionError(f"golden gate failed (lane, ns, err): {errs}")
    return worst


def counts(sols):
    return dict(accepted=sum(s.n_accepted for s in sols),
                rejected=sum(s.n_rejected for s in sols),
                newton=sum(s.n_newton for s in sols))


def check_counts(cell, sols, want):
    """A cell's (accepted, rejected, Newton, attempts) over all lanes must
    be the recorded ones (None: none recorded for this window yet; the
    phase's line prints them)."""
    c = counts(sols)
    got = (c["accepted"], c["rejected"], c["newton"], sols[0].n_attempts)
    if want is not None and got != tuple(want):
        raise AssertionError(f"cell {cell}: counts (accepted, rejected, "
                             f"Newton, attempts) {got}, recorded {want}")


#: the mixed chord path of phase 5 and the fused configuration of phase 7
#: (kernel_times.py says where each comes from)
XLA_OPTS = kt.XLA_OPTS
FUSED_OPTS = kt.FUSED_OPTS


class MixedMargin:
    """How near the mixed chord path's systems run to float32's edge,
    counted on the card without a host sync: while active it wraps
    ``linalg.chord_factor`` and ``linalg.chord_backsolve`` (which ``tran``
    looks up at each call) and adds up, over the systems they see, the
    factors with a pivot boosted to 1e-20, the factors with a non-finite
    entry, the largest finite |LU| entry (float32's largest is 3.4e38), the
    chord solves, and the solves with a non-finite entry.  A few small
    reductions per call beside each kernel launch."""

    def __init__(self, torch, linalg, dev):
        self.torch, self.linalg = torch, linalg
        self.acc = torch.zeros(6, dtype=torch.float64, device=dev)

    def __enter__(self):
        torch, lg, acc = self.torch, self.linalg, self.acc
        self.saved = factor, backsolve = lg.chord_factor, lg.chord_backsolve

        def chord_factor(J):
            LU, perm, r = factor(J)
            fin = torch.isfinite(LU)
            acc[0] += J.shape[0]
            acc[1] += (LU.diagonal(dim1=-2, dim2=-1).abs() <= 1e-20).any(-1) \
                .sum()
            acc[2] += (~fin).flatten(1).any(-1).sum()
            acc[3] = torch.maximum(
                acc[3], torch.where(fin, LU.abs(), 0).amax().double())
            return LU, perm, r

        def chord_backsolve(*args):
            x = backsolve(*args)
            acc[4] += x.shape[0]
            acc[5] += (~torch.isfinite(x)).any(-1).sum()
            return x
        lg.chord_factor, lg.chord_backsolve = chord_factor, chord_backsolve
        return self

    def __exit__(self, *exc):
        self.linalg.chord_factor, self.linalg.chord_backsolve = self.saved

    def read(self):
        v = self.acc.tolist()
        return dict(factors=int(v[0]), factors_boosted_pivot=int(v[1]),
                    factors_nonfinite=int(v[2]), lu_max_abs_finite=v[3],
                    solves=int(v[4]), solves_nonfinite=int(v[5]))


def phase_slice(torch, T, gesp_lu, linalg, dev, dff):
    comp, ctx, pb, x0, golden, t_setup = dff
    tstop = CELL_A_TSTOP
    opts = T.TranOptions(**XLA_OPTS)
    gesp_lu.lu_factor_gesp_f32.launches = 0
    gesp_lu.lu_subst_gesp_f32.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with MixedMargin(torch, linalg, dev) as margin:
        sols = T.tran(comp, (0.0, tstop), params=pb, ctx=ctx, opts=opts,
                      x0=x0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {"factor": gesp_lu.lu_factor_gesp_f32.launches,
                "subst": gesp_lu.lu_subst_gesp_f32.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"kernels not on the main path: {launches}")
    worst = gate_golden(sols, golden, comp.n_x, windows_ns=[
        t for t in golden["samples_ns"] if t * 1e-9 <= tstop])
    check_counts("A", sols, CELL_A)
    log("slice", lanes=N_LANES, setup_s=t_setup, wall_s=wall,
        transients_per_s=N_LANES / wall, worst_golden_err=worst,
        **counts(sols), attempts=sols[0].n_attempts, launches=launches,
        margin=margin.read(), card=smi())
    return launches


#: the repeat phase's window (the mixed chord path, 8 lanes)
REPEAT_TSTOP = 6e-8


def repeat_run(T, dff):
    """One run of the repeat phase: (ts per lane, xs per lane, counts)."""
    comp, ctx, pb, x0, _, _ = dff
    sols = T.tran(comp, (0.0, REPEAT_TSTOP), params=pb, ctx=ctx,
                  opts=T.TranOptions(**XLA_OPTS), x0=x0)
    return ([s.ts for s in sols], [s.xs for s in sols],
            [(s.n_accepted, s.n_rejected, s.n_newton) for s in sols])


def _same(a, b):
    return a[2] == b[2] and all(
        np.array_equal(u, w) for u, w in zip(a[0] + a[1], b[0] + b[1]))


def start_repeat_children():
    """The repeat phase's two child processes, string-hash seeds 1 and 2,
    started at once and early, so that each runs beside the main
    process's phases (each is host-bound on its own core).  Returns (the
    scratch directory, {seed: (output path, stderr file, process)});
    ``stop_children`` ends them."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_repeat_")
    procs = {}
    for seed in ("1", "2"):
        out = os.path.join(tmp, f"run{seed}.npz")
        err = open(os.path.join(tmp, f"stderr{seed}.txt"), "w")
        procs[seed] = (out, err, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--repeat-child",
             out], stdout=subprocess.DEVNULL, stderr=err,
            env={**os.environ, "PYTHONHASHSEED": seed}))
        track_child(f"repeat_seed{seed}", procs[seed][2])
    return tmp, procs


def stop_children(children):
    """End (if still running) and reap the repeat children, and remove
    their scratch directory."""
    import shutil
    tmp, procs = children
    for _, err, p in procs.values():
        if p.poll() is None:
            p.kill()
        p.wait()
        err.close()
    shutil.rmtree(tmp, ignore_errors=True)


def phase_repeat(torch, T, dev, dff, children):
    """The mixed chord path on identical inputs, twice in this process and
    once in each of two child processes with string-hash seeds 1 and 2
    (before the interpreter merged branches in walk order, those two seeds
    summed the BSIM4 rows in two different orders; ``children`` from
    ``start_repeat_children``): every run must be bitwise equal to the
    first."""
    t0 = time.perf_counter()
    runs = [repeat_run(T, dff), repeat_run(T, dff)]
    wall = time.perf_counter() - t0
    _, procs = children
    for seed, (out, err, p) in procs.items():
        p.wait(timeout=600)
        err.flush()
        if p.returncode != 0:
            with open(err.name) as f:
                raise AssertionError(f"repeat child (seed {seed}) failed:\n"
                                     f"{f.read()[-4000:]}")
        z = np.load(out)
        L = int(z["lanes"])
        runs.append(([z[f"ts{i}"] for i in range(L)],
                     [z[f"xs{i}"] for i in range(L)],
                     [tuple(int(c) for c in z["counts"][i])
                      for i in range(L)]))
    equal = [_same(runs[0], r) for r in runs[1:]]
    dmax = 0.0
    for r in runs[1:]:
        for u, w in zip(runs[0][1], r[1]):
            m = min(len(u), len(w))
            dmax = max(dmax, float(np.abs(u[:m] - w[:m]).max()))
    log("repeat", bitwise_equal_in_process=equal[0],
        bitwise_equal_hash_seed_1_2=equal[1:], max_abs_dx=dmax,
        steps=[[sum(c[k] for c in r[2]) for k in range(3)] for r in runs],
        wall_s_two_runs=wall)
    if not all(equal):
        raise AssertionError("the mixed chord path is not reproducible: "
                             f"{equal}")


def repeat_child(out):
    """``--repeat-child OUT``: the DFF set-up and one repeat run on the
    card, saved to OUT (numpy .npz)."""
    import torch
    import cedarsim_tpu_torch as T
    dev = torch.device("cuda", 0)
    ts, xs, cnt = repeat_run(T, dff_setup(torch, T, dev))
    np.savez(out, lanes=len(ts), counts=np.asarray(cnt),
             **{f"ts{i}": a for i, a in enumerate(ts)},
             **{f"xs{i}": a for i, a in enumerate(xs)})


def phase_fused_kernel(torch, T, fc, dev, dff, plan, t_plan):
    """The fused chord kernel against its plain version on the DFF's lanes
    at a BE start from the warm state, with the node unknowns perturbed by
    a seeded 0.05 V so that the loop iterates: equal (ok, nnwt) per lane,
    xn, S and Q within FUSED_RTOL, and two kernel runs bitwise equal.  S
    is held against the scale of the currents it is summed from (S at the
    predictor): the converged S cancels to ~1e-11 A from device currents
    of ~0.1 A, so its round-off relative to itself is ~1e-7 even where the
    model walks agree to 1e-19.  Times and bounds at 8 lanes (B1) and at
    the nominal lane alone (B1')."""
    info = plan.build()
    worst = dict(xn=0.0, S=0.0, Q=0.0)
    s_final_rel = 0.0
    abs_err = 0.0
    nnwt = []
    times = None
    for h in (1e-12, 1e-10):
        args, opts = kt.fused_args(torch, T, plan, dff[:4], h)
        k1, err = fused_vs_plain(torch, fc, plan, args, opts, f"h={h}",
                                 worst)
        s_final_rel = max(s_final_rel, err["s_final_rel"])
        abs_err = max(abs_err, err["xn_abs"])
        nnwt.append(k1[3].tolist())
        if times is None:
            # (device ms, call ms, plain ms) at 8 lanes and, B1', at one
            one = slice(N_LANES // 2, N_LANES // 2 + 1)
            args1, _ = kt.fused_args(torch, T, plan, dff[:4], h, lanes=one)
            times, bounds = {}, {}
            for key, a in (("B1", args), ("B1'", args1)):
                def run(a=a):
                    return fc.fused_chord(plan, *a, opts)
                times[key] = (kt.device_ms(run), kt.call_ms(run, 50),
                              kt.call_ms(lambda a=a: fc.fused_chord_plain(
                                  plan, *a, opts), 5))
                bounds[key], counted = fused_bound(plan, a, run())
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if any(w in ln for w in ("Function properties", "registers",
                                      "spill"))]
    log("fused_kernel", worst_rel_err=worst,
        s_rel_to_final_s=s_final_rel, ok_nnwt=nnwt,
        ms_device_call_plain={k: list(v) for k, v in times.items()},
        shape=list(dff[3].shape), bound_ms=bounds, nodes=counted,
        n_inst=plan.n_inst, fc_max_hoist=plan.max_hoist,
        threads=plan.threads, smem_bytes=plan.smem_bytes,
        smem_limit=plan.smem_limit, plan_s=t_plan,
        emit_s=info["emit_seconds"], nvcc_s=info["nvcc_seconds"],
        ptxas=ptxas, header=os.path.relpath(info["path"], REPO))
    return abs_err, times, info, bounds


def fused_vs_plain(torch, fc, plan, args, opts, what, worst):
    """The fused chord kernel against its plain version on ``args``: two
    launches bitwise equal, equal (ok, nnwt), xn, S and Q within
    FUSED_RTOL (S against the scale of the currents it is summed from: S
    at the predictor).  Updates ``worst`` ({xn, S, Q} relative errors);
    returns the kernel's outputs and {xn_abs, s_final_rel}."""
    k1 = fc.fused_chord(plan, *args, opts)
    k2 = fc.fused_chord(plan, *args, opts)
    p = fc.fused_chord_plain(plan, *args, opts)
    # S at the predictor: the scale of the device currents that the
    # converged S (a residual of ~1e-11 A) cancels from
    s_scale = float(fc.fused_chord_plain(
        plan, *args, dataclasses.replace(opts, max_newton=0))[1]
        .abs().max())
    torch.cuda.synchronize()
    if not all(torch.equal(u, w) for u, w in zip(k1, k2)):
        raise AssertionError(f"{what}: two kernel runs differ")
    if not torch.equal(k1[3], p[3]):
        raise AssertionError(f"{what}: (ok, nnwt) kernel "
                             f"{k1[3].tolist()} vs plain {p[3].tolist()}")
    out = dict(xn_abs=0.0, s_final_rel=0.0)
    for name, u, w in zip(("xn", "S", "Q"), k1[:3], p[:3]):
        err = float((u - w).abs().max())
        scale = float(w.abs().max())
        if name == "S":
            out["s_final_rel"] = err / max(scale, 1e-300)
            scale = max(scale, s_scale)
        rel = err / max(scale, 1e-300)
        if not (rel <= FUSED_RTOL):
            raise AssertionError(f"{what} {name}: relative error {rel:.3g}"
                                 f" > {FUSED_RTOL}")
        worst[name] = max(worst[name], rel)
        if name == "xn":
            out["xn_abs"] = err
    return k1, out


def fused_bound(plan, args, out):
    """B1's bound for one launch, from its inputs and outputs: the bytes
    of every tensor it reads or writes (not its scratch of hoisted
    values); the operations of each lane's hoisted model part (once per
    instance) and of its (Newton iterations + 1) evaluations (the walk's
    arithmetic nodes times the instances, and the G_lin/C_lin matvecs,
    3·2n²) and of its direction per iteration (2n²).  Returns ((ms, by),
    node counts of the emitted models)."""
    comp = plan.compiled
    lanes = args[7]
    tensors = (list(args[:7]) + list(out)
               + [plan.G_lin_T, plan.C_lin_T, plan.q_off_t,
                  plan.inst_group_t, plan.inst_var_t, plan.row_ptr_t,
                  plan.ent_slot_t, lanes.dyn, lanes.ent_scale])
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = plan.n_x
    ni = {key: len(comp.groups[key].instances) for key, _ in plan.emitted}
    pre = sum(e.n_pre * ni[key] for key, e in plan.emitted)
    walk = sum(e.n_walk * ni[key] for key, e in plan.emitted)
    nnwt = out[3][:, 1].double().cpu()
    ops = float((pre + (nnwt + 1) * (walk + 6 * n * n)
                 + nnwt * 2 * n * n).sum())
    counted = {key: {"hoisted_nodes": e.n_pre, "walk_nodes": e.n_walk,
                     "hoisted_values": e.n_hoist, "instances": ni[key]}
               for key, e in plan.emitted}
    return bound(nbytes, ops, "float64"), counted


def phase_fused_slice(torch, T, gesp_lu, fc, dev, dff, fused_setup):
    comp, ctx, pb, x0, golden, t_setup = dff
    tstop = 7e-7
    opts = T.TranOptions(**FUSED_OPTS)
    fc.fused_chord.launches = 0
    fc.fused_chord.launches_by_lanes.clear()
    gesp_lu.lu_factor_gesp_f32.launches = 0
    gesp_lu.lu_subst_gesp_f32.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sols = T.tran(comp, (0.0, tstop), params=pb, ctx=ctx, opts=opts, x0=x0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {"fused": fc.fused_chord.launches,
                "fused_one_lane": fc.fused_chord.launches_by_lanes[1],
                "factor": gesp_lu.lu_factor_gesp_f32.launches,
                "subst": gesp_lu.lu_subst_gesp_f32.launches}
    if launches["fused"] != sols[0].n_attempts or launches["fused"] <= 0:
        raise AssertionError(f"fused launches {launches['fused']} != "
                             f"{sols[0].n_attempts} step attempts")
    worst = gate_golden(sols, golden, comp.n_x)
    check_counts("B", sols, CELL_B)
    log("fused_slice", lanes=N_LANES,
        setup_s=t_setup + fused_setup["plan_s"] + fused_setup["nvcc_s"],
        fused_setup_s=fused_setup, wall_s=wall,
        transients_per_s=N_LANES / wall, worst_golden_err=worst,
        **counts(sols), attempts=sols[0].n_attempts, launches=launches,
        card=smi())
    return launches


def gate_lv1(sols, tstop=LV1_TSTOP):
    """The level-1 leg's gate on every lane (bench.py:554-557): finished,
    finite, q within GOLDEN_TOL of each level of ``LV1_GATE`` up to
    ``tstop``.  Returns the worst error."""
    worst, errs = 0.0, []
    for lane, sol in enumerate(sols):
        if not sol.converged:
            raise AssertionError(f"lv1 lane {lane} did not finish")
        if not np.isfinite(sol.xs).all():
            raise AssertionError(f"lv1 lane {lane}: non-finite waveform")
        for t_ns, want in LV1_GATE:
            if t_ns * 1e-9 > tstop:
                continue
            err = abs(float(sol.interp("q", t_ns * 1e-9)) - want)
            worst = max(worst, err)
            if not err < GOLDEN_TOL:
                errs.append((lane, t_ns, err))
    if errs:
        raise AssertionError(f"lv1 gate failed (lane, ns, err): {errs[:8]}")
    return worst


def phase_lv1_single(torch, T, gesp_lu, dev):
    """Phase 9: one stream of the level-1 leg through the public tran,
    alone on the card."""
    with open(os.path.join(DFF_DIR, "dff_tb.cir")) as f:
        nl = T.parse_spice(f.read(), file="dff_tb.cir")
    t0 = time.perf_counter()
    comp = T.compile_circuit(T.elaborate(nl, include_paths=[DFF_DIR]),
                             device=dev)
    t_setup = time.perf_counter() - t0
    opts = T.TranOptions(max_steps=16384)
    gesp_lu.lu_factor_gesp_f32.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sol = T.tran(comp, (0.0, LV1_SHORT_TSTOP),
                 ctx=T.SimSpec.make(gmin=1e-15),
                 opts=opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    if gesp_lu.lu_factor_gesp_f32.launches:
        raise AssertionError("one stream launched the GESP factor "
                             f"{gesp_lu.lu_factor_gesp_f32.launches} times")
    worst = gate_lv1([sol], LV1_SHORT_TSTOP)
    log("lv1_single", tstop=LV1_SHORT_TSTOP, setup_s=t_setup, wall_s=wall,
        newton_per_s=sol.n_newton / wall, worst_gate_err=worst,
        **counts([sol]), attempts=sol.n_attempts, card=smi())


def lv1_run(torch, T, gesp_lu, fc, lv1, cell, tstop):
    """Cell D or E over 0-tstop through the public tran, with the kernels'
    launches counted from 0.  Returns (solutions, launches, wall s)."""
    comp, ctx, pb, x0 = lv1[:4]
    opts = T.TranOptions(**(kt.LV1_XLA_OPTS if cell == "D"
                            else kt.LV1_FUSED_OPTS))
    fc.fused_chord.launches = 0
    gesp_lu.lu_factor_gesp_f32.launches = 0
    gesp_lu.lu_subst_gesp_f32.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sols = T.tran(comp, (0.0, tstop), params=pb, ctx=ctx, opts=opts, x0=x0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {"fused": fc.fused_chord.launches,
                "factor": gesp_lu.lu_factor_gesp_f32.launches,
                "subst": gesp_lu.lu_subst_gesp_f32.launches}
    if cell == "D" and (min(launches["factor"], launches["subst"]) <= 0
                        or launches["fused"]):
        raise AssertionError(f"cell D: kernels {launches}")
    if cell == "E" and not (0 < launches["fused"] == sols[0].n_attempts):
        raise AssertionError(f"cell E: fused launches {launches['fused']} "
                             f"!= {sols[0].n_attempts} step attempts")
    return sols, launches, wall


def phase_lv1(torch, T, gesp_lu, fc, lv1, cell, want, tstop, extra=None):
    """Phases 10 and 12: cell D or E over 0-``tstop`` at 256 lanes, gated
    on every lane at the points inside the window, its counts held to
    ``want``."""
    sols, launches, wall = lv1_run(torch, T, gesp_lu, fc, lv1, cell, tstop)
    worst = gate_lv1(sols, tstop)
    if want is not None:
        check_counts(cell, sols, want)
    log(f"lv1_{'mixed' if cell == 'D' else 'fused'}", cell=cell, tstop=tstop,
        lanes=len(sols), setup_s=lv1[4], wall_s=wall,
        transients_per_s=len(sols) / wall, worst_gate_err=worst,
        **counts(sols), attempts=sols[0].n_attempts, launches=launches,
        **(extra or {}), card=smi())
    return launches


def phase_lv1_repeat(torch, T, gesp_lu, fc, lv1):
    """Cells D and E over 0-LV1_REPEAT_TSTOP twice each in this process:
    the same step counts and bitwise the same waveforms."""
    equal = {}
    for cell in ("D", "E"):
        runs = [lv1_run(torch, T, gesp_lu, fc, lv1, cell,
                        LV1_REPEAT_TSTOP)[0] for _ in range(2)]
        equal[cell] = all(
            (a.n_accepted, a.n_rejected, a.n_newton)
            == (b.n_accepted, b.n_rejected, b.n_newton)
            and np.array_equal(a.ts, b.ts) and np.array_equal(a.xs, b.xs)
            for a, b in zip(*runs))
    log("lv1_repeat", bitwise_equal=equal, tstop=LV1_REPEAT_TSTOP)
    if not all(equal.values()):
        raise AssertionError(f"the level-1 leg is not reproducible: {equal}")
    return equal


def phase_lv1_fused_kernel(torch, T, fc, lv1, plan):
    """Phase 11: the fused chord kernel on the level-1 plan against its
    plain version at 256 lanes (h = 1e-12 and 1e-10), and its times and
    bound at 256 and 8 lanes."""
    info = plan.build()
    worst = dict(xn=0.0, S=0.0, Q=0.0)
    abs_err, nnwt = 0.0, []
    for h in (1e-12, 1e-10):
        args, opts = kt.fused_args(torch, T, plan, lv1[:4], h)
        k1, err = fused_vs_plain(torch, fc, plan, args, opts,
                                 f"lv1 h={h}", worst)
        abs_err = max(abs_err, err["xn_abs"])
        nnwt.append([int(k1[3][:, 1].min()), int(k1[3][:, 1].max())])
    times, bounds = {}, {}
    n = lv1[0].n_x
    for B in (LV1_LANES, N_LANES):
        args, opts = kt.fused_args(torch, T, plan, lv1[:4], 1e-12,
                                   lanes=slice(0, B))

        def run(a=args):
            return fc.fused_chord(plan, *a, opts)
        times[B] = (kt.device_ms(run), kt.call_ms(run, 50),
                    kt.call_ms(lambda a=args: fc.fused_chord_plain(
                        plan, *a, opts), 5))
        bounds[B], counted = fused_bound(plan, args, run())
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if any(w in ln for w in ("Function properties", "registers",
                                      "spill"))]
    log("lv1_fused_kernel", worst_rel_err=worst, nnwt_min_max=nnwt,
        ms_device_call_plain={f"{B}x{n}": list(v) for B, v in times.items()},
        bound_ms={f"{B}x{n}": v for B, v in bounds.items()}, nodes=counted,
        n_inst=plan.n_inst, threads=plan.threads, smem_bytes=plan.smem_bytes,
        emit_s=info["emit_seconds"], nvcc_s=info["nvcc_seconds"],
        ptxas=ptxas, header=os.path.relpath(info["path"], REPO))
    return abs_err, times, bounds


def phase_simulate(torch, T, dev):
    """Phase 13: simulate() on the card against the same call on the
    CPU."""
    from cedarsim_tpu_torch.benchmarks import netlists
    out = {}
    for name, text, times in (
            ("readme_inverter", netlists.README_INVERTER,
             netlists.README_TIMES),
            ("all_cards", netlists.ALL_CARDS, netlists.ALL_CARDS_TIMES)):
        t0 = time.perf_counter()
        rc = T.simulate(text, device=dev)
        wall = time.perf_counter() - t0
        rp = T.simulate(text, device="cpu")
        comp = rc["compiled"]
        if comp.device.type != "cuda":
            raise AssertionError(f"{name}: compiled on {comp.device}")
        sc, sp = rc["tran"], rp["tran"]
        if not (sc.converged and sp.converged):
            raise AssertionError(f"{name}: converged card {sc.converged}, "
                                 f"cpu {sp.converged}")
        nodes = comp.n_nodes
        dc_err = float(np.abs(sc.xs[0, :nodes] - sp.xs[0, :nodes]).max())
        wave_err = max(abs(float(sc.interp(nn, t)) - float(sp.interp(nn, t)))
                       for nn in comp.node_names for t in times)
        if not (dc_err <= SIM_DC_TOL and wave_err <= SIM_WAVE_TOL):
            raise AssertionError(f"{name}: card vs cpu operating point "
                                 f"{dc_err:.3g} V, waveform {wave_err:.3g} V")
        out[name] = dict(dc_err=dc_err, wave_err=wave_err, wall_s=wall,
                         card=[sc.n_accepted, sc.n_rejected, sc.n_newton],
                         cpu=[sp.n_accepted, sp.n_rejected, sp.n_newton])
    log("simulate", **out)


def phase_sweeps(torch, T, dev):
    """Phase 14: sweeps on the card against the same calls on the CPU."""
    from cedarsim_tpu_torch.analysis import montecarlo, sweeps
    from cedarsim_tpu_torch.frontend.elaborate import load_spice
    divider = "* divider\nV1 vin 0 1\nR1 vin vmid 1k\nR2 vmid 0 1k\n.op\n"
    tc1 = ("* tc1 divider\nV1 vin 0 1\nR1 vin vmid 1k tc1=0.002 tnom=27\n"
           "R2 vmid 0 1k\n.op\n")
    cases = {
        "product": lambda d: sweeps.dc_sweep(
            load_spice(divider), sweeps.ProductSweep(
                sweeps.Sweep("v1.dc", [0.5, 1.0, 2.0]),
                sweeps.Sweep("r1.r", [5e2, 1e3, 3e3])), device=d),
        "temp": lambda d: sweeps.dc_sweep(
            load_spice(tc1), sweeps.Sweep("temp", [-40.0, 27.0, 85.0,
                                                   125.0]), device=d),
        "mc_dc_256": lambda d: montecarlo.mc_dc(
            load_spice(divider), 256, {"r2.r": ("rel", 0.05),
                                       "r1.r": 20.0}, seed=3, device=d),
        "simulate_dc": lambda d: T.simulate(
            "* dc\nv1 a 0 1\nv2 c 0 1\nr1 a b 1k\nr2 b c 2k\n"
            ".dc v1 0 1 0.25 v2 1 2 0.5\n", device=d)["dc"],
    }
    out = {}
    for name, run in cases.items():
        t0 = time.perf_counter()
        rc = run(dev)
        wall = time.perf_counter() - t0
        rp = run("cpu")
        if rc.x.device.type != "cuda":
            raise AssertionError(f"sweep {name} ran on {rc.x.device}")
        if not (bool(rc.converged.all()) and bool(rp.converged.all())):
            raise AssertionError(f"sweep {name}: not every point converged")
        err = float((rc.x.cpu() - rp.x).abs().max())
        if not err <= SIM_DC_TOL:
            raise AssertionError(f"sweep {name}: card vs cpu {err:.3g} V")
        out[name] = dict(points=int(rc.x.shape[0]), max_abs_err=err,
                         wall_s=wall)
    log("sweeps", **out)


def pvt_lanes(torch, dev):
    """The PVT sweep's 256 lanes on the card: the harness's set-up
    (``pvt_sweep.PVT``), the chunk's params and each lane's operating
    point (the light ladder from the nominal one)."""
    from cedarsim_tpu_torch.benchmarks import pvt_sweep
    t0 = time.perf_counter()
    pvt = pvt_sweep.PVT(dev)
    vdds, wscs = pvt_sweep.grid(PVT_POINTS)
    pb = pvt.chunk_params(vdds, wscs)
    x0, _ = pvt.lane_ops(pb)
    return pvt, pb, x0, time.perf_counter() - t0


def phase_pvt(torch, gesp_lu, fc, dev, pvt_state, plan):
    """Phase 15: the 256-point PVT sweep through its entry point on the
    harness built by ``pvt_lanes`` (whose seconds are the set-up), B1's
    launches counted from 0 around it; ``plan`` (the one phase 16 checks)
    must be the only fused plan it launched."""
    from cedarsim_tpu_torch.benchmarks import pvt_sweep
    pvt = pvt_state[0]
    fc.fused_chord.launches = 0
    gesp_lu.lu_factor_gesp_f32.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pvt_sweep.run_chunked(PVT_POINTS, PVT_POINTS, PVT_SEGMENTS,
                                device=dev, details=True, pvt=pvt)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    chunk, = res.pop("chunks")
    launches = {"fused": fc.fused_chord.launches,
                "factor": gesp_lu.lu_factor_gesp_f32.launches}
    rescued = {int(k): v[0] for k, v in chunk["rescued"].items()}
    log("pvt", **res, harness_setup_s=pvt_state[3], total_s=total,
        launches=launches,
        suspects=chunk["suspects"], rescued_lane_tier=rescued,
        attempts_per_window=chunk["attempts"],
        cell_b_attempts_8_lanes=CELL_B[3],
        lanes_finished_first_pass=int(chunk["finished"].sum()),
        card=smi())
    if res["engine"] != "fused" or res["dense_lu"] != "mixed":
        raise AssertionError(f"PVT engine {res['engine']}/"
                             f"{res['dense_lu']}, not the fused kernel")
    if not res["ok"]:
        raise AssertionError(f"PVT gate failed: worst rail error "
                             f"{res['worst_rail_err']}, tiers "
                             f"{res['tiers']}")
    if launches["fused"] < res["attempts"] or launches["fused"] <= 0:
        raise AssertionError(f"PVT: {launches['fused']} B1 launches for "
                             f"{res['attempts']} step attempts")
    plans = list(pvt.comp._fused_plans.values())
    if len(plans) != 1 or plans[0] is not plan:
        raise AssertionError(f"PVT: {len(plans)} fused plans, not only the "
                             "one phase 16 checks")
    got = (res["accepted"], res["rejected"], res["newton"], res["attempts"])
    if CELL_P is not None and got != CELL_P:
        raise AssertionError(f"PVT counts (accepted, rejected, Newton, "
                             f"attempts) {got}, recorded {CELL_P}")
    return res, launches


def phase_pvt_fused_kernel(torch, T, fc, pvt_state, plan):
    """Phase 16: B1 on the PVT plan against its plain version at 256 lanes
    (h = 1e-12 and 1e-10), and its times and bound there."""
    pvt, pb, x0, t_setup = pvt_state
    lanes = (pvt.comp, pvt.ctx, pb, x0)
    info = plan.build()
    worst = dict(xn=0.0, S=0.0, Q=0.0)
    abs_err, nnwt = 0.0, []
    for h in (1e-12, 1e-10):
        args, opts = kt.fused_args(torch, T, plan, lanes, h)
        k1, err = fused_vs_plain(torch, fc, plan, args, opts,
                                 f"pvt h={h}", worst)
        abs_err = max(abs_err, err["xn_abs"])
        nnwt.append([int(k1[3][:, 1].min()), int(k1[3][:, 1].max())])
    args, opts = kt.fused_args(torch, T, plan, lanes, 1e-12)

    def run():
        return fc.fused_chord(plan, *args, opts)
    times = (kt.device_ms(run), kt.call_ms(run, 20),
             kt.call_ms(lambda: fc.fused_chord_plain(plan, *args, opts), 3))
    bnd, counted = fused_bound(plan, args, run())
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if any(w in ln for w in ("Function properties", "registers",
                                      "spill"))]
    n = pvt.comp.n_x
    log("pvt_fused_kernel", lanes_setup_s=t_setup, worst_rel_err=worst,
        nnwt_min_max=nnwt,
        shape=[PVT_POINTS, n], ms_device_call_plain=list(times),
        bound_ms=bnd, nodes=counted, per_lane_leaves=[
            f"{k}.{pn}" for k, pn in fc.split_lanes(pvt.comp, pb)[1]],
        threads=plan.threads, smem_bytes=plan.smem_bytes,
        emit_s=info["emit_seconds"], nvcc_s=info["nvcc_seconds"],
        ptxas=ptxas, header=os.path.relpath(info["path"], REPO))
    return abs_err, times, bnd


def phase_pvt_xla(torch, gesp_lu, fc, dev):
    """Phase 17: the harness through the GESP kernels (``impl="xla"``),
    16 points over 0-100 ns, its counts those of the same call on the
    CPU."""
    from cedarsim_tpu_torch.benchmarks import pvt_sweep
    fc.fused_chord.launches = 0
    gesp_lu.lu_factor_gesp_f32.launches = 0
    gesp_lu.lu_subst_gesp_f32.launches = 0
    torch.cuda.synchronize()
    res = pvt_sweep.run_chunked(PVT_XLA_POINTS, PVT_XLA_POINTS, PVT_SEGMENTS,
                                "xla", PVT_XLA_TSTOP, device=dev)
    torch.cuda.synchronize()
    launches = {"fused": fc.fused_chord.launches,
                "factor": gesp_lu.lu_factor_gesp_f32.launches,
                "subst": gesp_lu.lu_subst_gesp_f32.launches}
    t0 = time.perf_counter()
    cpu = pvt_sweep.run_chunked(PVT_XLA_POINTS, PVT_XLA_POINTS, PVT_SEGMENTS,
                                "xla", PVT_XLA_TSTOP, device="cpu")
    cpu_s = time.perf_counter() - t0

    def counts(r):
        return (r["accepted"], r["rejected"], r["newton"], r["attempts"])
    got, want = counts(res), counts(cpu)
    log("pvt_xla", **res, launches=launches, cpu_counts=want,
        cpu_ok=cpu["ok"], cpu_s=cpu_s, card=smi())
    if launches["fused"] or min(launches["factor"], launches["subst"]) <= 0:
        raise AssertionError(f"PVT xla: kernels {launches}")
    if not res["ok"] or res["engine"] != "xla" or res["dense_lu"] != "mixed":
        raise AssertionError(f"PVT xla: {res}")
    if got != want or not cpu["ok"]:
        raise AssertionError(f"PVT xla counts (accepted, rejected, Newton, "
                             f"attempts) {got}, the CPU's {want}")
    return launches


def phase_ac_noise(torch, T, gesp_lu, pivot_lu, fc, dev):
    """Phase 18: AC and noise on the card (see the module docstring)."""
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch import config
    from cedarsim_tpu_torch.analysis.ac import _system
    from cedarsim_tpu_torch.core.compile import default_ctx
    counters = (gesp_lu.lu_factor_gesp_f32, gesp_lu.lu_subst_gesp_f32,
                gesp_lu.lu_solve_gesp_f32, pivot_lu.lu_solve_pivot_f32,
                fc.fused_chord)
    for k in counters:
        k.launches = 0
    inc = [netlists.DFF_DIR]
    text = netlists.dff_ac_noise()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = T.simulate(text, include_paths=inc, device=dev)
    torch.cuda.synchronize()
    sim_wall = time.perf_counter() - t0
    rp = T.simulate(text, include_paths=inc, device="cpu")
    cpu_wall = time.perf_counter() - t0 - sim_wall
    comp = rc["compiled"]
    ac_c, ac_p, ns_c, ns_p = rc["ac"], rp["ac"], rc["noise"], rp["noise"]
    if comp.device.type != "cuda" or ac_c.v.device.type != "cuda":
        raise AssertionError(f"AC ran on {ac_c.v.device}")
    if len(ac_c.freqs) != 751 or comp.n_x != 25 or comp.n_eps != 60:
        raise AssertionError(f"deck: {len(ac_c.freqs)} frequencies, n_x "
                             f"{comp.n_x}, {comp.n_eps} noise sources")
    op_err = float((ac_c.op_x.cpu() - ac_p.op_x).abs().max())
    vc, vp = ac_c.v.cpu(), ac_p.v
    ac_err = float(((vc - vp).abs().amax(1) / vp.abs().amax(1)).max())
    qc, qp = ac_c["q"], ac_p["q"]
    psd_err = float(np.max(np.abs(ns_c.psd - ns_p.psd) / ns_p.psd))
    if not (op_err <= SIM_DC_TOL and ac_err <= AC_RTOL
            and psd_err <= PSD_RTOL and np.all(np.isfinite(qc))
            and np.all(ns_c.psd > 0)):
        raise AssertionError(f"ac_noise: card vs cpu op {op_err:.3g} V, AC "
                             f"{ac_err:.3g}, PSD {psd_err:.3g}")
    total, inoise = ns_c.total(), ns_c.inoise()
    # the set-up (parse, compile, operating point), then each analysis
    # about that operating point
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nl = T.parse_spice(text)
    comp = T.compile_circuit(T.elaborate(nl, include_paths=inc), device=dev)
    ctx = default_ctx(comp)
    op = T.solve_dc(comp, ctx=ctx)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    freqs = ac_c.freqs
    T.ac(comp, freqs, ctx=ctx, x_op=op.x)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    T.noise(comp, "q", freqs, ctx=ctx, x_op=op.x)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    c_ac = ctx.with_mode(T.Modes.AC)
    eps_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        te = time.perf_counter()
        comp.eps_jacobian(op.x, c_ac)
        torch.cuda.synchronize()
        eps_s.append(time.perf_counter() - te)
    A, _ = _system(comp, op.x, c_ac, comp.params0, freqs)
    b = comp.ac_rhs().expand(A.shape[0], comp.n_x).contiguous()
    solve = kt.library_times(lambda: torch.linalg.solve(A, b), 10)
    n = comp.n_x
    # complex LU and two substitutions: 8 real operations a complex
    # multiply-add, ~(2/3)n³ + 2n² of them a system
    solve_bound = bound(A.numel() * 16 + 2 * b.numel() * 16,
                        A.shape[0] * 8 * (2 * n ** 3 / 3 + 2 * n * n),
                        "float64")
    # the inverter deck on the card: the structural gates
    inv = T.simulate(netlists.INVERTER_NOISE, include_paths=inc,
                     device=dev)["noise"]
    f, s = inv.freqs, np.sqrt(inv.psd)
    pl = s[f <= 1e6]
    flat = float(np.ptp(pl) / pl.mean())
    m = (f >= 1e12) & (f <= 1e15)
    slope = float(np.polyfit(np.log10(f[m]), np.log10(s[m]), 1)[0])
    corner = float(f[np.argmax(s < 0.5 * s[0])])
    if not (flat < 5e-3 and abs(slope + 1.0) < 0.01
            and 1e9 <= corner <= 1e11):
        raise AssertionError(f"inverter gates: plateau {flat:.3g}, slope "
                             f"{slope:.4f}, corner {corner:.3g} Hz")
    # an RC low-pass on the card: the corner and kT/C
    r, cap = 10e3, 1e-9
    rc_ckt = T.Circuit()
    vin, out = rc_ckt.net("vin"), rc_ckt.net("out")
    rc_ckt.add(T.VSource, "V1", (vin, rc_ckt.gnd), dict(dc=0.0, ac=1.0))
    rc_ckt.add(T.Resistor, "R1", (vin, out), dict(r=r))
    rc_ckt.add(T.Capacitor, "C1", (out, rc_ckt.gnd), dict(c=cap))
    rc_comp = T.compile_circuit(rc_ckt, device=dev)
    h = T.ac(rc_comp, [1.0 / (2 * np.pi * r * cap)])["out"]
    h_err = abs(abs(complex(h[0])) - 2 ** -0.5)
    kt_total = T.noise(rc_comp, "out", T.acdec(48, 1.0, 1e9)).total()
    ktc = (config.K_BOLTZMANN * (27.0 + config.T_ZERO_C) / cap) ** 0.5
    ktc_err = abs(kt_total - ktc) / ktc
    if not (h_err <= RC_H_TOL and ktc_err <= KTC_RTOL):
        raise AssertionError(f"RC: |H| error {h_err:.3g}, kT/C error "
                             f"{ktc_err:.3g}")
    launches = {k.__name__: k.launches for k in counters}
    if any(launches.values()):
        raise AssertionError(f"a hand-written kernel launched: {launches}")
    log("ac_noise", frequencies=len(freqs), n_x=n, noise_sources=comp.n_eps,
        simulate_card_s=sim_wall, simulate_cpu_s=cpu_wall,
        setup_s=t1 - t0, ac_wall_s=t2 - t1, noise_wall_s=t3 - t2,
        eps_jacobian_s=min(eps_s), solve_shape=list(A.shape),
        solve_call_ms=solve["call_ms"], solve_device_ms=solve["device_ms"],
        solve_device_by=solve["device_by"], solve_bound_ms=solve_bound[0],
        solve_bound_by=solve_bound[1], op_err_v=op_err, ac_rel_err=ac_err,
        psd_rel_err=psd_err, q_gain_1hz=abs(complex(qc[0])),
        q_psd_1hz=float(ns_c.psd[0]), total_v=total,
        inoise_1hz=float(inoise[0]), inverter=dict(
            plateau_ptp=flat, slope=slope, corner_hz=corner,
            sqrt_psd_1khz=float(s[0])),
        rc=dict(h_err=h_err, ktc_rel_err=ktc_err), launches=launches,
        card=smi())


#: phase 19: the JAX package's large-circuit transient, the 40-cell BSIM4
#: shift register (452 unknowns) through the sparse Newton path, and the
#: sparse DC against the dense one on the card (float64 both)
CHAIN_CELLS = 40
CHAIN_N_X = 452
SPARSE_DC_TOL = 1e-9
#: cell F's counts (accepted, rejected, Newton, attempts): those of the JAX
#: package's CPU run of the same chain, which the card has matched since the
#: sparse path came
CELL_F = (2506, 655, 6998, 3160)
#: S1/S2's lane counts in phase 19's kernel checks
SPARSE_LANES = (1, 8)
#: phase 19's lane-batched run of the chain: lanes and window
SPARSE_BATCH = 2
CHAIN_LANES_TSTOP = 1e-9
#: phase 19's ẋ0 of the chain (ROADMAP C7): the most device memory its
#: set-up may take above what was allocated before it (the normal matrix
#: CᵀC in O(n²); the broadcast product it replaced held n³ float64, 0.74 GB)
XDOT0_PEAK_LIMIT = 10 * 2 ** 20
#: ROADMAP C6's witness: the level-1 chain of 21 cells, 11·21 + 12 = 243
#: unknowns (above the 240 the GESP kernels hold, below the sparse path's
#: 256), at 2 lanes over 0-1 ns through dense_lu="auto", which must take the
#: exact float64 solve; the card against the CPU from the same operating
#: point (the exact solve on both, other summation orders in the walks)
C6_CELLS = 21
C6_N_X = 243
C6_LANES = 2
C6_TSTOP = 1e-9
C6_TOL = 1e-9


def same_plan(a, b):
    """Two sparse LU plans equal field by field, array by array."""
    for f in dataclasses.fields(a):
        u, w = getattr(a, f.name), getattr(b, f.name)
        if isinstance(u, tuple):
            flat = [(x, y) for uu, ww in zip(u, w)
                    for x, y in (zip(uu, ww) if isinstance(uu, tuple)
                                 else [(uu, ww)])]
            if len(u) != len(w) or not all(np.array_equal(x, y)
                                           for x, y in flat):
                return False
        elif not np.array_equal(u, w):
            return False
    return True


def sparse_bound(plan, L, kind):
    """S1's or S2's bound for one launch at L lanes, from this plan: the
    values, right-hand side and solution moved once (float64) and the int32
    schedule arrays read once; the operations of the plan's levels (a
    division, a multiply and a subtract per term, a comparison per boost)."""
    from cedarsim_tpu_torch.ops import sparse_lu
    sch = sparse_lu.schedule(plan, "cpu").kernel
    if kind == "factor":
        idx = sum(sch[k].numel() * 4 for k in sparse_lu.FACTOR_ARRAYS)
        nbytes = 2 * 8 * L * plan.nnz_f + idx
        ops = L * (sch["div_dst"].numel() + 2 * sch["term_l"].numel()
                   + sch["piv"].numel() + plan.n)
    else:
        idx = sum(sch[k].numel() * 4 for k in sparse_lu.SOLVE_ARRAYS)
        nbytes = 8 * L * (plan.nnz_f + 2 * plan.n) + idx
        ops = L * (2 * (sch["fw_pos"].numel() + sch["bw_pos"].numel())
                   + plan.n)
    return bound(nbytes, ops, "float64")


def xdot0_memory(torch, T, comp, x_op, ctx):
    """Phase 19's ẋ0 of the chain (``tran.xdot0_and_mask``, one stream at
    the operating point, as ``tran`` calls it) and of its normal matrix
    (``linalg.normal_matrix``) alone: each one's peak device memory above
    what was allocated before it, bytes."""
    from cedarsim_tpu_torch.analysis.tran import xdot0_and_mask
    from cedarsim_tpu_torch.ops import linalg
    x = x_op[None]
    c_op = ctx.with_mode("tranop").at_time(0.0)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, out
    whole, (xd0, _) = peak(lambda: xdot0_and_mask(comp, x, c_op,
                                                  comp.params0))
    _, _, _, C = comp.res_jacs_fwd(x, ctx.with_mode("tran").at_time(0.0),
                                   comp.params0)
    normal, _ = peak(lambda: linalg.normal_matrix(C))
    if not bool(torch.isfinite(xd0).all()) or whole > XDOT0_PEAK_LIMIT:
        raise AssertionError(f"chain ẋ0: {whole} bytes above the baseline "
                             f"(limit {XDOT0_PEAK_LIMIT}), finite "
                             f"{bool(torch.isfinite(xd0).all())}")
    return dict(peak_bytes=whole, normal_matrix_peak_bytes=normal,
                broadcast_product_bytes=8 * comp.n_x ** 3,
                limit_bytes=XDOT0_PEAK_LIMIT)


def c6_chain(torch, T, dev, counters):
    """ROADMAP C6 on the card: the 21-cell level-1 chain (243 unknowns) at
    ``C6_LANES`` lanes over 0-``C6_TSTOP`` through ``tran`` with
    ``dense_lu="auto"``, which must resolve to the exact solve ("jax"), and
    an explicit "mixed" must raise naming ``dense_lu="jax"`` and
    ``sparse=True``: no kernel of the port launched, each lane bitwise the
    one stream, the one stream within ``C6_TOL`` of the same call on the
    CPU from the same operating point."""
    from cedarsim_tpu_torch.analysis.tran import resolve_impl
    from cedarsim_tpu_torch.benchmarks import chain_transient as ct
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.core.compile import use_sparse_solver
    from cedarsim_tpu_torch.ops import gesp_lu
    comp = netlists.chain(C6_CELLS, device=dev)
    if comp.n_x != C6_N_X or use_sparse_solver(comp):
        raise AssertionError(f"C6 chain: {comp.n_x} unknowns, sparse "
                             f"{use_sparse_solver(comp)}")
    opts = T.TranOptions(max_steps=4096)
    limit = gesp_lu.max_n(dev)
    resolved = resolve_impl(comp, opts, batched=True).dense_lu
    if not limit < C6_N_X or resolved != "jax":
        raise AssertionError(f"C6: 'auto' gives {resolved!r} at "
                             f"{C6_N_X} unknowns, GESP limit {limit}")
    try:
        resolve_impl(comp, T.TranOptions(dense_lu="mixed"), batched=True)
        raise AssertionError("C6: an explicit 'mixed' above the GESP limit "
                             "did not raise")
    except ValueError as e:
        if "dense_lu='jax'" not in str(e) or "sparse=True" not in str(e):
            raise AssertionError(f"C6: 'mixed' raised {e!r}") from e
    ctx = T.SimSpec.make(gmin=1e-15)
    op = T.solve_dc(comp, ctx=ctx, mode="tranop",
                    opts=T.NewtonOptions(**ct.DC_OPTS))
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes = T.tran(comp, (0.0, C6_TSTOP), ctx=ctx, opts=opts,
                   x0=op.x.expand(C6_LANES, -1).contiguous())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    one = T.tran(comp, (0.0, C6_TSTOP), ctx=ctx, opts=opts, x0=op.x)
    launches = {k.__name__: k.launches for k in counters}
    if any(launches.values()):
        raise AssertionError(f"C6: a kernel launched: {launches}")
    if not (one.converged and all(
            s.converged and np.array_equal(s.xs, one.xs)
            and np.array_equal(s.ts, one.ts) for s in lanes)):
        raise AssertionError("C6: a lane is not the one stream")
    cpu = T.tran(netlists.chain(C6_CELLS, device="cpu"), (0.0, C6_TSTOP),
                 ctx=ctx, opts=opts, x0=op.x.cpu())
    probe = np.linspace(0.0, C6_TSTOP, 11)
    err = max(float(np.abs(np.interp(probe, one.ts, one.xs[:, i])
                           - np.interp(probe, cpu.ts, cpu.xs[:, i])).max())
              for i in range(C6_N_X))
    if not (cpu.converged and err <= C6_TOL):
        raise AssertionError(f"C6: card against CPU {err:.3g} V")
    return dict(cells=C6_CELLS, n_x=comp.n_x, gesp_max_n=limit,
                lanes=C6_LANES, tstop=C6_TSTOP, dense_lu=resolved,
                wall_s=wall, accepted=one.n_accepted,
                rejected=one.n_rejected, newton=one.n_newton,
                cpu_counts=[cpu.n_accepted, cpu.n_rejected, cpu.n_newton],
                card_vs_cpu_v=err, bitwise_one_stream=True,
                launches=launches)


def sparse_main_path(torch, T, gesp_lu, pivot_lu, fc, dev):
    """Phase 19's main path: the 40-cell BSIM4 chain through the
    benchmark's entry point (compile, plan, operating point, transient),
    every kernel count from 0 just before it and read just after, with its
    gates.  Returns (the benchmark's record, the launches, the operating
    point as numpy)."""
    from cedarsim_tpu_torch.benchmarks import chain_transient as ct
    from cedarsim_tpu_torch.core.compile import use_sparse_solver
    from cedarsim_tpu_torch.ops import sparse_lu
    counters = (gesp_lu.lu_factor_gesp_f32, gesp_lu.lu_subst_gesp_f32,
                gesp_lu.lu_solve_gesp_f32, pivot_lu.lu_solve_pivot_f32,
                fc.fused_chord, sparse_lu.factor, sparse_lu.solve_factored)
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    rec = ct.run(CHAIN_CELLS, "bsim4", device=dev)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    sol = rec.pop("sol")
    comp = sol.compiled
    if not (rec["path"] == "sparse" and use_sparse_solver(comp)
            and comp.n_x == CHAIN_N_X and comp.device == dev):
        raise AssertionError(f"chain: n_x {comp.n_x}, path {rec['path']}, "
                             f"on {comp.device}")
    if not rec["ok"]:
        raise AssertionError(f"chain gate: worst {rec['worst_gate_err']}, "
                             f"converged {rec['converged']}")
    got = (rec["accepted"], rec["rejected"], rec["newton"], rec["attempts"])
    if got != CELL_F:
        raise AssertionError(f"cell F: counts (accepted, rejected, Newton, "
                             f"attempts) {got}, recorded {CELL_F}")
    dense_kernels = {k: n for k, n in launches.items()
                     if k not in ("factor", "solve_factored")}
    if any(dense_kernels.values()):
        raise AssertionError(f"a dense kernel launched on the sparse path: "
                             f"{dense_kernels}")
    if rec["launches"]["factor"] < rec["attempts"] or \
            min(launches["factor"], launches["solve_factored"]) <= 0:
        raise AssertionError(f"S1/S2 launches {launches}, transient "
                             f"{rec['launches']}, {rec['attempts']} attempts")
    if not np.isfinite(sol.xs).all() or sol.xs.shape[1] != CHAIN_N_X:
        raise AssertionError("chain: bad waveform")
    return rec, launches, sol.xs[0]


def sparse_child(out):
    """``--sparse-child OUT``: phase 19's main path on the card in a
    process of its own, its record, launches and operating point saved to
    OUT (numpy .npz)."""
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.ops import gesp_lu, pivot_lu
    from cedarsim_tpu_torch.ops import fused_chord as fc
    rec, launches, x_op = sparse_main_path(torch, T, gesp_lu, pivot_lu, fc,
                                           torch.device("cuda", 0))
    np.savez(out, rec=json.dumps(rec), launches=json.dumps(launches),
             x_op=x_op)


def start_sparse_child():
    """Phase 19's main path in a child process (``sparse_child``), started
    after phase 8 so that the chain's transient, host-bound on its own
    core, runs beside phases 9-18.  Returns (scratch directory, {"19":
    (output path, stderr file, process)}), as ``start_repeat_children``;
    ``stop_children`` ends it."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sparse_")
    out = os.path.join(tmp, "sparse.npz")
    err = open(os.path.join(tmp, "stderr.txt"), "w")
    p = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sparse-child", out],
        stdout=subprocess.DEVNULL, stderr=err)
    track_child("sparse", p)
    return tmp, {"19": (out, err, p)}


def join_sparse_child(child):
    """Wait for phase 19's child; returns what ``sparse_main_path`` did."""
    _, procs = child
    out, err, p = procs["19"]
    t0 = time.perf_counter()
    p.wait(timeout=1100)
    err.flush()
    if p.returncode != 0:
        with open(err.name) as f:
            raise AssertionError(f"phase 19's main path failed:\n"
                                 f"{f.read()[-4000:]}")
    z = np.load(out)
    return (json.loads(str(z["rec"])), json.loads(str(z["launches"])),
            z["x_op"], time.perf_counter() - t0)


def phase_sparse(torch, T, dev, main):
    """Phase 19 on what its main path (``sparse_main_path``) returned: the
    plan, the dense DC, the chain with lanes, S1 and S2 against their plain
    versions (see the module docstring).  Returns S1's and S2's kernel
    entries."""
    from cedarsim_tpu_torch.benchmarks import chain_transient as ct
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.core.sparse_ops import TAU, get_sparse_ops
    from cedarsim_tpu_torch.ops import gesp_lu, pivot_lu, sparse_lu
    from cedarsim_tpu_torch.ops import fused_chord as fc
    rec, launches, x_op, waited_s = main
    b = sparse_lu.build()
    comp = netlists.chain(CHAIN_CELLS, models="bsim4", device=dev)
    counters = (gesp_lu.lu_factor_gesp_f32, gesp_lu.lu_subst_gesp_f32,
                gesp_lu.lu_solve_gesp_f32, pivot_lu.lu_solve_pivot_f32,
                fc.fused_chord, sparse_lu.factor, sparse_lu.solve_factored)
    for k in counters:
        k.launches = 0
    # the plan built on the card, bitwise the one built on the CPU
    sops = get_sparse_ops(comp)
    plan = sops.plan
    cpu_plan = get_sparse_ops(netlists.chain(CHAIN_CELLS, models="bsim4",
                                             device="cpu")).plan
    if not same_plan(plan, cpu_plan):
        raise AssertionError("the plan built on the card is not the CPU's")
    # the operating point (row 0 of the transient), sparse against dense
    ctx = T.SimSpec.make(gmin=1e-15)
    x_op = torch.as_tensor(x_op, device=dev)
    dense = T.compile_circuit(comp.circuit, sparse=False, device=dev)
    t0 = time.perf_counter()
    opd = T.solve_dc(dense, ctx=ctx, mode="tranop",
                     opts=T.NewtonOptions(**ct.DC_OPTS))
    torch.cuda.synchronize()
    dense_dc_s = time.perf_counter() - t0
    dc_err = float((x_op - opd.x).abs().max())
    if not (bool(opd.converged) and dc_err <= SPARSE_DC_TOL):
        raise AssertionError(f"chain DC: dense {bool(opd.converged)}, "
                             f"sparse against dense {dc_err:.3g}")
    # ẋ0's device memory (C7), and C6's witness
    xdot0 = xdot0_memory(torch, T, comp, x_op, ctx)
    c6 = c6_chain(torch, T, dev, counters)
    for k in counters:
        k.launches = 0
    # the chain with a lane axis: SPARSE_BATCH lanes from the operating
    # point over 0-CHAIN_LANES_TSTOP through the sparse path (S1/S2 at L
    # lanes, no dense kernel), each lane bitwise the one stream
    f0 = sparse_lu.factor.launches
    topts = T.TranOptions(**ct.TRAN_OPTS)
    t0 = time.perf_counter()
    batch = T.tran(comp, (0.0, CHAIN_LANES_TSTOP), ctx=ctx, opts=topts,
                   x0=x_op.expand(SPARSE_BATCH, -1).contiguous())
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    one = T.tran(comp, (0.0, CHAIN_LANES_TSTOP), ctx=ctx, opts=topts,
                 x0=x_op)
    batch_launches = {k.__name__: k.launches for k in counters}
    if not (all(b.converged and np.array_equal(b.xs, one.xs)
                and np.array_equal(b.ts, one.ts) for b in batch)
            and one.converged):
        raise AssertionError("chain lanes: a lane is not the one stream")
    if sparse_lu.factor.launches <= f0 or any(
            n for k, n in batch_launches.items()
            if k not in ("factor", "solve_factored")):
        raise AssertionError(f"chain lanes: launches {batch_launches}")
    # S1 and S2 on the equilibrated J at the operating point
    c_op = ctx.with_mode("tranop")
    S, _, Gv, _ = sops.res_jacs_sparse(x_op, c_op)
    J = sops.add_diag(Gv, ctx.gmin)
    v1, dr, dc = sops.equilibrate(J)
    v1 = v1[None]
    tau = TAU
    rng = np.random.default_rng(19)
    entries = {}
    for L in SPARSE_LANES:
        v = v1.expand(L, -1) * torch.as_tensor(
            1.0 + 1e-3 * rng.standard_normal((L, 1)), device=dev)
        rhs = (S * dr)[None].expand(L, -1).contiguous()
        v = v.contiguous()
        f1 = sparse_lu.factor(plan, v, tau)
        f2 = sparse_lu.factor(plan, v, tau)
        fp = sparse_lu.factor_plain(plan, v, tau)
        x1 = sparse_lu.solve_factored(plan, fp, rhs)
        x2 = sparse_lu.solve_factored(plan, fp, rhs)
        xp = sparse_lu.solve_factored_plain(plan, fp, rhs)
        torch.cuda.synchronize()
        for name, k1, k2, p in (("S1", f1, f2, fp), ("S2", x1, x2, xp)):
            if not torch.equal(k1.view(torch.int64), k2.view(torch.int64)):
                raise AssertionError(f"{name} L={L}: two launches differ")
            if not torch.equal(k1.view(torch.int64), p.view(torch.int64)):
                raise AssertionError(f"{name} L={L}: not bitwise its plain "
                                     "version")
            if not bool(torch.isfinite(k1).all()):
                raise AssertionError(f"{name} L={L}: non-finite")
        # the dense library call on the same systems (a yardstick only)
        A = torch.zeros(L, comp.n_x, comp.n_x, dtype=torch.float64,
                        device=dev)
        rows = torch.as_tensor(plan.pos_arow, dtype=torch.int64, device=dev)
        cols = torch.as_tensor(plan.pos_acol, dtype=torch.int64, device=dev)
        A[:, rows, cols] = v
        LU, piv = torch.linalg.lu_factor(A)
        xl = torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]
        x_ref = dc * sparse_lu.solve_factored(plan, f1, rhs)[0]
        lib_err = float((xl[0] * dc - x_ref).abs().max()
                        / x_ref.abs().max())

        def s1(v=v):
            return sparse_lu.factor(plan, v, tau)

        def s2(fp=fp, rhs=rhs):
            return sparse_lu.solve_factored(plan, fp, rhs)
        entries[L] = {
            "factor": (kt.device_ms(s1), kt.call_ms(s1, 50),
                       kt.call_ms(lambda: sparse_lu.factor_plain(
                           plan, v, tau), 3),
                       *library_ms(lambda: torch.linalg.lu_factor(A), 20),
                       sparse_bound(plan, L, "factor")),
            "solve": (kt.device_ms(s2), kt.call_ms(s2, 50),
                      kt.call_ms(lambda: sparse_lu.solve_factored_plain(
                          plan, fp, rhs), 3),
                      *library_ms(lambda: torch.linalg.lu_solve(
                          LU, piv, rhs[..., None]), 20),
                      sparse_bound(plan, L, "solve")),
            "dense_lu_rel_diff": lib_err}
    log("sparse", n_x=comp.n_x, n_levels=plan.n_levels, nnz=plan.nnz,
        nnz_f=plan.nnz_f, forward_levels=len(plan.f_lev),
        backward_levels=len(plan.b_lev), plan_equal_cpu=True,
        dense_dc_s=dense_dc_s, dc_sparse_vs_dense_v=dc_err,
        lanes=dict(lanes=SPARSE_BATCH, tstop=CHAIN_LANES_TSTOP,
                   wall_s=batch_s, attempts=batch[0].n_attempts,
                   accepted=batch[0].n_accepted, bitwise_one_stream=True),
        kernel_times={f"L{L}": {k: (list(v) if isinstance(v, tuple) else v)
                                for k, v in e.items()}
                      for L, e in entries.items()},
        nvcc_s=b["seconds"], ptxas=[ln.strip() for ln in b["log"]
                                    .splitlines() if "registers" in ln],
        xdot0_memory=xdot0, c6=c6,
        transient=rec, launches=launches, waited_for_child_s=waited_s,
        wall_per_attempt_ms=1e3 * rec["wall_s"] / rec["attempts"],
        card=smi())
    out = {}
    for key, name, line in (("factor", "sparse_factor_f64", 493),
                            ("solve", "sparse_solve_f64", 548)):
        dev_ms, call, plain, lib, lib_dev, lib_by, bnd = entries[1][key]
        e8 = entries[8][key]
        out[key] = kernel_entry(
            name, "cedarsim_tpu_torch/csrc/sparse_lu.cu", None,
            launches["factor" if key == "factor" else "solve_factored"],
            dev_ms, call, plain, lib, lib_dev, lib_by, bnd, 0.0,
            jax_counterpart=f"cedarsim_tpu/ops/sparse_lu.py:{line}",
            shape=[1, plan.nnz_f], n=plan.n, n_levels=plan.n_levels,
            library_call=("torch.linalg.lu_factor" if key == "factor"
                          else "torch.linalg.lu_solve")
            + f" float64 [1, {plan.n}, {plan.n}]",
            eight_lanes={"shape": [8, plan.nnz_f], "device_ms": e8[0],
                         "call_ms": e8[1], "plain_ms": e8[2],
                         "library_ms": e8[3], "library_device_ms": e8[4],
                         "bound_ms": e8[6][0], "bound_by": e8[6][1]})
    return out


#: phase 8's kernel checks: the bench's two shapes, one system alone, an
#: odd batch at an odd n, the two sides of the one-warp regime's edge
#: (n = 32 in registers, n = 33 in shared memory), and the largest n a
#: block's shared memory holds
LU_CHECK_SHAPES = [(1, 25), (37, 11), (512, 25), (8, 32), (8, 33),
                   (64, 122), (4, 240)]


def check_solve(torch, name, fn, plain, A32, b32):
    """A dense solve kernel against its plain version on the same card
    tensors: two launches bitwise equal, and bitwise the plain version.
    Returns the largest absolute difference from the plain version (0.0,
    or it raises)."""
    x1 = fn(A32, b32)
    x2 = fn(A32, b32)
    xp = plain(A32, b32)
    torch.cuda.synchronize()
    if not bitwise(torch, x1, x2):
        raise AssertionError(f"{name}: two launches differ")
    if not bitwise(torch, x1, xp):
        fin = torch.isfinite(xp) & torch.isfinite(x1)
        err = float((x1[fin] - xp[fin]).abs().max()) if bool(fin.any()) \
            else float("nan")
        raise AssertionError(f"{name}: not bitwise its plain version "
                             f"(largest finite difference {err:.3g})")
    fin = torch.isfinite(xp)
    return float((x1[fin] - xp[fin]).abs().max()) if bool(fin.any()) else 0.0


def phase_lu(torch, gesp_lu, pivot_lu, dev):
    """Phase 8: B4 and B5 against their plain versions, the dense-LU
    bench at full width (both kernels must launch), and per-launch times
    at the bench's shapes.  Returns (launches, per-shape numbers)."""
    from cedarsim_tpu_torch.benchmarks import lu_bench
    solves = {"gesp": (gesp_lu.lu_solve_gesp_f32,
                       gesp_lu.lu_solve_gesp_f32_plain),
              "pivot": (pivot_lu.lu_solve_pivot_f32,
                        pivot_lu.lu_solve_pivot_f32_plain)}
    rng = np.random.default_rng(0)
    checked = []
    for B, n in LU_CHECK_SHAPES + [(16, 25)]:
        A, b = kt.dominant_systems(rng, B, n)
        pivot_forcing = (B, n) == (16, 25)
        for key, (fn, plain) in solves.items():
            Ak = A.copy()
            if key == "pivot":
                # rows shuffled per system: the kernel swaps at almost
                # every step; or a tiny corner that forces a swap at step
                # 0 (tests/test_pallas_lu.py:26)
                if pivot_forcing:
                    Ak[:, 0, 0] = 1e-8
                else:
                    Ak = np.stack([a[rng.permutation(n)] for a in Ak])
            elif pivot_forcing:
                continue        # GESP does not pivot: no such case
            A32 = torch.as_tensor(Ak, dtype=torch.float32, device=dev)
            b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
            check_solve(torch, f"{key} B={B} n={n}", fn, plain, A32, b32)
            checked.append([key, B, n])
    # the bench, at full width, through its entry point
    gesp_lu.lu_solve_gesp_f32.launches = 0
    pivot_lu.lu_solve_pivot_f32.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = lu_bench.main(["--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gesp": gesp_lu.lu_solve_gesp_f32.launches,
                "pivot": pivot_lu.lu_solve_pivot_f32.launches}
    if not all(r["ok"] for r in rows):
        raise AssertionError("dense-LU bench gate failed: "
                             f"{[r for r in rows if not r['ok']]}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"kernels not on the bench's path: {launches}")
    # per-launch times at the bench's shapes on the bench's systems
    per_shape = {}
    for B, n in lu_bench.SHAPES:
        A, b = lu_bench.make_systems(B, n)
        A32 = torch.as_tensor(A, dtype=torch.float32, device=dev)
        b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
        ent = {}
        for key, (fn, plain) in solves.items():
            err = check_solve(torch, f"{key} bench B={B} n={n}", fn,
                              plain, A32, b32)
            lib = library_ms(lambda: torch.linalg.solve_ex(A32, b32), 200)
            bnd = bound(4 * B * n * (n + 2), lu_ops(n, B, f"{key}_solve"),
                        "float32")

            def run(fn=fn):
                return fn(A32, b32)
            ent[key] = dict(
                max_abs_err=err, device_ms=kt.device_ms(run),
                call_ms=kt.call_ms(run, 200),
                plain_ms=kt.call_ms(lambda: plain(A32, b32), 3),
                library_ms=lib[0], library_device_ms=lib[1],
                library_device_by=lib[2], bound_ms=bnd[0], bound_by=bnd[1])
        # B2 then B3 back to back: the two-launch form of B4's function
        ent["factor_then_subst_ms"] = kt.call_ms(
            lambda: gesp_lu.lu_subst_gesp_f32(
                gesp_lu.lu_factor_gesp_f32(A32), b32), 200)
        per_shape[(B, n)] = ent
    log("lu_bench", bitwise_equal_to_plain=checked,
        bench_wall_s=wall, launches=launches,
        bench_us_per_solve={f"{r['variant']} {r['B']}x{r['n']}":
                            r["us_per_solve"] for r in rows},
        bench_rel_err={f"{r['variant']} {r['B']}x{r['n']}": r["rel_err"]
                       for r in rows},
        per_launch={f"{B}x{n}": v for (B, n), v in per_shape.items()},
        card=smi())
    return launches, per_shape


def kernel_entry(name, source, replaces, launches, device, call, plain_ms,
                 library, library_device, library_device_by, bnd,
                 max_abs_err, **extra):
    """One kernel of the ``kernels`` line.  ``ms``, ``plain_ms`` and
    ``library_ms`` are call times (a Python loop of calls between two
    events, as every ``ms`` since the port began); ``device_ms`` and
    ``library_device_ms`` are CUDA-graph replay times per launch."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": call, "device_ms": device,
            "call_ms": call, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library,
            "library_device_ms": library_device,
            "library_device_by": library_device_by, **extra}


def main():
    import threading
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.ops import gesp_lu, linalg, pivot_lu, sparse_lu
    from cedarsim_tpu_torch.ops import fused_chord as fc
    from cedarsim_tpu_torch.analysis.tran import fused_plan_for
    dev = torch.device("cuda", 0)
    card = smi()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are enabled")
    log("device", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    dff = dff_setup(torch, T, dev)
    t_lv1 = time.perf_counter()
    lv1 = kt.lv1_lanes(torch, T, dev)
    lv1 = (*lv1, time.perf_counter() - t_lv1)
    # every kernel source compiles at once, one nvcc process each: the
    # fused kernel with the BSIM4 model emitted from the DFF's plan, with
    # the level-1 plan's Mos1 and with the PVT plan's BSIM4 (W an input),
    # and the pivoting LU, in threads beside the GESP build
    t_plan = time.perf_counter()
    plan = fused_plan_for(dff[0], dff[1], dff[2])
    t_plan = time.perf_counter() - t_plan
    plan_lv1 = fused_plan_for(*lv1[:3])
    pvt_state = pvt_lanes(torch, dev)
    plan_pvt = fused_plan_for(pvt_state[0].comp, pvt_state[0].ctx,
                              pvt_state[1])
    built = {}

    def build_in_thread(name, fn):
        def run():
            try:
                built[name] = fn()
            except BaseException as e:      # re-raised after the join
                built[name] = e
        th = threading.Thread(target=run)
        th.start()
        return th

    th_fused = build_in_thread("fused", plan.build)
    th_lv1 = build_in_thread("fused_lv1", plan_lv1.build)
    th_pvt = build_in_thread("fused_pvt", plan_pvt.build)
    th_pivot = build_in_thread("pivot", pivot_lu.build)
    th_sparse = build_in_thread("sparse", sparse_lu.build)
    b = gesp_lu.build()
    th_pivot.join()
    if isinstance(built["pivot"], BaseException):
        raise built["pivot"]
    ptxas = {name: [ln.strip() for ln in lib["log"].splitlines()
                    if "registers" in ln]
             for name, lib in (("gesp_lu", b), ("pivot_lu", built["pivot"]))}
    log("build", seconds={"gesp_lu": b["seconds"],
                          "pivot_lu": built["pivot"]["seconds"]},
        path=[os.path.relpath(b["path"], REPO),
              os.path.relpath(built["pivot"]["path"], REPO)],
        ptxas=ptxas)
    children = [None, None]
    try:
        abs_err, times, bounds = phase_kernels(torch, gesp_lu, linalg, dev)
        # the repeat phase's children run beside phases 4-5 from here on,
        # after phase 3's kernel timings
        children[0] = start_repeat_children()
        phase_rc(T, dev)
        launches = phase_slice(torch, T, gesp_lu, linalg, dev, dff)
        phase_repeat(torch, T, dev, dff, children[0])
        th_fused.join()
        if isinstance(built["fused"], BaseException):
            raise built["fused"]
        fabs_err, ftimes, info, fbounds = phase_fused_kernel(
            torch, T, fc, dev, dff, plan, t_plan)
        flaunches = phase_fused_slice(
            torch, T, gesp_lu, fc, dev, dff,
            dict(plan_s=t_plan, emit_s=info["emit_seconds"],
                 nvcc_s=info["nvcc_seconds"]))
        lu_launches, per_shape = phase_lu(torch, gesp_lu, pivot_lu, dev)
        # phase 19's main path (the chain's transient) runs from here in a
        # child process beside phases 9-18; the kernel-timing phases 11
        # and 16 wait until it has ended, so that no other process shares
        # the card while they time
        th_sparse.join()
        if isinstance(built["sparse"], BaseException):
            raise built["sparse"]
        children[1] = start_sparse_child()
        phase_lv1_single(torch, T, gesp_lu, dev)
        dl = phase_lv1(torch, T, gesp_lu, fc, lv1, "D", CELL_D,
                       LV1_SHORT_TSTOP,
                       extra=dict(jac_shunt=kt.LV1_XLA_OPTS["jac_shunt"]))
        th_lv1.join()
        if isinstance(built["fused_lv1"], BaseException):
            raise built["fused_lv1"]
        el = phase_lv1(torch, T, gesp_lu, fc, lv1, "E", CELL_E, LV1_TSTOP)
        phase_lv1_repeat(torch, T, gesp_lu, fc, lv1)
        phase_simulate(torch, T, dev)
        phase_sweeps(torch, T, dev)
        th_pvt.join()
        if isinstance(built["fused_pvt"], BaseException):
            raise built["fused_pvt"]
        _, pl = phase_pvt(torch, gesp_lu, fc, dev, pvt_state, plan_pvt)
        xl = phase_pvt_xla(torch, gesp_lu, fc, dev)
        phase_ac_noise(torch, T, gesp_lu, pivot_lu, fc, dev)
        main19 = join_sparse_child(children[1])
        labs_err, ltimes, lbounds = phase_lv1_fused_kernel(torch, T, fc, lv1,
                                                           plan_lv1)
        pabs_err, ptimes, pbound = phase_pvt_fused_kernel(torch, T, fc,
                                                          pvt_state, plan_pvt)
        sparse_entries = phase_sparse(torch, T, dev, main19)
        src = "cedarsim_tpu_torch/csrc/gesp_lu.cu"
        b1p = ftimes["B1'"]
        n1 = lv1[0].n_x

        def lv1_entry(B):
            return {"shape": [B, n1], "device_ms": ltimes[B][0],
                    "call_ms": ltimes[B][1], "plain_ms": ltimes[B][2],
                    "bound_ms": lbounds[B][0], "bound_by": lbounds[B][1]}
        kernels = [
            kernel_entry("fused_chord_f64",
                         "cedarsim_tpu_torch/csrc/fused_chord.cu",
                         "cedarsim_tpu/ops/fused_chord.py:632",
                         flaunches["fused"], *ftimes["B1"], None, None, None,
                         fbounds["B1"], fabs_err,
                         also_replaces="cedarsim_tpu/ops/fused_chord.py:526",
                         shape=[N_LANES, dff[0].n_x],
                         one_lane={"shape": [1, dff[0].n_x],
                                   "launches": flaunches["fused_one_lane"],
                                   "device_ms": b1p[0], "call_ms": b1p[1],
                                   "plain_ms": b1p[2],
                                   "bound_ms": fbounds["B1'"][0],
                                   "bound_by": fbounds["B1'"][1]},
                         lv1={"model": "Mos1", "launches": el["fused"],
                              "max_abs_err": labs_err, **lv1_entry(LV1_LANES),
                              "eight_lanes": lv1_entry(N_LANES)},
                         pvt={"model": "BSIM4, W and VDD per lane",
                              "launches": pl["fused"], "max_abs_err": pabs_err,
                              "shape": [PVT_POINTS, pvt_state[0].comp.n_x],
                              "device_ms": ptimes[0], "call_ms": ptimes[1],
                              "plain_ms": ptimes[2], "bound_ms": pbound[0],
                              "bound_by": pbound[1]}),
        ]
        design = {
            "factor": "dense_solve.cuh FACTOR instantiation: one warp per "
                      "system, rows in registers, steps in panels of 4 "
                      "(factor_panels), at n <= 32; one block per system, "
                      "steps in pairs, above",
            "subst": "one warp per system, column order, system staged in "
                     "shared memory"}
        for key, line in (("factor", 313), ("subst", 354)):
            kernels.append(kernel_entry(
                f"gesp_{key}_f32", src,
                f"cedarsim_tpu/ops/pallas_lu.py:{line}",
                launches[key], *times[key], bounds[key], abs_err[key],
                shape=[N_LANES, 25], design=design[key],
                lv1_launches=dl[key], pvt_xla_launches=xl[key]))
        for key, name, source, line in (
                ("gesp", "gesp_solve_f32", src, 164),
                ("pivot", "pivot_solve_f32",
                 "cedarsim_tpu_torch/csrc/pivot_lu.cu", 50)):
            (B, n), *rest = list(per_shape)
            e = per_shape[(B, n)][key]
            kernels.append(kernel_entry(
                name, source, f"cedarsim_tpu/ops/pallas_lu.py:{line}",
                lu_launches[key], e["device_ms"], e["call_ms"], e["plain_ms"],
                e["library_ms"], e["library_device_ms"],
                e["library_device_by"],
                (e["bound_ms"], e["bound_by"]), e["max_abs_err"], shape=[B, n],
                other_shapes=[{"shape": list(s), **per_shape[s][key]}
                              for s in rest]))
        kernels += [sparse_entries["factor"], sparse_entries["solve"]]
        print(json.dumps({"kernels": kernels}))
        print(smi())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
    finally:
        for c in children:
            if c is not None:
                stop_children(c)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--repeat-child":
        repeat_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--sparse-child":
        sparse_child(sys.argv[2])
    else:
        main()
