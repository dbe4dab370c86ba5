#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises, so the exit code is not
0 and no result line is printed).  A line printed while a child process of
the smoke ran, or after one ran since the line before, gives
``beside_children_s``: for each child, the seconds since the previous line
during which it ran, so that a wall taken beside another process on the
card says so.

The schedule (ROADMAP C15): G-xla's child (phase 22, the longest run)
starts right after the device line, so that its set-up runs beside the
build; phases 3-10, 12-18, 37, 38's world of one, 40's path and 44 run in
the main process beside it and
beside the other children (phase 19's, G-fused's and phases 25-33's,
started after phase 8's checking half; phases 34-36's, started after
phase 12); every phase that times a kernel runs only after all those
children have ended, so that no other process shares the card while it
times: phases 3, 6, 8 and 19 check their kernels early and time them
there (``kernel_times``, ``fused_kernel_times``, ``lu_bench``,
``sparse``), with phases 20, 24, 11 and 16 and the kernel halves of 39
and 40.  Phase 39 runs in phase 19's child after its main path, phase 17
in a child of its own from phase 16's end.  Once every child but
G-xla's has ended, phase 38's two ranks (beside phase 43's set-up), the
one-stream kernel check (phases 35-36's plans) and phase 20's checking
half run beside G-xla's child alone, before its join.  A ``children``
line before the timing phases gives every child's start and end on the
smoke's clock.

1. device  — requires CUDA; prints the card's name and power limit; full
   float32 matmuls (no TF32).
2. build   — compiles every CUDA source of the checkout at once, one nvcc
   each: the GESP LU kernels, the pivoting LU kernel and the fused chord
   kernel with the BSIM4 model emitted from the DFF's plan (the DFF is set
   up on the card first), with the level-1, PVT, BSIM-CMG and VBIC plans'
   models (cells G's and V's 32 lanes are set up on the card while nvcc
   runs).
3. kernels — the GESP factor (B2) and substitution (B3) bitwise equal to
   their plain PyTorch versions on the card (random, equilibrated,
   diagonally dominant inputs from a fixed numpy seed; n from 8 to 240,
   with B = 8, 16 and 256 at n = 25 (the DFF cells' and the PVT xla
   run's shapes) and B = 32 at n = 85 (cell G's), n = 32 and 33
   on both sides of the factor's one-warp regime and n = 32, 33, 64, 96
   and 122 reaching each of the substitution's rows-per-lane paths; each kernel's two launches bitwise equal); the
   mixed chord solve against float64 ``torch.linalg.solve``.  Its timing
   half (``kernel_times``, after the children): kernel, plain and
   library-call times at the DFF transient's shape.
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
   equal; emit and nvcc seconds, ptxas registers and spills.  Its timing
   half (``fused_kernel_times``, after the children): kernel and plain
   times at 8 lanes and at one (B1'), the model walk's hoisted and
   per-evaluation node counts.
7. fused_slice — the DFF through the public ``tran()`` with
   ``newton_impl="fused"`` (the JAX package's fused configuration), gated
   like phase 5; one fused launch per batched step attempt; the step
   counts must be cell B's (``CELL_B``).
8. lu_check — the dense solve kernels B4 (fused GESP) and B5 (partial
   pivoting) bitwise equal to their plain versions at (B, n) in {(1, 25),
   (37, 11), (512, 25), (8, 32), (8, 33), (64, 122), (4, 240)} (both sides
   of the edge between the one-warp and the one-block regime) and a
   pivot-forcing case (two launches bitwise equal).  lu_bench, its
   timing half (after the children): the dense-LU bench
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
11. lv1_fused_kernel — (run after phase 37, once every child has
   ended, so that no other process shares the card while it times) the
   fused chord kernel on the level-1 plan (``Mos1``
   emitted) against its plain version on the 256 lanes, as phase 6;
   kernel, plain and bound times at 256 and 8 lanes; ptxas registers and
   spills of the ``Mos1`` build.
12. lv1_fused (cell E) — the 256 lanes through the fused configuration
   (``kernel_times.LV1_FUSED_OPTS``) over the whole 0-700 ns: the gate on
   every lane, one fused launch per step attempt, and cell E's counts
   (``CELL_E``).
   lv1_repeat — cells D and E over 0-60 ns twice each: bitwise equal
   (the second run of each is phase 38's world of one).
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
   "mixed"``): 16 points over 0-100 ns (``PVT_XLA_TSTOP``) in two
   windows, both GESP kernels launched, B1 not, the counts
   ``CELL_P_XLA``; every lane's counts in both windows equal to those of
   the same call with ``device="cpu"`` (the kernels' plain versions), run
   here after it (``CELL_P_XLA_CPU``), but for the lanes
   ``PVT_XLA_PARTED``, whose steps part in the second window at the 50 ns
   clock edge's breakpoint (the step controller's choice there follows
   the walk's last bits, which the card rounds apart from the CPU,
   ROADMAP C13's class): each side's counts there are held to its own
   recorded ones.  Then the same call on the card with B2 and B3 replaced
   by their plain versions: every lane's counts in both windows those of
   the kernels' run, so the lanes part by the card's walk, not by the
   kernels.  It runs in a child process (``--pvt-xla-child``,
   its line printed from its record), started once phase 16 has ended,
   beside phases 18-40 and 44.
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
   that runs beside phases 9-18 and 37 (each process host-bound on its
   own core; the walls of both include the sharing, which each of those
   phases' lines gives as ``beside_children_s``), every kernel count from 0 in
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
   printed.  Then, in the main process (``sparse_check``, after phase 37):
   its plan (built on the card, the probe on the CPU)
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
   lane bitwise the one stream; and, in the timing half (``sparse``, after
   phase 16), the sparse factor (S1,
   ``sparse_lu.factor``) and solve (S2, ``sparse_lu.solve_factored``) on
   the chain's equilibrated Jacobian at that operating point, at 1 and 8
   lanes: bitwise their plain versions, two launches bitwise equal; each
   one's device time (CUDA-graph replay) and call time, the plain
   version's, the dense library call on the same systems
   (``torch.linalg.lu_factor``/``lu_solve``, float64 [L, 452, 452]) and
   the bound.

20. cmg_fused_kernel — B1 on the CMG plan (the BSIM-CMG 107 walk
   emitted: 449 hoisted, 3,135 walk nodes) against its plain version on
   cell G's 32 lanes, as phase 6 with the leg's fused options (checked
   beside G-xla's child alone, before its join); its device, call and
   plain times (after every child has ended)
   and bound at [32, 85]; emit and nvcc seconds, ptxas's registers, stack
   and spills; shared memory a lane.
21. cmg_fused (cell G) — ``bench.py``'s BSIM-CMG DFF leg
   (``cedarsim_tpu_torch/benchmarks/cmg_dff.py``: ``dff_tb_cmg.cir``, 30
   BSIM-CMG FinFETs, 85 unknowns, NFIN·``linspace(0.99, 1.01)`` per lane,
   each lane from its own warm DC) at the JAX package's 32 lanes for it,
   through the public ``tran()`` with ``newton_impl="fused"`` (the cap
   form, ``jac_reuse=1``, the leg's tolerances) over 0-700 ns: the golden
   gate of ``golden_cmg.json`` (the nominal lane within 0.05 V at every
   point, every lane at 150, 250 and 700 ns), one B1 launch per batched
   step attempt, no GESP launch, the counts ``CELL_G_FUSED``; then its
   counts over 0-``G_CPU_TSTOP`` equal to the same call's on the CPU.
22. cmg_xla (cell G) — the same leg through the chord path with
   ``dense_lu="auto"``, which on the card is B2/B3 (``jac_shunt=1e-4``,
   ROADMAP Queue C), over 0-60 ns (``G_XLA_TSTOP``: across the first
   clock edge, CLKN falling over 50-51.02 ns; over 0-160 ns the 32 lanes
   in lockstep do not finish in 1,000 s, PERF.md §4): B2 and B3 launched
   at [32, 85], B1 not; on every lane the latch's clock nodes (cki, ncki)
   switched with the edge and q, which starts on either rail (the
   operating point's latch state), at the golden's first level (0 V)
   after it (``edge_crossed``); the counts ``CELL_G_XLA``; over
   0-``G_CPU_TSTOP`` the counts equal to the same call's on the CPU
   (``dense_lu="mixed"``, the kernels' plain versions), which phase 21's
   child runs: G-xla's child runs nothing on the host beside its own
   run.
   Phases 21 and 22 run in two child processes (one an engine, each
   setting its lanes up on the card): 22 from the start, beside the
   build and phases 3-18 and 37, 21 from phase 8 on, beside phases 9-18
   and 37, as
   phase 19's (every kernel count from 0 in that process just before its
   run and read just after); their lines are printed from their records
   once they have ended.
23. cmg_noise — the reference's BSIM-CMG inverter on the ASAP7 TT Spectre
   deck (``netlists.CMG_INVERTER_NOISE``) compiled on the card, its noise
   at q: √PSD within 1e-6 of the ngspice table, the PSD within
   ``CMG_PSD_RTOL`` of the same call on the CPU, no hand-written kernel
   launched.
24. vbic_fused_kernel — (run after phase 20) B1 on the VBIC plan (the
   VBIC walk emitted, its thermal node on the switched branch's I side)
   against its plain version on cell V's 32 lanes, as phase 20 with cell
   V's fused options (h = 1e-6 and 1e-4); its device, call and plain times
   and bound at [32, 12]; emit and nvcc seconds, ptxas's registers and
   spills.
25. vbic_fused (cell V) — the reference's bipolar amplifier on a VBIC
   card with self-heating (``benchmarks/vbic_amp.py``: 12 unknowns, AREA
   ·``linspace(0.99, 1.01)`` per lane, ``gmin=1e-12``) at 32 lanes over
   0-6 ms through ``newton_impl="fused"`` (``kernel_times.FUSED_OPTS``):
   on every lane the output's amplitude over 4-6 ms within 25 % of |AC
   gain at 500 Hz| × 1 mV (the gain from ``ac`` on the card at the lane's
   operating point), one B1 launch per batched step attempt, no GESP
   launch, the counts ``CELL_V_FUSED``; then its counts over
   0-``V_CPU_TSTOP`` equal to the same call's on the CPU.
26. vbic_xla (cell V) — the same through the chord path with
   ``dense_lu="auto"`` (B2/B3 at [32, 12]) and the Jacobian-only shunt of
   the other chord-path cells (1e-9: the thermal node's KCL row has no
   diagonal, ROADMAP Queue C), the counts ``CELL_V_XLA``, and over
   0-``V_CPU_TSTOP`` the CPU's (``dense_lu="mixed"``).
27. vbic_noise — the amplifier (one stream) compiled on the card, its
   noise at out over 10 Hz-10 MHz (VBIC's shot, flicker and resistor
   thermal sites, which B1 does not run): the PSD positive and within
   2·cond·eps of the same call on the CPU, cond the largest condition
   number of G + jωC at the CPU's operating point over the frequencies; no
   hand-written kernel launched.
28-29. lv1_bdf3, lv1_bdf5 (cells E-bdf3, E-bdf5) — cell E (the level-1
   DFF, 256 lanes, B1 on the ``Mos1`` plan, cell B's options) with
   ``method="bdf3"`` and ``"bdf5"`` over 0-700 ns: the level-1 gate on
   every lane, one B1 launch per batched step attempt, the counts
   ``CELL_E_BDF3``/``CELL_E_BDF5``, and over 0-``E_BDF_CPU_TSTOP`` the
   counts of the same call on the CPU.  Phase 11 also holds B1 at a
   uniform-step BDF3 and BDF5 start (its leading coefficient and history
   combination) against its plain version and times it at [256, 25].
   Phases 25-29 run first in the A14b child (``--a14b-both-child``,
   ``a14b_vbic_bdf``: first the CPU's side of their count comparisons,
   from the CPU's own lanes, then the card's runs) started after phase 8
   beside cell G's; their lines are printed from its record once it has
   ended.
30. lossy_link (cell O) — the JAX package's heavy-loss LTRA link
   (``benchmarks/lossy_link.py``: six ``LTRALine`` sections, 21 unknowns,
   12 ring slots) at 32 lanes, RL × ``linspace(0.9, 1.1)``, over 0-360 ns
   through ``dense_lu="auto"`` (B2/B3, ``jac_shunt=1e-6``): on every lane
   the first transit at 37 ns within 2 % of its closed form, b at 350 ns
   within 0.01 V of the divider, no ring underflow; B2/B3 launched, B1
   not; the counts ``CELL_O`` and the CPU's (``dense_lu="mixed"``).
   lossy_link_ac — the link's AC (R·LEN = 30 Ω, RL = 75 Ω) on the card
   within 2·cond·eps of the CPU and within 2e-6 of the exact two-port.
31. delay_history (phase H) — the JAX test's history-mode ``absdelay``
   line (``benchmarks/delay_latch.py``: a 1 MHz sine, td = 2 µs) at 8
   lanes over 0-8 µs through B2/B3: every lane within 0.02 of the
   delayed sine over 3-7.5 µs, no underflow, the counts ``CELL_H``, and
   the CPU's over 0-``H_CPU_TSTOP`` (ROADMAP C13); the same line driven by
   a pulse, its top and base one delay later within 1e-9 V and the CPU's
   counts over the whole window.  delay_history_ac — its AC, e^{−jωtd}
   within 1e-9, on the card within 2·cond·eps of the CPU.  c12_witness —
   the line at td = 1.9 µs, one stream, on the card and the CPU: neither
   may end converged with no ring underflow (ROADMAP C12).
32. latch (phase Z) — the LRM ``transition`` ramp, linear and
   interrupted (``netlists.VA_TRANSITION_RAMP``), and the ``zi_nd`` FIR
   and IIR on their 1 µs clock, 8 lanes each through B2/B3: the JAX
   tests' gates on every lane and the CPU's counts.
33. transient_noise (phase N) — kT/C (100 kΩ, 100 fF, h = τ/8,
   ``noise_seed=7``), one stream: the variance over t > 20τ within
   0.6-1.4·kT/C, the CPU's accepted steps and its waveform within 1e-12 V
   over the first 500 (the same draws).
   Phases 30-33 (``a14b3_delay_latch``: first the CPU's side of every
   comparison) run in the A14b child after phases 25-29, one card
   process beside cell G's; their lines are printed from its record once
   it has ended.
34. a16_sensitivity — on the card, no hand-written kernel launched
   (AD takes the exact float64 solve): the BSIM4 DFF's
   ``dc_sensitivity`` of d_neg at the transient operating point to
   x_tp10's W and VDD's dc (the adjoint solve and two vector-Jacobian
   products) and ``tf`` from VDD; the level-1 DFF's ``tran_sensitivity``
   of d_neg at 200.6 ns (mid-fall after D's edge) to x_tn10's W by
   forward-mode AD through the transient over 200-200.7 ns.  Each
   within ``A16_CPU_RTOL`` of the CPU's, the DC ones within
   ``A16_FD_RTOL`` of central differences of the card's ``solve_dc``
   (±1 %, warm from the operating point), the transient's within
   ``A16_LV1_FD_RTOL`` of one of the card's ``tran`` (±0.1 %, two
   lanes).
35. a17_driven — cell V's amplifier, one stream, nominal AREA, on the
   card: ``pss`` over its 2 ms period (the monodromy from one forward-AD
   run of 12 lanes) and ``hb`` at 7 harmonics, both converged, HB's
   warm-up through B1 on the VBIC plan at B = 1 (its only kernel); the
   output's fundamental from HB within 25 % of |AC gain| × 1 mV (the
   reference's check) and within 1 % of the PSS orbit's; ``pac`` (k = 0)
   against ``ac`` and ``pnoise`` against ``noise`` within 1 %; all of it
   against the CPU's.
36. a17_autonomous — ``test_hb.py``'s level-1 ring oscillator on the card
   by ``hb_autonomous`` (13 harmonics, its warm-up through B1 on the
   ring's level-1 plan at B = 1): its period against the CPU's and within
   2 % of a kicked transient's crossings, its swing, and
   ``oscillator_phase_noise`` (the PPV's biorthogonality spread under
   0.05); ``init_fragility``'s solve of the level-1 DFF from 256 starts
   drawn with numpy from a fixed seed, the same starts on the card and
   the CPU: the distinct operating points and their counts, every lane
   within 1e-9 V of the CPU's.
   Before G-xla's join, B1 at B = 1 on the amplifier's and the ring's
   plans against its plain version (``one_stream_fused_kernel``, as
   phases 11 and 24: two step sizes under each option set those
   transients use), the source of the ``ring`` and ``hb_warmup`` entries'
   ``max_abs_err``.
   The CPU's side of phases 34-36 runs in one child process
   (``a16a17_cpu``, one intra-op thread, no card) started after phase 8
   beside the others; the card's side starts after phase 12, once it has
   ended: phases 34, 35 and 36 in a child each (``--a16a17-card-child``),
   beside each other and the main process's phases 13-18 and 37; their
   lines are printed from their records once they have ended.
37. a19 — ROADMAP A19 on the card, in the main process after phase 18
   (beside the children), each item against the same call with
   ``device="cpu"`` at phase 13's tolerances: Spectre text through
   ``simulate`` (``test_spectre.py``'s subcircuit transient; the ASAP7
   BSIM-CMG inverter's operating point); an altergroup and a device
   ``alter`` (every segment's operating point and transient); ``.save``
   through ``simulate`` (one stream) and ``store_vars`` on cell A's 8
   lanes over 0-30 ns through B2/B3 and through B1, each bit for bit the
   same run without the projection in the saved columns, with the same
   counts and launches; a ``.data`` table swept by re-elaboration; a
   ``statistics`` Monte-Carlo at ``mc_seed=7`` (every draw equal as a
   float to numpy's ``default_rng`` under the JAX package's keys);
   ``explore`` on a 64-lane (R, C) grid of phase 4's RC (B1 alone or
   B2/B3 alone launched, every sampled series within 1e-6 V);
   the operating-point cache in a fresh directory (the second solve warm,
   fewer Newton iterations, within 1e-9 V); ``profile_compile`` and
   ``profile_run`` on the card (their keys printed).  Its launches are
   counted in the ``kernels`` line (``a19_launches``).
38. a18 — sweeps sharded over ranks of ``torch.distributed``
   (``cedarsim_tpu_torch/parallel/``).  In the main process, right after
   phase 12's first repeat runs: a world of one on NCCL,
   ``tran_sweep_sharded`` over cells E (B1) and D (B2/B3), their 256
   lanes over 0-60 ns (``A18_TSTOP``), each lane's operating point
   solved inside the sweep from zeros: per-lane counts equal to the
   repeat run's (``a18_nccl``; its waveforms are phase 12's second run).
   Once every child but G-xla's has ended, before its join and beside
   phase 43's set-up (a thread of the main process waits on them): two gloo
   ranks sharing the card (``RankPool``, child processes):
   ``dryrun_child.gates`` (the level-1 DFF's ``vto`` DC sweep, its
   sharded transient, the RC closed-form gate over distinct-τ lanes),
   then cell E's 256 lanes, 128 a rank, against the one-rank run: both
   ranks return the whole result bitwise alike, per-lane counts equal,
   the waveforms bitwise or within 1e-12 V, the line says which
   (``a18_gloo``).
39. a16b — forward-mode AD through the sparse LU (``SparseSolve``), in
   phase 19's child after its main path: ``tran_sensitivity`` of
   ``netlists.diode_ladder()`` (259 unknowns, the sparse path) on the
   card against the same on the CPU (``A16B_CPU_RTOL``) and against the
   card's central difference (``A16B_FD_RTOL``); S1/S2 launches, S2's
   under the tangent counted apart.  Its kernel half with the timing
   phases: S1 and S2 at one lane on the ladder's equilibrated Jacobian,
   S2 on a tangent right-hand side, bitwise their plain versions, with
   their times and bounds (``a16b_kernels``).
40. a21 — the emitter's integer, bitwise and point-list constructs
   (``netlists.a21_circuit``): its four lanes through B1 (the emitted
   walk) over 0-12 ns in the main process after phase 37, against the
   same call on the CPU (B1's plain version): equal counts, waveforms
   within 1e-6 V (``a21_path``); with the timing phases, B1 on its plan
   against its plain version within ``FUSED_RTOL``, with its times and
   bound (``a21_fused_kernel``).
41-42. b_f32, g_f32 (cells B-f32 and G-f32) — ``bench.py``'s accelerator
   configuration of its two DFF legs (``benchmarks/cmg_dff.py``): each
   compiled with ``eval_dtype=float32`` (the models in float32; states,
   time, step control and solves float64), W (BSIM4, 128 lanes) or NFIN
   (CMG, 32 lanes) per lane by ``linspace(0.99, 1.01)``, each lane from
   its warm DC under the float32 Newton defaults, through the public
   ``tran()`` with the leg's ``tpu_opts``, ``jac_reuse=1``, the cap form
   and BDF2 ("auto" under float32 evaluation), ``newton_impl="fused"``
   (B1's float32 form, ``fused_chord_f32``) and the rescue on B2/B3:
   ``bench.py``'s golden gate inside the window (B-f32 over 0-700 ns,
   G-f32 over 0-``G_F32_TSTOP``), its ``race_lane_agreement``, one B1
   launch per batched step attempt; the counts over 0-``F32_CPU_TSTOP``
   on the card and on the CPU, each from its own ``F32_CPU_LANES`` lanes,
   recorded side by side.  Both run in one child process
   (``--f32-child``, one torch thread) started with the device line,
   beside G-xla's; their lines are printed from its record once it has
   ended.
43. f32_fused_kernel — (with the timing phases; its lanes and plans are
   set up in the main process while it waits for G-xla's child) B1's
   float32 form on each leg's plan against its float32 plain version at
   the phases' shapes (``kernel_times.check_fused_f32``: every lane's
   chord converged in both, outputs within 64 float32 ulps where the
   Newton counts agree; where they differ, the two certified points'
   distance in chord tolerances is recorded); device, call and plain
   times and the bound (the walk at the float32 rate, the float64
   direction at the float64 rate), beside the float64 form's device time
   on the BSIM4 lanes compiled in float64; ptxas's registers, stack and
   spills of the float32 library beside the float64 one's.
44. switch  — (in the main process after phase 40, before the children
   are joined; its plan's library builds with the others) ROADMAP C17
   and C18: the pass switch (``netlists.pass_switch``: a gf180
   ``nfet_06v0`` closed at zero drain-source bias, the track phase of a
   sample-and-hold).  Its DC operating point, AC and OUT's noise on the
   card against the same calls on the CPU (OUT exactly 0 V on the CPU,
   the card within SIM_DC_TOL; AC within AC_RTOL, the PSD within
   PSD_RTOL; the gain IN to OUT a closed switch's); B1 (float64) on the
   switch's plan at four lanes (W per lane) at their operating points,
   where every vds is exactly 0, against its plain version; a 0-2 µs
   track-phase transient of those lanes through B1 (a 0.1 V, 1 MHz sine
   on IN), its counts on every lane the CPU's.

The line before the last is the card's name and power limit from
``nvidia-smi``; before it, one JSON line with each kernel's route, source,
the TPU kernel it replaces, launches on its path (B1 in phase 7 and, on
the level-1 plan, in phase 12 and at bdf3/bdf5 in phases 28-29, on the
PVT plan in phase 15, on the CMG plan in phase 21, on the VBIC plan in
phase 25 and at B = 1 in phase 35's HB warm-up, on the ring's level-1
plan in phase 36's, and phase 37's, in phase 38 (``a18_launches``) and
on the A21 plan in phase 40 (``a21``), on the pass switch's plan in
phase 44 (``switch``); B1's float32 form
(``fused_chord_f32``) in phase 41 and, on the CMG plan, 42; B2/B3 in
phase 5, in phase 10, in phase 17, in phase 22, in phase 26, in phases 30-32, in phase 37 and in
phase 38's cell D; B4/B5 in phase 8; S1/S2 in phase 19 and under forward
AD in phase 39 (``a16b``, S2's launches under the tangent apart),
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
from cedarsim_tpu_torch.benchmarks import cmg_dff  # noqa: E402

DFF_DIR = os.path.join(REPO, "benchmarks", "gf180_dff")
#: golden tolerance of the DFF benchmark (bench.py GOLDEN_TOL)
GOLDEN_TOL = kt.GOLDEN_TOL
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
CELL_A = (3086, 279, 7491, 428)
CELL_B = (4799, 1306, 16653, 772)
#: cells D and E, the level-1 DFF at 256 lanes through the mixed chord path
#: and the fused engine (accepted, rejected, Newton, attempts over all
#: lanes); cell D over 0-260 ns (``LV1_SHORT_TSTOP``; over 0-700 ns it was
#: 384556, 57104, 1024766, 1740), cell E over 0-700 ns.  Cell D's lanes
#: whose GESP factor rounds a pivot to 0 are factored again in the source
#: row order (``linalg.chord_factor``, ROADMAP C19: 12 lanes; before it,
#: 164482, 23578, 435608, 744)
CELL_D = (164464, 23562, 435335, 744)
CELL_E = (161553, 30938, 505888, 756)
#: the PVT sweep (phase 15): 256 points, one chunk, two windows (accepted,
#: rejected, Newton over all lanes, batched step attempts over both
#: windows), and the 16-point run through the GESP kernels over
#: 0-``PVT_XLA_TSTOP`` (phase 17)
PVT_POINTS = 256
PVT_SEGMENTS = 2
CELL_P = (157702, 38581, 528815, 808)
PVT_XLA_POINTS = 16
PVT_XLA_TSTOP = 1e-7
#: phase 17's counts over 0-PVT_XLA_TSTOP (accepted, rejected, Newton,
#: attempts) on the card and on the CPU, and the lanes whose counts
#: (accepted, rejected, Newton) in the second window (50-100 ns) part
#: between the two: lane → (the card's, the CPU's).  Lane 2's step at the
#: 50 ns clock edge's breakpoint follows the walk's last bits, which the
#: card rounds apart from the CPU (ROADMAP C13's class); every other lane,
#: and every lane in the first window, is equal
CELL_P_XLA = (2079, 308, 5241, 160)
CELL_P_XLA_CPU = (2072, 309, 5225, 156)
PVT_XLA_PARTED = {2: ((93, 20, 300), (86, 21, 284))}
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
                 (8, 122), (CMG_LANES, 85), (4, n_max)]:
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
    log("kernels", bitwise_equal_to_plain=checked,
        max_abs_err_dff_shape=abs_err)
    # the timing half's systems, drawn here as before the split
    return abs_err, kt.dominant_systems(rng, N_LANES, 25)


def phase_kernel_times(torch, gesp_lu, dev, systems):
    """Phase 3's timing half, run once no other process shares the card:
    B2 and B3 at the transient's shape (B = lanes, n = 25 unknowns) on
    ``systems`` from the checking half; beside each kernel, one PyTorch
    call computing the same function (timed here only: the port never
    calls it)."""
    B, n = N_LANES, 25
    A, b = systems
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
    log("kernel_times", ms_device_call_plain_library_call_device_by={
            k: list(v) for k, v in times.items()},
        bound_ms=bounds, shape=[B, n, n])
    return times, bounds


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
    t0 = time.perf_counter()
    comp, ctx, pb, x0 = kt.dff_lanes(torch, T, dev)
    return comp, ctx, pb, x0, kt.golden(T), time.perf_counter() - t0


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

        def chord_factor(J, *args):
            LU, perm, r = factor(J, *args)
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
    worst = kt.gate_golden(sols, golden, comp.n_x, tstop)
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
    the nominal lane alone (B1') in the timing half
    (``phase_fused_kernel_times``), on the inputs this half returns."""
    info = plan.build()
    worst = dict(xn=0.0, S=0.0, Q=0.0)
    s_final_rel = 0.0
    abs_err = 0.0
    nnwt = []
    timing = None
    for h in (1e-12, 1e-10):
        args, opts = kt.fused_args(torch, T, plan, dff[:4], h)
        k1, err = fused_vs_plain(torch, fc, plan, args, opts, f"h={h}",
                                 worst)
        s_final_rel = max(s_final_rel, err["s_final_rel"])
        abs_err = max(abs_err, err["xn_abs"])
        nnwt.append(k1[3].tolist())
        if timing is None:
            # the timing half's inputs: 8 lanes and, B1', the nominal one
            one = slice(N_LANES // 2, N_LANES // 2 + 1)
            args1, _ = kt.fused_args(torch, T, plan, dff[:4], h, lanes=one)
            timing = ((("B1", args), ("B1'", args1)), opts)
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if any(w in ln for w in ("Function properties", "registers",
                                      "spill"))]
    log("fused_kernel", worst_rel_err=worst,
        s_rel_to_final_s=s_final_rel, ok_nnwt=nnwt,
        shape=list(dff[3].shape),
        n_inst=plan.n_inst, fc_max_hoist=plan.max_hoist,
        threads=plan.threads, smem_bytes=plan.smem_bytes,
        smem_limit=plan.smem_limit, plan_s=t_plan,
        emit_s=info["emit_seconds"], nvcc_s=info["nvcc_seconds"],
        ptxas=ptxas, header=os.path.relpath(info["path"], REPO))
    return abs_err, info, timing


def phase_fused_kernel_times(fc, plan, timing):
    """Phase 6's timing half, run once no other process shares the card:
    B1's (device ms, call ms, plain ms) and bound at 8 lanes and, B1', at
    the nominal lane, and the host cost of the AD check on B1's inputs.
    Returns (times, bounds)."""
    runs, opts = timing
    times, bounds = {}, {}
    for key, a in runs:
        def run(a=a):
            return fc.fused_chord(plan, *a, opts)
        times[key] = (kt.device_ms(run), kt.call_ms(run, 50),
                      kt.call_ms(lambda a=a: fc.fused_chord_plain(
                          plan, *a, opts), 5))
        bounds[key], nodes = fused_bound(plan, a, run())
    check_us = refuse_tangent_us(runs[0][1][:6])
    log("fused_kernel_times", refuse_tangent_us=check_us,
        ms_device_call_plain={k: list(v) for k, v in times.items()},
        bound_ms=bounds, nodes=nodes)
    return times, bounds


def refuse_tangent_us(tensors, reps=20000):
    """Host µs of one ``refuse_tangent`` on ``tensors`` (B1's six tensor
    inputs on the card): the AD check that every kernel wrapper makes on
    every launch, outside any dual level or ``torch.func`` transform."""
    from cedarsim_tpu_torch.ops.ad import refuse_tangent
    t0 = time.perf_counter()
    for _ in range(reps):
        refuse_tangent("fused_chord", *tensors)
    return (time.perf_counter() - t0) / reps * 1e6


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
    ops = float((pre + (nnwt + 1) * (walk + 6 * n * n)).sum())
    ops_dir = float((nnwt * 2 * n * n).sum())
    counted = {key: {"hoisted_nodes": e.n_pre, "walk_nodes": e.n_walk,
                     "hoisted_values": e.n_hoist, "instances": ni[key]}
               for key, e in plan.emitted}
    if plan.entry == "fused_chord_f64":
        return bound(nbytes, ops + ops_dir, "float64"), counted
    # the float32 form: the walk and the matvecs at the float32 rate, the
    # direction (summed in float64) at the float64 rate
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (ops / PEAK_OPS_PER_S["float32"]
             + ops_dir / PEAK_OPS_PER_S["float64"]) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")), counted


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
    worst = kt.gate_golden(sols, golden, comp.n_x)
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


def lv1_run(torch, T, gesp_lu, fc, lv1, cell, tstop, method=None):
    """Cell D or E over 0-tstop through the public tran, with the kernels'
    launches counted from 0 (``method``: the integrator, else the cell's
    own).  Returns (solutions, launches, wall s)."""
    comp, ctx, pb, x0 = lv1[:4]
    opts = dict(kt.LV1_XLA_OPTS if cell == "D" else kt.LV1_FUSED_OPTS)
    if method is not None:
        opts["method"] = method
    opts = T.TranOptions(**opts)
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
    ``want``; the lanes that the chord factor took again in the source
    row order (``linalg.reordered``, ROADMAP C19) printed."""
    from cedarsim_tpu_torch.ops import linalg
    r0 = linalg.reordered
    sols, launches, wall = lv1_run(torch, T, gesp_lu, fc, lv1, cell, tstop)
    worst = gate_lv1(sols, tstop)
    if want is not None:
        check_counts(cell, sols, want)
    log(f"lv1_{'mixed' if cell == 'D' else 'fused'}", cell=cell, tstop=tstop,
        lanes=len(sols), setup_s=lv1[4], wall_s=wall,
        transients_per_s=len(sols) / wall, worst_gate_err=worst,
        **counts(sols), attempts=sols[0].n_attempts, launches=launches,
        reordered_lanes=linalg.reordered - r0, **(extra or {}), card=smi())
    return launches


def phase_lv1_repeat(torch, T, gesp_lu, fc, lv1, dev):
    """Cells D and E over 0-LV1_REPEAT_TSTOP twice each in this process:
    the same step counts and bitwise the same waveforms.  The second run
    of each cell is phase 38's world of one (``phase_a18_one``: the same
    lanes through ``tran_sweep_sharded``, each lane's operating point
    solved inside it as ``kernel_times.lv1_lanes`` solves it), so that the
    two phases share one run.  Returns cell E's world-of-one result and
    the launches by cell."""
    first = {cell: lv1_run(torch, T, gesp_lu, fc, lv1, cell,
                           LV1_REPEAT_TSTOP)[0] for cell in ("D", "E")}
    res_e, launches, equal = phase_a18_one(torch, T, dev, lv1, first)
    log("lv1_repeat", bitwise_equal=equal, tstop=LV1_REPEAT_TSTOP,
        second_run="phase 38's world of one (tran_sweep_sharded)")
    if not all(equal.values()):
        raise AssertionError(f"the level-1 leg is not reproducible: {equal}")
    return res_e, launches


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
    # the BE start at 256 and 8 lanes, and uniform-step BDF3 and BDF5
    # starts (cells E-bdf3, E-bdf5) at 256, each against its plain version
    for B, order in ((LV1_LANES, 1), (N_LANES, 1), (LV1_LANES, 3),
                     (LV1_LANES, 5)):
        args, opts = kt.fused_args(torch, T, plan, lv1[:4], 1e-12,
                                   lanes=slice(0, B), order=order)
        key = B if order == 1 else f"bdf{order}"
        if order > 1:
            k1, err = fused_vs_plain(torch, fc, plan, args, opts,
                                     f"lv1 bdf{order}", worst)
            abs_err = max(abs_err, err["xn_abs"])
            nnwt.append([int(k1[3][:, 1].min()), int(k1[3][:, 1].max())])

        def run(a=args):
            return fc.fused_chord(plan, *a, opts)
        times[key] = (kt.device_ms(run), kt.call_ms(run, 50),
                      kt.call_ms(lambda a=args: fc.fused_chord_plain(
                          plan, *a, opts), 5))
        bounds[key], counted = fused_bound(plan, args, run())
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


def phase_pvt_xla(torch, gesp_lu, fc, dev, emit=log):
    """Phase 17: the harness through the GESP kernels (``impl="xla"``),
    16 points over 0-100 ns in two windows, its counts ``CELL_P_XLA``;
    every lane's counts in both windows those of the same call on the
    CPU but for the lanes ``PVT_XLA_PARTED`` (each side's counts held to
    its own there, the CPU's totals to ``CELL_P_XLA_CPU``); and the same
    call on the card with B2 and B3 replaced by their plain versions, its
    every lane's counts the kernels' run's (the witness that the lanes
    part by the card's walk, not by the kernels)."""
    from cedarsim_tpu_torch.benchmarks import pvt_sweep
    fc.fused_chord.launches = 0
    gesp_lu.lu_factor_gesp_f32.launches = 0
    gesp_lu.lu_subst_gesp_f32.launches = 0
    torch.cuda.synchronize()
    res = pvt_sweep.run_chunked(PVT_XLA_POINTS, PVT_XLA_POINTS, PVT_SEGMENTS,
                                "xla", PVT_XLA_TSTOP, device=dev,
                                details=True)
    torch.cuda.synchronize()
    launches = {"fused": fc.fused_chord.launches,
                "factor": gesp_lu.lu_factor_gesp_f32.launches,
                "subst": gesp_lu.lu_subst_gesp_f32.launches}
    t0 = time.perf_counter()
    cpu = pvt_sweep.run_chunked(PVT_XLA_POINTS, PVT_XLA_POINTS, PVT_SEGMENTS,
                                "xla", PVT_XLA_TSTOP, device="cpu",
                                details=True)
    cpu_s = time.perf_counter() - t0
    # the witness: the card's run with the kernels' plain versions
    kernels = (gesp_lu.lu_factor_gesp_f32, gesp_lu.lu_subst_gesp_f32)
    t0 = time.perf_counter()
    try:
        gesp_lu.lu_factor_gesp_f32 = gesp_lu.lu_factor_gesp_f32_plain
        gesp_lu.lu_subst_gesp_f32 = gesp_lu.lu_subst_gesp_f32_plain
        plain = pvt_sweep.run_chunked(PVT_XLA_POINTS, PVT_XLA_POINTS,
                                      PVT_SEGMENTS, "xla", PVT_XLA_TSTOP,
                                      device=dev, details=True)
    finally:
        gesp_lu.lu_factor_gesp_f32, gesp_lu.lu_subst_gesp_f32 = kernels
    plain_s = time.perf_counter() - t0

    def counts(r):
        return (r["accepted"], r["rejected"], r["newton"], r["attempts"])

    def lanes(r):
        """Per window, per lane (accepted, rejected, Newton)."""
        ch, = r.pop("chunks")
        return [np.stack([np.asarray(ch[c])[k] for c in
                          ("accepted", "rejected", "newton")], -1).tolist()
                for k in range(PVT_SEGMENTS)]
    card, on_cpu, with_plain = lanes(res), lanes(cpu), lanes(plain)
    parted = {i: [card[1][i], on_cpu[1][i]] for i in range(PVT_XLA_POINTS)
              if card[1][i] != on_cpu[1][i]}
    emit("pvt_xla", **res, launches=launches, cpu_counts=counts(cpu),
         first_window_equal=card[0] == on_cpu[0],
         parted_after_edge=parted, cpu_ok=cpu["ok"], cpu_s=cpu_s,
         plain_kernels_counts=counts(plain),
         plain_kernels_lanes_equal=with_plain == card, plain_s=plain_s,
         card=smi())
    if launches["fused"] or min(launches["factor"], launches["subst"]) <= 0:
        raise AssertionError(f"PVT xla: kernels {launches}")
    if not res["ok"] or res["engine"] != "xla" or res["dense_lu"] != "mixed":
        raise AssertionError(f"PVT xla: {res}")
    if card[0] != on_cpu[0] or not cpu["ok"]:
        raise AssertionError(f"PVT xla counts over the first window "
                             f"{card[0]}, the CPU's {on_cpu[0]}")
    want = {i: [list(c) for c in pair]
            for i, pair in PVT_XLA_PARTED.items()}
    if parted != want:
        raise AssertionError(f"PVT xla: lanes parted from the CPU's in the "
                             f"second window (card, CPU) {parted}, "
                             f"recorded {want}")
    if (counts(res), counts(cpu)) != (CELL_P_XLA, CELL_P_XLA_CPU):
        raise AssertionError(f"PVT xla counts (accepted, rejected, Newton, "
                             f"attempts) {counts(res)}, the CPU's "
                             f"{counts(cpu)}, recorded {CELL_P_XLA}, "
                             f"{CELL_P_XLA_CPU}")
    if with_plain != card or not plain["ok"]:
        raise AssertionError(f"PVT xla with B2/B3's plain versions on the "
                             f"card: per-lane counts {with_plain}, the "
                             f"kernels' {card}")
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
    A, _, _ = _system(comp, op.x, c_ac, comp.params0, freqs)
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


#: cell G (phases 20-22, ``benchmarks/cmg_dff.py``): ``bench.py``'s
#: BSIM-CMG DFF leg (85 unknowns) at the JAX package's 32 lanes for it;
#: G-fused over the leg's 0-700 ns, G-xla over 0-``G_XLA_TSTOP``, across
#: the first clock edge (CLKN falls over 50-51.02 ns, ``G_EDGE``) but
#: short of the first golden point (150 ns): its 32 lanes in lockstep take
#: 284 s on the card over 0-60 ns and had reached only 63 ns after 488 s
#: of a 0-160 ns run (PERF.md §4), while G-fused takes ~90 s for the whole
#: leg.  Their counts (accepted, rejected, Newton over all lanes, batched
#: attempts) on the card; over 0-``G_CPU_TSTOP`` they must equal the same
#: call's on the CPU (the kernels' plain versions there).  Beyond it the
#: two part: the card's operating point holds the slave latch at q = 0 V,
#: the CPU's at VDD, both DC solutions of the latch that CLKN = 1 holds
#: (ROADMAP C9).
CMG_LANES = kt.CMG_LANES
#: cell V (phases 24-27): the card's counts over the whole window
#: (accepted, rejected, Newton, attempts over all lanes), and the window
#: over which they equal the CPU's
CELL_V_FUSED = (2368, 704, 7192, 96)
CELL_V_XLA = (4320, 1231, 12142, 176)
V_CPU_TSTOP = 2e-4
#: the amplifier's noise analysis (phase 27): 10 Hz-10 MHz, 10 a decade
V_NOISE_FREQS = np.logspace(1.0, 7.0, 61)
#: cells E-bdf3 and E-bdf5 (phases 28-29) over 0-700 ns, and the window
#: over which their counts equal the CPU's
CELL_E_BDF3 = (168739, 26553, 472628, 768)
CELL_E_BDF5 = (224014, 26352, 574998, 984)
E_BDF_CPU_TSTOP = 2e-9
G_XLA_TSTOP = 6e-8
G_EDGE = (5e-8, 5.102e-8)
CELL_G_FUSED = (19408, 5569, 91663, 784)
CELL_G_XLA = (3934, 1461, 39844, 396)
G_CPU_TSTOP = 2e-9
#: cells B-f32 and G-f32 (phases 41-42, ``benchmarks/cmg_dff.py``):
#: ``bench.py``'s accelerator configuration of the BSIM4 and CMG DFF legs
#: (models in float32, B1's float32 form, 128 and 32 lanes); G-f32's
#: window; the card's counts against the CPU's over 0-``F32_CPU_TSTOP``
#: (recorded, and whether they are equal: how far the two agree is the
#: measurement); B1's float32 form against its float32 plain version
#: (``kernel_times.check_fused_f32``) at each leg's (h, perturbation)
#: starts: the CMG chord converges from 1 mV, not from 50 mV
#: (``tests/test_torch_mixed_fused.py``).  G-f32 runs over 0-260 ns (the
#: 150 and 250 ns points): over 0-700 ns it passed its gate in 257 s of
#: ``tran``, and the smoke then ran ~1,000 s, G-xla's ``tran`` 765 s
#: beside it (PERF.md, PR 18), too near the 1,100 s gate
G_F32_TSTOP = 2.6e-7
F32_CPU_TSTOP = 1e-9
#: the count comparison's lanes (``linspace(0.99, 1.01)`` over 8 lanes,
#: set up on each side): the CPU's eager walk at the legs' own 128 and 32
#: lanes took minutes of the host beside G-xla
F32_CPU_LANES = 8
F32_STARTS = {"bsim4": ((1e-12, 0.05), (1e-10, 0.05)),
              "cmg": ((1e-12, 1e-3), (1e-11, 1e-3))}
#: phase 23: the ASAP7 BSIM-CMG inverter's √PSD against ngspice's table
#: (the reference's gate, ``tests/test_noise_pdk_goldens.py``) and its PSD
#: on the card against the CPU's.  The adjoint systems G + jωC reach
#: cond 2.4e8 there (q sits on its rail), so two correct complex solves of
#: them part by up to cond·eps = 2.7e-8 and the PSD, |H|², by twice that
#: (ROADMAP C8: the CPU's torch against the JAX package's LAPACK part by
#: 3.1e-9)
CMG_NGSPICE_RTOL = 1e-6
CMG_PSD_RTOL = 5.4e-8
#: the ASAP7 7nm TT deck (Spectre ``bsimcmg`` cards) and ngspice's table
#: of the inverter's noise on it, the repo's test data
ASAP7_DIR = os.path.join(REPO, "tests", "data", "asap7")
CMG_NOISE_TABLE = os.path.join(REPO, "tests",
                               "data_cmg_inverter_noise_ngspice.py")


def cmg_noise_table():
    """(frequencies Hz, ngspice's √PSD V/√Hz) from ``CMG_NOISE_TABLE``,
    read as data: the literal assigned to ``NGSPICE_CMG_INV_NOISE``."""
    import ast
    with open(CMG_NOISE_TABLE) as f:
        tree = ast.parse(f.read())
    rows, = [ast.literal_eval(n.value) for n in tree.body
             if isinstance(n, ast.Assign)
             and n.targets[0].id == "NGSPICE_CMG_INV_NOISE"]
    return np.array([r[0] for r in rows]), np.array([r[1] for r in rows])


def cmg_setup(torch, T, dev):
    """Cell G's lanes on the card (``cmg_dff.setup``) and their fused
    plan: (lanes, set-up s, plan, plan s)."""
    from cedarsim_tpu_torch.analysis.tran import fused_plan_for
    cmg, setup_s = cmg_dff.setup(device=dev)
    t0 = time.perf_counter()
    plan = fused_plan_for(*cmg[:3])
    return cmg, setup_s, plan, time.perf_counter() - t0


def cmg_fused_kernel_check(torch, T, fc, cmg, plan):
    """Phase 20's checking half, beside G-xla's child: B1 on the CMG plan
    (the BSIM-CMG walk emitted) against its plain version on cell G's 32
    lanes, as phase 6 (the leg's fused options, h = 1e-12 and 1e-10).
    Returns (worst relative errors, max |xn − plain|, (min, max) Newton
    iterations per step, the last step's inputs) for the timing half."""
    worst = dict(xn=0.0, S=0.0, Q=0.0)
    abs_err, nnwt = 0.0, []
    for h in (1e-12, 1e-10):
        args, opts = kt.fused_args(torch, T, plan, cmg, h,
                                   opts=kt.CMG_FUSED_OPTS)
        k1, err = fused_vs_plain(torch, fc, plan, args, opts,
                                 f"cmg h={h}", worst)
        abs_err = max(abs_err, err["xn_abs"])
        nnwt.append([int(k1[3][:, 1].min()), int(k1[3][:, 1].max())])
    return worst, abs_err, nnwt, (args, opts)


def phase_cmg_fused_kernel(torch, T, fc, cmg, plan, t_plan, checked):
    """Phase 20's timing half, alone on the card: the line of B1 on the
    CMG plan, with ``checked`` (``cmg_fused_kernel_check``'s return); its
    device, call and plain times and bound at [32, 85]; emit and nvcc
    seconds, ptxas's lines."""
    info = plan.build()
    worst, abs_err, nnwt, (args, opts) = checked

    def run():
        return fc.fused_chord(plan, *args, opts)
    times = (kt.device_ms(run), kt.call_ms(run, 20),
             kt.call_ms(lambda: fc.fused_chord_plain(plan, *args, opts), 3))
    bnd, counted = fused_bound(plan, args, run())
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if any(w in ln for w in ("Function properties", "registers",
                                      "spill"))]
    log("cmg_fused_kernel", worst_rel_err=worst, nnwt_min_max=nnwt,
        ms_device_call_plain=list(times), shape=list(cmg[3].shape),
        bound_ms=bnd, nodes=counted, n_inst=plan.n_inst,
        threads=plan.threads, smem_bytes=plan.smem_bytes,
        smem_limit=plan.smem_limit, fc_max_hoist=plan.max_hoist,
        plan_s=t_plan, emit_s=info["emit_seconds"],
        nvcc_s=info["nvcc_seconds"], ptxas=ptxas,
        header=os.path.relpath(info["path"], REPO))
    return abs_err, times, bnd


def cmg_cpu_counts(T, engine, cmg_cpu, tstop):
    """Cell G's counts through ``engine`` over 0-``tstop`` on the CPU,
    from the CPU's own lanes ``cmg_cpu`` (the kernels' plain versions:
    ``dense_lu="mixed"`` for G-xla)."""
    r = cmg_dff.run(engine, tstop, dff=cmg_cpu,
                    dense_lu="mixed" if engine == "xla" else None)
    return (r["accepted"], r["rejected"], r["newton"], r["attempts"])


def edge_crossed(T, sols, tstop):
    """G-xla's gate for a window that crosses the first clock edge
    (``G_EDGE``) and ends before the first golden point: on every lane the
    latch's clock nodes start at CLKN = 1's levels (cki at VDD, ncki at 0
    V) and end at the edge's (cki 0 V, ncki VDD), q starts on a rail (the
    operating point's latch state, either) and ends at the golden's first
    level (0 V, which q holds from that edge to 150 ns), all within
    ``GOLDEN_TOL``.  Returns (the worst error, the lanes whose q started
    at VDD)."""
    gold = kt.golden(T, "cmg")
    vdd, q_after = gold["vdd"], gold["q"][0]
    if not G_EDGE[1] < tstop < gold["samples_ns"][0] * 1e-9:
        raise AssertionError(f"G-xla's window 0-{tstop:g} s does not end "
                             "between the first edge and golden point")
    worst, high = 0.0, 0
    for lane, sol in enumerate(sols):
        (c0, n0, q0), (c1, n1, q1) = [
            [float(sol.interp(name, t)) for name in ("cki", "ncki", "q")]
            for t in (0.0, tstop)]
        high += q0 > vdd / 2
        errs = (abs(c0 - vdd), abs(n0), abs(c1), abs(n1 - vdd),
                min(abs(q0), abs(q0 - vdd)), abs(q1 - q_after))
        if not max(errs) <= GOLDEN_TOL:
            raise AssertionError(f"G-xla lane {lane}: the clock edge did "
                                 f"not reach the latch, errors {errs}")
        worst = max(worst, *errs)
    return worst, high


def cmg_path(T, engine, cmg, plan, cmg_cpu):
    """Cell G through ``engine`` (phase 21: "fused", phase 22: "xla"):
    the public ``tran()`` (``cmg_dff.run``, every kernel count from 0 just
    before the call and read just after), gated on ``golden_cmg.json`` as
    ``bench.py`` gates it inside the window; G-fused one B1 launch per
    batched step attempt and no GESP launch, G-xla B2 and B3 launched
    through ``dense_lu="auto"`` and no B1, and the first clock edge
    through the latch (``edge_crossed``); the counts recorded for the
    cell; then the card's counts over 0-``G_CPU_TSTOP``, held here to
    the CPU's from the CPU lanes ``cmg_cpu``, or, where that is None
    (G-xla), recorded for ``phase_cmg`` to hold to the CPU's that
    G-fused's child ran.  Returns the run's record."""
    fused = engine == "fused"
    tstop = cmg_dff.TSTOP if fused else G_XLA_TSTOP
    res = cmg_dff.run(engine, tstop, dff=cmg, plan=plan)
    sols = res.pop("sols")
    la = res["launches"]
    if fused:
        if la["fused"] != res["attempts"] or la["fused"] <= 0 \
                or la["factor"] or la["subst"]:
            raise AssertionError(f"G-fused: launches {la}, "
                                 f"{res['attempts']} step attempts")
    else:
        if la["fused"] or min(la["factor"], la["subst"]) <= 0 \
                or res["dense_lu"] != "mixed":
            raise AssertionError(f"G-xla: launches {la}, dense_lu "
                                 f"{res['dense_lu']}")
        res["edge_err"], res["lanes_q0_at_vdd"] = edge_crossed(T, sols,
                                                               tstop)
    check_counts("G-" + engine, sols,
                 CELL_G_FUSED if fused else CELL_G_XLA)
    res.pop("ptxas", None)
    card = cmg_dff.run(engine, G_CPU_TSTOP, dff=cmg, plan=plan)
    got = (card["accepted"], card["rejected"], card["newton"],
           card["attempts"])
    if cmg_cpu is None:
        res["card_counts_short"] = dict(tstop=G_CPU_TSTOP, counts=got)
        return res
    want = cmg_cpu_counts(T, engine, cmg_cpu, G_CPU_TSTOP)
    if got != want:
        raise AssertionError(f"cell G {engine} over 0-{G_CPU_TSTOP:g} s: "
                             f"counts {got} on the card, {want} on the CPU")
    res["card_equals_cpu_counts"] = dict(tstop=G_CPU_TSTOP, counts=got)
    return res


def cmg_child(engine, out):
    """``--cmg-child ENGINE OUT``: phase 21 ("fused") or 22 ("xla"),
    cell G through one engine (``cmg_path``), in a process of its own: the
    lanes' set-up on the card, the fused plan (its library built by the
    main process before), G-fused's CPU lanes for the count comparison
    of both engines, then the run; its record saved to OUT (JSON).  Two
    torch threads, so that its CPU run shares the host with the smoke's
    other processes; a line to stderr at each step."""
    import torch
    import cedarsim_tpu_torch as T
    torch.set_num_threads(2)
    cmg, setup_s, plan, plan_s = cmg_setup(torch, T, torch.device("cuda", 0))
    print(f"cmg_{engine}: set up in {setup_s:.1f} s", file=sys.stderr,
          flush=True)
    cmg_cpu = cmg_dff.setup(device="cpu")[0] if engine == "fused" else None
    rec = cmg_path(T, engine, cmg, plan, cmg_cpu)
    rec.update(lanes_setup_s=setup_s, plan_s=plan_s)
    if engine == "fused":
        # G-xla's CPU side, from lanes of its own: G-xla's child, the
        # smoke's critical path, runs nothing on the host beside its run
        rec["xla_cpu_counts"] = cmg_cpu_counts(
            T, "xla", cmg_dff.setup(device="cpu")[0], G_CPU_TSTOP)
    print(f"cmg_{engine}: done, tran {rec['wall_s']:.1f} s", file=sys.stderr,
          flush=True)
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_cmg(engine, child, cpu_counts=None):
    """Phase 21 or 22's line, from its child's record (``cmg_child``);
    G-xla's card counts over 0-``G_CPU_TSTOP`` held to ``cpu_counts``, the
    CPU's from G-fused's child.  Returns (the run's launches, the CPU's
    G-xla counts that G-fused's child recorded, or None)."""
    out, waited = join_child(child)
    with open(out) as f:
        rec = json.load(f)
    xla_cpu = rec.pop("xla_cpu_counts", None)
    if engine == "xla":
        got = tuple(rec.pop("card_counts_short")["counts"])
        if got != tuple(cpu_counts):
            raise AssertionError(f"cell G {engine} over 0-{G_CPU_TSTOP:g} "
                                 f"s: counts {got} on the card, "
                                 f"{tuple(cpu_counts)} on the CPU")
        rec["card_equals_cpu_counts"] = dict(tstop=G_CPU_TSTOP, counts=got)
    log("cmg_" + engine, **rec, ran_in_child=True, waited_s=waited)
    return rec["launches"], xla_cpu


def f32_leg_path(leg, dff, cpu_lanes, tstop):
    """Cell B-f32 (``leg`` "bsim4", phase 41) or G-f32 ("cmg", phase 42):
    the public ``tran()`` through ``cmg_dff.run`` (every kernel count
    from 0 just before the call and read just after), gated on the leg's
    golden as ``bench.py`` gates it inside the window, with its
    ``race_lane_agreement``; one launch of B1's float32 form
    (``fused_chord_f32``) per batched step attempt; then the counts over
    0-``F32_CPU_TSTOP`` on the card and on the CPU, each from its own
    ``F32_CPU_LANES`` lanes (``cpu_lanes``: (card's, CPU's)), both
    recorded.  Returns the run's record."""
    res = cmg_dff.run("fused", tstop, dff=dff, leg=leg)
    res.pop("sols")
    la = res["launches"]
    if la["fused"] != res["attempts"] or la["fused"] <= 0 \
            or res["entry"] != "fused_chord_f32":
        raise AssertionError(f"{leg}-f32: launches {la}, {res['attempts']} "
                             f"step attempts, entry {res.get('entry')}")

    def counts(r):
        return [r["accepted"], r["rejected"], r["newton"], r["attempts"]]
    card, cpu = (cmg_dff.run("fused", F32_CPU_TSTOP, dff=d, leg=leg)
                 for d in cpu_lanes)
    res["card_vs_cpu_counts"] = dict(
        tstop=F32_CPU_TSTOP, lanes=F32_CPU_LANES, card=counts(card),
        cpu=counts(cpu), equal=counts(card) == counts(cpu))
    res.pop("ptxas", None)
    return res


def f32_child(out):
    """``--f32-child OUT``: phases 41 and 42 (``f32_leg_path``) in a
    process of its own, started with the device line beside G-xla's
    child: each leg's lanes on the card (compiled with
    ``eval_dtype=float32``), its float32 library (built here), the count
    comparison's lanes on the card and on the CPU, then the runs; the
    records saved to OUT (JSON).  One torch thread (G-xla's child, the
    critical path, shares the host); a line to stderr at each step."""
    import torch
    torch.set_num_threads(1)
    recs = {}
    card = torch.device("cuda", 0)
    for leg, tstop in (("bsim4", cmg_dff.TSTOP), ("cmg", G_F32_TSTOP)):
        dff, setup_s = cmg_dff.setup(device=card, leg=leg,
                                     eval_dtype=torch.float32)
        cpu_lanes = [cmg_dff.setup(F32_CPU_LANES, d, leg, torch.float32)[0]
                     for d in (card, "cpu")]
        print(f"{leg}_f32: set up in {setup_s:.1f} s", file=sys.stderr,
              flush=True)
        recs[leg] = f32_leg_path(leg, dff, cpu_lanes, tstop)
        recs[leg]["lanes_setup_s"] = setup_s
        print(f"{leg}_f32: done, tran {recs[leg]['wall_s']:.1f} s",
              file=sys.stderr, flush=True)
    with open(out, "w") as f:
        json.dump(recs, f)


def phase_f32(child):
    """Phases 41 and 42's lines, from their child's record
    (``f32_child``); returns each leg's launches."""
    out, waited = join_child(child)
    with open(out) as f:
        recs = json.load(f)
    for leg, name in (("bsim4", "b_f32"), ("cmg", "g_f32")):
        log(name, **recs[leg], ran_in_child=True, waited_s=waited)
    return {leg: rec["launches"] for leg, rec in recs.items()}


def f32_kernel_setup(torch, T, leg):
    """Phase 43's inputs for ``leg``, made in the main process while it
    waits for G-xla's child (no timing): ``cmg_dff``'s float32 lanes on
    the card (128 BSIM4 or 32 CMG) and their plan, its library loaded; for
    BSIM4
    also the same lanes compiled in float64 and their plan."""
    from cedarsim_tpu_torch.analysis.tran import fused_plan_for
    dev = torch.device("cuda", 0)
    dff, setup_s = cmg_dff.setup(device=dev, leg=leg,
                                 eval_dtype=torch.float32)
    t0 = time.perf_counter()
    plan = fused_plan_for(*dff[:3])
    t_plan = time.perf_counter() - t0
    info = plan.build()
    if plan.entry != "fused_chord_f32":
        raise AssertionError(f"{leg}: the plan's entry is {plan.entry}")
    f64 = None
    if leg == "bsim4":
        d64 = kt.dff_lanes(torch, T, dev, lanes=kt.LEGS[leg]["tpu_nb"],
                           leg=leg)
        f64 = (d64, fused_plan_for(*d64[:3]))
    return dict(dff=dff, plan=plan, info=info, setup_s=setup_s,
                t_plan=t_plan, f64=f64)


def phase_f32_fused_kernel(torch, T, fc, leg, state, f64_log):
    """Phase 43 (with the timing phases): B1's float32 form on the leg's
    plan (``f32_kernel_setup``'s ``state``) against its float32 plain
    version at ``F32_STARTS[leg]`` (``kernel_times.check_fused_f32``); its
    device, call and plain times and bound at the phase's shape; nvcc
    seconds and ptxas's registers, stack and spills of the float32
    library beside the float64 one's (``f64_log``, the same leg's float64
    plan); on the BSIM4 plan also the float64 form's device time on the
    same lanes compiled in float64, same shape and start.  Returns (xn's
    largest error, times, bound, ptxas lines)."""
    dff, plan, info = state["dff"], state["plan"], state["info"]
    checks = []
    abs_err, nnwt = 0.0, []
    for h, pert in F32_STARTS[leg]:
        args, opts = kt.fused_args(torch, T, plan, dff, h,
                                   opts=cmg_dff.options("fused", leg, True),
                                   pert=pert)
        try:
            chk, k1 = kt.check_fused_f32(torch, fc, plan, args, opts)
        except AssertionError as e:
            raise AssertionError(f"{leg} f32 h={h}: {e}") from None
        checks.append(dict(h=h, pert=pert, **chk))
        abs_err = max(abs_err, chk["xn_abs"])
        nnwt.append([int(k1[3][:, 1].min()), int(k1[3][:, 1].max())])

    def run():
        return fc.fused_chord(plan, *args, opts)
    times = (kt.device_ms(run), kt.call_ms(run, 20),
             kt.call_ms(lambda: fc.fused_chord_plain(plan, *args, opts), 1,
                        rounds=2))
    bnd, counted = fused_bound(plan, args, run())
    f64_ms = None
    if state["f64"] is not None:
        # the float64 form on the same lanes compiled in float64, at the
        # same shape and start (phase 20 gives the CMG plan's, [32, 85])
        d64, p64 = state["f64"]
        h, pert = F32_STARTS[leg][-1]
        a64, o64 = kt.fused_args(torch, T, p64, d64, h,
                                 opts=cmg_dff.options("fused", leg, True),
                                 pert=pert)
        f64_ms = kt.device_ms(lambda: fc.fused_chord(p64, *a64, o64))

    def lines(log_text):
        return [ln.strip() for ln in log_text.splitlines()
                if any(w in ln for w in ("registers", "spill",
                                         "stack frame"))]
    ptxas = {"float32": lines(info["log"]), "float64": lines(f64_log)}
    log("f32_fused_kernel", leg=leg, checks=checks, nnwt_min_max=nnwt,
        ms_device_call_plain=list(times), shape=list(dff[3].shape),
        float64_form_device_ms=f64_ms,
        bound_ms=bnd, nodes=counted, threads=plan.threads,
        smem_bytes=plan.smem_bytes, lanes_setup_s=state["setup_s"],
        plan_s=state["t_plan"],
        emit_s=info["emit_seconds"], nvcc_s=info["nvcc_seconds"],
        ptxas=ptxas, library=os.path.relpath(info["path"], REPO))
    return abs_err, times, bnd, ptxas


def phase_cmg_noise(torch, T, gesp_lu, pivot_lu, fc, dev):
    """Phase 23: the ASAP7 BSIM-CMG inverter (``netlists.
    CMG_INVERTER_NOISE``: the Spectre deck through ``elaborate``, compiled
    on the card) and its noise at q (``ctx`` gmin 1e-15): √PSD within
    ``CMG_NGSPICE_RTOL`` of ngspice's table, the PSD within
    ``CMG_PSD_RTOL`` of the same call on the CPU; no hand-written kernel
    launched."""
    from cedarsim_tpu_torch.benchmarks import netlists
    counters = (gesp_lu.lu_factor_gesp_f32, gesp_lu.lu_subst_gesp_f32,
                gesp_lu.lu_solve_gesp_f32, pivot_lu.lu_solve_pivot_f32,
                fc.fused_chord)
    for k in counters:
        k.launches = 0
    freqs, ref = cmg_noise_table()
    ctx = T.SimSpec.make(gmin=1e-15)
    out = []
    for d in (dev, "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp = T.compile_circuit(T.elaborate(
            T.parse_spice(netlists.CMG_INVERTER_NOISE),
            include_paths=[ASAP7_DIR]), device=d)
        t1 = time.perf_counter()
        ns = T.noise(comp, "q", freqs, ctx=ctx)
        torch.cuda.synchronize()
        out.append((ns.psd, t1 - t0, time.perf_counter() - t1))
    (psd, setup_s, noise_s), cpu = out
    ng_err = float(np.max(np.abs(np.sqrt(np.abs(psd)) / ref - 1.0)))
    cpu_err = float(np.max(np.abs(psd - cpu[0]) / cpu[0]))
    launches = {k.__name__: k.launches for k in counters}
    log("cmg_noise", frequencies=len(freqs), ngspice_rel_err=ng_err,
        ngspice_rtol=CMG_NGSPICE_RTOL, cpu_psd_rel_err=cpu_err,
        cpu_rtol=CMG_PSD_RTOL, setup_s=setup_s, noise_s=noise_s,
        cpu_setup_s=cpu[1], cpu_noise_s=cpu[2],
        launches=launches, card=smi())
    if any(launches.values()):
        raise AssertionError(f"a hand-written kernel launched: {launches}")
    if not (ng_err <= CMG_NGSPICE_RTOL and cpu_err <= CMG_PSD_RTOL):
        raise AssertionError(f"CMG inverter noise: ngspice {ng_err:.3g}, "
                             f"card vs CPU {cpu_err:.3g}")


def vbic_setup(torch, T, dev):
    """Cell V's lanes on the card (``vbic_amp.setup``) and their fused
    plan: (lanes, set-up s, plan, plan s)."""
    from cedarsim_tpu_torch.analysis.tran import fused_plan_for
    from cedarsim_tpu_torch.benchmarks import vbic_amp
    amp, setup_s = vbic_amp.setup(device=dev)
    t0 = time.perf_counter()
    plan = fused_plan_for(*amp[:3])
    return amp, setup_s, plan, time.perf_counter() - t0


def phase_vbic_fused_kernel(torch, T, fc, amp, plan, t_plan):
    """Phase 24: B1 on the VBIC plan against its plain version on cell V's
    32 lanes (cell V's fused options, h = 1e-6 and 1e-4); its device, call
    and plain times and bound at [32, 12]; emit and nvcc seconds, ptxas's
    lines."""
    info = plan.build()
    worst = dict(xn=0.0, S=0.0, Q=0.0)
    abs_err, nnwt = 0.0, []
    for h in (1e-6, 1e-4):
        args, opts = kt.fused_args(torch, T, plan, amp[:4], h)
        k1, err = fused_vs_plain(torch, fc, plan, args, opts,
                                 f"vbic h={h}", worst)
        abs_err = max(abs_err, err["xn_abs"])
        nnwt.append([int(k1[3][:, 1].min()), int(k1[3][:, 1].max())])

    def run():
        return fc.fused_chord(plan, *args, opts)
    times = (kt.device_ms(run), kt.call_ms(run, 50),
             kt.call_ms(lambda: fc.fused_chord_plain(plan, *args, opts), 5))
    bnd, counted = fused_bound(plan, args, run())
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if any(w in ln for w in ("Function properties", "registers",
                                      "spill"))]
    log("vbic_fused_kernel", worst_rel_err=worst, nnwt_min_max=nnwt,
        ms_device_call_plain=list(times), shape=list(amp[3].shape),
        bound_ms=bnd, nodes=counted, n_inst=plan.n_inst,
        threads=plan.threads, smem_bytes=plan.smem_bytes, plan_s=t_plan,
        emit_s=info["emit_seconds"], nvcc_s=info["nvcc_seconds"],
        ptxas=ptxas, header=os.path.relpath(info["path"], REPO))
    return abs_err, times, bnd


def vbic_path(T, engine, amp, plan, cpu_counts):
    """Phases 25 ("fused") and 26 ("xla"): cell V through ``engine``, the
    public ``tran()`` (``vbic_amp.run``, every kernel count from 0 just
    before the call and read just after) over 0-6 ms, gated on every lane
    (``vbic_amp.gate``), V-fused one B1 launch per batched step attempt
    and no GESP launch, V-xla B2 and B3 launched through ``dense_lu=
    "auto"`` and no B1; the counts recorded for the cell; then the card's
    counts over 0-``V_CPU_TSTOP`` equal to the CPU's (``cpu_counts``).
    Returns the run's record."""
    from cedarsim_tpu_torch.benchmarks import vbic_amp
    fused = engine == "fused"
    res = vbic_amp.run(engine, vbic_amp.TSTOP, amp=amp, plan=plan)
    sols = res.pop("sols")
    la = res["launches"]
    if fused:
        if la["fused"] != res["attempts"] or la["fused"] <= 0 \
                or la["factor"] or la["subst"]:
            raise AssertionError(f"V-fused: launches {la}, "
                                 f"{res['attempts']} step attempts")
    elif la["fused"] or min(la["factor"], la["subst"]) <= 0 \
            or res["dense_lu"] != "mixed":
        raise AssertionError(f"V-xla: launches {la}, dense_lu "
                             f"{res['dense_lu']}")
    check_counts("V-" + engine, sols, CELL_V_FUSED if fused else CELL_V_XLA)
    r = vbic_amp.run(engine, V_CPU_TSTOP, amp=amp, plan=plan)
    got = [r["accepted"], r["rejected"], r["newton"], r["attempts"]]
    want = cpu_counts["V-" + engine]
    if got != want:
        raise AssertionError(f"cell V {engine} over 0-{V_CPU_TSTOP:g} s: "
                             f"counts {got} on the card, {want} on the CPU")
    res["card_equals_cpu_counts"] = dict(tstop=V_CPU_TSTOP, counts=got)
    return res


def vbic_noise(torch, T, gesp_lu, pivot_lu, fc, dev):
    """Phase 27: the amplifier (one stream) compiled on the card and on the
    CPU, its noise at out over ``V_NOISE_FREQS``: the PSD finite and
    positive, and the card's within 2·cond·eps of the CPU's (cond: the
    largest condition number of G + jωC at the CPU's operating point over
    the frequencies); no hand-written kernel launched.  Returns its
    record."""
    from cedarsim_tpu_torch.benchmarks import netlists, vbic_amp
    counters = (gesp_lu.lu_factor_gesp_f32, gesp_lu.lu_subst_gesp_f32,
                gesp_lu.lu_solve_gesp_f32, pivot_lu.lu_solve_pivot_f32,
                fc.fused_chord)
    for k in counters:
        k.launches = 0
    ctx = T.SimSpec.make(gmin=vbic_amp.GMIN)
    out = []
    for d in (dev, "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp = T.compile_circuit(T.elaborate(
            T.parse_spice(netlists.VBIC_AMP)), device=d)
        t1 = time.perf_counter()
        ns = T.noise(comp, "out", V_NOISE_FREQS, ctx=ctx)
        torch.cuda.synchronize()
        out.append((np.asarray(ns.psd), t1 - t0,
                    time.perf_counter() - t1, comp))
    (psd, setup_s, noise_s, _), (cpu, cpu_setup_s, cpu_noise_s, comp) = out
    op = T.solve_dc(comp, ctx=ctx)
    _, _, G, C = comp.res_jacs_fwd(op.x, ctx.with_mode("dcop"))
    w = torch.as_tensor(2 * np.pi * V_NOISE_FREQS, dtype=torch.complex128)
    A = G.to(torch.complex128)[None] + 1j * w[:, None, None] \
        * C.to(torch.complex128)[None]
    cond = float(torch.linalg.cond(A).abs().max())
    rtol = 2.0 * cond * 2.0 ** -53
    err = float(np.max(np.abs(psd - cpu) / cpu))
    launches = {k.__name__: k.launches for k in counters}
    if any(launches.values()):
        raise AssertionError(f"a hand-written kernel launched: {launches}")
    if not (np.isfinite(psd).all() and (psd > 0).all() and err <= rtol):
        raise AssertionError(f"amplifier noise: card vs CPU {err:.3g} "
                             f"(bound {rtol:.3g})")
    return dict(frequencies=len(V_NOISE_FREQS), cpu_psd_rel_err=err,
                rtol=rtol, cond=cond,
                psd_min_max=[float(psd.min()), float(psd.max())],
                setup_s=setup_s, noise_s=noise_s, cpu_setup_s=cpu_setup_s,
                cpu_noise_s=cpu_noise_s, launches=launches, card=smi())


def lv1_bdf_counts(T, lv1, method, tstop=E_BDF_CPU_TSTOP):
    """Cell E-``method``'s counts over 0-``tstop`` on ``lv1``'s lanes:
    [accepted, rejected, Newton, attempts]."""
    comp, ctx, pb, x0 = lv1[:4]
    s = T.tran(comp, (0.0, tstop), params=pb, ctx=ctx,
               opts=T.TranOptions(**dict(kt.LV1_FUSED_OPTS, method=method)),
               x0=x0)
    c = counts(s)
    return [c["accepted"], c["rejected"], c["newton"], s[0].n_attempts]


def lv1_bdf_path(torch, T, gesp_lu, fc, lv1, cpu_counts, method, want):
    """Phases 28 ("bdf3") and 29 ("bdf5"): cell E with ``method`` over
    0-700 ns, gated on every lane (``gate_lv1``), one B1 launch per batched
    step attempt, its counts held to ``want``; then its counts over
    0-``E_BDF_CPU_TSTOP`` equal to the CPU's (``cpu_counts``).  Returns
    its record."""
    sols, launches, wall = lv1_run(torch, T, gesp_lu, fc, lv1, "E",
                                   LV1_TSTOP, method=method)
    worst = gate_lv1(sols, LV1_TSTOP)
    check_counts("E-" + method, sols, want)
    got = lv1_bdf_counts(T, lv1, method)
    if got != cpu_counts["E-" + method]:
        raise AssertionError(f"cell E-{method} over 0-{E_BDF_CPU_TSTOP:g} "
                             f"s: counts {got} on the card, "
                             f"{cpu_counts['E-' + method]} on the CPU")
    return dict(cell="E-" + method, tstop=LV1_TSTOP, lanes=len(sols),
                wall_s=wall, transients_per_s=len(sols) / wall,
                worst_gate_err=worst, **counts(sols),
                attempts=sols[0].n_attempts, launches=launches,
                card_equals_cpu_counts=dict(tstop=E_BDF_CPU_TSTOP,
                                            counts=got), card=smi())


def a14b_vbic_bdf(out):
    """Phases 25-29, the first half of ``a14b_both_child`` (two torch
    threads).  First the CPU's side of their count comparisons, from the
    CPU's own lanes: cell V's counts over 0-``V_CPU_TSTOP`` through each
    engine (``dense_lu="mixed"`` for V-xla: the kernels' plain versions)
    and cells E-bdf3/E-bdf5's over 0-``E_BDF_CPU_TSTOP``; then on the
    card cell V's lanes and plan (its library built by the main process
    before), V-fused, V-xla, the amplifier's noise, and cells E-bdf3 and
    E-bdf5 on the level-1 lanes.  Each phase's record, with the seconds
    the set-ups took, saved to OUT (JSON); a line to stderr at each
    step."""
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.benchmarks import vbic_amp
    from cedarsim_tpu_torch.ops import gesp_lu, pivot_lu
    from cedarsim_tpu_torch.ops import fused_chord as fc
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)

    def say(what):
        print(f"a14b: {what}", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    amp_cpu = vbic_amp.setup(device="cpu")[0]
    cpu_counts = {}
    for engine in ("fused", "xla"):
        r = vbic_amp.run(engine, V_CPU_TSTOP, amp=amp_cpu,
                         dense_lu=None if engine == "fused" else "mixed")
        cpu_counts["V-" + engine] = [r["accepted"], r["rejected"],
                                     r["newton"], r["attempts"]]
    lv1_cpu = kt.lv1_lanes(torch, T, torch.device("cpu"))
    for method in ("bdf3", "bdf5"):
        cpu_counts["E-" + method] = lv1_bdf_counts(T, lv1_cpu, method)
    rec = dict(cpu_counts=cpu_counts, cpu_s=time.perf_counter() - t0)
    say(f"CPU counts in {rec['cpu_s']:.1f} s")
    amp, rec["vbic_setup_s"], plan, rec["vbic_plan_s"] = vbic_setup(
        torch, T, dev)
    for engine in ("fused", "xla"):
        rec["vbic_" + engine] = vbic_path(T, engine, amp, plan, cpu_counts)
        say(f"V-{engine} done")
    rec["vbic_noise"] = vbic_noise(torch, T, gesp_lu, pivot_lu, fc, dev)
    t0 = time.perf_counter()
    lv1 = kt.lv1_lanes(torch, T, dev)
    rec["lv1_setup_s"] = time.perf_counter() - t0
    for method, want in (("bdf3", CELL_E_BDF3), ("bdf5", CELL_E_BDF5)):
        rec["lv1_" + method] = lv1_bdf_path(torch, T, gesp_lu, fc, lv1,
                                            cpu_counts, method, want)
        say(f"E-{method} done")
    with open(out, "w") as f:
        json.dump(rec, f)


def a14b_both_child(out):
    """``--a14b-both-child OUT``: the A14b child, started after phase 8
    beside cell G's: phases 25-29 (``a14b_vbic_bdf``, record to OUT) then
    phases 30-33 (``a14b3_delay_latch``, record to OUT.a14b3), one after
    the other in one card process."""
    a14b_vbic_bdf(out)
    a14b3_delay_latch(out + ".a14b3")


def phase_a14b(out, waited):
    """Phases 25-29's lines, from their record (``a14b_vbic_bdf``)
    at ``out``; returns (V's launches by engine, E-bdf's by method)."""
    with open(out) as f:
        rec = json.load(f)
    log("a14b_setup", cpu_counts=rec["cpu_counts"], cpu_s=rec["cpu_s"],
        vbic_setup_s=rec["vbic_setup_s"], vbic_plan_s=rec["vbic_plan_s"],
        lv1_setup_s=rec["lv1_setup_s"], ran_in_child=True, waited_s=waited)
    for phase in ("vbic_fused", "vbic_xla", "vbic_noise", "lv1_bdf3",
                  "lv1_bdf5"):
        log(phase, **rec[phase], ran_in_child=True)
    return ({e: rec["vbic_" + e]["launches"] for e in ("fused", "xla")},
            {m: rec["lv1_" + m]["launches"] for m in ("bdf3", "bdf5")})


#: phases 30-33: the delay ring and the latch channel (cell O,
#: ``benchmarks/lossy_link.py``; the history line, the latch cases and kT/C,
#: ``benchmarks/delay_latch.py``); the cells' recorded counts (accepted,
#: rejected, Newton, attempts over all lanes) and the lanes of phases
#: 31-32
CELL_O = (27328, 0, 28443, 856)
CELL_H = (9680, 6232, 31352, 1988)
DL_LANES = 8
#: phase 31: the sine-driven history line's card and CPU counts are held
#: equal over 0-``H_CPU_TSTOP``: its LTE is pure cancellation (no
#: capacitance, a sine drive), so the last bits in which CUDA's pow and sin
#: round apart from the CPU's (``benchmarks/card_rounding.py``) part the
#: grids at step 32, 0.327 µs (ROADMAP C13); the pulsed line is held equal
#: over its whole window
H_CPU_TSTOP = 3e-7
#: the link's AC sweep (``tests/test_ltra_urc.py::test_ltra_ac_exact_two_
#: port``: R·LEN = 30 Ω, RL = 75 Ω) and the history line's
LINK_AC_FREQS = np.array([1e6, 1e7, 2e7, 123.4e6])
LINE_AC_FREQS = np.array([1e3, 1e5, 1e6, 5e6])
#: phase 33: the card's and the CPU's kT/C waveforms over their first
#: accepted steps
KTC_STEPS, KTC_WAVE_ATOL = 500, 1e-12


def _tot(sols):
    """[accepted, rejected, Newton, attempts] over all lanes."""
    return [sum(s.n_accepted for s in sols), sum(s.n_rejected for s in sols),
            sum(s.n_newton for s in sols), sols[0].n_attempts]


def _gesp_path(what, la):
    """B2 and B3 launched, B1 not."""
    if la["fused"] or min(la["factor"], la["subst"]) <= 0:
        raise AssertionError(f"{what}: launches {la}")


def _same_counts(what, card, cpu):
    if list(card) != list(cpu):
        raise AssertionError(f"{what}: counts {card} on the card, {cpu} "
                             "on the CPU")


def _ac_card_cpu(torch, T, what, make, freqs, probe, closed, closed_tol):
    """``ac`` of the circuit ``make(device)`` on the card and on the CPU:
    the card's solution within 2·cond·eps of the CPU's (cond: the largest
    condition number of the CPU's system over the frequencies, each
    frequency's error relative to its largest entry), and ``probe``'s value
    within ``closed_tol`` of ``closed(freqs)``.  Returns its record."""
    from cedarsim_tpu_torch.analysis import ac as tac
    out = []
    for d in ("cuda", "cpu"):
        comp = make(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = T.ac(comp, freqs)
        torch.cuda.synchronize()
        out.append((sol, time.perf_counter() - t0, comp))
    (sc, card_s, _), (sp, cpu_s, comp) = out
    A, _, _ = tac._system(comp, sp.op_x, T.SimSpec.make().with_mode("ac"),
                          comp.params0, freqs)
    cond = float(torch.linalg.cond(A).abs().max())
    vc, vp = sc.v.cpu().numpy(), sp.v.numpy()
    err = float(np.max(np.abs(vc - vp).max(1) / np.abs(vp).max(1)))
    rtol = 2.0 * cond * 2.0 ** -53
    if not err <= rtol:
        raise AssertionError(f"{what} AC: card vs CPU {err:.3g} (bound "
                             f"{rtol:.3g})")
    cerr = float(np.max(np.abs(sc[probe] - closed(freqs))))
    if not cerr <= closed_tol:
        raise AssertionError(f"{what} AC: {cerr:.3g} from the closed form")
    return dict(frequencies=len(freqs), cpu_rel_err=err, rtol=rtol,
                cond=cond, closed_form_err=cerr, card_s=card_s, cpu_s=cpu_s)


def link_ac_closed(freqs, rtot=30.0, rl=75.0):
    """V(b) of the link by the exact RLCG two-port and the node equations
    (``tests/test_ltra_urc.py::test_ltra_ac_exact_two_port``)."""
    from cedarsim_tpu_torch.benchmarks import netlists
    z0, td = netlists.LINK_Z0, netlists.LINK_TD
    out = []
    for f in freqs:
        s = 2j * np.pi * f
        zs, yp = rtot + s * z0 * td, s * td / z0
        gl, zc = np.sqrt(zs * yp), np.sqrt(zs / yp)
        y11, y12 = 1.0 / (zc * np.tanh(gl)), -1.0 / (zc * np.sinh(gl))
        out.append(np.linalg.solve(np.array([[1 / 50.0 + y11, y12],
                                             [y12, y11 + 1 / rl]]),
                                   np.array([1 / 50.0, 0.0]))[1])
    return np.asarray(out)


def a14b3_delay_latch(out):
    """Phases 30-33, the second half of ``a14b_both_child`` (two torch
    threads).  First the CPU's side of every comparison
    (``dense_lu="mixed"`` where the card takes B2/B3: the kernels' plain
    versions), then the card's runs, every kernel count from 0 just before
    each run and read just after: cell O, the link's AC, the history line
    at 8 lanes and its AC, the C12 witness (one stream), the four latch
    cases at 8 lanes and kT/C (one stream).  Each phase's record saved to
    OUT (JSON); a line to stderr at each step."""
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.benchmarks import delay_latch as dl
    from cedarsim_tpu_torch.benchmarks import lossy_link, netlists
    from cedarsim_tpu_torch.ops import gesp_lu
    from cedarsim_tpu_torch.ops import fused_chord as fc
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    counters = (fc.fused_chord, gesp_lu.lu_factor_gesp_f32,
                gesp_lu.lu_subst_gesp_f32)

    def say(what):
        print(f"a14b3: {what}", file=sys.stderr, flush=True)

    def launched(fn):
        for k in counters:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dict(zip(
            ("fused", "factor", "subst"), (k.launches for k in counters)))

    def line_run(comp, lanes, tstop=dl.LINE_TSTOP, dense_lu="auto"):
        kw = dict(params=dl.rl_lanes(comp, lanes)) if lanes else {}
        return T.tran(comp, (0.0, tstop), **kw, opts=T.TranOptions(
            **dl.LINE_OPTS, dense_lu=dense_lu))

    def latch_run(case, device, dense_lu="auto"):
        comp, tstop = dl.latch_case(case, device)
        return T.tran(comp, (0.0, tstop), params=dl.rl_lanes(comp, DL_LANES),
                      opts=T.TranOptions(**dl.LATCH_OPTS, dense_lu=dense_lu))

    def witness(sol):
        if sol.converged and not sol.n_ring_underflow:
            raise AssertionError("C12: the short-ring line converged with "
                                 "no underflow")
        return dict(converged=sol.converged, t_end=float(sol.ts[-1]),
                    accepted=sol.n_accepted, rejected=sol.n_rejected,
                    newton=sol.n_newton, ring_underflow=sol.n_ring_underflow)

    t0 = time.perf_counter()
    cpu = {}
    link_cpu = lossy_link.run(device="cpu", dense_lu="mixed")
    cpu["O"] = [link_cpu[k] for k in ("accepted", "rejected", "newton",
                                      "attempts")]
    cpu["H"] = _tot(line_run(dl.delay_line("cpu"), DL_LANES,
                             tstop=H_CPU_TSTOP, dense_lu="mixed"))
    cpu["H_pulse"] = _tot(line_run(dl.delay_line("cpu", source="pulse"),
                                   DL_LANES, dense_lu="mixed"))
    cpu["C12"] = witness(line_run(dl.delay_line("cpu", td=dl.C12_TD), 0))
    for case in dl.LATCH_CASES:
        cpu[case] = _tot(latch_run(case, "cpu", "mixed"))
    kc, kctx, kopts = dl.ktc("cpu")
    ktc_cpu = T.tran(kc, (0.0, dl.KTC_SPAN), ctx=kctx, opts=kopts)
    rec = dict(cpu_counts=cpu, cpu_s=time.perf_counter() - t0)
    say(f"CPU side in {rec['cpu_s']:.1f} s")

    # phase 30: cell O, and the link's AC
    link, setup_s = lossy_link.setup(device=dev)
    res, _, _ = launched(lambda: lossy_link.run(link=link))
    res.pop("sols")
    res["setup_s"] = setup_s
    _gesp_path("cell O", res["launches"])
    got = [res[k] for k in ("accepted", "rejected", "newton", "attempts")]
    _same_counts("cell O", got, cpu["O"])
    _same_counts("cell O (recorded)", got, CELL_O)
    rec["lossy_link"] = dict(res, card_equals_cpu_counts=True, card=smi())
    rec["lossy_link_ac"] = _ac_card_cpu(
        torch, T, "link",
        lambda d: T.compile_circuit(T.elaborate(T.parse_spice(
            netlists.lossy_link(30.0, 75.0, pulse=False))), device=d),
        LINK_AC_FREQS, "b", link_ac_closed, 2e-6)
    say("cell O done")

    # phase 31: the history line at 8 lanes (sine and pulse), its AC and
    # the C12 witness
    comp = dl.delay_line(dev)
    sols, wall, la = launched(lambda: line_run(comp, DL_LANES))
    _gesp_path("history line", la)
    worst = dl.sine_gate(sols)
    got = _tot(sols)
    _same_counts("history line (recorded)", got, CELL_H)
    early = _tot(line_run(comp, DL_LANES, tstop=H_CPU_TSTOP))
    _same_counts(f"history line over 0-{H_CPU_TSTOP:g} s", early, cpu["H"])
    pcomp = dl.delay_line(dev, source="pulse")
    psols, pwall, pla = launched(lambda: line_run(pcomp, DL_LANES))
    _gesp_path("pulsed history line", pla)
    pworst = dl.pulse_gate(psols)
    pgot = _tot(psols)
    _same_counts("pulsed history line", pgot, cpu["H_pulse"])
    rec["delay_history"] = dict(
        lanes=DL_LANES, tstop=dl.LINE_TSTOP, wall_s=wall,
        transients_per_s=DL_LANES / wall, worst_sine_err=worst,
        counts=got, ring_underflow=sum(s.n_ring_underflow for s in sols),
        launches=la, card_equals_cpu_counts=dict(tstop=H_CPU_TSTOP,
                                                 counts=early),
        pulse=dict(wall_s=pwall, counts=pgot, worst_err=pworst,
                   launches=pla, card_equals_cpu_counts=True), card=smi())
    rec["delay_history_ac"] = _ac_card_cpu(
        torch, T, "history line", lambda d: dl.delay_line(d, source=0.0),
        LINE_AC_FREQS, "out",
        lambda f: np.exp(-2j * np.pi * f * dl.LINE_TD), 1e-9)
    sol, wall, la = launched(lambda: line_run(
        dl.delay_line(dev, td=dl.C12_TD), 0))
    if any(la.values()):
        raise AssertionError(f"C12 (one stream): launches {la}")
    rec["c12_witness"] = dict(card=witness(sol), cpu=cpu["C12"], wall_s=wall,
                              delay_history=T.TranOptions().delay_history)
    say("history line done")

    # phase 32: the latch cases at 8 lanes
    rec["latch"] = {}
    for case in dl.LATCH_CASES:
        sols, wall, la = launched(lambda: latch_run(case, dev))
        _gesp_path(f"latch {case}", la)
        worst = dl.latch_gate(case, sols)
        got = _tot(sols)
        _same_counts(f"latch {case}", got, cpu[case])
        rec["latch"][case] = dict(lanes=DL_LANES, wall_s=wall, counts=got,
                                  worst_gate_err=worst, launches=la)
    rec["latch"]["card"] = smi()
    say("latch cases done")

    # phase 33: kT/C, one stream, card against CPU
    kc, kctx, kopts = dl.ktc(dev)
    sol, wall, la = launched(lambda: T.tran(kc, (0.0, dl.KTC_SPAN),
                                            ctx=kctx, opts=kopts))
    ratio = dl.ktc_ratio(sol)
    if not 0.6 < ratio < 1.4:
        raise AssertionError(f"kT/C: variance {ratio:.3g}·kT/C")
    if sol.n_accepted != ktc_cpu.n_accepted or any(la.values()):
        raise AssertionError(f"kT/C: {sol.n_accepted} accepted steps on "
                             f"the card, {ktc_cpu.n_accepted} on the CPU; "
                             f"launches {la}")
    n = KTC_STEPS + 1
    werr = float(np.max(np.abs(sol.xs[:n] - ktc_cpu.xs[:n])))
    if not werr <= KTC_WAVE_ATOL:
        raise AssertionError(f"kT/C: the card's waveform {werr:.3g} V from "
                             "the CPU's")
    rec["transient_noise"] = dict(
        wall_s=wall, accepted=sol.n_accepted, rejected=sol.n_rejected,
        newton=sol.n_newton, var_over_ktc=ratio,
        cpu_var_over_ktc=dl.ktc_ratio(ktc_cpu), wave_err=werr,
        wave_steps=KTC_STEPS, card=smi())
    say("kT/C done")
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_a14b3(out, waited):
    """Phases 30-33's lines, from their record (``a14b3_delay_latch``)
    at ``out``; returns B2/B3's launches in cell O, the history line and
    the latch cases."""
    with open(out) as f:
        rec = json.load(f)
    log("a14b3_setup", cpu_counts=rec["cpu_counts"], cpu_s=rec["cpu_s"],
        ran_in_child=True, waited_s=waited)
    for phase in ("lossy_link", "lossy_link_ac", "delay_history",
                  "delay_history_ac", "c12_witness", "latch",
                  "transient_noise"):
        log(phase, **rec[phase], ran_in_child=True)
    latch = {k: sum(v["launches"][k] for c, v in rec["latch"].items()
                    if c != "card") for k in ("factor", "subst")}
    dh = rec["delay_history"]
    return dict(link=rec["lossy_link"]["launches"],
                delay={k: dh["launches"][k] + dh["pulse"]["launches"][k]
                       for k in ("factor", "subst")}, latch=latch)


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
    a16b = a16b_sparse(torch, T, torch.device("cuda", 0))
    with open(out, "wb") as f:
        np.savez(f, rec=json.dumps(rec), launches=json.dumps(launches),
                 x_op=x_op, a16b=json.dumps(a16b))


def start_child(kind, *args):
    """This script with ``--<kind>-child [ARGS] OUT`` in a child process
    (phase 19's main path, ``sparse_child``, or cell G's through the
    engine in ARGS, ``cmg_child``, each started after phase 8),
    host-bound on its own core beside the main process's phases.  Returns
    (scratch directory, {name: (output path, stderr file, process)}), the
    name ``kind`` joined by "_" to the ARGS that are not absolute paths
    (a record that the child reads), as ``start_repeat_children``;
    ``stop_children`` ends it."""
    import tempfile
    name = "_".join((kind,) + tuple(a for a in args
                                    if not os.path.isabs(a)))
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    out = os.path.join(tmp, f"{name}.out")
    err = open(os.path.join(tmp, "stderr.txt"), "w")
    p = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"--{kind}-child",
         *args, out], stdout=subprocess.DEVNULL, stderr=err)
    track_child(name, p)
    return tmp, {name: (out, err, p)}


def join_child(child):
    """Wait for a child of ``start_child``; returns (its output path, the
    seconds waited), or raises with the end of its stderr if it failed."""
    _, procs = child
    (kind, (out, err, p)), = procs.items()
    t0 = time.perf_counter()
    p.wait(timeout=1100)
    err.flush()
    if p.returncode != 0:
        with open(err.name) as f:
            raise AssertionError(f"the {kind} child failed:\n"
                                 f"{f.read()[-4000:]}")
    return out, time.perf_counter() - t0


def join_sparse_child(child):
    """Wait for phase 19's child; returns what ``sparse_main_path`` did,
    and phase 39's record (``a16b_sparse``)."""
    out, waited = join_child(child)
    z = np.load(out, allow_pickle=False)
    return (json.loads(str(z["rec"])), json.loads(str(z["launches"])),
            z["x_op"], waited), json.loads(str(z["a16b"]))


def phase_sparse_check(torch, T, dev, main):
    """Phase 19's checks on what its main path (``sparse_main_path``)
    returned: the plan, the dense DC, ẋ0's memory, C6's witness and the
    chain with lanes (see the module docstring).  Returns what the timing
    half (``phase_sparse``) needs."""
    from cedarsim_tpu_torch.benchmarks import chain_transient as ct
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.core.sparse_ops import get_sparse_ops
    from cedarsim_tpu_torch.ops import gesp_lu, pivot_lu, sparse_lu
    from cedarsim_tpu_torch.ops import fused_chord as fc
    rec, launches, x_op, waited_s = main
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
    log("sparse_check", n_x=comp.n_x, n_levels=plan.n_levels, nnz=plan.nnz,
        nnz_f=plan.nnz_f, forward_levels=len(plan.f_lev),
        backward_levels=len(plan.b_lev), plan_equal_cpu=True,
        dense_dc_s=dense_dc_s, dc_sparse_vs_dense_v=dc_err,
        lanes=dict(lanes=SPARSE_BATCH, tstop=CHAIN_LANES_TSTOP,
                   wall_s=batch_s, attempts=batch[0].n_attempts,
                   accepted=batch[0].n_accepted, bitwise_one_stream=True),
        xdot0_memory=xdot0, c6=c6, transient=rec, launches=launches,
        waited_for_child_s=waited_s,
        wall_per_attempt_ms=1e3 * rec["wall_s"] / rec["attempts"])
    return comp, sops, ctx, x_op, launches


def phase_sparse(torch, T, dev, state):
    """Phase 19's timing half, run once no other process shares the card:
    S1 and S2 on the chain's equilibrated Jacobian at its operating point
    at 1 and 8 lanes, bitwise their plain versions, with their times,
    the dense library call's and the bound.  Returns S1's and S2's kernel
    entries."""
    from cedarsim_tpu_torch.core.sparse_ops import TAU
    from cedarsim_tpu_torch.ops import sparse_lu
    comp, sops, ctx, x_op, launches = state
    plan = sops.plan
    b = sparse_lu.build()
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
    log("sparse", kernel_times={
            f"L{L}": {k: (list(v) if isinstance(v, tuple) else v)
                      for k, v in e.items()} for L, e in entries.items()},
        nvcc_s=b["seconds"], ptxas=[ln.strip() for ln in b["log"]
                                    .splitlines() if "registers" in ln],
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


def lu_solves(gesp_lu, pivot_lu):
    """B4 and B5 with their plain versions."""
    return {"gesp": (gesp_lu.lu_solve_gesp_f32,
                     gesp_lu.lu_solve_gesp_f32_plain),
            "pivot": (pivot_lu.lu_solve_pivot_f32,
                      pivot_lu.lu_solve_pivot_f32_plain)}


def phase_lu_check(torch, gesp_lu, pivot_lu, dev):
    """Phase 8's checking half: B4 and B5 against their plain versions
    at ``LU_CHECK_SHAPES`` and at a pivot-forcing [16, 25]."""
    solves = lu_solves(gesp_lu, pivot_lu)
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
    log("lu_check", bitwise_equal_to_plain=checked)


def phase_lu(torch, gesp_lu, pivot_lu, dev):
    """Phase 8's timing half, run once no other process shares the card:
    the dense-LU bench at full width (its gates; both kernels must
    launch), and B4's and B5's per-launch times at the bench's shapes
    beside their checks there.  Returns (launches, per-shape numbers)."""
    from cedarsim_tpu_torch.benchmarks import lu_bench
    solves = lu_solves(gesp_lu, pivot_lu)
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
    log("lu_bench", bench_wall_s=wall, launches=launches,
        bench_us_per_solve={f"{r['variant']} {r['B']}x{r['n']}":
                            r["us_per_solve"] for r in rows},
        bench_rel_err={f"{r['variant']} {r['B']}x{r['n']}": r["rel_err"]
                       for r in rows},
        per_launch={f"{B}x{n}": v for (B, n), v in per_shape.items()},
        card=smi())
    return launches, per_shape


# ------------------------------------------------- phases 34-36 (A16, A17)

#: phase 34: d_neg of the BSIM4 DFF (D's inverted copy, 5 V at the
#: transient operating point) against the W of its pull-up x_tp10 and
#: VDD's dc; the central differences step each by 1 % (at 0.1 % a W step
#: moves d_neg by ~3e-13 V, under the DC Newton's stopping tolerance)
A16_NODE = "d_neg"
A16_WRT = ("x_tp10.mp.W", "vvdd.dc")
A16_FD_REL = 1e-2
#: the central difference's truncation error at a 1 % step (5.4e-5 for W
#: on the CPU) with room
A16_FD_RTOL = 2e-3
#: the DC solves' options: the update limited to 0.5 V and 20 iterations a
#: rung reach the BSIM4 DFF's operating point in 87 Newton iterations
#: from zeros, the defaults (5 V, 60) in 316, at ~60 ms an iteration on
#: the card (one stream, the eager walk); the same point to the last bit
#: on the CPU
A16_DC_OPTS = dict(max_step=0.5, max_iter=20)
#: the level-1 DFF's d_neg mid-way down its fall after D's rise at 200 ns
#: (4.3 V at 200.5 ns, 0.9 V at 200.75 ns), against x_tn10's W (the
#: pull-down), over 200-200.7 ns from the operating point at 200 ns (68
#: accepted steps)
A16_LV1 = dict(node="d_neg", wrt="x_tn10.mn.w", window=(2.0e-7, 2.007e-7),
               t_eval=2.006e-7)
#: its transients' options: the per-step chord (one exact factor a step
#: attempt) gives the full Newton's derivative to 1e-10 in 0.76 of its
#: time on the CPU
A16_LV1_OPTS = dict(max_steps=4096, jac_reuse=1)
#: its central difference moves W by ±0.1 % in one ``tran`` of two lanes
#: (the exact solve): each lane takes its own steps, so the difference
#: carries the step sequence's change (0.73 % on the CPU); the bound is
#: that with room
A16_LV1_FD_REL = 1e-3
A16_LV1_FD_RTOL = 0.03
#: card against CPU: the same float64 walks and solves, apart in the last
#: bits of the card's libm and its row sums (ROADMAP C13), which the
#: leakage-set d_neg and the transient's Newton loops carry into these
#: derivatives at far below this bound
A16_CPU_RTOL = 1e-6
#: phase 35: cell V's amplifier, one stream, nominal AREA, its 500 Hz
#: drive: shooting over T = 2 ms, HB at 7 harmonics (its warm-up 2
#: periods through B1), PAC and PNOISE at four frequencies
A17_PERIOD = 2e-3
A17_HARMONICS = 7
#: the shooting tolerance (relative to max|x0| + 1 = 6 V): the 10 µF
#: couplings give M eigenvalues near 1, so M − I amplifies the transient's
#: own error (rtol 1e-3) and at pss's default 1e-9 the Newton takes 8
#: iterations to 2 at this tolerance on the CPU; the per-step chord
#: (``jac_reuse=1``, one factor a step attempt) gives the same orbit to
#: 1e-13 V in 0.65 of the full Newton's time
A17_PSS_TOL = 1e-6
A17_PSS_OPTS = dict(jac_reuse=1)
A17_PAC_FREQS = np.array([100.0, 500.0, 2e3, 1e4])
A17_NOISE_FREQS = np.array([100.0, 1e3, 1e4, 1e5])
#: the reference's cross-method check (tests/test_bipolar_amplifier.py):
#: the fundamental within 25 % of |AC gain| × 1 mV
A17_AC_RTOL = 0.25
#: HB's fundamental against the PSS orbit's: two steady-state solutions
#: of one circuit, the orbit from an adaptive transient at rtol 1e-3
A17_PSS_HB_RTOL = 1e-2
#: PAC (k = 0) against AC and PNOISE against noise(): at a 1 mV drive the
#: transistor's gm swings ±4 % (1 mV/V_T) about the operating point, and
#: the averages about the orbit part from the operating point's values by
#: a few 1e-4 (test_hb.py's LTI cases hold 1e-9 with no swing)
A17_LTI_RTOL = 1e-2
#: card against CPU: both Newton loops stop at tol·scale (PSS 1e-9·6 V,
#: HB 1e-9·6 V) from starts that part in the last bits (the card's libm,
#: B1 against its plain version in the warm-up)
A17_CPU_ATOL = 1e-7
A17_CPU_RTOL = 1e-6
#: phase 36: test_hb.py's level-1 ring oscillator at its 13 harmonics;
#: its warm-up through B1 is 5 guessed periods (the JAX test's 20 cost
#: ~2,100 step attempts; 8, 952 attempts) and the kicked transient's
#: crossings are taken over guessed periods 2-4 (the JAX test's 20-30;
#: 1.4e-3 from HB's period on the CPU, 708 attempts), within that test's
#: 2 %
RING_NETLIST = """ring3
.param wp=20u wn=10u
VDD vdd 0 3.3
M1p n2 n1 vdd vdd pmos W='wp' L=1u
M1n n2 n1 0   0   nmos W='wn' L=1u
M2p n3 n2 vdd vdd pmos W='wp' L=1u
M2n n3 n2 0   0   nmos W='wn' L=1u
M3p n1 n3 vdd vdd pmos W='wp' L=1u
M3n n1 n3 0   0   nmos W='wn' L=1u
C1 n1 0 0.5p
C2 n2 0 0.5p
C3 n3 0 0.5p
.model nmos nmos level=1 vto=0.7 kp=100u gamma=0.4 lambda=0.05 cgso=1n cgdo=1n
.model pmos pmos level=1 vto=-0.8 kp=40u gamma=0.5 lambda=0.05 cgso=1n cgdo=1n
.end
"""
RING_T_GUESS = 6e-9
RING_KICK = 0.3 * 3.3
RING_HARMONICS = 13
RING_WARMUP = 5.0
RING_TRAN_SPAN = (2, 4)
#: the kicked transient through B1 at the default tolerances (the
#: exact-solve chord loop over guessed periods 4-8, 1,448 attempts, took
#: 34 s on the card)
RING_TRAN_OPTS = dict(max_steps=16384, jac_reuse=1, formulation="cap",
                      newton_impl="fused")
RING_TRAN_RTOL = 0.02
#: the PPV's biorthogonality spread along the orbit (test_hb.py's bound)
RING_SPREAD = 0.05
#: init_fragility on the level-1 DFF: 256 starts, each node voltage
#: FRAG_CENTER + FRAG_SIGMA·N(0, 1) from numpy's default_rng(FRAG_SEED),
#: each branch current 0, with phase 34's Newton options (with the
#: defaults 225 of 256 reach an operating point on the CPU and the other
#: 31 run every rung, 1,204 iterations; with these all 256 do, in at most
#: 295)
FRAG_STARTS = 256
FRAG_CENTER = 2.5
FRAG_SIGMA = 0.5
FRAG_SEED = 34
#: a lane's operating point on the card against the CPU's: the DC Newton
#: stops at |dx| <= 1e-4·|x| + 1e-9 and its last step is quadratic
FRAG_ATOL = 1e-9


def kernel_counters():
    """Every hand-written kernel's wrapper (its ``launches`` count)."""
    from cedarsim_tpu_torch.ops import fused_chord as fc
    from cedarsim_tpu_torch.ops import gesp_lu, pivot_lu, sparse_lu
    return {"fused": fc.fused_chord,
            "factor": gesp_lu.lu_factor_gesp_f32,
            "subst": gesp_lu.lu_subst_gesp_f32,
            "gesp_solve": gesp_lu.lu_solve_gesp_f32,
            "pivot_solve": pivot_lu.lu_solve_pivot_f32,
            "sparse_factor": sparse_lu.factor,
            "sparse_solve": sparse_lu.solve_factored}


def counted(fn):
    """(fn(), {kernel: launches during it}): every count set to 0 just
    before the call and read just after."""
    ks = kernel_counters()
    for k in ks.values():
        k.launches = 0
    out = fn()
    return out, {name: k.launches for name, k in ks.items()}


def _rel(a, b):
    a, b = np.asarray(a, dtype=complex), np.asarray(b, dtype=complex)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def a16_run(T, dev):
    """Phase 34's analyses on ``dev``: the BSIM4 DFF's ``dc_sensitivity``
    and ``tf`` at the transient operating point, and the level-1 DFF's
    ``tran_sensitivity``; each with its wall."""
    from cedarsim_tpu_torch.analysis import sensitivity as sens
    from cedarsim_tpu_torch.core.context import Modes
    out = {}
    nl = T.parse_spice(open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")).read(),
                       file="dff_tb_bsim4.cir")
    comp = T.compile_circuit(T.elaborate(nl, include_paths=[DFF_DIR]),
                             device=dev)
    ctx = T.SimSpec.make(gmin=1e-15)
    t0 = time.perf_counter()
    opts = T.NewtonOptions(**A16_DC_OPTS)
    val, g = sens.dc_sensitivity(comp, A16_NODE, list(A16_WRT), ctx=ctx,
                                 opts=opts, mode=Modes.TRANOP)
    out["dc"] = dict(value=float(val), grad={k: float(v) for k, v in
                                             g.items()},
                     wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    r = sens.tf(comp, A16_NODE, "vvdd", ctx=ctx, opts=opts)
    out["tf"] = dict(gain=float(r["gain"]), rout=float(r["rout"]),
                     value=float(r["value"]),
                     wall_s=time.perf_counter() - t0)
    nl = T.parse_spice(open(os.path.join(DFF_DIR, "dff_tb.cir")).read(),
                       file="dff_tb.cir")
    lv1 = T.compile_circuit(T.elaborate(nl, include_paths=[DFF_DIR]),
                            device=dev)
    t0 = time.perf_counter()
    v, dv = sens.tran_sensitivity(lv1, A16_LV1["node"], A16_LV1["wrt"],
                                  A16_LV1["window"], A16_LV1["t_eval"],
                                  ctx=ctx, opts=T.TranOptions(**A16_LV1_OPTS))
    out["tran"] = dict(value=float(v), deriv=float(dv),
                       wall_s=time.perf_counter() - t0)
    return out, (comp, ctx, lv1)


def a16_fd(torch, T, comp, ctx, lv1):
    """Phase 34's central differences on the card: ``solve_dc`` from the
    operating point at each param ± 1 %, and the public ``tran`` with the
    level-1 W ± 0.1 % as two lanes."""
    from cedarsim_tpu_torch.core.compile import ensure_dynamic
    from cedarsim_tpu_torch.core.context import Modes
    c2 = ensure_dynamic(comp, A16_WRT)
    opts = T.NewtonOptions(**A16_DC_OPTS)
    op = T.solve_dc(c2, ctx=ctx, opts=opts, mode=Modes.TRANOP)
    i = c2.circuit._nets[A16_NODE].index
    fd = {}
    for name in A16_WRT:
        p0 = float(c2.get_param(c2.params0, name))
        h = abs(p0) * A16_FD_REL
        v = [float(T.solve_dc(c2, c2.set_param(c2.params0, name, p0 + s * h),
                              ctx, x0=op.x, opts=opts,
                              mode=Modes.TRANOP).x[i])
             for s in (1.0, -1.0)]
        fd[name] = (v[0] - v[1]) / (2.0 * h)
    c3 = ensure_dynamic(lv1, [A16_LV1["wrt"]])
    key, j, pn = c3.param_loc(A16_LV1["wrt"])
    w = torch.as_tensor(c3.params0[key][pn])
    h = float(w[j]) * A16_LV1_FD_REL
    pb = {k: dict(g) for k, g in c3.params0.items()}
    pb[key][pn] = w.expand(2, -1).clone()
    pb[key][pn][:, j] += torch.tensor([h, -h], dtype=w.dtype,
                                      device=w.device)
    sols = T.tran(c3, A16_LV1["window"], params=pb, ctx=ctx,
                  opts=T.TranOptions(**A16_LV1_OPTS, dense_lu="jax"))
    if not all(sol.converged for sol in sols):
        raise AssertionError("phase 34: a central-difference lane did not "
                             "finish")
    v = [float(sol.interp(A16_LV1["node"], A16_LV1["t_eval"]))
         for sol in sols]
    fd["tran"] = (v[0] - v[1]) / (2.0 * h)
    return fd


def phase_a16(torch, T, dev, cpu, emit=log):
    """Phase 34 (A16): the BSIM4 DFF's ``dc_sensitivity`` of d_neg to a
    W and to VDD's dc and ``tf`` from VDD, and the level-1 DFF's
    ``tran_sensitivity`` by forward-mode AD through the transient, on the
    card against the CPU's (``cpu``, from the A16/A17 child) and against
    central differences of the card's ``solve_dc`` and ``tran``; no
    hand-written kernel may launch (AD takes the exact solve)."""
    t0 = time.perf_counter()
    (card, objs), la = counted(lambda: a16_run(T, dev))
    t_ad = time.perf_counter() - t0
    if any(la.values()):
        raise AssertionError(f"phase 34: kernels launched under AD: {la}")
    t1 = time.perf_counter()
    fd = a16_fd(torch, T, *objs)
    t_fd = time.perf_counter() - t1
    err = {}
    for name in A16_WRT:
        got = card["dc"]["grad"][name]
        err[f"cpu {name}"] = _rel(got, cpu["dc"]["grad"][name])
        err[f"fd {name}"] = _rel(got, fd[name])
    err["cpu value"] = _rel(card["dc"]["value"], cpu["dc"]["value"])
    for k in ("gain", "rout"):
        err[f"cpu tf {k}"] = _rel(card["tf"][k], cpu["tf"][k])
    err["cpu tran value"] = _rel(card["tran"]["value"],
                                 cpu["tran"]["value"])
    err["cpu tran"] = _rel(card["tran"]["deriv"], cpu["tran"]["deriv"])
    err["fd tran"] = _rel(card["tran"]["deriv"], fd["tran"])
    bad = {k: v for k, v in err.items()
           if not v <= (A16_LV1_FD_RTOL if k == "fd tran" else
                        A16_FD_RTOL if k.startswith("fd") else
                        A16_CPU_RTOL)}
    if bad or not abs(card["tran"]["deriv"]) > 0:
        raise AssertionError(f"phase 34: {bad}; card {card}, cpu {cpu}, "
                             f"fd {fd}")
    emit("a16_sensitivity", card=card, cpu=cpu, fd=fd, rel_err=err,
        tol=dict(cpu=A16_CPU_RTOL, fd_dc=A16_FD_RTOL,
                 fd_tran=A16_LV1_FD_RTOL), launches=la, ad_wall_s=t_ad,
        fd_wall_s=t_fd, card_name=smi())


def phase_one_stream_fused_kernel(torch, T, fc, circuits):
    """B1 at B = 1 on the plans of phases 35-36's one-stream transients
    (the amplifier at nominal AREA, the ring oscillator) against its plain
    version, as phases 11 and 24: from the operating point with the node
    unknowns perturbed, at two step sizes under each option set that
    those transients launch it with.  ``circuits``: (name, compiled,
    context, step sizes, option sets).  Returns {name: max |xn − plain|}."""
    from cedarsim_tpu_torch.analysis.tran import fused_plan_for
    from cedarsim_tpu_torch.core.context import Modes
    worst = dict(xn=0.0, S=0.0, Q=0.0)
    abs_err, nnwt = {}, {}
    for name, comp, ctx, hs, option_sets in circuits:
        plan = fused_plan_for(comp, ctx, comp.params0)
        x0 = T.solve_dc(comp, ctx=ctx, mode=Modes.TRANOP).x[None]
        abs_err[name], nnwt[name] = 0.0, []
        for which, o in option_sets.items():
            for h in hs:
                args, opts = kt.fused_args(
                    torch, T, plan, (comp, ctx, comp.params0, x0), h, opts=o)
                k1, err = fused_vs_plain(torch, fc, plan, args, opts,
                                         f"{name} {which} h={h}", worst)
                abs_err[name] = max(abs_err[name], err["xn_abs"])
                nnwt[name].append(int(k1[3][0, 1]))
    log("one_stream_fused_kernel", worst_rel_err=worst, max_abs_err=abs_err,
        nnwt=nnwt, steps={name: list(hs) for name, _, _, hs, _ in circuits},
        option_sets={name: list(o) for name, *_, o in circuits},
        tol=FUSED_RTOL)
    return abs_err


def _fundamental(sol, name, period):
    """2|X_1| of one period of a transient's signal (256 uniform samples
    of its linear interpolant, from sol.ts[0])."""
    tg = sol.ts[0] + np.arange(256) * (period / 256)
    y = np.interp(tg, sol.ts, sol[name])
    return 2.0 * abs(np.fft.fft(y)[1] / 256)


def a17_driven_run(T, dev):
    """Phase 35's analyses on ``dev``: the VBIC amplifier (one stream,
    nominal AREA; compiled with AREA dynamic, as cell V, so that its
    fused plan is cell V's walk) by shooting, by HB (its warm-up through
    the fused configuration), AC, PAC and PNOISE about the HB orbit,
    ``noise``."""
    from cedarsim_tpu_torch.benchmarks import netlists, vbic_amp
    comp = T.compile_circuit(T.elaborate(T.parse_spice(netlists.VBIC_AMP)),
                             device=dev, dynamic_params=("area",))
    ctx = T.SimSpec.make(gmin=vbic_amp.GMIN)
    out, walls = {}, {}
    t0 = time.perf_counter()
    ps = T.pss(comp, A17_PERIOD, ctx=ctx, opts=T.TranOptions(**A17_PSS_OPTS),
               tol=A17_PSS_TOL)
    walls["pss"] = time.perf_counter() - t0
    out["pss"] = dict(converged=ps.converged, iters=ps.iters,
                      resnorm=ps.resnorm, x0=ps.x0.tolist(),
                      fundamental=_fundamental(ps.solution, "out",
                                               A17_PERIOD))
    t0 = time.perf_counter()
    hr, la = counted(lambda: T.hb(
        comp, A17_PERIOD, ctx=ctx, n_harmonics=A17_HARMONICS,
        tran_opts=T.TranOptions(**FUSED_OPTS)))
    walls["hb"] = time.perf_counter() - t0
    X = hr.spectrum("out")
    out["hb"] = dict(converged=hr.converged, iters=hr.iters,
                     resnorm=hr.resnorm, x=hr.x_samples.tolist(),
                     fundamental=2.0 * abs(X[1]), thd=hr.thd("out"))
    t0 = time.perf_counter()
    g = T.ac(comp, [vbic_amp.DRIVE_HZ], ctx=ctx)["out"]
    out["ac_fundamental"] = abs(complex(np.asarray(g)[0])) * vbic_amp.DRIVE_V
    p = T.pac(hr, A17_PAC_FREQS).gain("out", 0)
    a = T.ac(comp, A17_PAC_FREQS, ctx=ctx)["out"]
    out["pac"] = dict(re=np.real(p).tolist(), im=np.imag(p).tolist())
    out["ac"] = dict(re=np.real(a).tolist(), im=np.imag(a).tolist())
    out["pnoise"] = T.pnoise(hr, "out", A17_NOISE_FREQS).psd.tolist()
    out["noise"] = T.noise(comp, "out", A17_NOISE_FREQS, ctx=ctx).psd.tolist()
    walls["ac_pac_pnoise"] = time.perf_counter() - t0
    out["walls_s"] = walls
    return out, la


def phase_a17_driven(torch, T, dev, cpu, emit=log):
    """Phase 35 (A17, driven): cell V's amplifier, one stream, by
    ``pss`` and ``hb`` (converged; HB's warm-up through B1 on the VBIC
    plan), its fundamental from HB, from the PSS orbit and from |AC gain|
    × 1 mV (the reference's 25 %), PAC (k = 0) against ``ac`` and PNOISE
    against ``noise`` (near-LTI at 1 mV), everything on the card against
    the CPU's (``cpu``)."""
    t0 = time.perf_counter()
    card, la = a17_driven_run(T, dev)
    wall = time.perf_counter() - t0
    ps, hr = card["pss"], card["hb"]
    if not (ps["converged"] and hr["converged"]):
        raise AssertionError(f"phase 35: pss {ps['converged']}, hb "
                             f"{hr['converged']}")
    if la["fused"] <= 0 or any(v for k, v in la.items() if k != "fused"):
        raise AssertionError(f"phase 35: HB's warm-up launches {la}")
    fund = dict(hb=hr["fundamental"], pss=ps["fundamental"],
                ac=card["ac_fundamental"])
    pac = np.array(card["pac"]["re"]) + 1j * np.array(card["pac"]["im"])
    ac = np.array(card["ac"]["re"]) + 1j * np.array(card["ac"]["im"])
    err = dict(hb_vs_ac=_rel(fund["hb"], fund["ac"]),
               hb_vs_pss=_rel(fund["hb"], fund["pss"]),
               pac_vs_ac=_rel(pac, ac),
               pnoise_vs_noise=_rel(card["pnoise"], card["noise"]))
    cpu_err = dict(
        pss_x0=float(np.max(np.abs(np.subtract(ps["x0"], cpu["pss"]["x0"])))),
        hb_x=float(np.max(np.abs(np.subtract(hr["x"], cpu["hb"]["x"])))),
        fundamentals=max(_rel(card[k]["fundamental"], cpu[k]["fundamental"])
                         for k in ("pss", "hb")),
        pac=_rel(pac, np.array(cpu["pac"]["re"])
                 + 1j * np.array(cpu["pac"]["im"])),
        pnoise=_rel(card["pnoise"], cpu["pnoise"]),
        noise=_rel(card["noise"], cpu["noise"]))
    bad = [k for k, v in err.items() if not v <= (
        A17_AC_RTOL if k == "hb_vs_ac" else A17_PSS_HB_RTOL
        if k == "hb_vs_pss" else A17_LTI_RTOL)]
    bad += [k for k, v in cpu_err.items() if not v <= (
        A17_CPU_ATOL if k in ("pss_x0", "hb_x") else A17_CPU_RTOL)]
    if ps["iters"] != cpu["pss"]["iters"]:
        bad.append("pss iters")
    if bad:
        raise AssertionError(f"phase 35: {bad}: {err}, card vs cpu "
                             f"{cpu_err}; card {card}; cpu {cpu}")
    emit("a17_driven", fundamental=fund, rel_err=err, card_vs_cpu=cpu_err,
        pss=dict(iters=ps["iters"], resnorm=ps["resnorm"]),
        hb=dict(iters=hr["iters"], resnorm=hr["resnorm"], thd=hr["thd"],
                n_harmonics=A17_HARMONICS),
        tol=dict(ac=A17_AC_RTOL, pss_hb=A17_PSS_HB_RTOL, lti=A17_LTI_RTOL,
                 cpu_atol=A17_CPU_ATOL, cpu_rtol=A17_CPU_RTOL),
        launches=la, walls_s=card["walls_s"], wall_s=wall,
        cpu_walls_s=cpu["walls_s"], card_name=smi())
    return la


def _crossing_period(ts, y, t_lo, t_hi):
    """The mean spacing of a signal's rising mid-level crossings over
    [t_lo, t_hi] (test_hb.py's ring check)."""
    tq = np.linspace(t_lo, t_hi, 4096)
    v = np.interp(tq, ts, y)
    mid = 0.5 * (v.max() + v.min())
    up = np.where((v[:-1] < mid) & (v[1:] >= mid))[0]
    tc = tq[up] + (mid - v[up]) / (v[up + 1] - v[up]) * (tq[1] - tq[0])
    return float(np.mean(np.diff(tc)))


def a17_auto_run(T, dev, starts):
    """Phase 36's analyses on ``dev``: the ring oscillator by
    ``hb_autonomous`` (its warm-up through the fused configuration) and
    its phase noise, and ``init_fragility``'s solve of the level-1 DFF
    from ``starts``."""
    from cedarsim_tpu_torch.analysis import fragility
    walls = {}
    ring = T.compile_circuit(T.load_spice(RING_NETLIST), device=dev)
    t0 = time.perf_counter()
    res, la = counted(lambda: T.hb_autonomous(
        ring, RING_T_GUESS, anchor="n1", n_harmonics=RING_HARMONICS,
        kick=RING_KICK, warmup_periods=RING_WARMUP, tol=1e-8,
        tran_opts=T.TranOptions(**FUSED_OPTS)))
    walls["hb_autonomous"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pn = T.oscillator_phase_noise(res)
    walls["phase_noise"] = time.perf_counter() - t0
    v = res.samples("n1")
    out = dict(converged=res.converged, iters=res.iters, period=res.period,
               resnorm=res.resnorm, n1_min=float(v.min()),
               n1_max=float(v.max()), c=pn.c, norm_spread=pn.norm_spread,
               null_resid=pn.null_resid, x=res.x_samples.tolist())
    nl = T.parse_spice(open(os.path.join(DFF_DIR, "dff_tb.cir")).read(),
                       file="dff_tb.cir")
    dff = T.compile_circuit(T.elaborate(nl, include_paths=[DFF_DIR]),
                            device=dev)
    t0 = time.perf_counter()
    rep = fragility._fragility_from_starts(
        dff, starts, opts=T.NewtonOptions(**A16_DC_OPTS))
    walls["fragility"] = time.perf_counter() - t0
    frag = dict(converged=rep.converged.tolist(), x=rep.x.tolist(),
                iters=rep.iters.tolist(), counts=rep.counts.tolist(),
                solutions=rep.solutions.tolist())
    return dict(ring=out, fragility=frag, walls_s=walls), la, ring


def frag_starts(comp):
    """Phase 36's DC starts [FRAG_STARTS, n_x] for the level-1 DFF
    ``comp``: each node voltage FRAG_CENTER + FRAG_SIGMA·N(0, 1) from
    numpy's ``default_rng(FRAG_SEED)``, each branch current 0."""
    x = FRAG_CENTER + FRAG_SIGMA * np.random.default_rng(
        FRAG_SEED).standard_normal((FRAG_STARTS, comp.n_x))
    x[:, comp.n_nodes + comp.n_internal:] = 0.0
    return x


def phase_a17_auto(torch, T, dev, cpu, emit=log):
    """Phase 36 (A17, autonomous and DC): the ring oscillator's HB period
    (its warm-up through B1 on the ring's level-1 plan) against the CPU's
    and against a kicked transient's crossings, its phase noise; the
    level-1 DFF's DC from the same 256 starts on the card and the CPU,
    lane by lane."""
    from cedarsim_tpu_torch.core.context import Modes
    starts = np.asarray(cpu["starts"])
    t0 = time.perf_counter()
    card, la, ring = a17_auto_run(T, dev, starts)
    r, rc = card["ring"], cpu["ring"]
    if not (r["converged"] and rc["converged"]):
        raise AssertionError(f"phase 36: ring HB converged card "
                             f"{r['converged']}, cpu {rc['converged']}")
    # the kicked transient's own crossings
    t1 = time.perf_counter()
    op = T.solve_dc(ring, mode=Modes.TRANOP)
    x0 = op.x.clone()
    x0[ring.circuit._nets["n1"].index] += RING_KICK
    lo, hi = RING_TRAN_SPAN
    sol, la_tran = counted(lambda: T.tran(
        ring, (0.0, hi * RING_T_GUESS), x0=x0,
        opts=T.TranOptions(**RING_TRAN_OPTS)))
    t_meas = _crossing_period(sol.ts, sol["n1"], lo * RING_T_GUESS,
                              hi * RING_T_GUESS)
    walls = dict(card["walls_s"], kicked_tran=time.perf_counter() - t1)
    for what, c in (("warm-up", la), ("kicked transient", la_tran)):
        if c["fused"] <= 0 or any(v for k, v in c.items() if k != "fused"):
            raise AssertionError(f"phase 36: the ring's {what} launches {c}")
    f, fc_ = card["fragility"], cpu["fragility"]
    conv, conv_c = np.array(f["converged"]), np.array(fc_["converged"])
    xs, xs_c = np.array(f["x"]), np.array(fc_["x"])
    # a lane that reaches no operating point ends wherever its ladder
    # left it: its state is compared only where both sides converged
    both = conv & conv_c
    lane_err = np.where(both, np.abs(xs - xs_c).max(-1), 0.0)
    apart = np.nonzero((conv != conv_c) | (lane_err > FRAG_ATOL))[0]
    err = dict(period_vs_cpu=_rel(r["period"], rc["period"]),
               period_vs_tran=_rel(r["period"], t_meas),
               ring_x_vs_cpu=float(np.max(np.abs(np.subtract(r["x"],
                                                             rc["x"])))),
               c_vs_cpu=_rel(r["c"], rc["c"]))
    bad = []
    if not err["period_vs_tran"] <= RING_TRAN_RTOL:
        bad.append("period against the kicked transient")
    if not (err["period_vs_cpu"] <= A17_CPU_RTOL
            and err["ring_x_vs_cpu"] <= A17_CPU_ATOL
            and err["c_vs_cpu"] <= A17_CPU_RTOL):
        bad.append("ring against the CPU")
    if not (r["n1_min"] > -0.1 and r["n1_max"] < 3.4
            and r["n1_max"] - r["n1_min"] > 0.6 * 3.3):
        bad.append("ring swing")
    if not r["norm_spread"] < RING_SPREAD:
        bad.append("the PPV's biorthogonality spread")
    if len(apart):
        bad.append(f"fragility lanes apart from the CPU: {apart.tolist()}")
    if bad:
        raise AssertionError(f"phase 36: {bad}: {err}; card {r}, cpu {rc}; "
                             f"fragility card {f['counts']}, cpu "
                             f"{fc_['counts']}")
    emit("a17_autonomous", ring=dict(
            period=r["period"], period_cpu=rc["period"],
            period_kicked_tran=t_meas, iters=r["iters"],
            resnorm=r["resnorm"], swing=[r["n1_min"], r["n1_max"]],
            phase_noise_c=r["c"], norm_spread=r["norm_spread"],
            null_resid=r["null_resid"], n_harmonics=RING_HARMONICS),
        fragility=dict(starts=FRAG_STARTS, center=FRAG_CENTER,
                       sigma=FRAG_SIGMA, seed=FRAG_SEED,
                       converged=int(conv.sum()),
                       distinct=len(f["counts"]), counts=f["counts"],
                       counts_cpu=fc_["counts"],
                       worst_lane_err=float(lane_err.max()),
                       unconverged_lanes=np.nonzero(~conv)[0].tolist(),
                       iters_max=int(max(f["iters"]))),
        rel_err=err, tol=dict(tran=RING_TRAN_RTOL, cpu_rtol=A17_CPU_RTOL,
                              cpu_atol=A17_CPU_ATOL, frag_atol=FRAG_ATOL),
        launches=la, kicked_tran_launches=la_tran, walls_s=walls,
        wall_s=time.perf_counter() - t0, cpu_walls_s=cpu["walls_s"],
        card_name=smi())
    return la, la_tran


#: the phases whose card side runs in a child of its own (phase 35 stays
#: in the main process), by their key in the CPU's record
A16A17_CARD_CHILDREN = ("a16", "a17_driven", "a17_auto")


def a16a17_card_child(which, cpu_out, out):
    """Phase 34 (``which`` "a16"), 35 ("a17_driven") or 36 ("a17_auto")
    on the card in a child process, against the CPU's record in
    ``cpu_out``: its line and its return value written to ``out`` as JSON
    for the main process to print."""
    import torch
    import cedarsim_tpu_torch as T
    with open(cpu_out) as f:
        cpu = json.load(f)
    lines = []
    phase = {"a16": phase_a16, "a17_driven": phase_a17_driven,
             "a17_auto": phase_a17_auto}[which]
    ret = phase(
        torch, T, torch.device("cuda", 0), cpu[which],
        emit=lambda phase, **kw: lines.append([phase, kw]))
    with open(out, "w") as f:
        json.dump({"lines": lines, "ret": ret}, f)


def pvt_xla_child(out):
    """``--pvt-xla-child OUT``: phase 17 on the card in a child process,
    started once phase 16 has ended, beside the main process's phases
    18-40 and 44 (two torch threads for its CPU run): its line and its
    launches written to ``out`` as JSON for the main process to print."""
    import torch
    from cedarsim_tpu_torch.ops import fused_chord as fc
    from cedarsim_tpu_torch.ops import gesp_lu
    torch.set_num_threads(2)
    lines = []
    la = phase_pvt_xla(torch, gesp_lu, fc, torch.device("cuda", 0),
                       emit=lambda phase, **kw: lines.append([phase, kw]))
    with open(out, "w") as f:
        json.dump({"lines": lines, "ret": la}, f)


def a16a17_cpu(out=None):
    """The CPU's side of phases 34-36 (one intra-op thread, so that it
    takes one core beside the card's processes); written to ``out`` as
    JSON when given, else returned."""
    import torch
    import cedarsim_tpu_torch as T
    torch.set_num_threads(1)
    rec = {}
    t0 = time.perf_counter()
    rec["a16"] = a16_run(T, "cpu")[0]
    rec["a17_driven"] = a17_driven_run(T, "cpu")[0]
    nl = T.parse_spice(open(os.path.join(DFF_DIR, "dff_tb.cir")).read(),
                       file="dff_tb.cir")
    starts = frag_starts(T.compile_circuit(
        T.elaborate(nl, include_paths=[DFF_DIR]), device="cpu"))
    auto = a17_auto_run(T, "cpu", starts)[0]
    rec["a17_auto"] = dict(auto, starts=starts.tolist())
    rec["wall_s"] = time.perf_counter() - t0
    if out is None:
        return rec
    with open(out, "w") as f:
        json.dump(rec, f)


# ---------------------------------------------------------- phase 37 (A19)

#: phase 37: the front-end breadth of ROADMAP A19 on the card, each item
#: against the same call with ``device="cpu"`` at phase 13's tolerances
#: (SIM_DC_TOL, SIM_WAVE_TOL).  ``test_spectre.py``'s subcircuit transient
#: (tau = 2 ms), and its sample times
A19_SPECTRE_RC = """// spectre rc
simulator lang=spectre
subckt lowpass (in out)
parameters r=1k c=1u
r1 (in out) resistor r=r
c1 (out 0) capacitor c=c
ends lowpass
v1 (vin 0) vsource type=pulse val0=0 val1=1 delay=1m rise=1u fall=1u width=10m
x1 (vin vout) lowpass r=2k
tran1 tran stop=5m
"""
A19_SPECTRE_RC_TIMES = (1.5e-3, 2e-3, 3e-3, 4e-3, 5e-3)
#: the ASAP7 TT deck's BSIM-CMG inverter at its switching point, in
#: Spectre text (include path ASAP7_DIR)
A19_SPECTRE_CMG = """// CMG inverter op, ASAP7 TT
simulator lang=spectre
include "7nm_TT.scs"
vvdd (vdd 0) vsource dc=0.7
vvss (vss 0) vsource dc=0
vd (d 0) vsource dc=0.3
mneg (q d vss vss) nmos_lvt
mpos (q d vdd vdd) pmos_lvt
op1 dc
"""
#: an altergroup, then a device alter: three segments (op and tran each)
A19_ALTER = """// alter segments
simulator lang=spectre
parameters rr=1k
v1 (in 0) vsource type=pulse val0=0 val1=1 delay=10n rise=1n fall=1n width=1u
r1 (in out) resistor r=rr
r2 (out 0) resistor r=1k
c1 (out 0) capacitor c=1p
op1 op
tran1 tran stop=40n
ag1 altergroup {
parameters rr=3k
}
op2 op
tran2 tran stop=40n
a1 alter dev=r2 param=r value=3k
op3 op
tran3 tran stop=40n
"""
A19_ALTER_TIMES = (5e-9, 12e-9, 20e-9, 30e-9, 40e-9)
#: ``.save`` through ``simulate`` (one stream, the exact solve) and a
#: ``.data`` table swept by re-elaboration
A19_SAVE = """* rc ladder, .save
V1 a 0 PULSE(0 1 1n 0.1n 0.1n 10n 20n)
R1 a b 1k
C1 b 0 1p
R2 b c 2k
C2 c 0 2p
.tran 0.1n 40n
"""
A19_DATA = """* divider swept by a .data table
.param ra=1k rb=1k
V1 in 0 2
R1 in mid {ra}
R2 mid 0 {rb}
.data tbl ra rb
1k 1k 2k 1k 1k 3k 5k 5k
.enddata
.op
"""
#: ``test_spectre.py``'s statistics deck: process and mismatch draws of
#: r0 at a fixed ``mc_seed``
A19_STATS = """// stats
simulator lang=spectre
parameters r0=1k
statistics {
   process {
      vary r0 dist=gauss std=100
   }
   mismatch {
      vary r0 dist=gauss std=10
   }
}
i1 (0 a) isource dc=1m
r1 (a 0) resistor r=r0
r2 (a b) resistor r=r0
r3 (b 0) resistor r=r0
"""
A19_MC_SEED = 7
#: cell A's lanes through ``store_vars`` over 0-30 ns, and what is stored
A19_SAVE_TSTOP = 3e-8
A19_STORE = ("q", "clkn", "d")
#: ``explore``'s slider grid: the RC of phase 4 at 8 x 8 (R, C)
A19_EXPLORE_GRID = {"R1.r": np.linspace(500.0, 4000.0, 8),
                    "C1.c": np.linspace(0.5e-9, 4e-9, 8)}
A19_EXPLORE_TSPAN = (0.0, 2e-5)


def on_card(comp, what):
    """Raise unless ``comp`` was compiled on the CUDA card."""
    if comp.device.type != "cuda":
        raise AssertionError(f"{what}: compiled on {comp.device}")


def a19_spectre(T, dev):
    """Spectre text through ``simulate``: the subcircuit RC's transient
    (operating point, waveform at its times, counts) and the ASAP7 CMG
    inverter's operating point, card against CPU."""
    out = {}
    rc, rp = (T.simulate(A19_SPECTRE_RC, device=d) for d in (dev, "cpu"))
    sc, sp = rc["tran"], rp["tran"]
    on_card(rc["compiled"], "Spectre RC")
    if not (sc.converged and sp.converged):
        raise AssertionError("Spectre RC did not converge")
    want = 1.0 - np.exp(-1.0)
    got = float(sc.interp("vout", 3e-3))
    if abs(got - want) > 0.02:
        raise AssertionError(f"Spectre RC: vout(3 ms) {got}, want {want}")
    out["rc"] = dict(
        dc_err=float(np.abs(sc.xs[0] - sp.xs[0]).max()),
        wave_err=max(abs(float(sc.interp("vout", t))
                         - float(sp.interp("vout", t)))
                     for t in A19_SPECTRE_RC_TIMES),
        card=[sc.n_accepted, sc.n_rejected, sc.n_newton],
        cpu=[sp.n_accepted, sp.n_rejected, sp.n_newton], vout_3ms=got)
    rc, rp = (T.simulate(A19_SPECTRE_CMG, include_paths=[ASAP7_DIR],
                         device=d) for d in (dev, "cpu"))
    if not (bool(rc["op"].converged) and bool(rp["op"].converged)):
        raise AssertionError("Spectre CMG inverter: no operating point")
    out["cmg_op"] = dict(
        dc_err=float((rc["op"].x.cpu() - rp["op"].x).abs().max()),
        q=float(rc["op"].x[rc["compiled"].node_names.index("q")]))
    for name, r in out.items():
        if not (r["dc_err"] <= SIM_DC_TOL
                and r.get("wave_err", 0.0) <= SIM_WAVE_TOL):
            raise AssertionError(f"Spectre {name}: card vs CPU {r}")
    return out


def a19_alter(T, dev):
    """Every segment of an altergroup and a device alter, card against
    CPU: the operating points and the transients (their own operating
    point and the waveform at ``A19_ALTER_TIMES``); the segments' dividers
    as stated (1/2, 1/4, 3/4 of the 1 V step)."""
    rc, rp = (T.simulate(A19_ALTER, device=d) for d in (dev, "cpu"))
    out = {}
    for sfx, ratio in (("", 0.5), ("@ag1", 0.25), ("@a1", 0.5)):
        comp = rc["compiled" + sfx]
        on_card(comp, f"alter{sfx}")
        sc, sp = rc["tran" + sfx], rp["tran" + sfx]
        i = comp.node_names.index("out")
        dc_err = float((rc["op" + sfx].x.cpu() - rp["op" + sfx].x)
                       .abs().max())
        wave_err = max(abs(float(sc.interp("out", t))
                           - float(sp.interp("out", t)))
                       for t in A19_ALTER_TIMES)
        settled = float(sc.interp("out", 40e-9))
        if not (sc.converged and dc_err <= SIM_DC_TOL
                and wave_err <= SIM_WAVE_TOL
                and abs(settled - ratio) < 1e-3
                and abs(float(rc["op" + sfx].x[i])) < 1e-9):
            raise AssertionError(f"alter segment {sfx or 'base'}: dc_err "
                                 f"{dc_err:.3g}, wave_err {wave_err:.3g}, "
                                 f"out(40 ns) {settled} (want {ratio})")
        out[sfx or "base"] = dict(dc_err=dc_err, wave_err=wave_err,
                                  out_40ns=settled,
                                  card=[sc.n_accepted, sc.n_rejected],
                                  cpu=[sp.n_accepted, sp.n_rejected])
    return out


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype \
        and bool((a.view(np.uint8) == b.view(np.uint8)).all())


def a19_save(torch, T, dev, dff):
    """``.save`` on the card: through ``simulate`` (one stream, the exact
    solve) the projected waveform against the same deck without
    ``.save``; then ``tran`` with ``store_vars`` on cell A's 8 lanes over
    0-30 ns through B2/B3 (cell A's options) and through B1 (cell B's),
    each against the same call without the projection.  Bit for bit in
    the saved columns, the same counts and the same launches."""
    out = {}
    full = T.simulate(A19_SAVE, device=dev)["tran"]
    proj = T.simulate(A19_SAVE + ".save v(c) v(b)\n", device=dev)["tran"]
    cols = [full.compiled.node_names.index(n) for n in ("c", "b")]
    same = _same_bits(proj.xs, np.ascontiguousarray(full.xs[:, cols])) \
        and _same_bits(proj.ts, full.ts)
    cnt = [[s.n_accepted, s.n_rejected, s.n_newton] for s in (full, proj)]
    if not same or cnt[0] != cnt[1] or proj.xs.shape[1] != 2:
        raise AssertionError(f".save through simulate: bitwise {same}, "
                             f"counts {cnt}, columns {proj.xs.shape}")
    try:
        proj["a"]
    except KeyError:
        pass
    else:
        raise AssertionError(".save: an unsaved net was readable")
    out["simulate"] = dict(bitwise=same, counts=cnt[0],
                           store_map=proj.store_map)
    comp, ctx, pb, x0 = dff[:4]
    cols = [comp.node_names.index(n) for n in A19_STORE]
    for engine, base in (("mixed", XLA_OPTS), ("fused", FUSED_OPTS)):
        runs = []
        for store in (None, A19_STORE):
            opts = T.TranOptions(**base, store_vars=store)
            sols, la = counted(lambda opts=opts: T.tran(
                comp, (0.0, A19_SAVE_TSTOP), params=pb, ctx=ctx, opts=opts,
                x0=x0))
            runs.append((sols, la))
        (fs, fl), (ps, pl) = runs
        same = all(_same_bits(p.xs, np.ascontiguousarray(f.xs[:, cols]))
                   and _same_bits(p.ts, f.ts) for f, p in zip(fs, ps))
        cf = [(s.n_accepted, s.n_rejected, s.n_newton) for s in fs]
        cp = [(s.n_accepted, s.n_rejected, s.n_newton) for s in ps]
        key = ("fused",) if engine == "fused" else ("factor", "subst")
        if not same or cf != cp or fl != pl or min(fl[k] for k in key) <= 0:
            raise AssertionError(f"store_vars through {engine}: bitwise "
                                 f"{same}, counts {cf} vs {cp}, launches "
                                 f"{fl} vs {pl}")
        out[engine] = dict(bitwise=same, lanes=len(fs), **counts(fs),
                           attempts=fs[0].n_attempts,
                           launches={k: fl[k] for k in key},
                           stored_bytes=int(sum(p.xs.nbytes for p in ps)),
                           full_bytes=int(sum(f.xs.nbytes for f in fs)))
    return out


def a19_data_stats(T, dev):
    """A ``.data`` table swept by re-elaboration (each row's operating
    point, card against CPU, and its divider), and the ``statistics``
    Monte-Carlo at ``A19_MC_SEED``: each instance's draw equal as a float
    to the JAX package's rule (numpy's ``default_rng``: the process draw
    from the seed, the mismatch draw from (seed, crc32 of the instance,
    crc32 of the name)), and the operating point card against CPU."""
    import zlib
    from cedarsim_tpu_torch.frontend.spectre import parse_spectre
    ckt = T.load_spice(A19_DATA)
    sweep = T.data_sweep(ckt, "tbl")
    rows = []
    for point in sweep:
        rc, rp = (T.simulate(A19_DATA, params=point, device=d)
                  for d in (dev, "cpu"))
        i = rc["compiled"].node_names.index("mid")
        v = float(rc["op"].x[i])
        want = 2.0 * point["rb"] / (point["ra"] + point["rb"])
        err = float((rc["op"].x.cpu() - rp["op"].x).abs().max())
        if not (err <= SIM_DC_TOL and abs(v - want) < 1e-6):
            raise AssertionError(f".data row {point}: mid {v} (want {want}), "
                                 f"card vs CPU {err:.3g}")
        rows.append(dict(point=point, mid=v, dc_err=err))
    rng = np.random.default_rng(A19_MC_SEED)
    nominal = 1000.0 + rng.normal(0, 100)
    want = {}
    for inst in ("r1", "r2", "r3"):
        mm = np.random.default_rng([A19_MC_SEED, zlib.crc32(inst.encode()),
                                    zlib.crc32(b"r0")])
        want[inst] = nominal + mm.normal(0, 10)
    circuit = T.elaborate(parse_spectre(A19_STATS), mc_seed=A19_MC_SEED)
    got = {i.name: float(i.params["r"]) for i in circuit.instances
           if i.name.startswith("r")}
    if got != want:
        raise AssertionError(f"statistics draws {got}, want {want}")
    rc, rp = (T.simulate(A19_STATS, mc_seed=A19_MC_SEED, device=d)
              for d in (dev, "cpu"))
    err = float((rc["op"].x.cpu() - rp["op"].x).abs().max())
    if err > SIM_DC_TOL:
        raise AssertionError(f"statistics op: card vs CPU {err:.3g}")
    return dict(data=rows, stats=dict(draws=got, dc_err=err))


def a19_explore(torch, T, dev):
    """``explore`` on the 64-lane (R, C) grid of phase 4's RC (0-20 µs,
    ``dense_lu="mixed"``) on the card and on the CPU (the kernels' plain
    versions): B1 alone or B2 and B3 alone launched (whichever the
    lane-batched call resolved to; read from the counts, not resolved a
    second time here), and every sampled series within SIM_WAVE_TOL of
    the CPU's.  Returns the record and the launches."""
    import json as _json
    import re
    import shutil
    import tempfile
    from cedarsim_tpu_torch.utils.explore import explore

    def rc(d):
        ckt = T.Circuit()
        vin, vout = ckt.net("vin"), ckt.net("vout")
        ckt.add(T.VSourcePULSE, "Vin", (vin, ckt.gnd),
                dict(v1=0.0, v2=3.3, td=1e-6, tr=1e-9, tf=1e-9, pw=4e-6,
                     per=10e-6))
        ckt.add(T.Resistor, "R1", (vin, vout), dict(r=1000.0))
        ckt.add(T.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
        return T.compile_circuit(ckt, device=d)

    opts = T.TranOptions(dense_lu="mixed")
    series, wall = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_explore_")
    try:
        for where, d in (("card", dev), ("cpu", "cpu")):
            comp = rc(d)
            path = os.path.join(tmp, f"{where}.html")
            t0 = time.perf_counter()
            if where == "card":
                on_card(comp, "explore")
                _, la = counted(lambda: explore(
                    comp, A19_EXPLORE_TSPAN, A19_EXPLORE_GRID, ["vout"],
                    path=path, opts=opts))
            else:
                explore(comp, A19_EXPLORE_TSPAN, A19_EXPLORE_GRID, ["vout"],
                        path=path, opts=opts)
            wall[where] = time.perf_counter() - t0
            with open(path) as f:
                payload = _json.loads(re.search(
                    r"const D = (\{.*?\});\n", f.read(), re.S).group(1))
            series[where] = np.asarray(
                payload["series"]["vout"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths = {"B1": ("fused",), "B2/B3": ("factor", "subst")}
    took = [name for name, key in paths.items()
            if min(la[k] for k in key) > 0
            and not any(n for k, n in la.items() if k not in key)]
    lanes = series["card"].shape[0]
    err = float(np.abs(series["card"] - series["cpu"]).max())
    if len(took) != 1 or lanes != 64 or err > SIM_WAVE_TOL:
        raise AssertionError(f"explore: {lanes} lanes, launches {la}, card "
                             f"vs CPU {err:.3g} V")
    return dict(lanes=lanes, path=took[0],
                launches={k: la[k] for k in paths[took[0]]}, wave_err=err,
                wall_s=wall), la


def a19_cache_profile(torch, T, dev):
    """The operating-point cache in a fresh directory: two ``solve_dc``
    calls of phase 4's RC with a diode load on the card, the second warm
    started (fewer Newton iterations, x within SIM_DC_TOL of the first);
    then ``profile_compile``/``profile_run`` of one RC Newton step on the
    card, their keys printed."""
    import shutil
    import tempfile
    from cedarsim_tpu_torch.utils import artifacts
    from cedarsim_tpu_torch.utils.profiling import (profile_compile,
                                                    profile_run)
    ckt = T.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(T.VSource, "V1", (vin, ckt.gnd), dict(dc=2.0))
    ckt.add(T.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(T.Diode, "D1", (vout, ckt.gnd), {"is": 1e-14, "n": 1.0})
    comp = T.compile_circuit(ckt, device=dev)
    on_card(comp, "op cache")
    ctx = T.SimSpec.make(gmin=1e-12)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_artifacts_")
    saved = os.environ.get(artifacts.ENV)
    os.environ[artifacts.ENV] = tmp
    try:
        r1, r2 = (T.solve_dc(comp, ctx=ctx) for _ in range(2))
        stored = len(os.listdir(tmp))
    finally:
        if saved is None:
            os.environ.pop(artifacts.ENV)
        else:
            os.environ[artifacts.ENV] = saved
        shutil.rmtree(tmp, ignore_errors=True)
    it = [int(r1.iters), int(r2.iters)]
    dx = float((r1.x - r2.x).abs().max())
    if not (it[1] < it[0] and dx <= SIM_DC_TOL and stored == 1
            and bool(r2.converged)):
        raise AssertionError(f"op cache: iterations {it}, |dx| {dx:.3g}, "
                             f"{stored} entries")
    rc = T.Circuit()
    a, b = rc.net("vin"), rc.net("vout")
    rc.add(T.VSource, "V1", (a, rc.gnd), dict(dc=1.0))
    rc.add(T.Resistor, "R1", (a, b), dict(r=1000.0))
    rc.add(T.Capacitor, "C1", (b, rc.gnd), dict(c=1e-9))
    c = T.compile_circuit(rc, device=dev)
    cdc = T.SimSpec.make(mode="dcop")
    eye = 1e-12 * torch.eye(c.n_x, dtype=c.dtype, device=dev)

    def step(x):
        S, _, G, _ = c.res_jacs_fwd(x, cdc, c.params0)
        return x + torch.linalg.solve(G + eye, -S)
    x0 = torch.zeros(c.n_x, dtype=c.dtype, device=dev)
    rep = profile_compile(step, x0)
    run = profile_run(rep.pop("compiled"), x0, iters=20)
    if rep["aten_ops"] != sum(rep["aten_histogram"].values()) \
            or not rep.get("cuda_launches"):
        raise AssertionError(f"profile_compile on the card: {rep}")
    return dict(op_cache=dict(iters=it, dx=dx),
                profile=dict(keys=sorted(rep) + sorted(run),
                             first_call_s=rep["first_call_s"],
                             aten_ops=rep["aten_ops"],
                             cuda_launches=rep["cuda_launches"],
                             cuda_device_s=rep["cuda_device_s"],
                             mean_s=run["mean_s"]))


def phase_a19(torch, T, dev, dff):
    """Phase 37 (A19): Spectre text and alter segments through
    ``simulate``, ``.save`` (one stream and cell A's lanes through B2/B3
    and B1), ``.data``, ``statistics``, ``explore`` on 64 lanes, the
    operating-point cache and the profiler on the card, each against the
    CPU or its unprojected twin.  Returns the launches of B1 and of B2/B3
    that phase 37 made (the ``kernels`` line counts them)."""
    t0 = time.perf_counter()
    rec = dict(spectre=a19_spectre(T, dev), alter=a19_alter(T, dev))
    rec["save"] = a19_save(torch, T, dev, dff)
    rec.update(a19_data_stats(T, dev))
    rec["explore"], la = a19_explore(torch, T, dev)
    rec.update(a19_cache_profile(torch, T, dev))
    # each store_vars run twice (projected and not), then explore's
    launches = {k: 2 * rec["save"]["fused" if k == "fused" else "mixed"][
        "launches"].get(k, 0) + la[k] for k in ("fused", "factor", "subst")}
    log("a19", **rec, launches=launches, wall_s=time.perf_counter() - t0,
        card=smi())
    return launches


# ----------------------------------------- phases 38-40 (A18, A16b, A21)

#: phase 38: cells E and D over 0-A18_TSTOP (the repeat window of phase
#: 12, whose first runs are the reference) on a world of one (NCCL), then
#: cell E on two gloo ranks sharing the card, 128 lanes each
A18_TSTOP = LV1_REPEAT_TSTOP
A18_RANKS = 2
#: the two-rank run against the one-rank run: per-lane counts equal, the
#: waveforms bitwise or within this
A18_WAVE_ATOL = 1e-12
#: phase 39: ``netlists.diode_ladder()`` (259 unknowns, sparse), the
#: sensitivity of v(b0_4) at 4 ns to R0 over 0-5 ns; the card against the
#: CPU (the card's model walk rounds apart in its last bits, ROADMAP C13)
#: and against the card's central difference (R0 ± 0.1 Ω: the adaptive
#: grid moves with the parameter, 8e-4 apart on the CPU)
A16B_ARGS = ("b0_4", "r0.r", (0.0, 5e-9), 4e-9)
A16B_CPU_RTOL = 1e-6
A16B_FD_H = 0.1
A16B_FD_RTOL = 1e-2
#: phase 40: the A21 circuit's fused transient over 0-A21_TSTOP
A21_TSTOP = 1.2e-8


def phase_a18_one(torch, T, dev, lv1, ref):
    """Phase 38's first half, in the main process: ``tran_sweep_sharded``
    on a world of one (NCCL) over cells E (B1) and D (B2/B3), the 256
    lanes of phases 10 and 12, each lane's operating point solved from
    zeros inside the sweep (as ``kernel_times.lv1_lanes`` solves it),
    every kernel count from 0 just before and read just after; per-lane
    counts equal to those of phase 12's first repeat run (``ref``, the
    same lanes by ``tran`` in this process); whether its waveforms are
    bitwise those is phase 12's check.  Returns (cell E's result, the
    launches by cell, bitwise equal by cell)."""
    import torch.distributed as dist
    from cedarsim_tpu_torch.parallel.mesh import (make_mesh,
                                                  tran_sweep_sharded)
    t0 = time.perf_counter()
    mesh = make_mesh(device=dev)
    if (mesh.backend, mesh.size, mesh.device) != ("nccl", 1, dev):
        raise AssertionError(f"a18: mesh {mesh}")
    init_s = time.perf_counter() - t0
    comp, ctx, pb = lv1[:3]
    zeros = torch.zeros(LV1_LANES, comp.n_x, dtype=comp.dtype, device=dev)
    rec, launches, res_e, equal = {}, {}, None, {}
    for cell in ("E", "D"):
        opts = T.TranOptions(**(kt.LV1_FUSED_OPTS if cell == "E"
                                else kt.LV1_XLA_OPTS))
        t1 = time.perf_counter()
        res, la = counted(lambda: tran_sweep_sharded(
            comp, None, (0.0, A18_TSTOP), mesh, params=pb, ctx=ctx,
            opts=opts, x0=zeros))
        wall = time.perf_counter() - t1
        sols = ref[cell]
        want = np.asarray([[s.n_accepted, s.n_rejected, s.n_newton]
                           for s in sols])
        got = np.stack([res.n_accepted, res.n_rejected, res.n_newton], 1)
        if not (res.finished.all() and np.array_equal(got, want)):
            raise AssertionError(f"a18 cell {cell}: per-lane counts differ "
                                 f"from tran's in {int((got != want).any(1).sum())}"
                                 " lanes")
        bitwise = all(np.array_equal(res.xs[k, :s.n_accepted], s.xs)
                      and np.array_equal(res.ts[k, :s.n_accepted], s.ts)
                      for k, s in enumerate(sols))
        kernel = la["fused"] if cell == "E" else min(la["factor"],
                                                     la["subst"])
        others = {k: n for k, n in la.items() if n and k not in (
            ("fused",) if cell == "E" else ("factor", "subst"))}
        if kernel <= 0 or others:
            raise AssertionError(f"a18 cell {cell}: launches {la}")
        rec[cell] = dict(wall_s=wall, lanes=int(len(sols)),
                         **{k: int(v.sum()) for k, v in (
                             ("accepted", res.n_accepted),
                             ("rejected", res.n_rejected),
                             ("newton", res.n_newton))},
                         per_lane_counts_equal=True,
                         bitwise_equal_tran=bitwise,
                         launches={k: n for k, n in la.items() if n})
        launches[cell], equal[cell] = la, bitwise
        if cell == "E":
            res_e = res
    dist.destroy_process_group()
    log("a18_nccl", world=1, backend="nccl", tstop=A18_TSTOP,
        init_s=init_s, cells=rec, wall_s=time.perf_counter() - t0)
    return res_e, launches, equal


def phase_a18_pair(torch, dev, one):
    """Phase 38's second half, once no child but G-xla's runs, before
    the timing phases: two gloo ranks sharing the card (``RankPool``, child
    processes): ``dryrun_child.gates`` (the level-1 DFF's DC sweep of
    ``vto``, its sharded transient and the RC closed-form gate), then cell
    E's 256 lanes over 0-A18_TSTOP, 128 a rank, against the one-rank run
    ``one``: both ranks return the whole result, bitwise alike; per-lane
    counts equal, and the waveforms bitwise or within A18_WAVE_ATOL (the
    line says which).  Returns the ranks' B1 launches (summed)."""
    from cedarsim_tpu_torch.parallel import RankPool, dryrun_child
    t0 = time.perf_counter()
    with RankPool(A18_RANKS, device=dev, backend="gloo") as pool:
        for r, p in enumerate(pool.procs):
            track_child(f"a18_rank{r}", p)
        up_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        lines = pool.call(dryrun_child.gates)
        gates_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        runs = pool.call(dryrun_child.lv1_cell, "E", A18_TSTOP)
        cell_s = time.perf_counter() - t1
    res = [r for r, _ in runs]
    for f in ("ts", "xs", "n_accepted", "n_rejected", "n_newton",
              "finished"):
        if not np.array_equal(getattr(res[0], f), getattr(res[1], f)):
            raise AssertionError(f"a18 gloo: the ranks' {f} differ")
    r2 = res[0]
    got = np.stack([r2.n_accepted, r2.n_rejected, r2.n_newton], 1)
    want = np.stack([one.n_accepted, one.n_rejected, one.n_newton], 1)
    if not (r2.finished.all() and np.array_equal(got, want)):
        raise AssertionError("a18 gloo: per-lane counts differ from the "
                             "one-rank run in "
                             f"{int((got != want).any(1).sum())} lanes")
    diff = max(float(np.abs(r2.xs[k, :m] - one.xs[k, :m]).max())
               for k, m in enumerate(one.n_accepted))
    bitwise = np.array_equal(r2.xs, one.xs) and np.array_equal(r2.ts,
                                                               one.ts)
    if not (bitwise or diff <= A18_WAVE_ATOL):
        raise AssertionError(f"a18 gloo: waveforms {diff:.3g} V apart")
    fused = sum(la["fused_chord"] for _, la in runs)
    if fused <= 0 or any(la["lu_factor_gesp_f32"] or la["lu_subst_gesp_f32"]
                         for _, la in runs):
        raise AssertionError(f"a18 gloo: launches {[la for _, la in runs]}")
    if len(set(lines)) != 1:
        raise AssertionError("a18 gloo: the ranks' gate lines differ")
    log("a18_gloo", world=A18_RANKS, backend="gloo", device=str(dev),
        startup_s=up_s, gates=lines[0], gates_s=gates_s, cell="E",
        lanes_per_rank=LV1_LANES // A18_RANKS, tstop=A18_TSTOP,
        wall_s=cell_s, per_lane_counts_equal=True,
        held="bitwise" if bitwise else f"within {A18_WAVE_ATOL} V",
        max_abs_diff_v=diff,
        launches_by_rank=[la for _, la in runs],
        total_s=time.perf_counter() - t0)
    return fused


def a16b_sparse(torch, T, dev):
    """Phase 39, in phase 19's child after its main path: the diode
    ladder's ``tran_sensitivity`` (``A16B_ARGS``) by forward-mode AD
    through the sparse path, on the CPU (S1/S2's plain versions) and on
    the card (S1/S2), every kernel count from 0 just before the card's
    call and read just after, S2's launches inside ``SparseSolve.jvp``
    (the tangent solves) counted apart; the card's central difference.
    Returns the phase's record."""
    from cedarsim_tpu_torch.analysis import sensitivity as tsens
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.core import sparse_ops
    from cedarsim_tpu_torch.core.compile import (ensure_dynamic,
                                                 use_sparse_solver)
    from cedarsim_tpu_torch.ops import sparse_lu
    text = netlists.diode_ladder()
    node, wrt, span, t_eval = A16B_ARGS
    t0 = time.perf_counter()
    v_cpu, d_cpu = tsens.tran_sensitivity(
        T.compile_circuit(T.load_spice(text), device="cpu"), *A16B_ARGS)
    cpu_s = time.perf_counter() - t0
    card = T.compile_circuit(T.load_spice(text), device=dev)
    if not (use_sparse_solver(card) and card.n_x == 259):
        raise AssertionError(f"a16b: n_x {card.n_x}, sparse "
                             f"{use_sparse_solver(card)}")
    tangent = [0]
    jvp = sparse_ops.SparseSolve.jvp

    def counting_jvp(ctx, *grads):
        n0 = sparse_lu.solve_factored.launches
        out = jvp(ctx, *grads)
        tangent[0] += sparse_lu.solve_factored.launches - n0
        return out
    sparse_ops.SparseSolve.jvp = staticmethod(counting_jvp)
    try:
        t0 = time.perf_counter()
        (v, d), la = counted(lambda: tsens.tran_sensitivity(card,
                                                            *A16B_ARGS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sparse_ops.SparseSolve.jvp = staticmethod(jvp)
    v, d = float(v), float(d)
    dense = {k: n for k, n in la.items()
             if n and k not in ("sparse_factor", "sparse_solve")}
    if min(la["sparse_factor"], la["sparse_solve"], tangent[0]) <= 0 \
            or dense:
        raise AssertionError(f"a16b: launches {la}, under the tangent "
                             f"{tangent[0]}")
    rel_v = abs(v - float(v_cpu)) / abs(float(v_cpu))
    rel_d = abs(d - float(d_cpu)) / abs(float(d_cpu))
    comp = ensure_dynamic(card, [wrt])
    vals = []
    for sgn in (1.0, -1.0):
        p = comp.set_param(comp.params0, wrt, 100.0 + sgn * A16B_FD_H)
        sol = T.tran(comp, span, params=p, opts=T.TranOptions(
            max_steps=4096))
        vals.append(float(sol.interp(node, t_eval)))
    cd = (vals[0] - vals[1]) / (2 * A16B_FD_H)
    rel_fd = abs(d - cd) / abs(cd)
    if not (rel_v <= A16B_CPU_RTOL and rel_d <= A16B_CPU_RTOL
            and rel_fd <= A16B_FD_RTOL):
        raise AssertionError(f"a16b: card {v}, {d}; CPU {float(v_cpu)}, "
                             f"{float(d_cpu)}; central difference {cd}")
    return dict(n_x=card.n_x, value=v, deriv=d, cpu_value=float(v_cpu),
                cpu_deriv=float(d_cpu), rel_vs_cpu=[rel_v, rel_d],
                central_difference=cd, rel_vs_cd=rel_fd, wall_s=wall,
                cpu_s=cpu_s, launches={k: n for k, n in la.items() if n},
                s2_launches_under_tangent=tangent[0])


def a21_run(T, dev):
    """The A21 circuit's four lanes (``netlists.a21_lanes``) through the
    fused engine over 0-A21_TSTOP on ``dev``, every kernel count from 0
    just before and read just after: (solutions, launches, wall s)."""
    from cedarsim_tpu_torch.benchmarks import netlists
    comp, ctx, pb = netlists.a21_lanes(dev)
    opts = T.TranOptions(**kt.LV1_FUSED_OPTS)
    t0 = time.perf_counter()
    sols, la = counted(lambda: T.tran(comp, (0.0, A21_TSTOP), params=pb,
                                      ctx=ctx, opts=opts))
    return sols, la, time.perf_counter() - t0


def phase_a21_path(torch, T, dev):
    """Phase 40's path, in the main process after phase 37: the A21
    circuit (integer, bitwise and point-list constructs) through B1 on
    the card against the same call on the CPU (B1's plain version): every
    lane finished, equal counts, waveforms within SIM_WAVE_TOL; B1
    launched once a step attempt and no GESP kernel.  Returns the
    launches."""
    sols, la, wall = a21_run(T, dev)
    cpu, _, cpu_s = a21_run(T, "cpu")
    if not (0 < la["fused"] == sols[0].n_attempts) or la["factor"] \
            or la["subst"]:
        raise AssertionError(f"a21: launches {la}, {sols[0].n_attempts} "
                             "attempts")
    worst = 0.0
    for s, c in zip(sols, cpu):
        if not (s.converged and c.converged and (s.n_accepted, s.n_rejected,
                                                 s.n_newton)
                == (c.n_accepted, c.n_rejected, c.n_newton)):
            raise AssertionError("a21: the card's lanes are not the CPU's")
        worst = max(worst, float(np.abs(s.xs - c.xs).max()))
    if worst > SIM_WAVE_TOL:
        raise AssertionError(f"a21: card against CPU {worst:.3g} V")
    log("a21_path", lanes=len(sols), tstop=A21_TSTOP, wall_s=wall,
        cpu_s=cpu_s, **counts(sols), attempts=sols[0].n_attempts,
        card_vs_cpu_v=worst, launches={k: n for k, n in la.items() if n})
    return la


#: phase 44: the pass switch's AC frequencies, its transient window and
#: the relative bound on its AC gain at the operating point, where the
#: closed switch passes IN to OUT through its on resistance (the 10 kΩ
#: load's divider, 0.89 at W = 3.6 µm; sign(0) = 0 at vds = 0 read 0 there,
#: ROADMAP C17)
SWITCH_FREQS = np.array([1e3, 1e6, 1e8])
SWITCH_TSTOP = 2e-6
SWITCH_GAIN = (0.85, 0.95)


def switch_ac_noise(T, device):
    """The pass switch (``netlists.pass_switch``, DC 0 and AC 1 on IN)
    compiled on ``device``: its DC operating point, AC and OUT's noise
    over ``SWITCH_FREQS``, each from the public calls."""
    from cedarsim_tpu_torch.benchmarks import netlists
    comp = T.compile_circuit(T.elaborate(
        T.parse_spice(netlists.pass_switch("ac"), file="pass_switch.cir"),
        include_paths=[netlists.DFF_DIR]), device=device)
    ctx = T.SimSpec.make(gmin=1e-15)
    op = T.solve_dc(comp, ctx=ctx)
    ac = T.ac(comp, SWITCH_FREQS, ctx=ctx)
    ns = T.noise(comp, "out", SWITCH_FREQS, ctx=ctx)
    return comp, op, ac, ns


def switch_run(T, lanes):
    """The switch's track phase (a 0.1 V, 1 MHz sine on IN from 0 V) on
    ``lanes`` (``netlists.pass_switch_lanes``: W per lane, each lane from
    its operating point, OUT exactly 0 V) through the fused engine over
    0-SWITCH_TSTOP, every kernel count from 0 just before and read just
    after: (solutions, launches, wall s)."""
    comp, ctx, pb, x0 = lanes
    t0 = time.perf_counter()
    sols, la = counted(lambda: T.tran(
        comp, (0.0, SWITCH_TSTOP), params=pb, ctx=ctx, x0=x0,
        opts=T.TranOptions(**FUSED_OPTS)))
    return sols, la, time.perf_counter() - t0


def phase_switch(torch, T, fc, dev, lanes, plan):
    """Phase 44 (ROADMAP C17, C18), in the main process before the
    children are joined: the pass switch with its drain exactly on its
    source.  Its DC operating point, AC and noise on the card against
    the same calls on the CPU (the ops within SIM_DC_TOL; AC within
    AC_RTOL, the PSD within PSD_RTOL; the AC gain IN to OUT inside
    SWITCH_GAIN, a closed switch); B1 (float64) on the switch's plan at
    the lanes' operating points, vds exactly 0, a step of 1e-10 s,
    against its plain version (``fused_vs_plain``); the track phase on
    those lanes through B1 against the same call on the CPU: equal counts
    on every lane, waveforms within SIM_WAVE_TOL, one B1 launch a step
    attempt.  OUT sits exactly at 0 V on the CPU (the JAX package's
    operating point); the card's is recorded beside it.  Returns the
    phase's B1 record for the kernels line."""
    from cedarsim_tpu_torch.benchmarks import netlists
    t0 = time.perf_counter()
    comp, op, ac, ns = switch_ac_noise(T, dev)
    on_card(comp, "switch")
    _, op_p, ac_p, ns_p = switch_ac_noise(T, "cpu")
    x_c, x_p = op.x.cpu(), op_p.x
    vc, vp = ac.v.cpu(), ac_p.v
    ac_err = float(((vc - vp).abs().amax(1) / vp.abs().amax(1)).max())
    psd_err = float(np.max(np.abs(ns.psd - ns_p.psd) / ns_p.psd))
    gain = np.abs(np.asarray(ac["out"]))
    i_out = comp.node_names.index("out")
    ties = [float(x_c[i_out]), float(x_p[i_out])]
    op_err = float((x_c - x_p).abs().max())
    if ties[1] != 0.0 or op_err > SIM_DC_TOL:
        raise AssertionError(f"switch: OUT at {ties} V (card, CPU); card "
                             f"vs CPU op {op_err:.3g} V")
    if not (ac_err <= AC_RTOL and psd_err <= PSD_RTOL
            and np.all(ns.psd > 0)
            and SWITCH_GAIN[0] <= gain.min() <= gain.max() <= SWITCH_GAIN[1]):
        raise AssertionError(f"switch: AC {ac_err:.3g}, PSD {psd_err:.3g}, "
                             f"gain {gain.tolist()}")
    ac_s = time.perf_counter() - t0
    worst = dict(xn=0.0, S=0.0, Q=0.0)
    args, opts_h = kt.fused_args(torch, T, plan, lanes, 1e-10, pert=0.0)
    _, err = fused_vs_plain(torch, fc, plan, args, opts_h, "switch B1",
                            worst)
    sols, la, wall = switch_run(T, lanes)
    cpu_lanes = netlists.pass_switch_lanes("cpu")
    cpu, _, cpu_s = switch_run(T, cpu_lanes)
    if not (0 < la["fused"] == sols[0].n_attempts) or la["factor"] \
            or la["subst"]:
        raise AssertionError(f"switch: launches {la}, {sols[0].n_attempts} "
                             "attempts")
    wave = 0.0
    for s, c in zip(sols, cpu):
        if not (s.converged and c.converged and (s.n_accepted, s.n_rejected,
                                                 s.n_newton)
                == (c.n_accepted, c.n_rejected, c.n_newton)):
            raise AssertionError("switch: the card's lanes are not the "
                                 "CPU's")
        wave = max(wave, float(np.abs(s.xs - c.xs).max()))
    if wave > SIM_WAVE_TOL:
        raise AssertionError(f"switch: card against CPU {wave:.3g} V")
    log("switch", out_v=ties, op_card_vs_cpu=op_err, ac_card_vs_cpu=ac_err,
        psd_card_vs_cpu=psd_err, gain=gain.tolist(), ac_noise_s=ac_s, b1_worst_rel_err=worst,
        b1_max_abs_err=err["xn_abs"], lanes=len(sols), tstop=SWITCH_TSTOP,
        wall_s=wall, cpu_s=cpu_s, **counts(sols),
        attempts=sols[0].n_attempts, card_vs_cpu_v=wave,
        launches={k: n for k, n in la.items() if n},
        phase_s=time.perf_counter() - t0)
    return {"model": "BSIM4 pass switch at vds = 0 (netlists.pass_switch, "
                     "W per lane)",
            "launches": la["fused"], "max_abs_err": err["xn_abs"],
            "shape": [len(sols), lanes[0].n_x]}


def a21_plan(T, dev):
    """The A21 circuit's lanes on ``dev`` and their fused plan."""
    from cedarsim_tpu_torch.analysis.tran import fused_plan_for
    from cedarsim_tpu_torch.benchmarks import netlists
    comp, ctx, pb = netlists.a21_lanes(dev)
    return (comp, ctx, pb), fused_plan_for(comp, ctx, pb)


def phase_a21_kernel(torch, T, fc, lanes, plan):
    """Phase 40's kernel half, with the timing phases: B1 on the A21
    plan against its plain version on its four lanes (the fused options
    of cell E, h = 1e-12 and 1e-10), with its device, call and plain times
    and bound."""
    from cedarsim_tpu_torch.benchmarks import netlists
    info = plan.build()
    comp, ctx, pb = lanes
    L = len(netlists.A21_CODES)
    op = T.solve_dc(comp, pb, ctx, mode="tranop",
                    x0=torch.zeros(L, comp.n_x, dtype=comp.dtype,
                                   device=comp.device))
    worst = dict(xn=0.0, S=0.0, Q=0.0)
    abs_err = 0.0
    for h in (1e-12, 1e-10):
        args, opts_h = kt.fused_args(torch, T, plan, (comp, ctx, pb, op.x),
                                     h, opts=kt.LV1_FUSED_OPTS)
        _, err = fused_vs_plain(torch, fc, plan, args, opts_h,
                                f"a21 h={h}", worst)
        abs_err = max(abs_err, err["xn_abs"])

    def run():
        return fc.fused_chord(plan, *args, opts_h)
    times = (kt.device_ms(run), kt.call_ms(run, 50),
             kt.call_ms(lambda: fc.fused_chord_plain(plan, *args, opts_h),
                        5))
    bnd, nodes = fused_bound(plan, args, run())
    log("a21_fused_kernel", worst_rel_err=worst, ms_device_call_plain=list(
        times), shape=[L, comp.n_x], bound_ms=bnd,
        nodes=nodes, emit_s=info["emit_seconds"],
        nvcc_s=info["nvcc_seconds"],
        header=os.path.relpath(info["path"], REPO))
    return abs_err, times, bnd


def a16b_kernel_times(torch, T, dev):
    """Phase 39's kernel half, with the timing phases: S1 and S2 at one
    lane on the diode ladder's equilibrated Jacobian at its operating
    point, S2 on a tangent right-hand side (d_rhs − dA·x, as
    ``SparseSolve.jvp`` forms it), each bitwise its plain version, with
    their device, call and plain times and bounds."""
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.core.sparse_ops import TAU, get_sparse_ops
    from cedarsim_tpu_torch.ops import sparse_lu
    comp = T.compile_circuit(T.load_spice(netlists.diode_ladder()),
                             device=dev)
    sops = get_sparse_ops(comp)
    plan = sops.plan
    ctx = T.SimSpec.make()
    x = T.solve_dc(comp, ctx=ctx, mode="tranop").x
    S, _, Gv, _ = sops.res_jacs_sparse(x, ctx.with_mode("tranop"))
    J = sops.add_diag(Gv, ctx.gmin)
    v, dr, dc = sops.equilibrate(J)
    v = v[None].contiguous()
    rng = np.random.default_rng(39)
    dA = J * torch.as_tensor(rng.standard_normal(J.shape), device=dev)
    xs = sops.solve(J, S)
    rhs = ((-sops.matvec(dA, xs)) * dr)[None].contiguous()
    f = sparse_lu.factor(plan, v, TAU)
    fp = sparse_lu.factor_plain(plan, v, TAU)
    xk = sparse_lu.solve_factored(plan, f, rhs)
    xp = sparse_lu.solve_factored_plain(plan, fp, rhs)
    torch.cuda.synchronize()
    for name, k, p in (("S1", f, fp), ("S2", xk, xp)):
        if not torch.equal(k.view(torch.int64), p.view(torch.int64)):
            raise AssertionError(f"a16b {name}: not bitwise its plain "
                                 "version")

    def s1():
        return sparse_lu.factor(plan, v, TAU)

    def s2():
        return sparse_lu.solve_factored(plan, f, rhs)
    # the dense library calls on the same system (a yardstick only)
    A = torch.zeros(1, comp.n_x, comp.n_x, dtype=torch.float64, device=dev)
    rows = torch.as_tensor(plan.pos_arow, dtype=torch.int64, device=dev)
    cols = torch.as_tensor(plan.pos_acol, dtype=torch.int64, device=dev)
    A[:, rows, cols] = v
    LU, piv = torch.linalg.lu_factor(A)
    out = {
        "factor": (kt.device_ms(s1), kt.call_ms(s1, 50),
                   kt.call_ms(lambda: sparse_lu.factor_plain(plan, v, TAU),
                              3), sparse_bound(plan, 1, "factor"),
                   *library_ms(lambda: torch.linalg.lu_factor(A), 20)),
        "solve": (kt.device_ms(s2), kt.call_ms(s2, 50),
                  kt.call_ms(lambda: sparse_lu.solve_factored_plain(
                      plan, fp, rhs), 3), sparse_bound(plan, 1, "solve"),
                  *library_ms(lambda: torch.linalg.lu_solve(
                      LU, piv, rhs[..., None]), 20))}
    log("a16b_kernels", n=plan.n, nnz_f=plan.nnz_f, n_levels=plan.n_levels,
        times={k: list(v) for k, v in out.items()}, bitwise_plain=True)
    out["nnz_f"] = plan.nnz_f
    return out


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
    """Run the smoke; every child process it started is ended (if still
    running) and reaped on the way out, whatever happened."""
    children = []
    try:
        run(children)
    finally:
        for c in children:
            stop_children(c)


def run(children):
    """The smoke's phases in order (the module docstring); each child
    process is appended to ``children`` as it starts."""
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
    # G-xla's child (phase 22, the longest run) from here: it sets its
    # lanes up beside this process's set-up and build, and launches only
    # B2/B3 (it loads the GESP library, or builds it if it finds none
    # yet); every kernel-timing phase waits for it (ROADMAP C15)
    child_xla = start_child("cmg", "xla")
    children.append(child_xla)
    # phases 41-42 (cells B-f32, G-f32) from here too, beside G-xla's
    child_f32 = start_child("f32")
    children.append(child_f32)
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
    a21_lv, plan_a21 = a21_plan(T, dev)
    th_a21 = build_in_thread("fused_a21", plan_a21.build)
    # phase 44's lanes (the pass switch, vds = 0) and plan
    from cedarsim_tpu_torch.benchmarks import netlists
    sw_lanes = netlists.pass_switch_lanes(dev)
    plan_sw = fused_plan_for(*sw_lanes[:3])
    th_sw = build_in_thread("fused_switch", plan_sw.build)
    th_pivot = build_in_thread("pivot", pivot_lu.build)
    th_sparse = build_in_thread("sparse", sparse_lu.build)
    th_gesp = build_in_thread("gesp", gesp_lu.build)
    # cell G's lanes and plan (phase 20 checks B1 on it), while nvcc runs
    cmg, cmg_setup_s, plan_cmg, t_plan_cmg = cmg_setup(torch, T, dev)
    th_cmg = build_in_thread("fused_cmg", plan_cmg.build)
    # cell V's lanes and plan (phase 24 checks B1 on it, phases 25-26 in
    # a child load its library)
    from cedarsim_tpu_torch.benchmarks import vbic_amp
    amp, amp_setup_s, plan_vbic, t_plan_vbic = vbic_setup(torch, T, dev)
    th_vbic = build_in_thread("fused_vbic", plan_vbic.build)
    # the one-stream plans of phases 35-36's warm-ups (the amplifier at
    # nominal AREA, the ring oscillator), built now so that those phases
    # find their libraries
    amp1 = T.compile_circuit(T.elaborate(T.parse_spice(netlists.VBIC_AMP)),
                             device=dev, dynamic_params=("area",))
    ring = T.compile_circuit(T.load_spice(RING_NETLIST), device=dev)
    th_one = [build_in_thread(name, fused_plan_for(
        c, ctx, c.params0).build) for name, c, ctx in (
            ("fused_vbic1", amp1, T.SimSpec.make(gmin=vbic_amp.GMIN)),
            ("fused_ring", ring, T.SimSpec.make()))]
    th_gesp.join()
    if isinstance(built["gesp"], BaseException):
        raise built["gesp"]
    b = built["gesp"]
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
        ptxas=ptxas, cmg_setup_s=cmg_setup_s, vbic_setup_s=amp_setup_s)
    abs_err, systems = phase_kernels(torch, gesp_lu, linalg, dev)
    # the repeat phase's children run beside phases 4-5
    children.append(start_repeat_children())
    phase_rc(T, dev)
    launches = phase_slice(torch, T, gesp_lu, linalg, dev, dff)
    phase_repeat(torch, T, dev, dff, children[-1])
    th_fused.join()
    if isinstance(built["fused"], BaseException):
        raise built["fused"]
    fabs_err, info, ftiming = phase_fused_kernel(
        torch, T, fc, dev, dff, plan, t_plan)
    flaunches = phase_fused_slice(
        torch, T, gesp_lu, fc, dev, dff,
        dict(plan_s=t_plan, emit_s=info["emit_seconds"],
             nvcc_s=info["nvcc_seconds"]))
    phase_lu_check(torch, gesp_lu, pivot_lu, dev)
    # phase 19's main path (the chain's transient), G-fused (once its
    # library is built), phases 25-33 (one child, once the VBIC and
    # level-1 libraries are built) and the CPU's side of phases 34-36
    # run from here in children beside phases 9-18 and 37; every
    # kernel-timing phase waits until every child has ended, so that no
    # other process shares the card while it times
    th_sparse.join()
    if isinstance(built["sparse"], BaseException):
        raise built["sparse"]
    child_sparse = start_child("sparse")
    children.append(child_sparse)
    th_cmg.join()
    if isinstance(built["fused_cmg"], BaseException):
        raise built["fused_cmg"]
    child_cmg = start_child("cmg", "fused")
    children.append(child_cmg)
    for th, name in ((th_vbic, "fused_vbic"), (th_lv1, "fused_lv1")):
        th.join()
        if isinstance(built[name], BaseException):
            raise built[name]
    child_a14b = start_child("a14b-both")
    children.append(child_a14b)
    child_cpu = start_child("a16a17")
    children.append(child_cpu)
    phase_lv1_single(torch, T, gesp_lu, dev)
    dl = phase_lv1(torch, T, gesp_lu, fc, lv1, "D", CELL_D,
                   LV1_SHORT_TSTOP,
                   extra=dict(jac_shunt=kt.LV1_XLA_OPTS["jac_shunt"]))
    el = phase_lv1(torch, T, gesp_lu, fc, lv1, "E", CELL_E, LV1_TSTOP)
    # phases 34-36 on the card from here, each in a child against the
    # CPU's record (its child has ended by now), beside phases 12-18 and
    # 37; their libraries (the one-stream plans) were built with the rest
    for th, name in zip(th_one, ("fused_vbic1", "fused_ring")):
        th.join()
        if isinstance(built[name], BaseException):
            raise built[name]
    cpu_out, _ = join_child(child_cpu)
    card_children = {which: start_child("a16a17-card", which, cpu_out)
                     for which in A16A17_CARD_CHILDREN}
    children.extend(card_children.values())
    a18_e, la38 = phase_lv1_repeat(torch, T, gesp_lu, fc, lv1, dev)
    phase_simulate(torch, T, dev)
    phase_sweeps(torch, T, dev)
    th_pvt.join()
    if isinstance(built["fused_pvt"], BaseException):
        raise built["fused_pvt"]
    _, pl = phase_pvt(torch, gesp_lu, fc, dev, pvt_state, plan_pvt)
    child_pvt_xla = start_child("pvt-xla")
    children.append(child_pvt_xla)
    phase_ac_noise(torch, T, gesp_lu, pivot_lu, fc, dev)
    phase_cmg_noise(torch, T, gesp_lu, pivot_lu, fc, dev)
    la37 = phase_a19(torch, T, dev, dff)
    th_a21.join()
    if isinstance(built["fused_a21"], BaseException):
        raise built["fused_a21"]
    la40 = phase_a21_path(torch, T, dev)
    th_sw.join()
    if isinstance(built["fused_switch"], BaseException):
        raise built["fused_switch"]
    sw44 = phase_switch(torch, T, fc, dev, sw_lanes, plan_sw)
    out, waited = join_child(child_pvt_xla)
    with open(out) as f:
        rec = json.load(f)
    for phase, kw in rec["lines"]:
        log(phase, **kw, ran_in_child=True, waited_s=waited)
    xl = rec["ret"]
    out, waited = join_child(child_a14b)
    vl, bl = phase_a14b(out, waited)
    dl3 = phase_a14b3(out + ".a14b3", waited)
    sparse_main, a16b = join_sparse_child(child_sparse)
    sparse_state = phase_sparse_check(torch, T, dev, sparse_main)
    log("a16b", **a16b, ran_in_child=True)
    rets = {}
    for which, child in card_children.items():
        out, _ = join_child(child)
        with open(out) as f:
            rec = json.load(f)
        for phase, kw in rec["lines"]:
            log(phase, **kw)
        rets[which] = rec["ret"]
    la35 = rets["a17_driven"]
    la36, la36_tran = rets["a17_auto"]
    # beside G-xla's child alone (the critical path, ROADMAP C16): phase
    # 38's two ranks on the card (child processes, which a thread of this
    # process waits on) beside phase 43's lanes and plans, then the checks
    # that time nothing, B1 on the one-stream plans and phase 20's
    # checking half
    th_a18 = build_in_thread("a18_pair",
                             lambda: phase_a18_pair(torch, dev, a18_e))
    f32_state = {leg: f32_kernel_setup(torch, T, leg)
                 for leg in ("bsim4", "cmg")}
    gl_fused, xla_cpu = phase_cmg("fused", child_cmg)
    f32l = phase_f32(child_f32)
    th_a18.join()
    if isinstance(built["a18_pair"], BaseException):
        raise built["a18_pair"]
    a18_pair = built["a18_pair"]
    one_err = phase_one_stream_fused_kernel(torch, T, fc, (
        ("amp1", amp1, T.SimSpec.make(gmin=vbic_amp.GMIN), (1e-6, 1e-4),
         {"hb_warmup": FUSED_OPTS}),
        ("ring", ring, T.SimSpec.make(), (1e-12, 1e-10),
         {"hb_warmup": FUSED_OPTS, "kicked_tran": RING_TRAN_OPTS})))
    cmg_checked = cmg_fused_kernel_check(torch, T, fc, cmg[:4], plan_cmg)
    gl = {"fused": gl_fused,
          "xla": phase_cmg("xla", child_xla, xla_cpu)[0]}
    log("children", spans={name: [t0, t1]
                           for name, t0, t1 in CHILD_SPANS})
    # the timing phases, alone on the card: 3, 6 and 8's timing
    # halves, then 20, 24, 11, 16 and 19's
    times, bounds = phase_kernel_times(torch, gesp_lu, dev, systems)
    ftimes, fbounds = phase_fused_kernel_times(fc, plan, ftiming)
    lu_launches, per_shape = phase_lu(torch, gesp_lu, pivot_lu, dev)
    cabs_err, ctimes, cbound = phase_cmg_fused_kernel(
        torch, T, fc, cmg[:4], plan_cmg, t_plan_cmg, cmg_checked)
    vabs_err, vtimes, vbound = phase_vbic_fused_kernel(
        torch, T, fc, amp, plan_vbic, t_plan_vbic)
    labs_err, ltimes, lbounds = phase_lv1_fused_kernel(torch, T, fc, lv1,
                                                       plan_lv1)
    pabs_err, ptimes, pbound = phase_pvt_fused_kernel(torch, T, fc,
                                                      pvt_state, plan_pvt)
    sparse_entries = phase_sparse(torch, T, dev, sparse_state)
    a21_abs_err, a21_times, a21_bound = phase_a21_kernel(torch, T, fc,
                                                         a21_lv, plan_a21)
    a16b_times = a16b_kernel_times(torch, T, dev)
    f32k = {leg: phase_f32_fused_kernel(torch, T, fc, leg, f32_state[leg],
                                        lg["log"])
            for leg, lg in (("bsim4", info), ("cmg", plan_cmg.build()))}
    src = "cedarsim_tpu_torch/csrc/gesp_lu.cu"
    b1p = ftimes["B1'"]
    n1 = lv1[0].n_x

    def lv1_entry(B):
        shape = [B if isinstance(B, int) else LV1_LANES, n1]
        return {"shape": shape, "device_ms": ltimes[B][0],
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
                          "eight_lanes": lv1_entry(N_LANES),
                          "ring": {
                              "shape": [1, ring.n_x],
                              "max_abs_err": one_err["ring"],
                              "hb_warmup_launches": la36["fused"],
                              "kicked_tran_launches":
                                  la36_tran["fused"]},
                          "bdf3": {"launches": bl["bdf3"]["fused"],
                                   **lv1_entry("bdf3")},
                          "bdf5": {"launches": bl["bdf5"]["fused"],
                                   **lv1_entry("bdf5")}},
                     pvt={"model": "BSIM4, W and VDD per lane",
                          "launches": pl["fused"], "max_abs_err": pabs_err,
                          "shape": [PVT_POINTS, pvt_state[0].comp.n_x],
                          "device_ms": ptimes[0], "call_ms": ptimes[1],
                          "plain_ms": ptimes[2], "bound_ms": pbound[0],
                          "bound_by": pbound[1]},
                     cmg={"model": "BSIM-CMG 107, NFIN per lane",
                          "launches": gl["fused"]["fused"],
                          "max_abs_err": cabs_err,
                          "shape": [CMG_LANES, cmg[0].n_x],
                          "device_ms": ctimes[0], "call_ms": ctimes[1],
                          "plain_ms": ctimes[2], "bound_ms": cbound[0],
                          "bound_by": cbound[1]},
                     a19_launches=la37["fused"],
                     a18_launches={"nccl_world_1": la38["E"]["fused"],
                                   "gloo_two_ranks": a18_pair},
                     a21={"model": "integer, bitwise and point-list "
                                   "constructs (netlists.a21_circuit)",
                          "launches": la40["fused"],
                          "max_abs_err": a21_abs_err,
                          "shape": [len(netlists.A21_CODES),
                                    a21_lv[0].n_x],
                          "device_ms": a21_times[0],
                          "call_ms": a21_times[1],
                          "plain_ms": a21_times[2],
                          "bound_ms": a21_bound[0],
                          "bound_by": a21_bound[1]},
                     switch=sw44,
                     vbic={"model": "VBIC with self-heating, AREA per "
                                    "lane",
                           "launches": vl["fused"]["fused"],
                           "max_abs_err": vabs_err,
                           "shape": [vbic_amp.LANES, amp[0].n_x],
                           "device_ms": vtimes[0], "call_ms": vtimes[1],
                           "plain_ms": vtimes[2], "bound_ms": vbound[0],
                           "bound_by": vbound[1],
                           "hb_warmup": {"shape": [1, amp1.n_x],
                                         "launches": la35["fused"],
                                         "max_abs_err": one_err["amp1"]}}),
    ]
    f32_err, f32_times, f32_bound, f32_ptxas = f32k["bsim4"]
    c32_err, c32_times, c32_bound, c32_ptxas = f32k["cmg"]
    kernels.append(kernel_entry(
        "fused_chord_f32", "cedarsim_tpu_torch/csrc/fused_chord.cu",
        "cedarsim_tpu/ops/fused_chord.py:632", f32l["bsim4"]["fused"],
        *f32_times, None, None, None, f32_bound, f32_err,
        also_replaces="cedarsim_tpu/ops/fused_chord.py:526",
        model="BSIM4, W per lane, eval_dtype=float32 (cell B-f32)",
        shape=[kt.LEGS["bsim4"]["tpu_nb"], dff[0].n_x], ptxas=f32_ptxas,
        rescue_launches={k: f32l["bsim4"][k] for k in ("factor", "subst")},
        cmg={"model": "BSIM-CMG 107, NFIN per lane, eval_dtype=float32 "
                      "(cell G-f32)",
             "launches": f32l["cmg"]["fused"], "max_abs_err": c32_err,
             "shape": [kt.LEGS["cmg"]["tpu_nb"], cmg[0].n_x],
             "device_ms": c32_times[0], "call_ms": c32_times[1],
             "plain_ms": c32_times[2], "bound_ms": c32_bound[0],
             "bound_by": c32_bound[1], "ptxas": c32_ptxas,
             "rescue_launches": {k: f32l["cmg"][k]
                                 for k in ("factor", "subst")}}))
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
            lv1_launches=dl[key], pvt_xla_launches=xl[key],
            cmg_xla_launches=gl["xla"][key],
            vbic_xla_launches=vl["xla"][key],
            link_launches=dl3["link"][key],
            delay_launches=dl3["delay"][key],
            latch_launches=dl3["latch"][key],
            a19_launches=la37[key], a18_launches=la38["D"][key]))
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
    for key, la_key in (("factor", "sparse_factor"),
                        ("solve", "sparse_solve")):
        dev_ms, call, plain, bnd, lib, lib_dev, lib_by = a16b_times[key]
        sparse_entries[key]["a16b"] = {
            "circuit": "netlists.diode_ladder(), forward-mode AD",
            "launches": a16b["launches"].get(la_key, 0),
            **({"under_tangent": a16b["s2_launches_under_tangent"],
                "rhs": "tangent (d_rhs - dA x)"} if key == "solve"
               else {"under_tangent": 0}),
            "max_abs_err": 0.0, "shape": [1, a16b_times["nnz_f"]],
            "device_ms": dev_ms, "call_ms": call, "plain_ms": plain,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
            "library_device_ms": lib_dev, "library_device_by": lib_by}
    kernels += [sparse_entries["factor"], sparse_entries["solve"]]
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--repeat-child":
        repeat_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--sparse-child":
        sparse_child(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "--cmg-child":
        cmg_child(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 3 and sys.argv[1] == "--f32-child":
        f32_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--a14b-both-child":
        a14b_both_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--pvt-xla-child":
        pvt_xla_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--a16a17-child":
        a16a17_cpu(sys.argv[2])
    elif len(sys.argv) == 5 and sys.argv[1] == "--a16a17-card-child":
        a16a17_card_child(*sys.argv[2:])
    else:
        main()
