#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises, so the exit code is not
0 and no result line is printed):

1. device  — requires CUDA; prints the card's name and power limit; full
   float32 matmuls (no TF32).
2. build   — compiles the CUDA GESP LU kernels from the checkout's sources.
3. kernels — each kernel against its plain PyTorch version on the card
   (random, equilibrated, diagonally dominant inputs from a fixed numpy
   seed); the mixed chord solve against float64 ``torch.linalg.solve``;
   kernel and plain times at the DFF transient's shape.
4. rc      — the RC step circuit against its closed form.
5. slice   — the gf180 DFF BSIM4 testbench: parse → elaborate → compile on
   the card → transient operating point → per-lane warm DC → an 8-lane
   transient with a per-lane W scatter through the mixed chord path, gated
   on the benchmark's golden Q levels; both kernels must have launched.

The line before the last is the card's name and power limit from
``nvidia-smi``; before it, one JSON line with each kernel's route, source,
launches on the main path, error and times.  The last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DFF_DIR = os.path.join(REPO, "benchmarks", "gf180_dff")
#: golden tolerance of the DFF benchmark (bench.py GOLDEN_TOL)
GOLDEN_TOL = 0.05
#: lanes of the transient and the per-lane W scatter (bench.py:217-225)
N_LANES = 8
#: relative tolerance of a kernel against its plain version: float32 with
#: FMA contraction and another summation order than the plain rounding
KERNEL_RTOL = 1e-5
#: the mixed chord solve (float32 GESP + two float64 refinement passes)
#: against float64 torch.linalg.solve on well-conditioned systems
CHORD_RTOL = 1e-10


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def test_matrices(rng, B, n):
    """Random, row-equilibrated, diagonally dominant float32 systems."""
    A = rng.standard_normal((B, n, n))
    A += (n + 8) * np.eye(n)
    A /= np.abs(A).max(-1, keepdims=True)
    b = rng.standard_normal((B, n))
    return A, b


def cuda_time_ms(fn, reps):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_kernels(torch, gesp_lu, linalg, dev):
    rng = np.random.default_rng(0)
    n_max = 240          # 240² · 4 B = 230,400 B of an H100 block's 232,448
    worst = {"factor": 0.0, "subst": 0.0}
    abs_err = {"factor": 0.0, "subst": 0.0}
    for B, n in [(1, 25), (8, 25), (37, 25), (128, 25), (8, 64),
                 (4, n_max)]:
        A, b = test_matrices(rng, B, n)
        A32 = torch.as_tensor(A, dtype=torch.float32, device=dev)
        b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
        LU_k = gesp_lu.lu_factor_gesp_f32(A32)
        LU_p = gesp_lu.lu_factor_gesp_f32_plain(A32)
        x_k = gesp_lu.lu_subst_gesp_f32(LU_p, b32)
        x_p = gesp_lu.lu_subst_gesp_f32_plain(LU_p, b32)
        torch.cuda.synchronize()
        for name, k, p in (("factor", LU_k, LU_p), ("subst", x_k, x_p)):
            if not bool(torch.isfinite(k).all()):
                raise AssertionError(f"{name} B={B} n={n}: non-finite")
            err = float((k - p).abs().max())
            rel = err / float(p.abs().max())
            if rel > KERNEL_RTOL:
                raise AssertionError(f"{name} B={B} n={n}: relative error "
                                     f"{rel:.3g} > {KERNEL_RTOL}")
            worst[name] = max(worst[name], rel)
            if n == 25 and B == N_LANES:
                abs_err[name] = err
        # the mixed chord solve on float64 systems vs torch.linalg.solve
        J = torch.as_tensor(A, dtype=torch.float64, device=dev)
        b64 = torch.as_tensor(b, dtype=torch.float64, device=dev)
        x_m = linalg.chord_solve_once(J, b64)
        x_e = torch.linalg.solve(J, b64)
        rel = float((x_m - x_e).abs().max() / x_e.abs().max())
        if rel > CHORD_RTOL:
            raise AssertionError(f"chord solve B={B} n={n}: relative error "
                                 f"{rel:.3g} > {CHORD_RTOL}")
    # times at the transient's shape: B = lanes, n = 25 unknowns
    A, b = test_matrices(rng, N_LANES, 25)
    A32 = torch.as_tensor(A, dtype=torch.float32, device=dev)
    b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
    LU = gesp_lu.lu_factor_gesp_f32(A32)
    times = {
        "factor": (cuda_time_ms(lambda: gesp_lu.lu_factor_gesp_f32(A32), 200),
                   cuda_time_ms(
                       lambda: gesp_lu.lu_factor_gesp_f32_plain(A32), 20)),
        "subst": (cuda_time_ms(lambda: gesp_lu.lu_subst_gesp_f32(LU, b32),
                               200),
                  cuda_time_ms(
                      lambda: gesp_lu.lu_subst_gesp_f32_plain(LU, b32), 20)),
    }
    log("kernels", worst_rel_err=worst, max_abs_err_dff_shape=abs_err,
        ms_kernel_vs_plain={k: list(v) for k, v in times.items()},
        shape=[N_LANES, 25, 25])
    return abs_err, times


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


def phase_slice(torch, T, gesp_lu, dev):
    import dataclasses
    from cedarsim_tpu_torch.analysis.dc import dc_core
    with open(os.path.join(DFF_DIR, "golden_bsim4.json")) as f:
        golden = json.load(f)
    tstop = 7e-7
    t0 = time.perf_counter()
    with open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")) as f:
        nl = T.parse_spice(f.read(), file="dff_tb_bsim4.cir")
    comp = T.compile_circuit(T.elaborate(nl, include_paths=[DFF_DIR]),
                             device=dev)
    ctx = T.SimSpec.make(gmin=1e-15)
    op = T.solve_dc(comp, ctx=ctx, mode="tranop")
    if not bool(op.converged):
        raise AssertionError("DFF operating point did not converge")
    key = [k for k in comp.group_order if "bsim4" in k.lower()][0]
    sc = np.linspace(0.99, 1.01, N_LANES)
    sc[N_LANES // 2] = 1.0
    scatter = torch.as_tensor(sc, dtype=comp.dtype, device=dev)
    pb = {k: {pn: v.expand((N_LANES,) + tuple(v.shape))
              for pn, v in grp.items()} for k, grp in comp.params0.items()}
    pb[key] = dict(pb[key])
    pb[key]["W"] = comp.params0[key]["W"][None, :] * scatter[:, None]
    light = dataclasses.replace(T.default_newton_options(comp),
                                gmin_steps=2, src_steps=2, restarts=0,
                                gmin_start=1e-6)
    warm = dc_core(comp, pb, ctx.with_mode("tranop"),
                   op.x.expand(N_LANES, comp.n_x), light)
    if not bool(warm.converged.all()):
        raise AssertionError("per-lane warm DC did not converge")
    t_setup = time.perf_counter() - t0
    # the mixed path's GESP factor has no pivoting: a Jacobian-only shunt
    # on the voltage rows keeps the node-first MNA pivots away from exact
    # cancellation (see PERF.md); the converged corrector is unchanged
    opts = T.TranOptions(max_steps=8192, jac_reuse=1, dense_lu="mixed",
                         newton_impl="xla", accept_slack=1.5,
                         jac_shunt=1e-9)
    gesp_lu.lu_factor_gesp_f32.launches = 0
    gesp_lu.lu_subst_gesp_f32.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sols = T.tran(comp, (0.0, tstop), params=pb, ctx=ctx, opts=opts,
                  x0=warm.x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {"factor": gesp_lu.lu_factor_gesp_f32.launches,
                "subst": gesp_lu.lu_subst_gesp_f32.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"kernels not on the main path: {launches}")
    worst, errs = 0.0, []
    for lane, sol in enumerate(sols):
        if not sol.converged:
            raise AssertionError(f"lane {lane} did not finish")
        if not (np.isfinite(sol.xs).all() and sol.xs.shape[1] == comp.n_x):
            raise AssertionError(f"lane {lane}: bad waveform")
        for j, (t_ns, g) in enumerate(zip(golden["samples_ns"],
                                          golden["q"])):
            if j in (2, 3) and lane != N_LANES // 2:
                continue        # the race points gate only the nominal lane
            err = abs(float(sol.interp("q", t_ns * 1e-9)) - g)
            worst = max(worst, err)
            if err > GOLDEN_TOL:
                errs.append((lane, t_ns, err))
    if errs:
        raise AssertionError(f"golden gate failed (lane, ns, err): {errs}")
    log("slice", lanes=N_LANES, setup_s=t_setup, wall_s=wall,
        transients_per_s=N_LANES / wall, worst_golden_err=worst,
        accepted=sum(s.n_accepted for s in sols),
        rejected=sum(s.n_rejected for s in sols),
        newton=sum(s.n_newton for s in sols), launches=launches,
        card=smi())
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    sys.path.insert(0, REPO)
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.ops import gesp_lu, linalg
    dev = torch.device("cuda", 0)
    card = smi()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are enabled")
    log("device", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    b = gesp_lu.build()
    ptxas = [ln.strip() for ln in b["log"].splitlines() if "registers" in ln]
    log("build", seconds=b["seconds"], path=os.path.relpath(b["path"], REPO),
        ptxas=ptxas)
    abs_err, times = phase_kernels(torch, gesp_lu, linalg, dev)
    phase_rc(T, dev)
    launches = phase_slice(torch, T, gesp_lu, dev)
    src = "cedarsim_tpu_torch/csrc/gesp_lu.cu"
    kernels = [
        {"name": "gesp_factor_f32", "route": "cuda", "source": src,
         "replaces": "cedarsim_tpu/ops/pallas_lu.py:313",
         "launches": launches["factor"], "max_abs_err": abs_err["factor"],
         "ms": times["factor"][0], "plain_ms": times["factor"][1]},
        {"name": "gesp_subst_f32", "route": "cuda", "source": src,
         "replaces": "cedarsim_tpu/ops/pallas_lu.py:354",
         "launches": launches["subst"], "max_abs_err": abs_err["subst"],
         "ms": times["subst"][0], "plain_ms": times["subst"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
