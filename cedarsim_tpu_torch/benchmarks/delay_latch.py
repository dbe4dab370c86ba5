"""The delay ring, the latch channel and transient noise on a device: the
circuits and gates of ``chip_smoke.py``'s phases H, Z and N, each the JAX
package's own test circuit (``tests/test_va_delay_history.py``,
``test_va_transition_latch.py``, ``test_va_zi.py``,
``test_transient_noise.py``).

- :func:`delay_line`: a 1 MHz sine (or a 1 V PULSE) through a
  history-mode ``absdelay`` of ``td`` into RL = 10 kΩ; with lanes, RL ×
  ``linspace(0.9, 1.1)``.  :func:`sine_gate`: every lane within 0.02 of
  sin(2πF(t − td)) over 3–7.5 µs and no ring underflow;
  :func:`pulse_gate`: the pulse's top and base one delay later.
- :func:`latch_case`: the LRM ``transition`` ramp (the linear and the
  interrupted one, ``netlists.VA_TRANSITION_RAMP``) and the ``zi_nd``
  FIR and IIR filters, each with RL = 1 MΩ × ``linspace(0.9, 1.1)`` per
  lane, and its gate (:func:`latch_gate`).
- :func:`ktc`: a 100 kΩ resistor on a 100 fF capacitor with noise
  injection at h = τ/8 (``noise_seed=7``), and its variance gate.

    python -m cedarsim_tpu_torch.benchmarks.delay_latch --device cpu

runs each case once on the device (8 lanes, the noise one stream) and
prints one JSON line of walls, counts, launches and gate errors.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

#: the history line (``tests/test_va_delay_history.py``)
LINE_F, LINE_TD, LINE_TSTOP = 1e6, 2e-6, 8e-6
LINE_OPTS = dict(rtol=1e-4, atol=1e-7, max_steps=16384)
SINE_PROBES = np.linspace(3e-6, 7.5e-6, 60)
SINE_ATOL = 0.02
#: the pulse through the line: 0 → 1 V, edges of 0.3 µs from 0.2 µs, 0.5
#: µs wide, every 2 µs; its top reaches out over 2.5-3.0 µs
LINE_PULSE = dict(v1=0.0, v2=1.0, td=0.2e-6, tr=0.3e-6, tf=0.3e-6,
                  pw=0.5e-6, per=2e-6)
#: the short-ring collapse (ROADMAP C12)
C12_TD = 1.9e-6
#: the latch cases (``tests/test_va_transition_latch.py``,
#: ``tests/test_va_zi.py``): source, device params, window
LATCH_OPTS = dict(rtol=1e-5, atol=1e-8, max_steps=16384)
ZI_T = 1e-6
LATCH_CASES = {
    "ramp": (dict(v1=0.0, v2=3.3, td=2e-5, tr=1e-9, pw=1e-3, per=2e-3),
             dict(tt=1e-5), 6e-5),
    "interrupted": (dict(v1=0.0, v2=3.3, td=2e-5, tr=1e-9, tf=1e-9,
                         pw=5e-6, per=2e-3), dict(tt=1e-5), 6e-5),
    "fir": (dict(v1=0.0, v2=10.0, td=0.0, tr=10 * ZI_T, pw=1e-3, per=2e-3),
            {}, 6.2 * ZI_T),
    "iir": (dict(v1=0.0, v2=2.0, td=0.5 * ZI_T, tr=1e-9, pw=1e-3, per=2e-3),
            dict(c=0.5), 8.2 * ZI_T),
}
#: kT/C (``tests/test_transient_noise.py``)
KTC_R, KTC_C = 1e5, 1e-13
KTC_TAU = KTC_R * KTC_C
KTC_SPAN = 400 * KTC_TAU
KTC_SEED = 7


def rl_lanes(comp, lanes, inst="RL", span=(0.9, 1.1)):
    """Per-lane params of ``comp``: ``inst``'s resistance × ``linspace(*
    span)`` (compiled with ``dynamic_params=("<inst>.r",)``), the rest as
    compiled."""
    import torch
    key, j, pn = comp.param_loc(f"{inst}.r")
    pb = {k: {p: v.expand((lanes,) + tuple(v.shape))
              for p, v in grp.items()} for k, grp in comp.params0.items()}
    pb[key] = dict(pb[key])
    r = comp.params0[key][pn][None, :].repeat(lanes, 1)
    r[:, j] = r[:, j] * torch.as_tensor(np.linspace(*span, lanes),
                                        dtype=comp.dtype, device=comp.device)
    pb[key][pn] = r
    return pb


def delay_line(device, td=LINE_TD, source="sin"):
    """The history line compiled on ``device``: ``source`` "sin" (the
    test's 1 MHz, 1 V sine), "pulse" (``LINE_PULSE``) or a DC value with
    an AC drive of 1."""
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.va.codegen import load_va
    ckt = T.Circuit()
    vin, out = ckt.net("vin"), ckt.net("out")
    if source == "sin":
        ckt.add(T.VSourceSIN, "V1", (vin, ckt.gnd),
                dict(vo=0.0, va=1.0, freq=LINE_F))
    elif source == "pulse":
        ckt.add(T.VSourcePULSE, "V1", (vin, ckt.gnd), LINE_PULSE)
    else:
        ckt.add(T.VSource, "V1", (vin, ckt.gnd), dict(dc=source, ac=1.0))
    dly = load_va(netlists.VA_DELAY_LINE, delay_mode="history")["vdelay"]
    ckt.add(dly, "X1", (out, ckt.gnd, vin, ckt.gnd), dict(td=td))
    ckt.add(T.Resistor, "RL", (out, ckt.gnd), dict(r=1e4))
    return T.compile_circuit(ckt, device=device, dynamic_params=("rl.r",))


def sine_gate(sols, td=LINE_TD):
    """Every lane finished, no ring underflow, and within ``SINE_ATOL`` of
    sin(2πF(t − td)) over ``SINE_PROBES``; returns the worst error."""
    worst = 0.0
    for lane, sol in enumerate(sols):
        if not sol.converged or sol.n_ring_underflow:
            raise AssertionError(
                f"history line lane {lane}: converged {sol.converged}, "
                f"{sol.n_ring_underflow} ring underflows")
        err = float(np.max(np.abs(
            sol.interp("out", SINE_PROBES)
            - np.sin(2 * np.pi * LINE_F * (SINE_PROBES - td)))))
        worst = max(worst, err)
    if not worst < SINE_ATOL:
        raise AssertionError(f"history line: {worst:.3g} from the delayed "
                             "sine")
    return worst


def pulse_gate(sols, td=LINE_TD):
    """Every lane finished with no ring underflow, its output at the
    pulse's top (1 V) mid-way along it one delay later and at its base
    (0 V) before that; returns the worst error."""
    top = td + LINE_PULSE["td"] + LINE_PULSE["tr"] + 0.5 * LINE_PULSE["pw"]
    worst = 0.0
    for lane, sol in enumerate(sols):
        if not sol.converged or sol.n_ring_underflow:
            raise AssertionError(
                f"pulsed line lane {lane}: converged {sol.converged}, "
                f"{sol.n_ring_underflow} ring underflows")
        err = max(abs(float(sol.interp("out", top)) - 1.0),
                  abs(float(sol.interp("out", 0.9 * td))))
        worst = max(worst, err)
        if not err < 1e-9:
            raise AssertionError(f"pulsed line lane {lane}: {err:.3g} from "
                                 "the delayed pulse")
    return worst


def latch_case(case, device):
    """One latch case compiled on ``device``: (compiled, PULSE params,
    window)."""
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.va.codegen import load_va
    sp, dp, tstop = LATCH_CASES[case]
    if case in ("ramp", "interrupted"):
        dev_cls = load_va(netlists.VA_TRANSITION_RAMP,
                          transition_mode="latch")["vatrans"]
    else:
        dev_cls = load_va(netlists.VA_ZI_FIR if case == "fir"
                          else netlists.VA_ZI_IIR)["va" + case]
    ckt = T.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(T.VSourcePULSE, "V1", (vin, ckt.gnd), sp)
    ckt.add(dev_cls, "F1", (vin, vout), dp)
    ckt.add(T.Resistor, "RL", (vout, ckt.gnd), dict(r=1e6))
    return (T.compile_circuit(ckt, device=device, dynamic_params=("rl.r",)),
            tstop)


def latch_gate(case, sols):
    """The JAX test's gate of ``case`` on every lane; returns the worst
    error against its closed-form level."""
    probes = {
        "ramp": [(2e-5 + f * 1e-5, 3.3 * f, 0.05) for f in (0.25, 0.5, 0.75)]
        + [(3.05e-5, 3.3, 1e-6), (1.9e-5, 0.0, 1e-9)],
        "interrupted": [(2.5e-5, 1.65, 0.05), (3.6e-5, 0.0, 0.02)],
        "fir": [((n + 0.5) * ZI_T, n - 0.5, 1e-6) for n in (2, 3, 5)],
        "iir": [((m + 0.5) * ZI_T, 2.0 * (1 - 0.5 ** m), 1e-6)
                for m in (1, 2, 3, 6)],
    }[case]
    worst = 0.0
    for lane, sol in enumerate(sols):
        if not sol.converged:
            raise AssertionError(f"latch {case} lane {lane} did not finish")
        for t, want, tol in probes:
            err = abs(float(sol.interp("vout", t)) - want)
            worst = max(worst, err)
            if not err < tol:
                raise AssertionError(f"latch {case} lane {lane}: {err:.3g} "
                                     f"at {t:g} s (tolerance {tol:g})")
        if case == "interrupted":
            peak = float(sol.interp("vout", 2.5e-5))
            if not abs(float(sol.interp("vout", 3.0e-5)) - peak / 2) < 0.05:
                raise AssertionError(f"latch {case} lane {lane}: the fall "
                                     "ramp misses its midpoint")
    return worst


def ktc(device):
    """The kT/C circuit compiled on ``device``, its context and options."""
    import cedarsim_tpu_torch as T
    ckt = T.Circuit()
    vout = ckt.net("vout")
    ckt.add(T.Resistor, "R1", (vout, ckt.gnd), dict(r=KTC_R))
    ckt.add(T.Capacitor, "C1", (vout, ckt.gnd), dict(c=KTC_C))
    opts = T.TranOptions(noise_seed=KTC_SEED,
                         hmax_frac=(KTC_TAU / 8) / KTC_SPAN, rtol=10.0,
                         atol=10.0, max_steps=8192, method="be",
                         h0=KTC_TAU / 8)
    return (T.compile_circuit(ckt, device=device),
            T.SimSpec.make(gmin=1e-15), opts)


def ktc_ratio(sol):
    """The variance over t > 20τ over kT/C (the gate: 0.6-1.4)."""
    from cedarsim_tpu_torch import config
    var = float(np.var(sol["vout"][sol.ts > 20 * KTC_TAU]))
    return var / (config.K_BOLTZMANN * (config.T_ZERO_C + 27.0) / KTC_C)


def run_all(device, lanes=8):
    """Every case once on ``device``: walls, counts and gate errors."""
    import torch
    import cedarsim_tpu_torch as T
    on_card = torch.device(device).type == "cuda"

    def timed(fn):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def tot(sols):
        return [sum(s.n_accepted for s in sols),
                sum(s.n_rejected for s in sols),
                sum(s.n_newton for s in sols), sols[0].n_attempts]
    rec = {}
    comp = delay_line(device)
    pb = rl_lanes(comp, lanes)
    sols, wall = timed(lambda: T.tran(comp, (0.0, LINE_TSTOP), params=pb,
                                      opts=T.TranOptions(**LINE_OPTS)))
    rec["line"] = dict(wall_s=wall, counts=tot(sols),
                       worst_err=sine_gate(sols))
    comp = delay_line(device, source="pulse")
    pb = rl_lanes(comp, lanes)
    sols, wall = timed(lambda: T.tran(comp, (0.0, LINE_TSTOP), params=pb,
                                      opts=T.TranOptions(**LINE_OPTS)))
    rec["pulse"] = dict(wall_s=wall, counts=tot(sols),
                        worst_err=pulse_gate(sols))
    for case in LATCH_CASES:
        comp, tstop = latch_case(case, device)
        pb = rl_lanes(comp, lanes)
        sols, wall = timed(lambda: T.tran(comp, (0.0, tstop), params=pb,
                                          opts=T.TranOptions(**LATCH_OPTS)))
        rec[case] = dict(wall_s=wall, counts=tot(sols),
                         worst_err=latch_gate(case, sols))
    comp, ctx, opts = ktc(device)
    sol, wall = timed(lambda: T.tran(comp, (0.0, KTC_SPAN), ctx=ctx,
                                     opts=opts))
    rec["ktc"] = dict(wall_s=wall, accepted=sol.n_accepted,
                      var_over_ktc=ktc_ratio(sol))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    print(json.dumps(run_all(args.device, args.lanes)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
