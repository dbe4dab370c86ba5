"""Cell O: the heavy-loss LTRA link through the public ``tran()``.

The JAX package's heavy-loss link (``netlists.lossy_link``: a 0→2 V PULSE
at 10 ns, RS 50 Ω, an O element on ``LTRA (R=60 L=1.25u G=0 C=0.5n
LEN=1)``, which elaborates to six ``LTRALine`` sections, 21 unknowns and
12 ring slots, and RL) at 32 lanes, a termination-tolerance sweep: RL =
50 Ω × ``linspace(0.9, 1.1)``, each lane from its own operating point,
over the whole 0-360 ns with ``TranOptions(rtol=1e-4, atol=1e-7,
max_steps=32768)``, a Jacobian shunt of 1e-6 (``OPTS``) and
``dense_lu="auto"``, which on a card with a lane axis is the float32 GESP
pair B2/B3.  The gate is closed-form physics on
every lane: b at 37 ns (the first transit through the six sections)
within 2 % of :func:`first_transit`, b at 350 ns within 0.01 V of the DC
divider 2·RL/(110 + RL), and no history-ring lookup underflowed.

    python -m cedarsim_tpu_torch.benchmarks.lossy_link
    python -m cedarsim_tpu_torch.benchmarks.lossy_link --device cpu \\
        --lanes 2 --tstop 1e-7

prints one JSON line: lanes, n_x, ring slots, breakpoints, set-up, the
``tran`` wall, the counts over all lanes, the kernels' launches in that
call, the gate's worst relative first-transit error and worst settled
error (null when the window ends before them) and, on a card, the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

TSTOP = 3.6e-7
LANES = 32
RTOT = 60.0
RL = 50.0
RS = 50.0
VS = 2.0
#: the sweep of RL, the transit and settled probes and their gates
RL_SPAN = (0.9, 1.1)
T_TRANSIT, T_SETTLED = 37e-9, 350e-9
TRANSIT_RTOL, SETTLED_ATOL = 0.02, 0.01
#: the JAX test's options, and a Jacobian-only shunt on the voltage rows:
#: the junctions between sections hold only branch currents in their KCL
#: rows (G = 0, no capacitance), so their diagonal is 0, and without the
#: shunt the no-pivot float32 factor (B2) boosts those pivots to 1e-20 and
#: every lane stops at the first edge; with 1e-6 the lanes take the exact
#: solve's accepted and rejected steps and a few Newton steps more (1e-9
#: and 1e-4 cost more than 1e-6)
OPTS = dict(rtol=1e-4, atol=1e-7, max_steps=32768, jac_shunt=1e-6)


def first_transit(vs, rs, rl, rtot, k, z0=50.0):
    """The closed-form first-transit amplitude at the load through a chain
    of ``k`` lossy sections (the JAX package's ``tests/test_ltra_urc.py::
    _first_transit``): the launch divider, each junction's transmission
    into a quiet section, the receive divider, α per section."""
    rk = rtot / k
    alpha = np.exp(-rk / (2 * z0))
    rs_w = z0 * (1 - alpha * alpha) / (2 * alpha)
    gc = (1 - alpha) / (z0 * (1 + alpha))
    rho = max(0.0, (rk - rs_w) / 2)
    zin = rho + z0 / (1 - z0 * gc)
    i1 = vs / (rs + zin)
    w = 2 * z0 * i1 / (1 - z0 * gc)
    for _ in range(k - 1):
        e = alpha * w
        vj = e / ((1 + rho / zin) * (1 - z0 * gc) + z0 / zin)
        w = 2 * z0 * (vj / zin) / (1 - z0 * gc)
    e = alpha * w
    return e / ((1 + rho / rl) * (1 - z0 * gc) + z0 / rl)


def setup(lanes=LANES, device=None):
    """The link compiled on ``device`` with RL's resistance dynamic, its
    lanes (RL × ``linspace(*RL_SPAN)``) and each lane's transient operating
    point.  Returns ((compiled, ctx, per-lane params, per-lane initial
    states, per-lane RL [lanes], sections), seconds)."""
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.config import resolve_device
    t0 = time.perf_counter()
    dev = resolve_device(device)
    ckt = T.elaborate(T.parse_spice(netlists.lossy_link(RTOT, RL)))
    comp = T.compile_circuit(ckt, device=dev, dynamic_params=("rl.r",))
    sections = len([i for i in ckt.instances if "o1#s" in i.name])
    ctx = T.SimSpec.make()
    key, j, pn = comp.param_loc("rl.r")
    rl = RL * np.linspace(*RL_SPAN, lanes)
    pb = {k: {p: v.expand((lanes,) + tuple(v.shape))
              for p, v in grp.items()} for k, grp in comp.params0.items()}
    pb[key] = dict(pb[key])
    r = comp.params0[key][pn][None, :].repeat(lanes, 1)
    r[:, j] = torch.as_tensor(rl, dtype=comp.dtype, device=dev)
    pb[key][pn] = r
    x0 = torch.zeros(lanes, comp.n_x, dtype=comp.dtype, device=dev)
    op = T.solve_dc(comp, pb, ctx, mode="tranop", x0=x0)
    if not bool(op.converged.all()):
        raise AssertionError("link operating points did not converge")
    return (comp, ctx, pb, op.x, rl, sections), time.perf_counter() - t0


def gate(sols, rl, sections, tstop):
    """Every lane finished with no ring underflow, and b at ``T_TRANSIT``
    within ``TRANSIT_RTOL`` of :func:`first_transit`, b at ``T_SETTLED``
    within ``SETTLED_ATOL`` of the divider.  Raises on a miss; returns
    (worst relative transit error, worst settled error), None for a probe
    past ``tstop``."""
    worst_t = worst_s = None
    bad = []
    for lane, (sol, r) in enumerate(zip(sols, rl)):
        if not (sol.converged and np.isfinite(sol.xs).all()):
            raise AssertionError(f"link lane {lane} did not finish")
        if sol.n_ring_underflow:
            raise AssertionError(f"link lane {lane}: {sol.n_ring_underflow}"
                                 " ring lookups underflowed")
        if tstop >= T_TRANSIT:
            want = first_transit(VS, RS, r, RTOT, sections)
            e = abs(float(sol.interp("b", T_TRANSIT)) - want) / want
            worst_t = e if worst_t is None else max(worst_t, e)
            if not e < TRANSIT_RTOL:
                bad.append((lane, "transit", e))
        if tstop >= T_SETTLED:
            e = abs(float(sol.interp("b", T_SETTLED))
                    - VS * r / (RS + RTOT + r))
            worst_s = e if worst_s is None else max(worst_s, e)
            if not e < SETTLED_ATOL:
                bad.append((lane, "settled", e))
    if bad:
        raise AssertionError(f"link gate failed (lane, probe, err): {bad}")
    return worst_t, worst_s


def run(tstop=TSTOP, device=None, link=None, dense_lu=None, lanes=LANES):
    """Run cell O over 0-``tstop`` and gate it; ``link``: the lanes from
    :func:`setup` (made here otherwise), ``dense_lu`` overrides "auto".
    Every kernel count is set to 0 just before the call and read just
    after.  Returns the result dict (the solutions under ``"sols"``)."""
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.analysis.tran import resolve_impl
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    from cedarsim_tpu_torch.ops import fused_chord as fc
    from cedarsim_tpu_torch.ops import gesp_lu
    setup_s = 0.0
    if link is None:
        link, setup_s = setup(lanes, device)
    comp, ctx, pb, x0, rl, sections = link
    on_card = comp.device.type == "cuda"
    opts = dict(OPTS)
    if dense_lu is not None:
        opts["dense_lu"] = dense_lu
    impl = resolve_impl(comp, T.TranOptions(**opts), ctx, pb)
    counters = (fc.fused_chord, gesp_lu.lu_factor_gesp_f32,
                gesp_lu.lu_subst_gesp_f32)
    for f in counters:
        f.launches = 0
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = T.tran(comp, (0.0, tstop), params=pb, ctx=ctx, x0=x0,
                  opts=T.TranOptions(**opts))
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(("fused", "factor", "subst"),
                        (f.launches for f in counters)))
    worst_t, worst_s = gate(sols, rl, sections, tstop)
    n = len(sols)
    return dict(
        lanes=n, n_x=comp.n_x, ring_slots=comp.n_ring, sections=sections,
        breakpoints=len(comp.breakpoints(tstop)), device=str(comp.device),
        dense_lu=impl.dense_lu, newton_impl=impl.newton_impl, tstop=tstop,
        setup_s=setup_s, wall_s=wall, transients_per_s=n / wall,
        worst_transit_rel_err=worst_t, worst_settled_err=worst_s,
        accepted=sum(s.n_accepted for s in sols),
        rejected=sum(s.n_rejected for s in sols),
        newton=sum(s.n_newton for s in sols), attempts=sols[0].n_attempts,
        ring_underflow=sum(s.n_ring_underflow for s in sols),
        launches=launches, card=kt.smi() if on_card else None, sols=sols)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tstop", type=float, default=TSTOP)
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rec = run(args.tstop, args.device, lanes=args.lanes)
    rec.pop("sols")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
