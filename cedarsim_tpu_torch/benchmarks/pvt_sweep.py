"""PVT sweep of the gf180 DFF on the BSIM4-class model: a batched
process × voltage grid of transients, the port's counterpart of the JAX
package's ``benchmarks/pvt_sweep.py`` (``run`` and ``run_chunked``).

    python -m cedarsim_tpu_torch.benchmarks.pvt_sweep --points 256
    python -m cedarsim_tpu_torch.benchmarks.pvt_sweep --points 256 --impl xla
    python -m cedarsim_tpu_torch.benchmarks.pvt_sweep --points 4 \\
        --device cpu --tstop 6e-8
    python -m cedarsim_tpu_torch.benchmarks.pvt_sweep --whole --points 64

Axes: every transistor's width W scaled over ±3 % (process) × the supply
``vvdd.dc`` over ±5 % (voltage), ``points`` of them on a grid of
``round(sqrt(points))`` supplies.  Every lane starts from its own operating
point, solved by the light continuation ladder from the nominal one (a lane
whose ladder fails starts from the nominal point).  The lanes run in chunks
of ``chunk`` through ``tran_core``, the span cut into ``segments`` windows
chained by checkpoint, storing only q (``store_vars``).  Gate, per lane:
finished, and q at 699 ns within 0.1 V of the lane's own supply (so a lane
permutation or a physics break cannot pass).

``run`` (``--whole``) is the JAX package's first mode: the whole grid as
one transient through the public ``tran``, every lane from the nominal
operating point, whole waveforms.

The engine is what ``resolve_impl`` gives a batched call: on CUDA the fused
chord kernel (B1), since W is an input of the nonlinear group and
``vvdd.dc`` a pure source offset (``dyn_leaf_safe``); ``impl="xla"`` takes
the chord loop with the GESP kernels (B2/B3, ``dense_lu="mixed"``) on any
device.  The options are the JAX package's on its chip (its harness's
``topts`` with the cap-form corrector), evaluated in float64.

A lane that fails the gate goes down the JAX package's rescue ladder, as
far as a float64 run needs it: all of a chunk's suspects (three or more)
in one batched pass over the whole span (``batch``), else the lane alone
over the whole span with the chunk's options (``solo_fast``), then alone
with cross-step Jacobian reuse (``jac_reuse=4``) from its full-ladder
operating point (``solo_warm``) and from ``tran``'s own (``solo_cold``).
The result counts the lanes that each tier brought through the gate.  The
JAX harness's worker processes (``run_robust``, for TPU client faults) and
its float32-evaluation and host float64 tiers have no counterpart: the
port evaluates in float64 on the card throughout.

One JSON line is printed (under 500 bytes); nothing is written.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

#: the benchmark's span, and the gate's time and tolerance
#: (benchmarks/pvt_sweep.py:105-112)
TSTOP = 7e-7
GATE_T = 6.99e-7
GATE_TOL = 0.1
#: the first step of every window chain (the JAX harness's)
H0 = 7e-13
#: the chunk options: the JAX harness's on its chip (pvt_sweep.py:191-195,
#: where float32 evaluation picks the cap form) with the cap form named
PVT_OPTS = dict(jac_reuse=1, formulation="cap", newton_reltol=1e-4,
                newton_abstol=5e-7, res_tol=1e-3, jac_shunt=1e-7,
                res_rel=3e-5, rtol=1e-2, atol=1e-4)
#: the chunk program's step budget over the whole span, shared by its
#: windows (pvt_sweep.py:190)
CHUNK_STEPS = 8192
#: the solo tiers' step budget and cross-step reuse (pvt_sweep.py:241-245)
SOLO_STEPS = 16384
SOLO_JAC_REUSE = 4
#: suspects of one chunk from which the batched pass runs
BATCH_RESCUE_MIN = 3


def grid(points):
    """(vdd, W scale) per point: ``round(sqrt(points))`` supplies over
    4.75-5.25 V, each with the W scales over 0.97-1.03."""
    nv = max(2, int(round(points ** 0.5)))
    nw = max(2, -(-points // nv))
    vdds = np.repeat(np.linspace(4.75, 5.25, nv), nw)[:points]
    wscs = np.tile(np.linspace(0.97, 1.03, nw), nv)[:points]
    return vdds, wscs


def _dff_dir():
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(os.path.dirname(here)),
                        "benchmarks", "gf180_dff")


class PVT:
    """The DFF compiled with ``vvdd.dc`` and ``w`` dynamic on ``device``,
    its nominal transient operating point and the chunk machinery."""

    def __init__(self, device=None, tstop=TSTOP, segments=2, impl="auto"):
        import torch
        import cedarsim_tpu_torch as T
        from cedarsim_tpu_torch import config
        from cedarsim_tpu_torch.core.compile import ensure_dynamic
        from cedarsim_tpu_torch.analysis import tran as ttran
        self.torch, self.T, self.ttran = torch, T, ttran
        self.device = config.resolve_device(device)
        d = _dff_dir()
        with open(os.path.join(d, "dff_tb_bsim4.cir")) as f:
            nl = T.parse_spice(f.read(), file="dff_tb_bsim4.cir")
        comp = T.compile_circuit(T.elaborate(nl, include_paths=[d]),
                                 device=self.device)
        self.comp = comp = ensure_dynamic(comp, ["vvdd.dc", "w"])
        self.ctx = T.SimSpec.make(gmin=1e-15)
        self.ctx_op = self.ctx.with_mode("tranop")
        self.key = [k for k in comp.group_order if "bsim4" in k.lower()][0]
        self.iq = comp.node_names.index("q")
        self.op = T.solve_dc(comp, ctx=self.ctx, mode="tranop")
        if not bool(self.op.converged):
            raise RuntimeError("the nominal operating point did not converge")
        self.nopts = T.default_newton_options(comp)
        self.tstop = float(tstop)
        self.segments = int(segments)
        self.impl = impl
        self.edges = np.linspace(0.0, self.tstop, self.segments + 1)
        bps = comp.breakpoints(self.tstop)
        self.win = ttran.window_schedules(bps, self.edges)
        self.bps_solo = np.concatenate([bps[bps > 0.0], [self.tstop],
                                        [np.inf]])
        self.mask = ttran.xdot0_and_mask(comp, self.op.x[None], self.ctx_op,
                                         comp.params0)[1][0]
        kw = dict(PVT_OPTS, max_steps=CHUNK_STEPS // self.segments,
                  store_vars=(self.iq,))
        if impl == "xla":
            kw.update(newton_impl="xla", dense_lu="mixed")
        elif impl == "fused":
            kw.update(newton_impl="fused")
        elif impl != "auto":
            raise ValueError(f"unknown impl {impl!r}")
        self.opts = T.TranOptions(**kw)
        self.solo_opts = dataclasses.replace(self.opts,
                                             max_steps=SOLO_STEPS)
        self.warm_opts = T.TranOptions(**dict(
            PVT_OPTS, max_steps=SOLO_STEPS, jac_reuse=SOLO_JAC_REUSE))
        kv, jv, pv = comp.param_loc("vvdd.dc")
        self._vloc = (kv, jv, pv)

    # ------------------------------------------------------------ lanes

    def chunk_params(self, vdds, wscs):
        """One params tree for the lanes (vdd, W scale): every leaf the
        compiled one broadcast over the lanes, ``vvdd.dc`` (given) and W
        set per lane."""
        torch, comp = self.torch, self.comp
        L = len(vdds)
        dt, dev = comp.dtype, comp.device
        pb = {k: {pn: v.expand((L,) + tuple(v.shape))
                  for pn, v in g.items()} for k, g in comp.params0.items()}
        kv, jv, pv = self._vloc
        gv = dict(pb[kv])
        col = gv[pv].clone()
        col[:, jv] = torch.as_tensor(np.asarray(vdds, np.float64), dtype=dt,
                                     device=dev)
        gv[pv] = col
        if f"{pv}$given" in gv:
            g1 = gv[f"{pv}$given"].clone()
            g1[:, jv] = 1.0
            gv[f"{pv}$given"] = g1
        pb[kv] = gv
        gk = dict(pb[self.key])
        gk["W"] = comp.params0[self.key]["W"][None, :] * torch.as_tensor(
            np.asarray(wscs, np.float64), dtype=dt, device=dev)[:, None]
        pb[self.key] = gk
        return pb

    def lane_ops(self, pb):
        """(x0 [L, n_x], converged [L]): each lane's operating point by the
        light ladder from the nominal one; a failed lane starts from the
        nominal point."""
        from cedarsim_tpu_torch.analysis.dc import dc_from_nominal
        r = dc_from_nominal(self.comp, pb, self.ctx_op, self.op.x,
                            self.nopts)
        x0 = self.torch.where(r.converged[:, None], r.x, self.op.x)
        return x0, r.converged

    def resolved(self, pb):
        """The chunk options resolved for this batched call."""
        return self.ttran.resolve_impl(self.comp, self.opts, self.ctx, pb,
                                       batched=True)

    def build(self, pb):
        """Build what the resolved engine launches (the fused plan and its
        nvcc build, or the GESP library) outside the timed chunks."""
        opts = self.resolved(pb)
        if opts.newton_impl == "fused":
            plan = self.ttran.fused_plan_for(self.comp, self.ctx, pb)
            if self.device.type == "cuda":
                plan.build()
        elif opts.dense_lu == "mixed" and self.device.type == "cuda":
            from cedarsim_tpu_torch.ops import gesp_lu
            gesp_lu.build()
        return opts

    def run_windows(self, pb, x0, opts=None):
        """The chunk's transient: ``segments`` windows of ``tran_core``
        chained by checkpoint from ``blank_checkpoint``.  Returns per-lane
        numpy arrays: ts and q over the windows, finished (every window),
        accepted, rejected and Newton per window [segments, L], and the
        batched step attempts per window."""
        ttran, comp = self.ttran, self.comp
        opts = opts or self.resolved(pb)
        xd0 = ttran.xdot0_and_mask(comp, x0, self.ctx_op, pb)[0]
        st = ttran.blank_checkpoint(x0, xd0, H0)
        ts, qs, fin, acc, rej, nwt, att = [], [], [], [], [], [], []
        for k in range(self.segments):
            out = ttran.tran_core(comp, pb, self.ctx, st["x"], st["xdot"],
                                  self.edges[k], self.edges[k + 1],
                                  self.win[k], H0, opts, self.mask,
                                  init_state=st)
            ts.append(out[0].cpu().numpy())
            qs.append(out[1][:, :, 0].cpu().numpy())
            acc.append(out[3].cpu().numpy() - 1)
            fin.append(out[4].cpu().numpy())
            rej.append(out[5].cpu().numpy())
            nwt.append(out[6].cpu().numpy())
            att.append(int(out[7]))
            st = out[8]
        return dict(ts=np.concatenate(ts, 1), q=np.concatenate(qs, 1),
                    finished=np.all(fin, 0), accepted=np.stack(acc),
                    rejected=np.stack(rej), newton=np.stack(nwt),
                    attempts=att)

    def full_span(self, pb, x0, opts):
        """The lanes over the whole span in one window (the rescue's
        differently shaped program): (ts, q, finished, Newton)."""
        ttran = self.ttran
        xd0 = ttran.xdot0_and_mask(self.comp, x0, self.ctx_op, pb)[0]
        out = ttran.tran_core(self.comp, pb, self.ctx, x0, xd0, 0.0,
                              self.tstop, self.bps_solo, H0, opts, self.mask)
        return (out[0].cpu().numpy(), out[1][:, :, 0].cpu().numpy(),
                out[4].cpu().numpy(), out[6].cpu().numpy())

    def rail_err(self, ts, q, vdd):
        return abs(float(np.interp(min(GATE_T, self.tstop), ts, q)) - vdd)

    def gated(self):
        return self.tstop >= GATE_T

    # ---------------------------------------------------------- rescue

    def rescue(self, pb, lanes, vdds):
        """The rescue ladder over the suspect ``lanes`` (indices into the
        chunk's params ``pb``).  Returns ({lane: (tier, rail error or None,
        finished)}, Newton iterations spent)."""
        torch = self.torch
        out, n_newton = {}, 0

        def sub(idx):
            ii = torch.as_tensor(idx, dtype=torch.long, device=self.device)
            return {k: {pn: v[ii] for pn, v in g.items()}
                    for k, g in pb.items()}

        def ok(fin, err):
            return bool(fin) and (err is None or err <= GATE_TOL)

        def err_of(ts, q, lane):
            return self.rail_err(ts, q, vdds[lane]) if self.gated() else None

        rest = list(lanes)
        if len(rest) >= BATCH_RESCUE_MIN:
            ps = sub(rest)
            x0, _ = self.lane_ops(ps)
            ts, q, fin, nw = self.full_span(ps, x0, self.solo_opts)
            n_newton += int(nw.sum())
            left = []
            for m, lane in enumerate(rest):
                e = err_of(ts[m], q[m], lane)
                if ok(fin[m], e):
                    out[lane] = ("batch", e, True)
                else:
                    left.append(lane)
            tried_fast = True
            rest = left
        else:
            tried_fast = False
        for lane in rest:
            p1 = sub([lane])
            if not tried_fast:
                x0, _ = self.lane_ops(p1)
                ts, q, fin, nw = self.full_span(p1, x0, self.solo_opts)
                n_newton += int(nw.sum())
                e = err_of(ts[0], q[0], lane)
                if ok(fin[0], e):
                    out[lane] = ("solo_fast", e, True)
                    continue
            # the full-refresh tiers, one stream: warm from the full-ladder
            # operating point (taken even when it is not certified), then
            # cold through tran's own ladder
            # (a flop's metastable bias point can be a good start that
            # Newton does not certify)
            from cedarsim_tpu_torch.analysis.dc import dc_core
            lp = {k: {pn: v[0] for pn, v in g.items()} for k, g in p1.items()}
            x0w = dc_core(self.comp, p1, self.ctx_op, self.op.x[None],
                          self.nopts).x
            for tier, x0 in (("solo_warm", x0w[0]), ("solo_cold", None)):
                sol = self.T.tran(self.comp, (0.0, self.tstop), params=lp,
                                  ctx=self.ctx, opts=self.warm_opts, x0=x0)
                n_newton += int(sol.n_newton)
                if sol.converged:
                    e = (self.rail_err(sol.ts, sol["q"], vdds[lane])
                         if self.gated() else None)
                    out[lane] = (tier, e, True)
                    break
            else:
                out[lane] = ("failed", None, False)
        return out, n_newton


def run(points=256, impl="auto", tstop=TSTOP, device=None):
    """The whole grid as one batched transient through the public ``tran``
    (the JAX package's ``run``): every lane warm-started from the nominal
    operating point, whole waveforms stored, one window; gated per lane.
    Returns the result line's dict."""
    from cedarsim_tpu_torch import config
    config.resolve_device(device)
    t0 = time.perf_counter()
    pvt = PVT(device, tstop, 1, impl)
    vdds, wscs = grid(points)
    pb = pvt.chunk_params(vdds, wscs)
    opts = dataclasses.replace(pvt.build(pb), store_vars=None)
    x0 = pvt.op.x.expand(points, pvt.comp.n_x)
    if pvt.device.type == "cuda":
        pvt.torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sols = pvt.T.tran(pvt.comp, (0.0, pvt.tstop), params=pb, ctx=pvt.ctx,
                      opts=opts, x0=x0)
    if pvt.device.type == "cuda":
        pvt.torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ok = all(s.converged for s in sols)
    worst = 0.0
    if pvt.gated():
        for s, vdd in zip(sols, vdds):
            worst = max(worst, pvt.rail_err(s.ts, s["q"], vdd))
        ok = ok and worst <= GATE_TOL
    return dict(points=points, tstop=pvt.tstop, engine=opts.newton_impl,
                dense_lu=opts.dense_lu, device=pvt.device.type, ok=bool(ok),
                worst_rail_err=worst, setup_s=setup_s, wall_s=wall,
                points_per_s=points / wall,
                accepted=sum(s.n_accepted - 1 for s in sols),
                rejected=sum(s.n_rejected for s in sols),
                newton=sum(s.n_newton for s in sols),
                attempts=sols[0].n_attempts)


def run_chunked(points=256, chunk=256, segments=2, impl="auto",
                tstop=TSTOP, device=None, details=False, pvt=None):
    """The chunked PVT sweep (the JAX package's ``run_chunked``): the
    W × VDD grid of ``points`` lanes in chunks of ``chunk`` (padded with
    nominal lanes that are gated but not counted), each chunk's lanes from
    their own operating points through ``segments`` windows chained by
    checkpoint, gated per lane, and the suspects down the rescue ladder.
    ``device``: by default the CUDA card (without one, pass ``"cpu"``).
    Returns the result line's dict; with ``details`` it also holds the
    per-chunk records (``"chunks"``).  ``pvt``: a :class:`PVT` built
    beforehand with these ``device``, ``tstop``, ``segments`` and ``impl``,
    to run on (and inspect afterwards) instead of a new one."""
    from cedarsim_tpu_torch import config
    device = config.resolve_device(device)
    t0 = time.perf_counter()
    if pvt is None:
        pvt = PVT(device, tstop, segments, impl)
    elif (pvt.device, pvt.tstop, pvt.segments, pvt.impl) != (
            device, float(tstop), int(segments), impl):
        raise ValueError("run_chunked: the PVT given was built for another "
                         "device, span, window count or engine")
    torch = pvt.torch
    vdds, wscs = grid(points)
    n_pad = (-points) % chunk
    vdds = np.concatenate([vdds, np.full(n_pad, 5.0)])
    wscs = np.concatenate([wscs, np.ones(n_pad)])
    opts = pvt.build(pvt.chunk_params(vdds[:chunk], wscs[:chunk]))
    if pvt.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    tiers = dict(batch=0, solo_fast=0, solo_warm=0, solo_cold=0, failed=0)
    tot = dict(accepted=0, rejected=0, newton=0, attempts=0,
               rescue_newton=0)
    wall = tran_s = 0.0
    worst = 0.0
    ok = True
    chunks = []
    for k0 in range(0, len(vdds), chunk):
        tc = time.perf_counter()
        v_c, w_c = vdds[k0:k0 + chunk], wscs[k0:k0 + chunk]
        pb = pvt.chunk_params(v_c, w_c)
        x0, conv = pvt.lane_ops(pb)
        if pvt.device.type == "cuda":
            torch.cuda.synchronize()
        tt = time.perf_counter()
        r = pvt.run_windows(pb, x0, opts)
        tran_s += time.perf_counter() - tt
        conv = conv.cpu().numpy()
        n_real = max(0, min(points - k0, chunk))
        errs, suspects = {}, []
        for lane in range(len(v_c)):
            e = (pvt.rail_err(r["ts"][lane], r["q"][lane], v_c[lane])
                 if pvt.gated() else 0.0)
            errs[lane] = e
            if not (r["finished"][lane] and conv[lane] and e <= GATE_TOL):
                suspects.append(lane)
        res, nw = pvt.rescue(pb, suspects, v_c) if suspects else ({}, 0)
        for lane, (tier, e, fin) in res.items():
            tiers[tier] += lane < n_real
            if fin:
                errs[lane] = e if e is not None else 0.0
            else:
                errs.pop(lane)
                ok = ok and not lane < n_real
        for lane, e in errs.items():
            if lane < n_real:
                worst = max(worst, e)
                ok = ok and e <= GATE_TOL
        wall += time.perf_counter() - tc
        real = slice(0, n_real)
        tot["accepted"] += int(r["accepted"][:, real].sum())
        tot["rejected"] += int(r["rejected"][:, real].sum())
        tot["newton"] += int(r["newton"][:, real].sum())
        tot["attempts"] += int(sum(r["attempts"]))
        tot["rescue_newton"] += nw
        chunks.append(dict(k0=k0, suspects=suspects, rescued=res,
                           converged_op=conv, **r))
    out = dict(points=points, chunk=chunk, segments=segments,
               tstop=pvt.tstop, engine=opts.newton_impl,
               dense_lu=opts.dense_lu, device=pvt.device.type, ok=bool(ok),
               worst_rail_err=worst, setup_s=setup_s, wall_s=wall,
               tran_s=tran_s, points_per_s=points / wall if wall else 0.0,
               **tot, tiers=tiers)
    if details:
        out["chunks"] = chunks
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=None,
                    help="lanes per chunk (default: points)")
    ap.add_argument("--segments", type=int, default=2)
    ap.add_argument("--impl", default="auto",
                    choices=["auto", "fused", "xla"])
    ap.add_argument("--tstop", type=float, default=TSTOP)
    ap.add_argument("--device", default=None)
    ap.add_argument("--whole", action="store_true",
                    help="the whole grid as one transient from the nominal "
                         "operating point (the JAX harness's run)")
    a = ap.parse_args(argv)
    if a.whole:
        rec = run(a.points, a.impl, a.tstop, a.device)
    else:
        rec = run_chunked(a.points, a.chunk or a.points, a.segments, a.impl,
                          a.tstop, a.device)
    rec = {k: (float(f"{v:.7g}") if isinstance(v, float) else v)
           for k, v in rec.items()}
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
