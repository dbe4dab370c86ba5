"""Fused chord-Newton solve (counterpart of
``cedarsim_tpu/ops/fused_chord.py``).

:class:`FusedChordPlan` is the host side: the numeric split of the
circuit's device groups into linear ones (folded into constant ``G_lin``,
``C_lin``, ``q_off`` and a time-dependent offset ``s_off(t)`` evaluated
outside the kernel) and nonlinear ones (evaluated inside it), the
per-instance tables of the nonlinear groups, and their models emitted as
CUDA device code (``va/emit.py``).  :func:`fused_chord` runs one chord
solve for a batch of lanes: on a CUDA tensor it launches the hand-written
kernel of ``csrc/fused_chord.cu`` (replacing the Pallas kernels B1,
``build_kernel_batched``, and B1′, ``build_kernel``), on a CPU tensor its
plain PyTorch version :func:`fused_chord_plain`; there is no other path.

The TPU kernel computes in float32 because Mosaic has no float64.  The
H100 has it, so on a circuit whose models evaluate in float64 the kernel
and its plain version compute the loop in float64 (the golden comes from
float64 physics).  On a circuit compiled with ``eval_dtype=float32`` the
plan takes the kernel's float32 form, the Pallas kernel's precision
contract: the model walk (emitted over ``float``), the iterate, the
residual and the convergence test in float32, the per-step inputs rounded
once as they enter, the state leaving in float64 as the predictor plus the
widened correction (``FusedChordPlan.real``; ``csrc/fused_chord.cu`` built
with ``-DFC_REAL=float``).  Its one departure: the direction −(f·rinv)·MT
is summed in float64 from the float64 MT in both forms (the Pallas
kernel's float32 product cannot converge the BSIM-CMG DFF's chord, whose
J/r has a condition number near 2e10).  The split's
probe and the baked ``G_lin``/``C_lin``/``q_off`` are float64-exact in
both forms (the JAX plan's ``exact=True``).  The Mosaic envelope
constants of the JAX plan (``MAX_NL_PARAMS``, ``AUTO_MAX_B``,
``MAX_N_BATCHED``, the lane-packing plan) are not copied: the one limit
here is the card's shared memory per block, which bounds n_x through this
lane's ``MT`` (:class:`FusedEnvelopeError`).

The kernel is compiled with ``nvcc`` at first use into ``build/kernels/``
beside the package, keyed on a hash of the skeleton, the emitted model
header and the flags, and loaded with ``ctypes``.  :func:`fused_chord`
counts its kernel launches in ``fused_chord.launches``, and by lane count
in ``fused_chord.launches_by_lanes``.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from cedarsim_tpu_torch.ops import cuda_lib, linalg
from cedarsim_tpu_torch.ops.ad import refuse_tangent
from cedarsim_tpu_torch.va import emit

SOURCE = os.path.join(cuda_lib.CSRC, "fused_chord.cu")
#: ``--fmad=false``: every multiply and add rounds on its own, as PyTorch's
#: elementwise kernels do, so the kernel follows its plain version to
#: round-off and not to contraction error
NVCC_FLAGS = cuda_lib.NVCC_FLAGS + ("--fmad=false",)
#: the kernel's block: at most this many threads (the emitted model walk
#: may take up to 255 registers a thread, and an SM has 65,536)
MAX_THREADS = 256
#: the float32 form's flags: the kernel's scalar type and its entry
#: ``fused_chord_f32``
NVCC_FLAGS_F32 = NVCC_FLAGS + ("-DFC_REAL=float", "-DFC_BITS=32")
#: per-iteration step cap of the chord loop (the Pallas kernel's CAP)
STEP_CAP = 5.0


class FusedEnvelopeError(ValueError):
    """The circuit or its lane params are outside what the fused kernel
    takes (a limit of the card, or a per-lane param that the kernel would
    read as a constant)."""


# ------------------------------------------------------------------ params

def _digest(params):
    h = hashlib.sha256()
    for key in sorted(params):
        for pn in sorted(params[key]):
            a = np.ascontiguousarray(
                torch.as_tensor(params[key][pn]).detach().cpu().numpy(),
                np.float64)
            h.update(f"{key}\0{pn}\0{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def split_lanes(compiled, params):
    """(base params, lane-varying leaves): ``base`` has lane 0 of every
    leaf that carries a lane axis; the leaves whose value differs between
    lanes are listed as (group key, param name)."""
    params = compiled.params0 if params is None else params
    base, varying = {}, []
    for key, grp in params.items():
        base[key] = {}
        for pn, v in grp.items():
            v = torch.as_tensor(v)
            if v.dim() == compiled.params0[key][pn].dim() + 1:
                if not bool((v == v[:1]).all()):
                    varying.append((key, pn))
                v = v[0]
            base[key][pn] = v
    return base, varying


@dataclasses.dataclass
class _Lanes:
    """Per-lane inputs of one params tree at ``L`` lanes."""
    L: int
    lp: dict                 # CompiledCircuit.lane_params
    dyn: torch.Tensor        # [L, n_inst, max_dyn] nonlinear params
    ent_scale: torch.Tensor  # [L, nnz] $mult on KCL rows, else 1


# -------------------------------------------------------------------- plan

class FusedChordPlan:
    """Constants of the fused chord solve for one circuit, context and
    params.  Build with :func:`get_fused_plan`; raises
    :class:`FusedEnvelopeError` outside the kernel's envelope."""

    def __init__(self, compiled, ctx, params=None):
        params = compiled.params0 if params is None else params
        if compiled.n_dly:
            raise FusedEnvelopeError("fused chord: delay/latch aux channels "
                                     "are not supported in-kernel")
        self.compiled = compiled
        self.n_x = compiled.n_x
        self.ctx = ctx
        self.params = params
        #: the kernel's scalar type: float32 on a circuit whose models
        #: evaluate in float32, else float64
        self.real = (torch.float32 if compiled.eval_dtype == torch.float32
                     else torch.float64)
        dev, dt = compiled.device, self.real
        self._build_split(params, ctx)
        self.G_lin_t = torch.as_tensor(self.G_lin, dtype=dt, device=dev)
        self.C_lin_t = torch.as_tensor(self.C_lin, dtype=dt, device=dev)
        # the kernel's copies: column j at j * n, so that the threads of a
        # row loop read neighbouring addresses
        self.G_lin_T = self.G_lin_t.T.contiguous()
        self.C_lin_T = self.C_lin_t.T.contiguous()
        self.q_off_t = torch.as_tensor(self.q_off, dtype=dt, device=dev)
        self._build_nl(ctx)
        self._lanes_last = None
        self._lib = None
        self.build_info = None

    # ----------------------------------------------------------- the split

    def _sub_res(self, keys, params, ctx, x, t):
        """(S, Q) [n_x] over the groups ``keys`` at one state ``x``, in
        float64 whatever the eval dtype (the probe and the baked constants
        must be float64-clean: under float32 evaluation the probe's 1e-9
        affine test would drown in the eval noise and class every linear
        group as nonlinear)."""
        comp = self.compiled
        xt = torch.as_tensor(np.asarray(x), dtype=comp.dtype,
                             device=comp.device)[None]
        S, Q = comp.evaluate(xt, ctx.at_time(t), comp.lane_params(params, 1),
                             keys=keys, exact=True)
        return S[0].cpu().numpy(), Q[0].cpu().numpy()

    def _sub_jac(self, keys, params, ctx, x, t=0.0):
        comp = self.compiled
        xt = torch.as_tensor(np.asarray(x), dtype=comp.dtype,
                             device=comp.device)[None]
        out = comp.evaluate(xt, ctx.at_time(t), comp.lane_params(params, 1),
                            jac=True, keys=keys, exact=True)
        return (out[0][0].cpu().numpy(), out[1][0].cpu().numpy(),
                out[2][0].cpu().numpy(), out[3][0].cpu().numpy())

    def _group_is_linear(self, key, params, ctx, xa, xb) -> bool:
        """Affine in x at fixed t: equal Jacobians at the probe points (two
        random scales, both sign mirrors, one near the origin) and the
        affine extrapolation from ``xa`` reproduces the values there, for S
        and Q, at two times, and Jacobians that do not depend on t."""
        others = (xb, -xb, -xa, 0.03 * xa)
        jacs = []
        for t in (0.0, 1.7e-9):
            Sa, Qa, Ga, Ca = self._sub_jac([key], params, ctx, xa, t)
            jacs.append((Ga, Ca))
            for xo in others:
                So, Qo, Go, Co = self._sub_jac([key], params, ctx, xo, t)
                dx = xo - xa
                if not (np.allclose(Sa + Ga @ dx, So, rtol=1e-9, atol=1e-12)
                        and np.allclose(Qa + Ca @ dx, Qo, rtol=1e-9,
                                        atol=1e-15)
                        and np.allclose(Go, Ga, rtol=1e-9, atol=1e-12)
                        and np.allclose(Co, Ca, rtol=1e-9, atol=1e-15)):
                    return False
        (Ga0, Ca0), (Ga1, Ca1) = jacs
        return bool(np.allclose(Ga0, Ga1) and np.allclose(Ca0, Ca1))

    def _build_split(self, params, ctx):
        comp = self.compiled
        rng = np.random.default_rng(0)
        xa = rng.normal(size=self.n_x) * 0.5
        xb = rng.normal(size=self.n_x) * 2.0 + 0.25
        self.lin_keys, self.nl_keys = [], []
        for key in comp.group_order:
            if self._group_is_linear(key, params, ctx, xa, xb):
                self.lin_keys.append(key)
            else:
                self.nl_keys.append(key)
        _, _, Ga, Ca = self._sub_jac(self.lin_keys, params, ctx, xa)
        z = np.zeros(self.n_x)
        _, Q0 = self._sub_res(self.lin_keys, params, ctx, z, 0.0)
        self.G_lin = np.asarray(Ga, np.float64)
        self.C_lin = np.asarray(Ca, np.float64)
        self.q_off = Q0 - self.C_lin @ z

    # --------------------------------------------------- nonlinear groups

    def _build_nl(self, ctx):
        """Emitted models and the kernel's per-instance tables."""
        comp = self.compiled
        dev = comp.device
        n = self.n_x
        t0 = time.perf_counter()
        self.emitted = [(key, emit.emit_group(comp, key, ctx, self.real))
                        for key in self.nl_keys]     # (key, emit.Emitted)
        self.emit_seconds = time.perf_counter() - t0
        self.max_hoist = max([e.n_hoist for _, e in self.emitted] + [1])
        groups = [comp.groups[k] for k in self.nl_keys]
        self.max_lvar = max([g.model.n_lvar() for g in groups], default=1)
        self.max_lrow = max([g.model.n_lrow() for g in groups], default=1)
        self.dyn_layout = [(gi, pn) for gi, k in enumerate(self.nl_keys)
                           for pn in emit.dyn_names(comp, k)]
        self.max_dyn = max([len(emit.dyn_names(comp, k))
                            for k in self.nl_keys] + [1])
        inst_group, inst_var, offs = [], [], []
        entries = [[] for _ in range(n)]      # per row: (slot, kcl, inst)
        base = 0
        for gi, g in enumerate(groups):
            offs.append(base)
            for j in range(len(g.instances)):
                k = base + j
                inst_group.append(gi)
                row = np.full(self.max_lvar, n, np.int32)
                row[: g.var_idx.shape[1]] = g.var_idx[j]
                inst_var.append(row)
                for r in range(g.model.n_lrow()):
                    ri = int(g.row_idx[j, r])
                    if ri < n:               # the trash row is dropped
                        entries[ri].append((k * self.max_lrow + r,
                                            bool(g.kcl_mask[r]), k))
            base += len(g.instances)
        self.n_inst = base
        self._nl_offsets = offs
        flat = [e for row in entries for e in row]
        row_ptr = np.cumsum([0] + [len(r) for r in entries])

        def it(a):
            return torch.as_tensor(np.asarray(a, np.int32).reshape(-1),
                                   dtype=torch.int32, device=dev)

        self.inst_group_t = it(inst_group if inst_group else [0])
        self.inst_var_t = it(np.stack(inst_var) if inst_var
                             else np.full(self.max_lvar, n))
        self.row_ptr_t = it(row_ptr)
        self.ent_slot_t = it([e[0] for e in flat] or [0])
        self.nnz = len(flat)
        self._ent_kcl = torch.as_tensor([bool(e[1]) for e in flat],
                                        dtype=torch.bool, device=dev)
        self._ent_inst = torch.as_tensor([e[2] for e in flat],
                                         dtype=torch.int64, device=dev)
        # the kernel also gives each circuit row one thread: the envelope
        # below keeps n_x far under MAX_THREADS (n_x <= 164 on an H100)
        self.threads = min(MAX_THREADS,
                           -(-max(self.n_inst, n, 1) // 32) * 32)
        es = torch.empty((), dtype=self.real).element_size()
        self.smem_bytes = (es * (12 * n + 3 * self.n_inst * self.max_lrow
                                 + 32) + 8 * n * n)
        limit = cuda_lib.smem_per_block(dev)
        self.smem_limit = limit
        if self.smem_bytes > limit:
            raise FusedEnvelopeError(
                f"fused chord: {self.smem_bytes} B of shared memory per lane "
                f"(n_x={n}, {self.n_inst} nonlinear instances) exceed the "
                f"card's {limit} B per block; use newton_impl='xla'")

    @property
    def entry(self):
        """The kernel library's C entry: ``fused_chord_f64`` or, in the
        float32 form, ``fused_chord_f32``."""
        return ("fused_chord_f32" if self.real == torch.float32
                else "fused_chord_f64")

    def header(self):
        """The emitted model header: every nonlinear group's two functions
        and the ``fc_pre`` and ``fc_eval`` dispatches the kernel calls,
        over the plan's scalar type."""
        f32 = self.real == torch.float32
        parts = [e.text for _, e in self.emitted] or [
            emit.PREAMBLE_F32 if f32 else emit.PREAMBLE]
        pre = "".join(f"    case {gi}: {e.name}_pre(dyn, t, h); break;\n"
                      for gi, (_, e) in enumerate(self.emitted))
        walk = "".join(
            f"    case {gi}: {e.name}(lv, lvd, h, s, q, qd); break;\n"
            for gi, (_, e) in enumerate(self.emitted))
        text = ("".join(parts)
                + f"#define FC_MAX_LVAR {self.max_lvar}\n"
                f"#define FC_MAX_LROW {self.max_lrow}\n"
                f"#define FC_MAX_DYN {self.max_dyn}\n"
                f"#define FC_MAX_HOIST {self.max_hoist}\n")
        real = "float" if f32 else "double"
        return (text
                + f"__device__ static inline void fc_pre(int g, const {real}* "
                f"dyn, {real} t, {real}* h) {{\n"
                "  switch (g) {\n" + pre + "    default: break;\n  }\n}\n"
                f"__device__ static inline void fc_eval(int g, const {real}* "
                f"lv, const {real}* lvd, const {real}* h, {real}* s, "
                f"{real}* q, {real}* qd) {{\n"
                "  switch (g) {\n" + walk + "    default: break;\n  }\n}\n")

    def hoist_scratch(self, B):
        """The kernel's device-memory scratch for the hoisted values, [B,
        n_inst, FC_MAX_HOIST] in the plan's scalar type (written by the
        kernel before it is read; it stays out of shared memory, so the
        envelope above is that of the walk without the cut)."""
        comp = self.compiled
        return torch.empty(B, max(self.n_inst, 1), self.max_hoist,
                           dtype=self.real, device=comp.device)

    # ------------------------------------------------------------ envelope

    def dyn_leaf_safe(self, key, pname):
        """True iff a per-lane value of ``params[key][pname]`` reaches the
        kernel: every leaf of a nonlinear group does (a runtime input); a
        linear-group leaf does only when a numeric probe shows that it does
        not enter G_lin/C_lin (a source's value, not an R, C or L)."""
        if key in self.nl_keys:
            return True
        if key not in self.lin_keys:
            return False
        p0 = self.params
        if pname not in p0.get(key, {}):
            return False
        xa = np.random.default_rng(0).normal(size=self.n_x) * 0.5
        _, _, Ga0, Ca0 = self._sub_jac([key], p0, self.ctx, xa)
        pp = dict(p0)
        grp = dict(pp[key])
        v = torch.as_tensor(grp[pname], dtype=torch.float64)
        grp[pname] = v * 1.07 + 0.013 * (v.abs() + 1.0)
        pp[key] = grp
        _, _, Ga1, Ca1 = self._sub_jac([key], pp, self.ctx, xa)
        tol = dict(rtol=1e-9, atol=1e-12)
        return bool(np.allclose(Ga0, Ga1, **tol)
                    and np.allclose(Ca0, Ca1, **tol))

    # ---------------------------------------------------------- per lane

    def nl_param_rows(self, lp, L):
        """The nonlinear groups' dynamic params [L, n_inst, max_dyn] (in
        ``dyn_layout`` order per group, in the plan's scalar type) from
        prepared lane params."""
        comp = self.compiled
        dyn = torch.zeros(L, max(self.n_inst, 1), self.max_dyn,
                          dtype=self.real, device=comp.device)
        names = {}
        for gi, pn in self.dyn_layout:
            names.setdefault(gi, []).append(pn)
        for gi, key in enumerate(self.nl_keys):
            ni = len(comp.groups[key].instances)
            o = self._nl_offsets[gi]
            p = lp[key][0]
            for k, pn in enumerate(names.get(gi, [])):
                dyn[:, o:o + ni, k] = p[pn].view(L, -1)[:, :ni]
        return dyn.contiguous()

    def lanes(self, params, L):
        """Per-lane inputs for ``params`` (leaves as compiled or with a
        leading lane axis) at ``L`` lanes; the last params tree's are kept,
        as a transient asks for the same ones at every step attempt."""
        params = self.compiled.params0 if params is None else params
        hit = self._lanes_last
        if hit is not None and hit[0] is params and hit[1].L == L:
            return hit[1]
        comp = self.compiled
        lp = comp.lane_params(params, L)
        mult = torch.zeros(L, max(self.n_inst, 1), dtype=comp.dtype,
                           device=comp.device)
        for gi, key in enumerate(self.nl_keys):
            ni = len(comp.groups[key].instances)
            o = self._nl_offsets[gi]
            mult[:, o:o + ni] = lp[key][1].view(L, -1)[:, :ni]
        scale = torch.where(self._ent_kcl[None, :],
                            mult[:, self._ent_inst], 1.0).to(self.real)
        ln = _Lanes(L, lp, self.nl_param_rows(lp, L),
                    scale.contiguous() if self.nnz else
                    torch.ones(L, 1, dtype=self.real, device=comp.device))
        self._lanes_last = (params, ln)
        return ln

    def s_off(self, t, ctx=None, params=None):
        """Linear-group offset S_lin(0, t): [n_x] for a float ``t``,
        [L, n_x] for ``t`` [L] (``params`` may carry the lane axis)."""
        comp = self.compiled
        ctx = self.ctx if ctx is None else ctx
        tt = torch.as_tensor(t, dtype=comp.dtype, device=comp.device)
        L = tt.shape[0] if tt.dim() == 1 else 1
        ln = self.lanes(params, L)
        S, _ = comp.evaluate(
            torch.zeros(L, self.n_x, dtype=comp.dtype, device=comp.device),
            ctx.at_time(tt if tt.dim() == 1 else float(t)), ln.lp,
            keys=self.lin_keys)
        return S if tt.dim() == 1 else S[0]

    # ------------------------------------------------------------- build

    def build(self):
        """Compile (if not built yet) and load the kernel for this plan's
        emitted models.  Returns ``build_info``: the shared object's
        ``path``, ``emit_seconds``, ``nvcc_seconds`` (0.0 when it was
        already built) and nvcc's ``log``."""
        if self._lib is not None:
            return self.build_info
        f32 = self.real == torch.float32
        b = cuda_lib.build_library(
            "fused", SOURCE, NVCC_FLAGS_F32 if f32 else NVCC_FLAGS,
            header=("FC_MODEL_HEADER", self.header()))
        fn = getattr(b["lib"], self.entry)
        p, i, d, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                       ctypes.c_longlong)
        fn.argtypes = [p] * 21 + [i] * 5 + [d] * 4 + [i, ll, p]
        fn.restype = i
        self._lib = fn
        self.build_info = dict(path=b["path"],
                               emit_seconds=self.emit_seconds,
                               nvcc_seconds=b["seconds"], log=b["log"])
        return self.build_info

    # -------------------------------------------------------------- solve

    def inputs(self, x_init, J, s_off_vec, c0, h, xdh, t_new, params=None,
               live=None):
        """The kernel's per-lane inputs ``(x0, MT, rinv, soff, vanch, coef,
        live, lanes)`` for :func:`fused_chord`: r = max|J| per row and
        MT = inv(J/r)ᵀ in float64 (batched ``torch.linalg``; a singular
        lane gets a non-finite MT, so its loop fails instead of raising),
        vanch = (c0·x_init + xdh)/h, coef = (c0/h, t_new)."""
        comp = self.compiled
        dt, dev = comp.dtype, comp.device
        L = x_init.shape[0]
        r = J.abs().amax(-1)
        r = torch.where(r == 0, torch.ones_like(r), r)
        inv, _ = torch.linalg.inv_ex(J / r[..., None])
        c0 = torch.as_tensor(c0, dtype=dt, device=dev).expand(L)
        h = torch.as_tensor(h, dtype=dt, device=dev).expand(L)
        t_new = torch.as_tensor(t_new, dtype=dt, device=dev).expand(L)
        if live is None:
            live = torch.ones(L, dtype=torch.bool, device=dev)
        return (x_init.contiguous(), inv.transpose(-1, -2).contiguous(),
                (1.0 / r).contiguous(), s_off_vec.contiguous(),
                ((c0[:, None] * x_init + xdh) / h[:, None]).contiguous(),
                torch.stack([c0 / h, t_new], -1).contiguous(),
                live.to(torch.int32), self.lanes(params, L))

    def __call__(self, x_init, J, s_off_vec, c0, h, xdh, t_new, opts,
                 params=None, live=None):
        """One fused chord solve over the lanes of ``x_init`` [L, n_x].
        ``J`` [L, n_x, n_x] is the (shunt-damped) chord Jacobian at
        ``x_init``, ``s_off_vec`` [L, n_x], ``c0``/``h``/``t_new`` [L],
        ``xdh`` [L, n_x]; ``live`` [L] bool (lanes not live enter done).
        Returns ``(xn, S, Q, ok, nnwt)`` as ``newton_mod`` does (cap-form
        residual convention)."""
        xn, S, Q, stat = fused_chord(
            self, *self.inputs(x_init, J, s_off_vec, c0, h, xdh, t_new,
                               params, live), opts)
        return xn, S, Q, stat[:, 0] > 0, stat[:, 1]


def get_fused_plan(compiled, ctx, params=None):
    """Build (or fetch the cached) fused chord plan for ``params`` (leaves
    as compiled; default params0), keyed on the context and on the params'
    values; raises :class:`FusedEnvelopeError` outside the envelope."""
    cache = getattr(compiled, "_fused_plans", None)
    if cache is None:
        cache = compiled._fused_plans = {}
    params = compiled.params0 if params is None else params
    key = (ctx.mode, float(ctx.temp), float(ctx.gmin), float(ctx.scale),
           float(ctx.sourcefac), _digest(params))
    plan = cache.get(key)
    if plan is None:
        plan = cache[key] = FusedChordPlan(compiled, ctx, params)
    return plan


# --------------------------------------------------------- kernel wrapper

def fused_chord_plain(plan, x0, MT, rinv, soff, vanch, coef, live, lanes,
                      opts):
    """Plain PyTorch version of the kernel: the same chord loop over the
    lanes, the nonlinear parts from the eager model walk
    (``evaluate(keys=nl_keys, v=...)``) and the linear parts from
    ``G_lin``/``C_lin``/``s_off``, in the plan's scalar type: in the float32
    form the inputs are rounded once to float32, the loop runs in float32
    but for the direction, summed in float64 from the float64 ``MT`` and
    rounded, and the state leaves as ``x0 + d`` in float64 (S and Q
    widened).
    Returns (xn, S, Q, stat [L, 2] int32 = (ok, Newton iterations))."""
    comp = plan.compiled
    L = x0.shape[0]
    x0_in = x0
    x0, rinv, soff, vanch, coef = (
        a.to(plan.real) for a in (x0, rinv, soff, vanch, coef))
    c0h, t = coef[:, 0], coef[:, 1]
    ctx_t = plan.ctx.at_time(t)
    G, C, qoff = plan.G_lin_t, plan.C_lin_t, plan.q_off_t

    def parts(d):
        x = x0 + d
        v = vanch + c0h[:, None] * d
        if plan.nl_keys:
            Sn, Qn, icn = comp.evaluate(x, ctx_t, lanes.lp, v=v,
                                        keys=plan.nl_keys)
        else:
            Sn = Qn = icn = torch.zeros_like(x)
        return (linalg.matvec(G, x) + soff + Sn,
                linalg.matvec(C, x) + qoff + Qn, linalg.matvec(C, v) + icn)

    d = torch.zeros_like(x0)
    S, Q, ic = parts(d)
    done = live == 0
    it = torch.zeros(L, dtype=torch.int32, device=x0.device)
    while True:
        active = ~done & (it < opts.max_newton)
        if not bool(active.any()):
            break
        g = (S + ic) * rinv
        dx = (-(g.to(MT.dtype)[:, :, None] * MT).sum(1)).to(plan.real)
        bad = ~torch.isfinite(dx).all(-1)
        dx = torch.where(bad[:, None], torch.zeros_like(dx), dx)
        mx = dx.abs().amax(-1)
        dx = dx * torch.where(mx > STEP_CAP,
                              STEP_CAP / mx.clamp(min=STEP_CAP), 1.0)[:, None]
        dn = d + dx
        Sn, Qn, icn = parts(dn)
        fn = Sn + icn
        sc = icn.abs() + Sn.abs()
        viol = ((fn.abs() > opts.res_rel * sc + opts.res_tol).any(-1)
                | (dx.abs() > opts.newton_reltol * (x0 + dn).abs()
                   + opts.newton_abstol).any(-1))
        a2 = active[:, None]
        d = torch.where(a2, dn, d)
        S, Q, ic = (torch.where(a2, Sn, S), torch.where(a2, Qn, Q),
                    torch.where(a2, icn, ic))
        done = torch.where(active, ~viol & ~bad, done)
        it = it + active.to(torch.int32)
    ok = done & torch.isfinite(d).all(-1)
    xn = x0 + d if plan.real == x0_in.dtype else x0_in + d.to(x0_in.dtype)
    return (xn, S.to(x0_in.dtype), Q.to(x0_in.dtype),
            torch.stack([ok.to(torch.int32), it], -1))


def _check(name, t, shape, dtype=torch.float64):
    if t.dtype != dtype:
        raise TypeError(f"fused_chord: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_chord: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_chord: {name} must be contiguous")


def fused_chord(plan, x0, MT, rinv, soff, vanch, coef, live, lanes, opts):
    """One fused chord solve for ``B`` lanes: x0/rinv/soff/vanch [B, n]
    float64, MT [B, n, n] = inv(J/r)ᵀ, coef [B, 2] = (c0/h, t), live [B]
    int32, ``lanes`` from :meth:`FusedChordPlan.lanes`.  CPU tensors take
    :func:`fused_chord_plain`; CUDA tensors launch the kernel of
    ``csrc/fused_chord.cu`` (one block per lane) or raise.  Returns (xn,
    S, Q [B, n], stat [B, 2] int32 = (ok, Newton iterations))."""
    if x0.dim() != 2:
        raise ValueError(f"fused_chord: x0 must be [B, n], got "
                         f"{tuple(x0.shape)}")
    refuse_tangent("fused_chord", x0, MT, rinv, soff, vanch, coef)
    B, n = x0.shape
    if n != plan.n_x:
        raise ValueError(f"fused_chord: n={n}, the plan has {plan.n_x}")
    for name, t, shape, dt in (
            ("x0", x0, (B, n), torch.float64),
            ("MT", MT, (B, n, n), torch.float64),
            ("rinv", rinv, (B, n), torch.float64),
            ("soff", soff, (B, n), torch.float64),
            ("vanch", vanch, (B, n), torch.float64),
            ("coef", coef, (B, 2), torch.float64),
            ("live", live, (B,), torch.int32)):
        if t.device != x0.device:
            raise ValueError(f"fused_chord: {name} on {t.device}, x0 on "
                             f"{x0.device}")
        _check(name, t, shape, dt)
    if lanes.L != B:
        raise ValueError(f"fused_chord: lane inputs for {lanes.L} lanes, "
                         f"got {B}")
    if x0.device.type == "cpu":
        return fused_chord_plain(plan, x0, MT, rinv, soff, vanch, coef,
                                 live, lanes, opts)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_chord: unsupported device {x0.device}")
    if x0.device != plan.compiled.device:
        raise ValueError(f"fused_chord: inputs on {x0.device}, the plan on "
                         f"{plan.compiled.device}")
    plan.build()
    fn = plan._lib
    xn = torch.empty_like(x0)
    S = torch.empty_like(x0)
    Q = torch.empty_like(x0)
    stat = torch.empty(B, 2, dtype=torch.int32, device=x0.device)
    if B == 0:
        return xn, S, Q, stat
    hs = plan.hoist_scratch(B)
    err = fn(
        x0.data_ptr(), MT.data_ptr(), rinv.data_ptr(), soff.data_ptr(),
        vanch.data_ptr(), coef.data_ptr(), live.data_ptr(),
        plan.G_lin_T.data_ptr(), plan.C_lin_T.data_ptr(),
        plan.q_off_t.data_ptr(), plan.inst_group_t.data_ptr(),
        plan.inst_var_t.data_ptr(), lanes.dyn.data_ptr(),
        plan.row_ptr_t.data_ptr(), plan.ent_slot_t.data_ptr(),
        lanes.ent_scale.data_ptr(), hs.data_ptr(), xn.data_ptr(),
        S.data_ptr(), Q.data_ptr(), stat.data_ptr(), B, n, plan.n_inst,
        plan.nnz, int(opts.max_newton), float(opts.newton_reltol),
        float(opts.newton_abstol), float(opts.res_rel), float(opts.res_tol),
        plan.threads, plan.smem_bytes,
        cuda_lib.current_stream(x0.device))
    cuda_lib.raise_on(err, plan.entry)
    fused_chord.launches += 1
    fused_chord.launches_by_lanes[B] += 1
    return xn, S, Q, stat


fused_chord.launches = 0
#: launches by lane count B (B1′, the JAX package's one-lane kernel, is the
#: count at B = 1)
fused_chord.launches_by_lanes = collections.Counter()
