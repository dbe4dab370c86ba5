"""Circuit compiler: graph IR → batched residual / Jacobian functions in
PyTorch (counterpart of ``cedarsim_tpu/core/compile.py``, dense path only).

Formulation: charge-oriented MNA DAE ``F(x, t) = S(x, t) + d/dt Q(x) = 0``
with unknowns x = [node voltages (ground excluded), internal node voltages,
branch currents]; G = ∂S/∂x, C = ∂Q/∂x.

Per device class (a "group"), all instances of all lanes evaluate in ONE
call of the model's ``eval`` over a flat batch of B = lanes × instances
entries (instances padded per lane to a whole number of SIMD vectors, see
``_LANE_ALIGN``).  Local unknowns are gathered by a static ``[n_inst,
n_lvar]`` index matrix (``x_pad[..., var_idx]``, the pad column being
ground), and the returned row contributions are added into a padded S/Q
(G/C) whose last row is a trash slot for ground (``index_add_``, or its
fixed-order counterpart on CUDA: see ``_scatter_add``).  Local Jacobians come from one
walk with forward-mode dual numbers (``core/dual.py``) carrying one tangent
per local unknown — the counterpart of the JAX package's ``jacfwd`` under
``vmap``.

Lanes: ``x`` is ``[n_x]`` or ``[L, n_x]``; a parameter leaf is the compiled
``[n_inst]`` (``[n_inst, P]`` for point lists) or carries a leading lane axis
``[L, ...]``; ``ctx.time`` is a float or an ``[L]`` tensor.  Every lane is
evaluated independently of the others.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from cedarsim_tpu_torch import config
from cedarsim_tpu_torch.core.circuit import Circuit, Instance
from cedarsim_tpu_torch.core.context import SimSpec
from cedarsim_tpu_torch.core.dual import Dual


@dataclasses.dataclass
class Group:
    key: str
    model: type
    instances: list          # list[Instance]
    var_idx: np.ndarray      # [n_inst, n_lvar] int, n_x = ground/pad slot
    row_idx: np.ndarray      # [n_inst, n_lrow] int, n_x = trash row
    kcl_mask: np.ndarray     # [n_lrow] bool: True for KCL rows (scaled by m)
    #: params uniform across the group and not requested dynamic: Python
    #: floats (or device tensors for point lists) so model conditionals on
    #: them fold on the host while the model is walked
    static_params: dict = dataclasses.field(default_factory=dict)


class CompiledCircuit:
    def __init__(self, circuit: Circuit, dtype=None, device="cpu",
                 dynamic_params=()):
        """``device``: the torch device every tensor of the circuit (and of
        every solve on it) lives on.  ``dynamic_params``: param names kept
        as per-instance tensors even when uniform across a group (bare names
        apply to every instance, dotted names to one)."""
        self.circuit = circuit
        self.dtype = dtype or config.real_dtype
        self.device = torch.device(device)
        self.dynamic_params = frozenset(
            d.lower() for d in (dynamic_params or ()))
        self._idx_cache = {}
        self._build()

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    # ------------------------------------------------------------- structure

    def _build(self):
        ckt = self.circuit
        if not ckt.instances:
            raise ValueError(
                "circuit is empty — no device instances (check that the "
                "netlist's first line is a title line, not a component)")
        n_nodes = ckt.n_nodes
        self.node_names = list(ckt.net_names)

        internal_base = n_nodes
        n_internal = sum(i.model.n_internal for i in ckt.instances)
        branch_base = internal_base + n_internal
        self._inst_internal: dict[str, int] = {}
        self._inst_branch: dict[str, int] = {}
        off = 0
        for inst in ckt.instances:
            if inst.model.n_internal:
                self._inst_internal[inst.name] = internal_base + off
                off += inst.model.n_internal
        off = 0
        for inst in ckt.instances:
            if inst.model.n_branch:
                self._inst_branch[inst.name] = branch_base + off
                off += inst.model.n_branch
        self.n_nodes = n_nodes
        self.n_internal = n_internal
        self.n_branch = off
        self.n_x = branch_base + off
        self.x_names = (
            self.node_names
            + [f"{i.name}#int{k}" for i in ckt.instances
               for k in range(i.model.n_internal)]
            + [f"{i.name}#br{k}" for i in ckt.instances
               for k in range(i.model.n_branch)])

        order: list[str] = []
        buckets: dict[str, list[Instance]] = {}
        for inst in ckt.instances:
            key = inst.model.group_key(inst.params)
            if key not in buckets:
                buckets[key] = []
                order.append(key)
            buckets[key].append(inst)

        pad = self.n_x
        self.groups: dict[str, Group] = {}
        self._inst_loc: dict[str, tuple[str, int]] = {}
        params0 = {}
        for key in order:
            insts = buckets[key]
            model = insts[0].model
            nt, ni, nb, nc = (model.n_terms(), model.n_internal,
                              model.n_branch, model.n_control)
            var_idx = np.full((len(insts), model.n_lvar()), pad, np.int64)
            row_idx = np.full((len(insts), model.n_lrow()), pad, np.int64)
            for j, inst in enumerate(insts):
                self._inst_loc[inst.name] = (key, j)
                for k, net in enumerate(inst.nets):
                    if not net.is_ground:
                        var_idx[j, k] = net.index
                        row_idx[j, k] = net.index
                if ni:
                    b = self._inst_internal[inst.name]
                    for k in range(ni):
                        var_idx[j, nt + k] = b + k
                        row_idx[j, nt + k] = b + k
                if nb:
                    b = self._inst_branch[inst.name]
                    for k in range(nb):
                        var_idx[j, nt + ni + k] = b + k
                        row_idx[j, nt + ni + k] = b + k
                if nc:
                    raise NotImplementedError(
                        f"{inst.name}: devices with control unknowns are "
                        "not ported yet — ROADMAP A14")
            kcl_mask = np.zeros(model.n_lrow(), bool)
            kcl_mask[: nt + ni] = True
            grp = Group(key, model, insts, var_idx, row_idx, kcl_mask)
            self.groups[key] = grp
            gp = {}
            for pn in insts[0].params.keys():
                vals = np.stack(
                    [np.asarray(i.params[pn], np.float64) for i in insts])
                base = pn[:-6] if pn.endswith("$given") else pn
                dyn = (base.lower() in self.dynamic_params or any(
                    f"{i.name}.{base}".lower() in self.dynamic_params
                    for i in insts))
                uniform = bool(np.all(vals == vals[0]))
                if uniform and not dyn:
                    v0 = vals[0]
                    grp.static_params[pn] = (
                        float(v0) if v0.ndim == 0 else self._t(v0))
                else:
                    gp[pn] = self._t(vals)
            gp["$mult"] = self._t([i.mult for i in insts])
            params0[key] = gp
        self.params0 = params0
        self.group_order = order

    # ----------------------------------------------------------- evaluation

    def _padded_idx(self, key):
        """A group's (var_idx, row_idx) with ``_n_pad - n_inst`` extra rows
        that read ground and write the trash row."""
        g = self.groups[key]
        extra = _n_pad(len(g.instances)) - len(g.instances)
        return tuple(np.concatenate(
            [a, np.full((extra, a.shape[1]), self.n_x, a.dtype)])
            for a in (g.var_idx, g.row_idx))

    def _index(self, key, L, kind):
        """Flat scatter indices for ``L`` lanes (cached per group and L):
        ``"row"`` into [L·(n_x+1)], ``"mat"`` into [L·(n_x+1)²]."""
        ck = (key, L, kind)
        if ck not in self._idx_cache:
            var_idx, row_idx = self._padded_idx(key)
            n1 = self.n_x + 1
            lanes = np.arange(L)[:, None, None]
            if kind == "row":
                idx = lanes * n1 + row_idx[None]
            else:
                idx = (lanes[..., None] * n1 * n1
                       + row_idx[None, :, :, None] * n1
                       + var_idx[None, :, None, :])
            self._idx_cache[ck] = torch.as_tensor(
                idx.reshape(-1), dtype=torch.int64, device=self.device)
        return self._idx_cache[ck]

    def _group_consts(self, key):
        """Device copies of a group's padded gather index, KCL-row mask and
        the identity that seeds the dual-number tangents (made once)."""
        ck = (key, "consts")
        if ck not in self._idx_cache:
            g = self.groups[key]
            nlv = g.model.n_lvar()
            self._idx_cache[ck] = (
                torch.as_tensor(self._padded_idx(key)[0],
                                device=self.device),
                torch.as_tensor(g.kcl_mask, device=self.device),
                torch.eye(nlv, dtype=self.dtype, device=self.device))
        return self._idx_cache[ck]

    def lane_params(self, params, L):
        """Per-group eval inputs for ``L`` lanes: ``{key: (p, mult)}`` with
        every dynamic leaf flattened to the eval batch [L·n_pad, ...] (the
        padding instances repeat the last one) and the static params merged
        in.  Solvers build this once per solve."""
        params = self.params0 if params is None else params
        out = {}
        for key in self.group_order:
            g = self.groups[key]
            ni = len(g.instances)
            extra = _n_pad(ni) - ni
            p = dict(g.static_params)
            mult = None
            for pn, v in params[key].items():
                base_dim = self.params0[key][pn].dim()
                v = torch.as_tensor(v, dtype=self.dtype, device=self.device)
                if v.dim() == base_dim:
                    v = v.expand((L,) + tuple(v.shape))
                elif v.dim() != base_dim + 1 or v.shape[0] != L:
                    raise ValueError(
                        f"param {key}.{pn}: shape {tuple(v.shape)} is "
                        f"neither the compiled {tuple(self.params0[key][pn].shape)}"
                        f" nor that with a leading axis of {L} lanes")
                v = torch.cat([v, v[:, -1:].expand(
                    (L, extra) + tuple(v.shape[2:]))], 1)
                v = v.reshape((L * (ni + extra),) + tuple(v.shape[2:]))
                if pn == "$mult":
                    mult = v
                else:
                    p[pn] = v
            out[key] = (p, mult)
        return out

    def _eval_ctx(self, ctx, n_inst):
        t = ctx.time
        if isinstance(t, torch.Tensor) and t.dim() == 1:
            return ctx.at_time(t.repeat_interleave(n_inst))
        return ctx

    def evaluate(self, x, ctx: SimSpec, lp, jac=False, v=None):
        """Core walk over ``[L, n_x]`` states with prepared lane params
        ``lp`` (:meth:`lane_params`).  Returns (S, Q) [L, n_x]; with
        ``jac=True`` also (G, C) [L, n_x, n_x]; with a direction ``v``
        [L, n_x] instead the charge tangent C(x)·v [L, n_x]."""
        L, n = x.shape
        n1 = n + 1
        dt, dev = self.dtype, self.device
        x_pad = torch.cat([x, torch.zeros(L, 1, dtype=dt, device=dev)], 1)
        v_pad = None if v is None else torch.cat(
            [v, torch.zeros(L, 1, dtype=dt, device=dev)], 1)
        S = torch.zeros(L * n1, dtype=dt, device=dev)
        Q = torch.zeros(L * n1, dtype=dt, device=dev)
        if jac:
            G = torch.zeros(L * n1 * n1, dtype=dt, device=dev)
            C = torch.zeros(L * n1 * n1, dtype=dt, device=dev)
        if v is not None:
            Qd = torch.zeros(L * n1, dtype=dt, device=dev)
        for key in self.group_order:
            g = self.groups[key]
            p, mult = lp[key]
            ni = _n_pad(len(g.instances))
            B = L * ni
            nlv = g.model.n_lvar()
            vi, kcl, eye = self._group_consts(key)
            lvv = x_pad[:, vi].reshape(B, nlv)
            if jac:
                lv = [Dual(lvv[:, k], eye[:, k:k + 1].expand(nlv, B))
                      for k in range(nlv)]
            elif v is not None:
                tv = v_pad[:, vi].reshape(B, nlv)
                lv = [Dual(lvv[:, k], tv[None, :, k]) for k in range(nlv)]
            else:
                lv = [lvv[:, k] for k in range(nlv)]
            s_rows, q_rows = g.model.eval(lv, p, self._eval_ctx(ctx, ni),
                                          None)
            K = nlv if jac else 1
            s, ds = _stack_rows(s_rows, B, K, dt, dev)
            q, dq = _stack_rows(q_rows, B, K, dt, dev)
            scale = torch.where(kcl, mult[:, None], 1.0)  # [B, n_lrow]
            ridx = self._index(key, L, "row")
            _scatter_add(S, ridx, (s * scale).reshape(-1))
            _scatter_add(Q, ridx, (q * scale).reshape(-1))
            if jac:
                midx = self._index(key, L, "mat")
                sc3 = scale[:, :, None]
                _scatter_add(G, midx, (ds * sc3).reshape(-1))
                _scatter_add(C, midx, (dq * sc3).reshape(-1))
            elif v is not None:
                _scatter_add(Qd, ridx, (dq[:, :, 0] * scale).reshape(-1))
        S = S.view(L, n1)[:, :n]
        Q = Q.view(L, n1)[:, :n]
        if jac:
            return (S, Q, G.view(L, n1, n1)[:, :n, :n],
                    C.view(L, n1, n1)[:, :n, :n])
        if v is not None:
            return S, Q, Qd.view(L, n1)[:, :n]
        return S, Q

    def _call(self, x, ctx, params, jac=False, v=None):
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        single = x.dim() == 1
        xb = x[None] if single else x
        if v is not None:
            v = torch.as_tensor(v, dtype=self.dtype, device=self.device)
            v = v[None] if single else v
        out = self.evaluate(xb, ctx, self.lane_params(params, xb.shape[0]),
                            jac=jac, v=v)
        return tuple(o[0] for o in out) if single else out

    def residuals(self, x, ctx: SimSpec, params=None):
        """(S, Q): static residual and charge vector, each [..., n_x]."""
        return self._call(x, ctx, params)

    def res_jacs_fwd(self, x, ctx: SimSpec, params=None):
        """(S, Q, G, C) from one dual-number walk per group."""
        return self._call(x, ctx, params, jac=True)

    def jacobians(self, x, ctx: SimSpec, params=None):
        """Dense (G, C) = (∂S/∂x, ∂Q/∂x), each [..., n_x, n_x]."""
        return self.res_jacs_fwd(x, ctx, params)[2:]

    def residuals_jvp(self, x, v, ctx: SimSpec, params=None):
        """(S, Q, C(x)·v) from one walk with a single tangent direction."""
        return self._call(x, ctx, params, v=v)

    # ---------------------------------------------------------- observables

    def observe(self, name: str) -> Callable:
        """fn(x, xdot, ctx, params) -> value for an observable name: a net
        name, ``"<inst>.V"`` (terminal-0/1 voltage difference) or
        ``"<inst>.I"`` (current into the first terminal, S + C·ẋ of the
        instance).  ``x``/``xdot`` may carry leading axes."""
        ckt = self.circuit
        if name in ckt._nets:
            net = ckt._nets[name]
            if net.is_ground:
                return lambda x, xd, ctx, params=None: torch.zeros_like(
                    x[..., 0])
            i = net.index
            return lambda x, xd, ctx, params=None: x[..., i]
        if "." in name:
            inst_name, field = name.rsplit(".", 1)
            if inst_name in self._inst_loc and field in ("V", "I"):
                key, j = self._inst_loc[inst_name]
                g = self.groups[key]
                ia, ib = g.var_idx[j, 0], g.var_idx[j, 1]
                if field == "V":
                    def volt(x, xd, ctx, params=None):
                        xp = torch.cat([x, torch.zeros_like(x[..., :1])], -1)
                        return xp[..., ia] - xp[..., ib]
                    return volt

                def curr(x, xd, ctx, params=None):
                    params = self.params0 if params is None else params
                    x2 = x.reshape(-1, self.n_x)
                    xd2 = xd.reshape(-1, self.n_x)
                    gp = {}
                    for pn, pv in params[key].items():
                        pv = torch.as_tensor(pv, dtype=self.dtype,
                                             device=self.device)
                        sel = pv[..., j] if pv.dim() == self.params0[key][
                            pn].dim() + 1 else pv[j]
                        gp[pn] = sel
                    mult = gp.pop("$mult")
                    p = {**g.static_params, **gp}
                    xp = torch.cat([x2, torch.zeros_like(x2[:, :1])], 1)
                    xdp = torch.cat([xd2, torch.zeros_like(xd2[:, :1])], 1)
                    lv = [Dual(xp[:, c], xdp[None, :, c])
                          for c in g.var_idx[j]]
                    s_rows, q_rows = g.model.eval(lv, p, ctx, None)
                    s, _ = _stack_rows(s_rows[:1], x2.shape[0], 1,
                                       self.dtype, self.device)
                    _, dq = _stack_rows(q_rows[:1], x2.shape[0], 1,
                                        self.dtype, self.device)
                    out = (s[:, 0] + dq[:, 0, 0]) * mult
                    return out.reshape(x.shape[:-1])
                return curr
        raise KeyError(f"unknown observable {name!r}; nets: "
                       f"{self.node_names[:20]}...")

    # ------------------------------------------------------------ utilities

    def breakpoints(self, tstop: float) -> np.ndarray:
        """All source-waveform discontinuity times in (0, tstop), sorted,
        with near-duplicates (sub-1e-9·tstop apart) merged."""
        pts = [np.asarray([], np.float64)]
        for key in self.group_order:
            g = self.groups[key]
            bp = getattr(g.model, "breakpoints", None)
            if bp is None:
                continue
            for inst in g.instances:
                pts.append(np.asarray(bp(inst.params, tstop), np.float64))
        out = np.unique(np.concatenate(pts))
        out = out[(out > 0) & (out < tstop)]
        if len(out) > 1:
            tol = max(tstop * 1e-9, 1e-18)
            keep = np.concatenate([[True], np.diff(out) > tol])
            out = out[keep]
        return out


#: instances of a group per lane are padded to a multiple of this.  PyTorch's
#: CPU elementwise loops take whole SIMD vectors (two AVX-512 vectors are 16
#: float64) and finish a ragged tail with scalar libm, which rounds some
#: functions (``pow``) one ulp apart from the vector code; with every lane a
#: whole number of vectors, a lane's values do not depend on how many lanes
#: run beside it.
_LANE_ALIGN = 16


def _n_pad(n_inst):
    return -(-n_inst // _LANE_ALIGN) * _LANE_ALIGN


def _scatter_add(dst, idx, src):
    """``dst[idx] += src`` summed in a fixed order.  On the CPU that is
    ``index_add_``.  On CUDA ``index_add_`` adds with atomics in an order
    that changes from run to run, and the DFF operating point's Newton path
    is sensitive enough to those last-bit differences to fail on some runs;
    ``index_put_(accumulate=True)`` sorts the indices and sums each slot in
    a fixed order."""
    if dst.device.type == "cuda":
        dst.index_put_((idx,), src, accumulate=True)
    else:
        dst.index_add_(0, idx, src)


def _stack_rows(rows, B, K, dtype, device):
    """Row contributions (float, [B] tensor or Dual) → values [B, n_rows]
    and tangents [B, n_rows, K] (zeros for rows without a tangent)."""
    def full(r, shape):
        # a Python float becomes a fill on the device (no host copy)
        if isinstance(r, torch.Tensor):
            return r.expand(shape)
        return torch.full(shape, float(r), dtype=dtype, device=device)

    vals, tans = [], []
    for r in rows:
        if isinstance(r, Dual):
            vals.append(full(r.v, (B,)))
            tans.append(full(r.d, (K, B)))
        else:
            vals.append(full(r, (B,)))
            tans.append(None)
    v = torch.stack(vals, 1)
    z = None
    out = []
    for t in tans:
        if t is None:
            if z is None:
                z = torch.zeros(K, B, dtype=dtype, device=device)
            t = z
        out.append(t)
    d = torch.stack(out, 0).permute(2, 0, 1)          # [B, n_rows, K]
    return v, d


def default_ctx(compiled: CompiledCircuit, temp_c=None) -> SimSpec:
    """SimSpec honoring the netlist's ``.option``/``.temp`` (gmin, temp)."""
    o = getattr(compiled.circuit, "options", {}) or {}
    if temp_c is None:
        temp_c = o.get("temp", 27.0)
    return SimSpec.make(temp_c=temp_c, gmin=o.get("gmin", 1e-12))


def compile_circuit(circuit: Circuit, dtype=None, device="cpu",
                    dynamic_params=()) -> CompiledCircuit:
    """Compile a circuit for the dense path on ``device``."""
    return CompiledCircuit(circuit, dtype=dtype, device=device,
                           dynamic_params=dynamic_params)
