"""Circuit compiler: graph IR → batched residual / Jacobian functions in
PyTorch (counterpart of ``cedarsim_tpu/core/compile.py``).

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
``[L, ...]``; ``ctx.time`` and ``ctx.temp`` are floats or ``[L]`` tensors.
Every lane is evaluated independently of the others.

Mixed precision: ``eval_dtype`` (default ``dtype``) is the dtype of the
model evaluations only.  The walk casts the local unknowns, their tangents,
the dynamic params, the aux inputs and the context's tensor fields to it;
the rows and their tangents come back to the state's dtype before the
scatter, so states, time, the step control and the solves stay in
``dtype`` (the JAX package's ``_cast_eval``/``_ctx_eval``).  The delay
ring's samples, the latch states and the noise powers are evaluated in
``dtype``, as the JAX package evaluates them.

Sparse path: circuits of ``SPARSE_AUTO_THRESHOLD`` unknowns or more (or
any circuit compiled with ``sparse=True``) solve their Newton systems with
the static-pattern sparse LU (:func:`use_sparse_solver`); their Jacobian
walk (``evaluate(jac="sparse")``) scatters each local Jacobian entry
straight into the LU plan's filled pattern, ``[L, nnz_f]``, with no dense
``[n, n]`` in between (``core/sparse_ops.py``).

Noise and AC: every noise source of every instance has a slot of the global
noise-input vector (``n_eps`` long; ``Group.eps_idx``).  Without ``eps``
the walk is exactly the one without noise; :meth:`eps_jacobian` walks the
noisy groups once with the inputs as Duals (unit tangents) for ∂S/∂eps,
:meth:`noise_sources` gathers each source's (power, exponent) and
:meth:`ac_rhs` the sources' complex AC drive.

Delay and latch channel: a device's aux inputs are ``[n_noise noise
inputs, n_delay delayed values, n_latch latched states]``
(``cedarsim_tpu/core/compile.py::_aux``).  The delayed values and latched
states of every instance have slots of the global aux vector ``dly``
(``n_dly`` long; ``Group.dly_idx``): the ring slots (``ring_slots``) are
filled by the transient from its history ring of accepted samples
(:meth:`delay_sources` gives what it stores, u and td), the latch slots
(``latch_slots``) hold state that changes only at accepted steps
(:meth:`latch_init`, :meth:`latch_update`).  Without ``dly`` a group with
such slots reads zeros, as the JAX package's ``_dly0``.
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
    eps_idx: np.ndarray      # [n_inst, n_noise] int into the noise inputs
    #: [n_inst, n_delay + n_latch] int into the aux vector ``dly``: the
    #: ring-filled delayed values first, then the latched-state slots
    dly_idx: np.ndarray = None
    #: params uniform across the group and not requested dynamic: Python
    #: floats (or device tensors for point lists) so model conditionals on
    #: them fold on the host while the model is walked
    static_params: dict = dataclasses.field(default_factory=dict)


class CompiledCircuit:
    #: dense/sparse linear-algebra crossover (unknown count) for "auto"
    SPARSE_AUTO_THRESHOLD = 256

    def __init__(self, circuit: Circuit, dtype=None, device=None,
                 dynamic_params=(), sparse="auto", eval_dtype=None):
        """``device``: the torch device every tensor of the circuit (and of
        every solve on it) lives on; by default the CUDA card, and with no
        card an error (pass ``device="cpu"``).  ``dynamic_params``: param
        names kept as per-instance tensors even when uniform across a group
        (bare names apply to every instance, dotted names to one).
        ``sparse``: the Newton linear algebra, "auto" (sparse at
        ``SPARSE_AUTO_THRESHOLD`` unknowns or more), True or False
        (:func:`use_sparse_solver`).  ``eval_dtype``: the dtype of the
        model evaluations only (default ``dtype``); ``torch.float32`` runs
        the device physics in float32 at ~1e-7 relative accuracy, so the
        Newton and step tolerances loosen (``default_newton_options``, the
        transient's defaults)."""
        self.circuit = circuit
        self.dtype = dtype or config.real_dtype
        self.eval_dtype = eval_dtype or self.dtype
        self.device = config.resolve_device(device)
        self.dynamic_params = frozenset(
            d.lower() for d in (dynamic_params or ()))
        self.sparse_mode = sparse
        self._idx_cache = {}
        self._build()

    @property
    def mixed(self):
        """True when the models evaluate in another dtype than the state."""
        return self.eval_dtype != self.dtype

    def _cast_eval(self, v):
        """A walk input (tensor or Dual) in the eval dtype; anything else
        (a Python float, a bool or integer tensor) as it is."""
        if isinstance(v, Dual):
            return Dual(self._cast_eval(v.v), self._cast_eval(v.d))
        if (isinstance(v, torch.Tensor) and v.is_floating_point()
                and v.dtype != self.eval_dtype):
            return v.to(self.eval_dtype)
        return v

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
        eps_off = 0
        dly_off = 0
        ring_slots, latch_slots = [], []
        for key in order:
            insts = buckets[key]
            model = insts[0].model
            nt, ni, nb, nc = (model.n_terms(), model.n_internal,
                              model.n_branch, model.n_control)
            n_delay, n_latch = _n_delay(model), _n_latch(model)
            var_idx = np.full((len(insts), model.n_lvar()), pad, np.int64)
            row_idx = np.full((len(insts), model.n_lrow()), pad, np.int64)
            eps_idx = np.zeros((len(insts), model.n_noise), np.int64)
            dly_idx = np.zeros((len(insts), n_delay + n_latch), np.int64)
            for j, inst in enumerate(insts):
                self._inst_loc[inst.name] = (key, j)
                if model.n_noise:
                    eps_idx[j] = eps_off + np.arange(model.n_noise)
                    eps_off += model.n_noise
                if n_delay or n_latch:
                    dly_idx[j] = dly_off + np.arange(n_delay + n_latch)
                    ring_slots.extend(range(dly_off, dly_off + n_delay))
                    latch_slots.extend(range(dly_off + n_delay,
                                             dly_off + n_delay + n_latch))
                    dly_off += n_delay + n_latch
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
                # control unknowns (F, H, W, B probes): a gathered branch
                # current or net voltage, read but never stamped into
                for k, (kind, ref) in enumerate(inst.extras):
                    if kind == "branch":
                        if ref not in self._inst_branch:
                            raise ValueError(
                                f"{inst.name}: control source {ref!r} "
                                "not found or has no branch current")
                        var_idx[j, nt + ni + nb + k] = \
                            self._inst_branch[ref]
                    elif not ref.is_ground:
                        var_idx[j, nt + ni + nb + k] = ref.index
            kcl_mask = np.zeros(model.n_lrow(), bool)
            kcl_mask[: nt + ni] = True
            grp = Group(key, model, insts, var_idx, row_idx, kcl_mask,
                        eps_idx, dly_idx=dly_idx)
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
        self.n_eps = eps_off
        #: the aux vector's width, its ring-filled and its latched slots
        self.n_dly = dly_off
        self.n_ring = len(ring_slots)
        self.n_lat = len(latch_slots)
        self.ring_slots = np.asarray(ring_slots, np.int64)
        self.latch_slots = np.asarray(latch_slots, np.int64)
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
        ``"row"`` into [L·(n_x+1)], ``"mat"`` into [L·(n_x+1)²],
        ``"sparse"`` (each local Jacobian entry's filled-pattern position,
        ``SparseOps.group_pos``) into [L·(nnz_f+1)], ``"src"`` (each noise
        source) into [L·(n_eps+1)], ``"eps"`` (each row by noise source)
        into [L·(n_x+1)·(n_eps+1)] and ``"dly"`` (each delay or latch
        slot) into [L·(n_dly+1)]; the padding instances write the trash
        row and column (the sparse pattern's trash slot)."""
        ck = (key, L, kind)
        if ck not in self._idx_cache:
            var_idx, row_idx = self._padded_idx(key)
            n1 = self.n_x + 1
            e1 = self.n_eps + 1
            lanes = np.arange(L)[:, None, None]
            if kind == "sparse":
                from cedarsim_tpu_torch.core.sparse_ops import get_sparse_ops
                sops = get_sparse_ops(self)
                pos = sops.group_pos[key]
                pos = np.concatenate([pos, np.full(
                    (row_idx.shape[0] - pos.shape[0],) + pos.shape[1:],
                    sops.nnz_f, pos.dtype)]).astype(np.int64)
                idx = lanes[..., None] * (sops.nnz_f + 1) + pos[None]
                self._idx_cache[ck] = torch.as_tensor(
                    idx.reshape(-1), dtype=torch.int64, device=self.device)
                return self._idx_cache[ck]
            if kind == "dly":
                d_idx = self.groups[key].dly_idx
                d_idx = np.concatenate([d_idx, np.full(
                    (row_idx.shape[0] - d_idx.shape[0], d_idx.shape[1]),
                    self.n_dly, d_idx.dtype)])
                idx = lanes * (self.n_dly + 1) + d_idx[None]
                self._idx_cache[ck] = torch.as_tensor(
                    idx.reshape(-1), dtype=torch.int64, device=self.device)
                return self._idx_cache[ck]
            if kind in ("src", "eps"):
                eps_idx = self.groups[key].eps_idx
                eps_idx = np.concatenate([eps_idx, np.full(
                    (row_idx.shape[0] - eps_idx.shape[0], eps_idx.shape[1]),
                    self.n_eps, eps_idx.dtype)])
            if kind == "row":
                idx = lanes * n1 + row_idx[None]
            elif kind == "src":
                idx = lanes * e1 + eps_idx[None]
            elif kind == "eps":
                idx = (lanes[..., None] * n1 * e1
                       + row_idx[None, :, :, None] * e1
                       + eps_idx[None, :, None, :])
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
                torch.eye(nlv, dtype=self.eval_dtype, device=self.device))
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

    def _eval_ctx(self, ctx, n_inst, cast=False):
        """``ctx`` for a group's flat eval batch: a per-lane time or
        temperature [L] is repeated over each lane's ``n_inst`` padded
        instances; with ``cast``, every tensor field in the eval dtype
        (Python floats stay: they fold on the host)."""
        kw = {}
        for f in ("time", "temp", "gmin", "scale", "sourcefac"):
            v = getattr(ctx, f)
            if not isinstance(v, torch.Tensor):
                continue
            if f in ("time", "temp") and v.dim() == 1:
                v = v.repeat_interleave(n_inst)
            if cast:
                v = self._cast_eval(v)
            if v is not getattr(ctx, f):
                kw[f] = v
        return ctx.replace(**kw) if kw else ctx

    def evaluate(self, x, ctx: SimSpec, lp, jac=False, v=None, keys=None,
                 eps=None, dly=None, exact=False):
        """Core walk over ``[L, n_x]`` states with prepared lane params
        ``lp`` (:meth:`lane_params`).  Returns (S, Q) [L, n_x]; with
        ``jac=True`` also (G, C) [L, n_x, n_x], with ``jac="sparse"`` (G,
        C) as value vectors [L, nnz_f] in the filled pattern of the sparse
        LU plan (``core/sparse_ops.py``); with a direction ``v`` [L, n_x]
        instead the charge tangent C(x)·v [L, n_x].  ``keys`` restricts the
        walk to those groups (in the compiled order): the fused chord
        plan's linear and nonlinear subsets.  ``eps`` [L, n_eps]: the noise
        inputs (None: the walk without noise); ``dly`` [L, n_dly]: the
        delayed values and latched states (None: zeros).  The sums are
        formed in ``x``'s dtype (the circuit's, but for the fused chord
        kernel's float32 plain version).  ``exact``: the walk in ``x``'s
        dtype whatever the eval dtype (the fused plan's linearity probe
        and its baked constants, as the JAX plan's ``exact=True``)."""
        L, n = x.shape
        n1 = n + 1
        dt, dev = x.dtype, self.device
        x_pad = torch.cat([x, torch.zeros(L, 1, dtype=dt, device=dev)], 1)
        v_pad = None if v is None else torch.cat(
            [v, torch.zeros(L, 1, dtype=dt, device=dev)], 1)
        S = torch.zeros(L * n1, dtype=dt, device=dev)
        Q = torch.zeros(L * n1, dtype=dt, device=dev)
        if jac:
            # dense [n+1, n+1] per lane, or the filled pattern and its
            # trash slot; ground rows and columns land in the trash
            m1 = n1 * n1
            if jac == "sparse":
                from cedarsim_tpu_torch.core.sparse_ops import get_sparse_ops
                m1 = get_sparse_ops(self).nnz_f + 1
            G = torch.zeros(L * m1, dtype=dt, device=dev)
            C = torch.zeros(L * m1, dtype=dt, device=dev)
        if v is not None:
            Qd = torch.zeros(L * n1, dtype=dt, device=dev)
        walk = self.group_order
        if keys is not None:
            keys = set(keys)
            walk = [k for k in walk if k in keys]
        for key in walk:
            s, q, ds, dq, scale = self._walk_group(key, x_pad, ctx, lp, L,
                                                   bool(jac), v_pad, eps, dly,
                                                   exact)
            ridx = self._index(key, L, "row")
            _scatter_add(S, ridx, (s * scale).reshape(-1))
            _scatter_add(Q, ridx, (q * scale).reshape(-1))
            if jac:
                midx = self._index(key, L,
                                   "sparse" if jac == "sparse" else "mat")
                sc3 = scale[:, :, None]
                _scatter_add(G, midx, (ds * sc3).reshape(-1))
                _scatter_add(C, midx, (dq * sc3).reshape(-1))
            elif v is not None:
                _scatter_add(Qd, ridx, (dq[:, :, 0] * scale).reshape(-1))
        S = S.view(L, n1)[:, :n]
        Q = Q.view(L, n1)[:, :n]
        if jac == "sparse":
            return S, Q, G.view(L, m1)[:, :-1], C.view(L, m1)[:, :-1]
        if jac:
            return (S, Q, G.view(L, n1, n1)[:, :n, :n],
                    C.view(L, n1, n1)[:, :n, :n])
        if v is not None:
            return S, Q, Qd.view(L, n1)[:, :n]
        return S, Q

    def _walk_group(self, key, x_pad, ctx, lp, L, jac, v_pad, eps,
                    dly=None, exact=False):
        """One group's model walk over its flat eval batch of ``L`` lanes:
        the row values s, q [B, n_lrow], their tangents ds, dq [B, n_lrow,
        K] (K = n_lvar local Jacobian columns with ``jac``, else the one
        direction of ``v_pad``, else zeros) and the KCL rows' multiplier
        ``scale`` [B, n_lrow], all in ``x_pad``'s dtype; the walk itself
        runs in the eval dtype (``exact``: in ``x_pad``'s)."""
        dt, dev = x_pad.dtype, self.device
        ed = dt if exact else self.eval_dtype
        g = self.groups[key]
        p, mult = lp[key]
        ni = _n_pad(len(g.instances))
        B = L * ni
        nlv = g.model.n_lvar()
        vi, kcl, eye = self._group_consts(key)
        lvv = x_pad[:, vi].reshape(B, nlv)
        cast = not exact and (dt != ed or self.mixed)
        if cast:
            lvv = lvv.to(ed)
            p = self._eval_params(g, p)
        if jac and eye.dtype != ed:
            eye = eye.to(ed)
        if jac:
            lv = [Dual(lvv[:, k], eye[:, k:k + 1].expand(nlv, B))
                  for k in range(nlv)]
        elif v_pad is not None:
            tv = v_pad[:, vi].reshape(B, nlv).to(ed)
            lv = [Dual(lvv[:, k], tv[None, :, k]) for k in range(nlv)]
        else:
            lv = [lvv[:, k] for k in range(nlv)]
        e = self._group_aux(key, eps, dly, B)
        if cast and e is not None:
            e = [self._cast_eval(a) for a in e]
        s_rows, q_rows = g.model.eval(lv, p, self._eval_ctx(ctx, ni, cast),
                                      e)
        K = nlv if jac else 1
        s, ds = _stack_rows(s_rows, B, K, ed, dev)
        q, dq = _stack_rows(q_rows, B, K, ed, dev)
        scale = torch.where(kcl, mult[:, None], 1.0)  # [B, n_lrow]
        if cast:
            s, ds, q, dq, scale = (a.to(dt) for a in (s, ds, q, dq, scale))
        return s, q, ds, dq, scale

    def _eval_params(self, g, p):
        """Walk params ``p`` of group ``g`` with the dynamic ones in the
        eval dtype (the static ones fold on the host, as in the JAX
        package)."""
        return {k: (v if k in g.static_params else self._cast_eval(v))
                for k, v in p.items()}

    def local_jacobians(self, x, ctx: SimSpec, params=None):
        """Each group's unscaled local Jacobians at ``x`` [L, n_x]: {key:
        (∂s/∂l, ∂q/∂l) [L, n_inst, n_lrow, n_lvar]}, the instances' rows
        and local unknowns in the order of ``row_idx`` and ``var_idx`` (the
        sparse plan's probe weights read them)."""
        L, n = x.shape
        lp = self.lane_params(params, L)
        x_pad = torch.cat([x, torch.zeros_like(x[:, :1])], 1)
        out = {}
        for key in self.group_order:
            g = self.groups[key]
            ni, np_ = len(g.instances), _n_pad(len(g.instances))
            _, _, ds, dq, _ = self._walk_group(key, x_pad, ctx, lp, L, True,
                                               None, None)
            shape = (L, np_) + tuple(ds.shape[1:])
            out[key] = (ds.reshape(shape)[:, :ni], dq.reshape(shape)[:, :ni])
        return out

    def _group_eps(self, key, eps, B):
        """A group's noise inputs for its flat eval batch: ``n_noise``
        columns [B] gathered from ``eps`` [L, n_eps] (the padding instances
        read zero)."""
        L = eps.shape[0]
        e_pad = torch.cat([eps, torch.zeros(L, 1, dtype=eps.dtype,
                                            device=eps.device)], 1)
        nn = self.groups[key].model.n_noise
        idx = self._index(key, 1, "src")      # [n_pad·n_noise] into n_eps+1
        le = e_pad[:, idx].reshape(B, nn)
        return [le[:, k] for k in range(nn)]

    def _group_aux(self, key, eps, dly, B):
        """A group's aux inputs for its flat eval batch: None for a group
        with no delay or latch slots and no ``eps``, else the noise inputs
        (zeros without ``eps``) followed by the delay and latch slots
        gathered from ``dly`` [L, n_dly] (zeros without it; the padding
        instances read zero)."""
        model = self.groups[key].model
        nd = _n_delay(model) + _n_latch(model)
        noise = None
        if eps is not None and model.n_noise:
            noise = self._group_eps(key, eps, B)
        if nd == 0:
            return noise
        if noise is None:
            noise = [0.0] * model.n_noise
        if dly is None:
            return noise + [0.0] * nd
        L = dly.shape[0]
        d_pad = torch.cat([dly, torch.zeros(L, 1, dtype=dly.dtype,
                                            device=dly.device)], 1)
        ld = d_pad[:, self._index(key, 1, "dly")].reshape(B, nd)
        return noise + [ld[:, k] for k in range(nd)]

    def _call(self, x, ctx, params, jac=False, v=None, eps=None, dly=None):
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        single = x.dim() == 1
        xb = x[None] if single else x
        if v is not None:
            v = torch.as_tensor(v, dtype=self.dtype, device=self.device)
            v = v[None] if single else v
        if eps is not None:
            eps = torch.as_tensor(eps, dtype=self.dtype, device=self.device)
            eps = eps.expand(xb.shape[0], self.n_eps)
        if dly is not None:
            dly = torch.as_tensor(dly, dtype=self.dtype, device=self.device)
            dly = dly.expand(xb.shape[0], self.n_dly)
        out = self.evaluate(xb, ctx, self.lane_params(params, xb.shape[0]),
                            jac=jac, v=v, eps=eps, dly=dly)
        return tuple(o[0] for o in out) if single else out

    def residuals(self, x, ctx: SimSpec, params=None, eps=None, dly=None):
        """(S, Q): static residual and charge vector, each [..., n_x];
        ``eps`` [n_eps] (or [L, n_eps]) are the noise inputs, ``dly``
        [n_dly] (or [L, n_dly]) the delayed values and latched states."""
        return self._call(x, ctx, params, eps=eps, dly=dly)

    def res_jacs_fwd(self, x, ctx: SimSpec, params=None, dly=None):
        """(S, Q, G, C) from one dual-number walk per group."""
        return self._call(x, ctx, params, jac=True, dly=dly)

    def jacobians(self, x, ctx: SimSpec, params=None, dly=None):
        """Dense (G, C) = (∂S/∂x, ∂Q/∂x), each [..., n_x, n_x]."""
        return self.res_jacs_fwd(x, ctx, params, dly=dly)[2:]

    def residuals_jvp(self, x, v, ctx: SimSpec, params=None):
        """(S, Q, C(x)·v) from one walk with a single tangent direction."""
        return self._call(x, ctx, params, v=v)

    # -------------------------------------------------------- noise and AC

    def _lane_inputs(self, x, params, lp=None):
        """(x [L, n_x], one state?, lane params) of ``x`` ([n_x] or [L,
        n_x])."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        single = x.dim() == 1
        xb = x[None] if single else x
        if lp is None:
            lp = self.lane_params(params, xb.shape[0])
        return xb, single, lp

    def _plain_groups(self, xb, ctx, lp, want, cast=False):
        """The walk inputs of every group that ``want(model)`` selects at
        ``xb`` [L, n_x]: per group (key, model, params, multiplier, eval
        batch B, local values [B] each, eval ctx); with ``cast``, the
        values, the dynamic params and the ctx in the eval dtype."""
        L = xb.shape[0]
        x_pad = torch.cat([xb, torch.zeros_like(xb[:, :1])], 1)
        out = []
        for key in self.group_order:
            g = self.groups[key]
            if not want(g.model):
                continue
            p, mult = lp[key]
            ni = _n_pad(len(g.instances))
            nlv = g.model.n_lvar()
            lvv = x_pad[:, self._group_consts(key)[0]].reshape(L * ni, nlv)
            if cast:
                lvv, p = self._cast_eval(lvv), self._eval_params(g, p)
            out.append((key, g.model, p, mult, L * ni,
                        [lvv[:, k] for k in range(nlv)],
                        self._eval_ctx(ctx, ni, cast)))
        return out

    def _noisy_groups(self, x, ctx, params, cast=False):
        """The walk inputs of every group with noise sources at ``x``
        ([n_x] or [L, n_x]): (L, one state?, and per group as
        :meth:`_plain_groups`)."""
        xb, single, lp = self._lane_inputs(x, params)
        return xb.shape[0], single, self._plain_groups(
            xb, ctx, lp, lambda m: m.n_noise > 0, cast)

    def eps_jacobian(self, x, ctx: SimSpec, params=None, dly=None):
        """∂S/∂eps [..., n_x, n_eps] at ``x``: one walk of each noisy group
        with its noise inputs as Duals of value 0 and unit tangents, the
        VA's own scale factors on a noise term carried through; the KCL
        rows scaled by the multiplier like S.  ``dly`` [..., n_dly]: the
        aux slots the walk reads (the operating point's, in the noise
        analysis of a circuit with delay or latch sites).  Walked in the
        eval dtype, as the JAX package's derivative of ``residuals``."""
        L, single, groups = self._noisy_groups(x, ctx, params, self.mixed)
        n1, e1 = self.n_x + 1, self.n_eps + 1
        dt, ed, dev = self.dtype, self.eval_dtype, self.device
        if dly is not None:
            dly = torch.as_tensor(dly, dtype=dt, device=dev).expand(
                L, self.n_dly)
        J = torch.zeros(L * n1 * e1, dtype=dt, device=dev)
        for key, model, p, mult, B, lv, ctx_e in groups:
            nn = model.n_noise
            zero = torch.zeros(B, dtype=ed, device=dev)
            eye = torch.eye(nn, dtype=ed, device=dev)
            e = [Dual(zero, eye[:, k:k + 1].expand(nn, B)) for k in range(nn)]
            aux = self._group_aux(key, None, dly, B)
            if aux is not None:
                e = e + [self._cast_eval(a) for a in aux[nn:]]
            s_rows, _ = model.eval(lv, p, ctx_e, e)
            _, ds = _stack_rows(s_rows, B, nn, ed, dev)   # [B, n_lrow, nn]
            ds = ds.to(dt)
            scale = torch.where(self._group_consts(key)[1], mult[:, None],
                                1.0)
            _scatter_add(J, self._index(key, L, "eps"),
                         (ds * scale[:, :, None]).reshape(-1))
        J = J.view(L, n1, e1)[:, :self.n_x, :self.n_eps]
        return J[0] if single else J

    def noise_sources(self, x, ctx: SimSpec, params=None):
        """(pwr, exp) [..., n_eps] of every noise source at the operating
        point ``x``: a current PSD of pwr·f^(−exp) A²/Hz (unscaled by the
        multiplier, as in the JAX package)."""
        L, single, groups = self._noisy_groups(x, ctx, params)
        e1 = self.n_eps + 1
        dt, dev = self.dtype, self.device
        pwr = torch.zeros(L * e1, dtype=dt, device=dev)
        ex = torch.zeros(L * e1, dtype=dt, device=dev)
        for key, model, p, _, B, lv, ctx_e in groups:
            idx = self._index(key, L, "src")
            for dst, rows in zip((pwr, ex), model.noise(lv, p, ctx_e)):
                vals, _ = _stack_rows(rows, B, 1, dt, dev)   # [B, nn]
                dst.index_put_((idx,), vals.reshape(-1))
        pwr = pwr.view(L, e1)[:, :self.n_eps]
        ex = ex.view(L, e1)[:, :self.n_eps]
        return (pwr[0], ex[0]) if single else (pwr, ex)

    # ------------------------------------------------ delay and latch slots

    def delay_sources(self, x, ctx: SimSpec, params=None, lp=None):
        """(u, td) [..., n_ring] at ``x`` ([n_x] or [L, n_x]): each ring
        slot's delayed expression now (what the transient's history ring
        stores) and its delay, in the order of ``ring_slots``.  ``lp``:
        the lane params, where the caller has them."""
        xb, single, lp = self._lane_inputs(x, params, lp)
        L = xb.shape[0]
        d1 = self.n_dly + 1
        dt, dev = self.dtype, self.device
        u = torch.zeros(L * d1, dtype=dt, device=dev)
        td = torch.zeros(L * d1, dtype=dt, device=dev)
        for key, model, p, _, B, lv, ctx_e in self._plain_groups(
                xb, ctx, lp, lambda m: _n_delay(m) > 0):
            nd = _n_delay(model)
            idx = self._index(key, L, "dly").view(B, -1)[:, :nd].reshape(-1)
            for dst, rows in zip((u, td), model.delays(lv, p, ctx_e)):
                vals, _ = _stack_rows(rows, B, 1, dt, dev)     # [B, nd]
                dst.index_put_((idx,), vals.reshape(-1))
        rs = torch.as_tensor(self.ring_slots, device=dev)
        u, td = u.view(L, d1)[:, rs], td.view(L, d1)[:, rs]
        return (u[0], td[0]) if single else (u, td)

    def latch_init(self, x, ctx: SimSpec, params=None, lp=None):
        """The aux vector [..., n_dly] with every latch slot settled at the
        operating point ``x`` (``model.latch0``) and the ring slots zero
        (the transient fills them from its ring)."""
        xb, single, lp = self._lane_inputs(x, params, lp)
        L = xb.shape[0]
        latw = torch.zeros(L, self.n_dly, dtype=self.dtype,
                           device=self.device)
        if self.n_lat:
            latw = self._latch_walk(xb, ctx, lp, latw, None)
        return latw[0] if single else latw

    def latch_update(self, x, ctx: SimSpec, latw, params=None, lp=None):
        """The aux vector after an accepted step at ``ctx.time``: each
        latch site sees its state in ``latw`` [..., n_dly] and the
        accepted solution ``x`` and gives its new state (``model.latch``,
        the event queue's counterpart); the other slots are kept."""
        xb, single, lp = self._lane_inputs(x, params, lp)
        latw = torch.as_tensor(latw, dtype=self.dtype, device=self.device)
        latw = latw.expand(xb.shape[0], self.n_dly)
        if self.n_lat:
            latw = self._latch_walk(xb, ctx, lp, latw, True)
        return latw[0] if single else latw

    def _latch_walk(self, xb, ctx, lp, latw, update):
        L = xb.shape[0]
        d1 = self.n_dly + 1
        dt, dev = self.dtype, self.device
        w = torch.cat([latw, torch.zeros(L, 1, dtype=dt, device=dev)],
                      1).reshape(-1).clone()
        for key, model, p, _, B, lv, ctx_e in self._plain_groups(
                xb, ctx, lp, lambda m: _n_latch(m) > 0):
            nd, nl = _n_delay(model), _n_latch(model)
            idx = self._index(key, L, "dly").view(B, -1)[:, nd:]
            if update:
                lat = w[idx]                                    # [B, nl]
                rows = model.latch(lv, p, ctx_e,
                                   [lat[:, k] for k in range(nl)])
            else:
                rows = model.latch0(lv, p, ctx_e)
            vals, _ = _stack_rows(rows, B, 1, dt, dev)
            w.index_put_((idx.reshape(-1),), vals.reshape(-1))
        return w.view(L, d1)[:, :self.n_dly]

    def ac_rhs(self, params=None):
        """Complex AC drive b [n_x] of (G + jωC)·v = b: each source's
        ``ac``/``acphase`` phasor in its rows (unscaled by the multiplier,
        as in the JAX package).  Assembled on the CPU (a few entries) and
        moved to the circuit's device."""
        params = self.params0 if params is None else params
        cd = config.complex_dtype
        b = torch.zeros(self.n_x + 1, dtype=cd)
        for key in self.group_order:
            g = self.groups[key]
            p = dict(g.static_params)
            for pn, v in params[key].items():
                if pn != "$mult":
                    p[pn] = torch.as_tensor(v, dtype=self.dtype).cpu()
            rows = g.model.ac_rhs(p)
            if rows is None:
                continue
            ni = len(g.instances)
            vals = torch.stack([torch.as_tensor(r, dtype=cd).expand(ni)
                                for r in rows], 1)
            b.index_add_(0, torch.as_tensor(g.row_idx.reshape(-1)),
                         vals.reshape(-1))
        return b[:-1].to(self.device)

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

                # delay and latch slots read zero here, as in the JAX
                # package (the solution does not carry the ring)
                nd = _n_delay(g.model) + _n_latch(g.model)
                aux0 = [0.0] * (g.model.n_noise + nd) if nd else None

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
                    s_rows, q_rows = g.model.eval(lv, p, ctx, aux0)
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

    def param_loc(self, dotted: str):
        """Resolve ``"inst.name.param"`` to (group key, instance index,
        param name); ``m`` is the multiplier ``$mult``."""
        inst_name, pname = dotted.rsplit(".", 1)
        if inst_name not in self._inst_loc:
            raise KeyError(f"no instance {inst_name!r}")
        key, j = self._inst_loc[inst_name]
        if pname == "m":
            pname = "$mult"
        elif pname not in self.params0[key]:
            if pname in self.groups[key].static_params:
                raise KeyError(
                    f"{inst_name}.{pname} was compiled as a static constant; "
                    f"pass dynamic_params=[{pname!r}] (or "
                    f"'{inst_name}.{pname}') to compile_circuit to sweep it")
            raise KeyError(f"{inst_name} has no parameter {pname!r}")
        return key, j, pname

    def set_param(self, params, dotted: str, value):
        """A copy of ``params`` with one instance parameter set (a bare name
        sets it on every instance that has it).  An explicit value is given:
        the ``$given`` flag beside it turns to 1, so that a device switching
        on it (a PULSE source's ``dc`` in DC mode) sees the value."""
        if "." not in dotted:
            pname = dotted.lower()
            new = dict(params)
            hit = False
            for key in self.group_order:
                if pname in new[key]:
                    grp = dict(new[key])
                    grp[pname] = torch.full_like(
                        torch.as_tensor(grp[pname]), float(value))
                    if f"{pname}$given" in grp:
                        grp[f"{pname}$given"] = torch.ones_like(
                            torch.as_tensor(grp[f"{pname}$given"]))
                    new[key] = grp
                    hit = True
                elif pname in self.groups[key].static_params:
                    raise KeyError(
                        f"{pname!r} was compiled as a static constant; pass "
                        f"dynamic_params=[{pname!r}] to compile_circuit")
            if not hit:
                raise KeyError(f"no instance has parameter {pname!r}")
            return new
        key, j, pname = self.param_loc(dotted)
        new = dict(params)
        grp = dict(new[key])
        v = torch.as_tensor(grp[pname]).clone()
        v[j] = value
        grp[pname] = v
        if f"{pname}$given" in grp:
            g = torch.as_tensor(grp[f"{pname}$given"]).clone()
            g[j] = 1.0
            grp[f"{pname}$given"] = g
        new[key] = grp
        return new

    def get_param(self, params, dotted: str):
        """One instance parameter's value in ``params`` (``"inst.param"``;
        the inverse of :meth:`set_param`)."""
        key, j, pname = self.param_loc(dotted)
        return params[key][pname][j]

    def breakpoints(self, tstop: float) -> np.ndarray:
        """All source-waveform discontinuity times in (0, tstop) and their
        echoes through the delay elements (``echo_delays``), sorted, with
        near-duplicates (sub-1e-9·tstop apart) merged."""
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
        # delay elements echo every waveform corner, and each echo's
        # reflections, one line delay later: the closure of the schedule
        # under those delays (capped at 200 rounds and 20,000 points)
        tds = []
        for key in self.group_order:
            g = self.groups[key]
            ed = getattr(g.model, "echo_delays", None)
            if ed is None:
                continue
            for inst in g.instances:
                tds.extend(float(v) for v in ed(inst.params) if v > 0)
        tds = sorted(set(tds))
        if tds and len(out):
            frontier = out
            acc = [out]
            for _ in range(min(int(np.ceil(tstop / tds[0])) + 1, 200)):
                new = np.concatenate([frontier + td for td in tds])
                new = np.unique(new[new < tstop])
                if not len(new) or sum(map(len, acc)) > 20000:
                    break
                acc.append(new)
                frontier = new
            out = np.unique(np.concatenate(acc))
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


def _n_delay(model):
    """A device class's ring-filled aux inputs (delayed values)."""
    return getattr(model, "n_delay", 0)


def _n_latch(model):
    """A device class's latched-state aux inputs."""
    return getattr(model, "n_latch", 0)


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


def compile_circuit(circuit: Circuit, dtype=None, device=None,
                    dynamic_params=(), sparse="auto",
                    eval_dtype=None) -> CompiledCircuit:
    """Compile a circuit on ``device`` (by default the CUDA card; without
    one, pass ``device="cpu"``).  ``sparse``: "auto" (the sparse Newton
    linear algebra for circuits with n_x >= SPARSE_AUTO_THRESHOLD
    unknowns), True, or False.  ``eval_dtype``: the model evaluations'
    dtype (default ``dtype``; ``torch.float32`` for mixed precision)."""
    return CompiledCircuit(circuit, dtype=dtype, device=device,
                           dynamic_params=dynamic_params, sparse=sparse,
                           eval_dtype=eval_dtype)


def use_sparse_solver(compiled: CompiledCircuit) -> bool:
    """Whether DC and the transient solve ``compiled``'s Newton systems
    with the sparse LU (``core/sparse_ops.py``) instead of a dense one."""
    mode = getattr(compiled, "sparse_mode", "auto")
    if mode == "auto":
        return compiled.n_x >= CompiledCircuit.SPARSE_AUTO_THRESHOLD
    return bool(mode)


def ensure_dynamic(compiled: CompiledCircuit, names) -> CompiledCircuit:
    """``compiled``, or a variant compiled again (on the same device) with
    every param in ``names`` (dotted or bare) dynamic, so that a sweep can
    give it a value per lane; variants are cached on ``compiled``."""
    names = frozenset(n.lower() for n in names)
    if names <= compiled.dynamic_params:
        return compiled
    want = compiled.dynamic_params | names
    cache = compiled.__dict__.setdefault("_dyn_variants", {})
    if want not in cache:
        cache[want] = CompiledCircuit(compiled.circuit, dtype=compiled.dtype,
                                      device=compiled.device,
                                      dynamic_params=want,
                                      sparse=compiled.sparse_mode,
                                      eval_dtype=compiled.eval_dtype)
    return cache[want]
