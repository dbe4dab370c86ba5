"""Netlist in, results out — counterpart of ``cedarsim_tpu/api.py`` for the
operating point (``.op``), the transient (``.tran``), the batched DC sweep
(``.dc``), the AC and noise analyses (``.ac``, ``.noise``), ``.measure``
and ``.four``.

:func:`simulate` parses and elaborates a SPICE netlist, compiles it on the
card (or on ``device``), and runs the analyses its directives ask for, in
their order, as the JAX package's ``simulate`` does: ``.tran`` with its
``tstop`` and ``tmax`` (the step cap), ``uic``, and ``.options
method=trap|gear maxord=``; ``.dc src start stop step [src2 ...]`` as one
batched ``dc_sweep`` over the product of the sources' values; ``.noise
v(out) src dec n f1 f2`` and ``.ac dec|lin n f1 f2``; then every
``.meas`` card against the analyses that ran, and ``.four`` on the
transient.  ``mc_seed`` seeds the netlist's ``agauss``-style draws and
a Spectre ``statistics`` block's.  A netlist without an analysis gets its
operating point.  Spectre text (``simulator lang=spectre``, a ``.scs``
file or ``dialect="spectre"``) parses through ``frontend/spectre.py``.
Spectre ``altergroup``/``alter`` statements split the run into segments:
the analyses after an alter see the altered parameters (each segment is
elaborated again with the altergroup bodies spliced in), under keys
``"<analysis>@<label>"``; a device-targeted ``alter`` (``dev=r1
param=r value=2k``) recompiles with that parameter dynamic
(``ensure_dynamic``) and runs with the new value.  ``.save``/``.probe``
targets that are nets keep only those columns of the transient
(``TranOptions.store_vars``).
"""

from __future__ import annotations

import numpy as np

from cedarsim_tpu_torch.analysis import ac as ac_mod
from cedarsim_tpu_torch.analysis.dc import solve_dc
from cedarsim_tpu_torch.analysis.measure import evaluate_all, fourier
from cedarsim_tpu_torch.analysis.sweeps import Sweep, ProductSweep, dc_sweep
from cedarsim_tpu_torch.analysis.tran import TranOptions, tran
from cedarsim_tpu_torch.core.compile import (compile_circuit, default_ctx,
                                             ensure_dynamic)
from cedarsim_tpu_torch.frontend import parser as P
from cedarsim_tpu_torch.frontend.elaborate import elaborate
from cedarsim_tpu_torch.frontend.parser import parse_spice
from cedarsim_tpu_torch.frontend.spectre import parse_mixed


def find_tran_directive(circuit):
    """(tstep, tstop, tstart, hmax, uic) from the netlist ``.tran``, or
    None."""
    for cmd, args, kw in circuit.directives:
        if cmd == "tran":
            nums = [a for a in args if isinstance(a, (int, float))]
            uic = any(isinstance(a, str) and a.lower() == "uic" for a in args)
            tstep = nums[0] if len(nums) > 0 else None
            tstop = nums[1] if len(nums) > 1 else (nums[0] if nums else None)
            tstart = nums[2] if len(nums) > 2 else 0.0
            hmax = nums[3] if len(nums) > 3 else None
            return dict(tstep=tstep, tstop=tstop, tstart=tstart, hmax=hmax,
                        uic=uic)
    return None


class _HostView:
    """A result whose observables read as host numpy arrays."""

    def __init__(self, res):
        self.res = res

    def __getitem__(self, name):
        return self.res[name].cpu().numpy()


def find_ac_directive(circuit):
    """(mode, n, fstart, fstop) from the netlist ``.ac``, or None."""
    for cmd, args, kw in circuit.directives:
        if cmd == "ac":
            mode = args[0] if args and isinstance(args[0], str) else "dec"
            nums = [a for a in args if isinstance(a, (int, float))]
            n, f1, f2 = int(nums[0]), nums[1], nums[2]
            return dict(mode=mode.lower(), n=n, fstart=f1, fstop=f2)
    return None


_ANALYSIS_CMDS = ("op", "tran", "dc", "ac", "noise")


def _as_name(v):
    if isinstance(v, tuple) and len(v) == 2 and v[0] == "ref":
        return str(v[1])
    return str(v)


def _alter_segments(stmts):
    """Split a statement list at altergroup/alter statements.  Returns None
    when there are no alters, else a list of (stmt_list, label): segment k
    holds every statement that is not an analysis, the bodies of alters
    0..k-1 spliced at their own positions (the sequential collection of
    params and models lets later definitions win), and only segment k's
    analyses."""

    def is_alter(st):
        return isinstance(st, P.Control) and st.cmd in ("altergroup",
                                                        "alterstmt")

    alters = [i for i, st in enumerate(stmts) if is_alter(st)]
    if not alters:
        return None
    bounds = [-1] + alters + [len(stmts) + 1]
    segs = []
    for k in range(len(alters) + 1):
        lo, hi = bounds[k], bounds[k + 1]
        seg = []
        for i, st in enumerate(stmts):
            if is_alter(st):
                if i <= lo:
                    if st.cmd == "altergroup":
                        seg.extend(st.args[1])
                    else:
                        seg.append(st)   # device alter: applied after
                continue
            if isinstance(st, P.Control) and st.cmd in _ANALYSIS_CMDS:
                if lo < i < hi:
                    seg.append(st)
                continue
            seg.append(st)
        label = _as_name(stmts[alters[k - 1]].args[0]) if k else None
        segs.append((seg, label))
    return segs


def save_targets(circuit):
    """The ``store_vars`` of a netlist's ``.save``/``.probe`` cards, or
    None: only saved vectors are kept (ngspice's meaning), O(steps ·
    len(save)) memory instead of O(steps · n_x); ``all`` or a current
    probe (``.save i(v1)``, not a state column) keeps the whole state."""
    saved = []
    for cmd, args, _ in circuit.directives:
        if cmd == "save":
            for t in args:
                if t == "all" or t.endswith(".i"):
                    return None
                saved.append(t)
    return tuple(dict.fromkeys(saved)) or None


def tran_options(circuit):
    """The :class:`TranOptions` a netlist's ``.tran`` and ``.options``
    ask for (the JAX package's rules): the step cap from ``tmax``, or
    near ``tstep`` (at most 5·tstep, at most span/25) without it; ``uic``;
    ``method=trap``, or ``method=gear``: BDF, ``maxord`` 2 (the
    default) the bdf2 ladder, 3 bdf3, 4 and above the order-5 ladder;
    ``store_vars`` from ``.save``/``.probe`` (:func:`save_targets`)."""
    d = find_tran_directive(circuit)
    okw = {}
    span = max(d["tstop"] - (d["tstart"] or 0.0), 1e-30)
    if d["hmax"]:
        okw["hmax_frac"] = d["hmax"] / span
    elif d.get("tstep"):
        okw["hmax_frac"] = min(0.04, 5.0 * d["tstep"] / span)
    if d["uic"]:
        okw["uic"] = True
    o = getattr(circuit, "options", {}) or {}
    m = str(o.get("method", "")).lower()
    if m in ("trap", "trapezoidal"):
        okw["method"] = "trap"
    elif m == "gear":
        mo = int(o.get("maxord", 2))
        okw["method"] = ("bdf2" if mo <= 2
                         else "bdf3" if mo == 3 else "bdf5")
    store = save_targets(circuit)
    if store is not None:
        okw["store_vars"] = store
    return TranOptions(**okw)


def dc_directive_sweep(args):
    """The sweep of a ``.dc src start stop step [src2 start2 ...]`` card's
    arguments (the JAX package's reading): each source's ``dc`` over
    ``arange(start, stop + step/2, step)``, a product of the sources; None
    when the arguments name no source."""
    sweeps = []
    i = 0
    while i < len(args):
        if not isinstance(args[i], str):
            break
        src = args[i].lower()
        nums = args[i + 1:i + 4]
        if len(nums) < 3 or any(isinstance(a, str) for a in nums):
            break
        start, stop, step = nums
        vals = np.arange(start, stop + step * 0.5, step)
        sweeps.append(Sweep(src if src.endswith(".dc") else src + ".dc",
                            vals))
        i += 4
    if not sweeps:
        return None
    return sweeps[0] if len(sweeps) == 1 else ProductSweep(*sweeps)


def simulate(text_or_circuit, include_paths=(), params=None, temp=None,
             tran_opts: TranOptions = None, file="<netlist>", mc_seed=None,
             dialect=None, device=None, eval_dtype=None):
    """Run the analyses requested by the netlist's directives.

    ``text_or_circuit``: SPICE or Spectre netlist text, or an elaborated
    ``Circuit``.  ``dialect``: "spice", "spectre", or None to detect it
    (``simulator lang=`` or a ``.scs`` file name selects Spectre).
    ``device``: where the circuit is compiled and solved (by default the
    CUDA card; ``"cpu"`` runs the kernels' plain versions).  Returns a dict
    with the ``circuit``, the ``compiled`` circuit and, as the directives
    ask, ``"op"`` (a DC result), ``"tran"`` (a ``TranSolution``),
    ``"dc"`` (a batched DC result, one lane per point) with ``"dc_sweep"``
    (its points), ``"ac"`` (an ``ACSolution``), ``"noise"`` (a
    ``NoiseSolution``), ``"measures"`` (name → value) and ``"fourier"``
    (name → harmonics); the analyses after an ``altergroup``/``alter``
    statement under suffixed keys (``"tran@<name>"``).  ``mc_seed`` seeds
    the elaboration's Monte-Carlo draws.  ``eval_dtype``: the model
    evaluations' dtype (``compile_circuit``'s; default float64)."""
    if isinstance(text_or_circuit, str):
        text = text_or_circuit
        if dialect not in (None, "spice", "spectre"):
            raise ValueError(f"unknown dialect {dialect!r}")
        if dialect is None:
            dialect = ("spectre" if "simulator lang" in text.lower()
                       or str(file).endswith(".scs") else "spice")
        if dialect == "spectre" or "simulator lang" in text.lower():
            nl = parse_mixed(text, file=file, start_lang=dialect)
        else:
            nl = parse_spice(text, file=file)
        segs = _alter_segments(nl.statements)
        if segs is not None:
            out = {}
            for k, (stmts, label) in enumerate(segs):
                circuit = elaborate(P.SpiceNetlist(nl.title, stmts, nl.path),
                                    include_paths=include_paths,
                                    params=params, mc_seed=mc_seed)
                res = _run_circuit(circuit, temp, tran_opts, device,
                                   eval_dtype)
                if k == 0:
                    out.update(res)
                else:
                    sfx = label or f"alter{k}"
                    out.update({f"{key}@{sfx}": v for key, v in res.items()})
            return out
        circuit = elaborate(nl, include_paths=include_paths, params=params,
                            mc_seed=mc_seed)
    else:
        circuit = text_or_circuit
    return _run_circuit(circuit, temp, tran_opts, device, eval_dtype)


def _run_circuit(circuit, temp=None, tran_opts=None, device=None,
                 eval_dtype=None):
    compiled = compile_circuit(circuit, device=device, eval_dtype=eval_dtype)
    run_params = None
    # device-targeted alter statements (a1 alter dev=r1 param=r value=2k)
    for cmd, args, kw in circuit.directives:
        if cmd == "alterstmt" and "dev" in kw and "param" in kw:
            dotted = f"{_as_name(kw['dev'])}.{_as_name(kw['param'])}".lower()
            compiled = ensure_dynamic(compiled, [dotted])
            run_params = compiled.set_param(
                run_params if run_params is not None else compiled.params0,
                dotted, float(kw.get("value", 0.0)))
    ctx = default_ctx(compiled, temp_c=temp)
    out = {"circuit": circuit, "compiled": compiled}
    ran_any = False
    bias = {}

    def ac_bias():
        """``.ac`` and ``.noise`` bias at one DC operating point."""
        if "x" not in bias:
            bias["x"] = solve_dc(compiled, params=run_params, ctx=ctx).x
        return bias["x"]
    for cmd, args, kw in circuit.directives:
        if cmd == "op" and "op" not in out:
            out["op"] = solve_dc(compiled, params=run_params, ctx=ctx)
            ran_any = True
        elif cmd == "tran" and "tran" not in out:
            d = find_tran_directive(circuit)
            opts = tran_opts if tran_opts is not None else \
                tran_options(circuit)
            out["tran"] = tran(compiled, (0.0, d["tstop"]), params=run_params,
                               ctx=ctx, opts=opts)
            ran_any = True
        elif cmd == "dc" and "dc" not in out and args:
            sw = dc_directive_sweep(args)
            if sw is not None:
                out["dc"] = dc_sweep(compiled, sw, params=run_params,
                                     ctx=ctx)
                out["dc_sweep"] = sw
                ran_any = True
        elif cmd == "noise" and "noise" not in out:
            # .noise v(out) src dec n f1 f2
            words = [a for a in args if isinstance(a, str)]
            nums = [a for a in args if isinstance(a, (int, float))]
            outname = words[0].lower() if words else None
            if outname in ("v",) and len(words) > 1:
                outname = words[1].lower()
            n_, f1, f2 = ((int(nums[0]), nums[1], nums[2])
                          if len(nums) >= 3 else (10, 1.0, 1e9))
            out["noise"] = ac_mod.noise(
                compiled, outname, ac_mod.acdec(n_, f1, f2),
                params=run_params, ctx=ctx,
                x_op=ac_bias() if compiled.n_eps else None)
            ran_any = True
        elif cmd == "ac" and "ac" not in out:
            d = find_ac_directive(circuit)
            if d["mode"] == "dec":
                freqs = ac_mod.acdec(d["n"], d["fstart"], d["fstop"])
            else:
                freqs = np.linspace(d["fstart"], d["fstop"], d["n"])
            out["ac"] = ac_mod.ac(compiled, freqs, params=run_params,
                                  ctx=ctx, x_op=ac_bias())
            ran_any = True
    if not ran_any:
        out["op"] = solve_dc(compiled, params=run_params, ctx=ctx)
    # .measure against whichever analyses ran (tran, ac, dc); a DC sweep's
    # observables are read on the host, as the copied evaluator wants
    view = dict(out)
    if "dc" in out:
        view["dc"] = _HostView(out["dc"])
    meas = evaluate_all(view, circuit)
    if meas:
        out["measures"] = meas
    if "tran" in out:
        for cmd, args, kw in circuit.directives:
            if cmd == "four" and args:
                names = []
                rest = [str(a) for a in args[1:]]
                i = 0
                while i < len(rest):
                    if rest[i].lower() in ("v", "i") and i + 1 < len(rest):
                        names.append(f"{rest[i]}({rest[i + 1]})")
                        i += 2
                    else:
                        names.append(rest[i])
                        i += 1
                out.setdefault("fourier", {}).update(
                    fourier(out["tran"], float(args[0]), names))
    return out
