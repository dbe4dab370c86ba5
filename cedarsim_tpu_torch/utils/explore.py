"""Interactive parameter exploration (counterpart of
``cedarsim_tpu/utils/explore.py``): the reference's ``explore()`` slider UI
(reference/ext/CedarSimMakieExt.jl), with the whole slider grid simulated
up front.

Every combination of slider values is one lane of the port's lane-batched
transient (``tran_core`` after ``resolve_impl``, as ``tran`` runs a call
with a lane axis: on the CUDA card the fused chord kernel B1 or the GESP
pair B2/B3, on the CPU their plain versions), on the compiled circuit's
device; no ``vmap``.  As in the JAX package, the lanes start from one TRANOP
operating point and its ẋ0 at the nominal params.  The output is a
self-contained HTML file whose sliders select the precomputed lane
client-side (the JAX package's writer, unchanged).
"""

from __future__ import annotations

import html
import itertools
import json

import numpy as np
import torch

_PALETTE = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e",
            "#8c564b", "#e377c2", "#7f7f7f"]


def explore(compiled, tspan, sliders, observables, path="explore.html",
            ctx=None, opts=None, n_samples=400, max_lanes=4096,
            title="cedarsim_tpu explore"):
    """Simulate every combination of ``sliders`` values as one lane-batched
    transient and write an interactive HTML viewer.

    ``sliders``: {dotted-param-name: sequence of values}; the product grid
    becomes the lane axis.  ``observables``: names ``compiled.observe``
    reads (nets, currents, VA variables).  Returns ``path``."""
    from cedarsim_tpu_torch.core.context import SimSpec, Modes
    from cedarsim_tpu_torch.core.compile import ensure_dynamic
    from cedarsim_tpu_torch.analysis.dc import solve_dc
    from cedarsim_tpu_torch.analysis.tran import (TranOptions, tran_core,
                                                  resolve_impl,
                                                  xdot0_and_mask)

    names = list(sliders)
    grids = [np.asarray(sliders[k], dtype=float) for k in names]
    combos = list(itertools.product(*grids))
    if len(combos) > max_lanes:
        raise ValueError(f"slider grid has {len(combos)} lanes "
                         f"(> max_lanes={max_lanes}); coarsen the grid")
    nb = len(combos)

    compiled = ensure_dynamic(compiled, names)
    ctx = ctx or SimSpec.make()
    opts = opts or TranOptions()
    t0, tstop = float(tspan[0]), float(tspan[1])
    dev = compiled.device

    # the lanes' params: assembled on the host, then one copy to the device
    pb = {key: {pn: np.repeat(np.asarray(v.cpu())[None], nb, 0)
                for pn, v in grp.items()}
          for key, grp in compiled.params0.items()}
    for j, combo in enumerate(combos):
        for k, v in zip(names, combo):
            _set_lane(compiled, pb, j, k, v)
    pb = {key: {pn: torch.as_tensor(v, device=dev) for pn, v in grp.items()}
          for key, grp in pb.items()}

    op = solve_dc(compiled, ctx=ctx, mode=Modes.TRANOP)
    xd0, mask = xdot0_and_mask(compiled, op.x[None],
                               ctx.with_mode(Modes.TRANOP), compiled.params0)
    bps = compiled.breakpoints(tstop)
    bps = np.concatenate([bps[bps > t0], [tstop], [np.inf]])
    opts = resolve_impl(compiled, opts, ctx, pb, batched=True)
    ts, xs, xds, k = tran_core(
        compiled, pb, ctx, op.x[None].expand(nb, -1).contiguous(),
        xd0.expand(nb, -1).contiguous(), t0, tstop, bps,
        (tstop - t0) * 1e-6, opts, mask[0])[:4]

    # every lane's observables sampled onto a uniform grid
    tgrid = np.linspace(t0, tstop, n_samples)
    ctx_t = ctx.with_mode(Modes.TRAN)
    kh = k.cpu().numpy()
    ts_h = ts.cpu().numpy()
    data = {name: np.empty((nb, n_samples)) for name in observables}
    for lane in range(nb):
        m = int(kh[lane])
        p = {key: {pn: v[lane] for pn, v in grp.items()}
             for key, grp in pb.items()}
        at = ctx_t.at_time(ts[lane, :m])
        for name in observables:
            vals = compiled.observe(name)(xs[lane, :m], xds[lane, :m], at, p)
            data[name][lane] = np.interp(tgrid, ts_h[lane, :m],
                                         vals.cpu().numpy())
    _write_html(path, title, names, grids, tgrid, data)
    return path


def _set_lane(compiled, pb, lane, dotted, value):
    """Write one slider value into lane ``lane`` of the host-side params
    (in place).  A bare name sets every instance carrying the parameter
    (``set_param``'s meaning)."""
    if "." in dotted:
        gkey, j, pname = compiled.param_loc(dotted)
        pb[gkey][pname][lane, j] = value
        return
    pname = dotted.lower()
    hit = False
    for gkey in compiled.group_order:
        if pname in pb[gkey]:
            pb[gkey][pname][lane] = value
            hit = True
    if not hit:
        raise KeyError(f"no instance has parameter {pname!r}")


def _write_html(path, title, names, grids, tgrid, data):
    W, H, PAD = 900, 420, 48
    payload = {
        "names": names,
        "grids": [g.tolist() for g in grids],
        "t": tgrid.tolist(),
        "series": {k: np.round(v, 9).tolist() for k, v in data.items()},
        "palette": _PALETTE,
    }
    sliders_html = "".join(
        f'<div><label>{html.escape(n)}: '
        f'<span id="v{i}">{grids[i][0]:g}</span></label> '
        f'<input type="range" id="s{i}" min="0" max="{len(grids[i])-1}" '
        f'value="0" step="1" style="width:300px"></div>'
        for i, n in enumerate(names))
    doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>{html.escape(title)}</title></head>
<body style="font-family:sans-serif">
<h3>{html.escape(title)}</h3>
{sliders_html}
<svg id="plot" width="{W + 160}" height="{H}"></svg>
<script>
const D = {json.dumps(payload)};
const W = {W}, H = {H}, PAD = {PAD};
const sizes = D.grids.map(g => g.length);
function laneIndex() {{
  let lane = 0;
  for (let i = 0; i < sizes.length; i++) {{
    const v = +document.getElementById('s' + i).value;
    document.getElementById('v' + i).textContent = D.grids[i][v].toPrecision(4);
    lane = lane * sizes[i] + v;
  }}
  return lane;
}}
function draw() {{
  const lane = laneIndex();
  const svg = document.getElementById('plot');
  const t0 = D.t[0], t1 = D.t[D.t.length - 1];
  let ymin = Infinity, ymax = -Infinity;
  const keys = Object.keys(D.series);
  for (const k of keys) {{
    for (const v of D.series[k][lane]) {{
      if (v < ymin) ymin = v;
      if (v > ymax) ymax = v;
    }}
  }}
  if (ymax === ymin) ymax = ymin + 1;
  const sx = t => PAD + (t - t0) / (t1 - t0) * (W - 2 * PAD);
  const sy = v => H - PAD - (v - ymin) / (ymax - ymin) * (H - 2 * PAD);
  let out = `<line x1="${{PAD}}" y1="${{H - PAD}}" x2="${{W - PAD}}" ` +
    `y2="${{H - PAD}}" stroke="#888"/>` +
    `<line x1="${{PAD}}" y1="${{PAD}}" x2="${{PAD}}" y2="${{H - PAD}}" ` +
    `stroke="#888"/>` +
    `<text x="${{PAD}}" y="${{H - PAD + 18}}" font-size="11">` +
    `${{t0.toPrecision(3)}}s</text>` +
    `<text x="${{W - PAD - 40}}" y="${{H - PAD + 18}}" font-size="11">` +
    `${{t1.toPrecision(3)}}s</text>` +
    `<text x="4" y="${{sy(ymax) + 4}}" font-size="11">` +
    `${{ymax.toPrecision(3)}}</text>` +
    `<text x="4" y="${{sy(ymin) + 4}}" font-size="11">` +
    `${{ymin.toPrecision(3)}}</text>`;
  keys.forEach((k, i) => {{
    const pts = D.t.map((t, j) =>
      `${{sx(t).toFixed(1)}},${{sy(D.series[k][lane][j]).toFixed(1)}}`
    ).join(' ');
    const col = D.palette[i % D.palette.length];
    out += `<polyline fill="none" stroke="${{col}}" stroke-width="1.5" ` +
      `points="${{pts}}"/>`;
    out += `<text x="${{W - PAD + 8}}" y="${{PAD + 16 * (i + 1)}}" ` +
      `font-size="12" fill="${{col}}">${{k}}</text>`;
  }});
  svg.innerHTML = out;
}}
for (let i = 0; i < sizes.length; i++)
  document.getElementById('s' + i).addEventListener('input', draw);
draw();
</script></body></html>"""
    with open(path, "w") as f:
        f.write(doc)
