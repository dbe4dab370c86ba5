"""Solution export: CSV and standalone HTML plots.

Reference equivalents: CSV.write(file, sol) (ext/CedarSimCSVExt.jl),
PlotlyLight Plot(sol)/Cobweb.save HTML export of all observables via
``default_name_map`` (ext/CedarSimPlotlyLightExt.jl, util.jl:239-260).
The HTML here is fully self-contained (inline SVG, no external JS) since the
build environment has no network.

Copy of ``cedarsim_tpu/utils/export.py``, which needs no JAX: importing it from
the JAX package would run ``cedarsim_tpu/__init__.py`` and with it JAX.
Only the import lines differ from the original, and citations of the
reference simulator's sources drop their machine-specific path prefix.
"""

from __future__ import annotations

import html


def default_name_map(sol):
    """All top-level net voltages (the reference's default_name_map,
    reference/src/util.jl:239-260): name -> waveform array."""
    comp = sol.compiled
    return {name: sol[name] for name in comp.node_names
            if not name.startswith("__")}


def write_csv(path, sol, names=None):
    """CSV with a time column plus one column per observable."""
    cols = names or list(default_name_map(sol).keys())
    data = [sol[c] for c in cols]
    with open(path, "w") as f:
        f.write(",".join(["time"] + [f"v({c})" for c in cols]) + "\n")
        for i, t in enumerate(sol.ts):
            f.write(",".join([repr(float(t))]
                             + [repr(float(d[i])) for d in data]) + "\n")
    return path


_PALETTE = ["#4477AA", "#EE6677", "#228833", "#CCBB44", "#66CCEE",
            "#AA3377", "#BBBBBB", "#000000"]


def save_html(path, sol, names=None, title="cedarsim_tpu solution"):
    """Self-contained SVG line plot of the solution's observables."""
    series = names or list(default_name_map(sol).keys())
    W, H, PAD = 960, 480, 50
    ts = sol.ts
    t0, t1 = float(ts[0]), float(ts[-1]) or 1.0
    datas = {s: sol[s] for s in series}
    ymin = min(float(d.min()) for d in datas.values())
    ymax = max(float(d.max()) for d in datas.values())
    if ymax == ymin:
        ymax = ymin + 1.0
    yr = ymax - ymin

    def sx(t):
        return PAD + (t - t0) / (t1 - t0 or 1.0) * (W - 2 * PAD)

    def sy(v):
        return H - PAD - (v - ymin) / yr * (H - 2 * PAD)

    polys, legend = [], []
    for i, s in enumerate(series):
        color = _PALETTE[i % len(_PALETTE)]
        pts = " ".join(f"{sx(float(t)):.1f},{sy(float(v)):.1f}"
                       for t, v in zip(ts, datas[s]))
        polys.append(f'<polyline fill="none" stroke="{color}" '
                     f'stroke-width="1.5" points="{pts}"/>')
        legend.append(f'<tspan x="{W-PAD+6}" dy="16" fill="{color}">'
                      f'{html.escape(s)}</tspan>')
    axes = (f'<line x1="{PAD}" y1="{H-PAD}" x2="{W-PAD}" y2="{H-PAD}" '
            f'stroke="#888"/>'
            f'<line x1="{PAD}" y1="{PAD}" x2="{PAD}" y2="{H-PAD}" '
            f'stroke="#888"/>'
            f'<text x="{PAD}" y="{H-PAD+20}" font-size="11">{t0:.3g}s</text>'
            f'<text x="{W-PAD-40}" y="{H-PAD+20}" font-size="11">'
            f'{t1:.3g}s</text>'
            f'<text x="4" y="{sy(ymax)+4}" font-size="11">{ymax:.3g}</text>'
            f'<text x="4" y="{sy(ymin)+4}" font-size="11">{ymin:.3g}</text>')
    doc = (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
           f"<title>{html.escape(title)}</title></head><body>"
           f"<h3>{html.escape(title)}</h3>"
           f'<svg width="{W+140}" height="{H}" '
           f'font-family="sans-serif">{axes}{"".join(polys)}'
           f'<text font-size="12">{"".join(legend)}</text></svg>'
           f"</body></html>")
    with open(path, "w") as f:
        f.write(doc)
    return path
