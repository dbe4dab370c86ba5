"""Where the card's float64 arithmetic rounds apart from the CPU's, and
where that parts the sine-driven history line's grid (ROADMAP C13).

- ``pow`` at the step controller's exponents (−1/3, −1/4, −1/5) on
  100,000 seeded arguments in [1e-6, 10], and ``sin`` on the arguments
  2πF·t of the line's accepted times on the CPU: how many results differ
  in their bits between CUDA and the CPU;
- the refinement's row sums ``(J * x).sum(-1)`` ([64, n, n] seeded, n in
  4-25) and the ring lookup (``tran.ring_interp``) on both;
- the history line (``delay_latch.delay_line``, 8 lanes, 0-8 µs) on the
  card through B2/B3 and on the CPU through their plain versions: the
  first accepted step where a lane's time or state differs, with the
  states before it.

    python -m cedarsim_tpu_torch.benchmarks.card_rounding

prints one JSON line (a CUDA card is required).
"""

from __future__ import annotations

import json
import sys

import numpy as np


def main():
    import torch
    import cedarsim_tpu_torch as T
    from cedarsim_tpu_torch.analysis.tran import ring_interp
    from cedarsim_tpu_torch.benchmarks import delay_latch as dl
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    from cedarsim_tpu_torch.devices import waveforms
    if not torch.cuda.is_available():
        raise SystemExit("card_rounding: no CUDA device")
    out = {"card": kt.smi()}
    runs = {}
    for dev, dense_lu in (("cuda", "auto"), ("cpu", "mixed")):
        comp = dl.delay_line(dev)
        runs[dev] = T.tran(comp, (0.0, dl.LINE_TSTOP),
                           params=dl.rl_lanes(comp, 8),
                           opts=T.TranOptions(**dl.LINE_OPTS,
                                              dense_lu=dense_lu))
    first = []
    for a, b in zip(runs["cuda"], runs["cpu"]):
        n = min(len(a.ts), len(b.ts))
        diff = np.nonzero((a.ts[:n] != b.ts[:n])
                          | (np.abs(a.xs[:n] - b.xs[:n]).max(1) > 0))[0]
        i = int(diff[0]) if len(diff) else -1
        first.append(dict(step=i, t_card=float(a.ts[i]),
                          t_cpu=float(b.ts[i]),
                          states_before_equal=bool(
                              np.array_equal(a.xs[i - 1], b.xs[i - 1]))))
    out["first_parting"] = first
    out["counts"] = {d: [sum(s.n_accepted for s in r),
                         sum(s.n_rejected for s in r)]
                     for d, r in runs.items()}
    ts = torch.as_tensor(np.concatenate([s.ts for s in runs["cpu"]]))
    sin_card = waveforms.sin_value(0.0, 1.0, dl.LINE_F, 0.0, 0.0, 0.0,
                                   ts.cuda()).cpu()
    sin_cpu = waveforms.sin_value(0.0, 1.0, dl.LINE_F, 0.0, 0.0, 0.0, ts)
    out["sin_differ"] = [int((sin_card != sin_cpu).sum()), ts.numel()]
    rng = np.random.default_rng(0)
    e = torch.as_tensor(rng.uniform(1e-6, 10.0, 100_000))
    out["pow_differ"] = {f"{p:.4f}": int(((e.cuda() ** p).cpu()
                                          != e ** p).sum())
                         for p in (-1.0 / 3.0, -0.25, -0.2)}
    rows = {}
    for n in (4, 5, 12, 21, 25):
        J = torch.as_tensor(rng.standard_normal((64, n, n)))
        x = torch.as_tensor(rng.standard_normal((64, n)))
        rows[n] = int(((J.cuda() * x.cuda()[:, None, :]).sum(-1).cpu()
                       != (J * x[:, None, :]).sum(-1)).sum())
    out["row_sum_differ_of_64n"] = rows
    tr = torch.as_tensor(np.sort(rng.uniform(0.0, 1.0, (8, 512)), 1))
    ur = torch.as_tensor(rng.standard_normal((8, 512, 3)))
    q = torch.as_tensor(rng.uniform(0.0, 1.0, (8, 3)))
    out["ring_interp_differ"] = int(
        (ring_interp(q.cuda(), tr.cuda(), ur.cuda()).cpu()
         != ring_interp(q, tr, ur)).sum())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
