"""Why cell G-xla runs slower beside the smoke's other processes (ROADMAP
C15): its ``tran`` over a short window, alone on the card and beside one
neighbour process of each kind, in turns on one card.

Cell G-xla (``cmg_dff.run("xla")``: 32 lanes, two eager BSIM-CMG walks a
chord iteration, B2/B3) is host-bound: thousands of small launches and a
host synchronisation every iteration.  Two neighbours can slow it:

* ``card``: a process that keeps the card busy with small kernels and a
  synchronisation after each (a 64 × 64 float64 matmul, as the smoke's
  other processes launch small kernels): the card time-slices between
  the two processes' contexts, so each of G-xla's launches may wait for
  the other's slice;
* ``cpu``: a process that keeps one host core busy in Python and never
  touches the card (no CUDA context);
* ``cpu_all``: a process that keeps every host core busy through
  PyTorch's intra-op threads (float64 matmuls on the CPU, as the smoke's
  CPU comparisons run with the default thread count), no CUDA context;
* ``card3``: three ``card`` neighbours at once.

The runs go over 0-``TSTOP``, alone and beside each neighbour in turns,
twice, then alone; each prints its ``tran`` wall and counts (the counts
must not move).  One JSON line at the end with every run, the card's
name and power limit.

    python -m cedarsim_tpu_torch.benchmarks.card_sharing
"""

from __future__ import annotations

import json
import subprocess
import sys

#: cell G-xla's window here: 36 step attempts, ~15 s alone on an H100
TSTOP = 5e-9
#: the neighbour kinds, in the order they run
BESIDE = ("card", "cpu", "card3", "cpu_all")
#: the neighbours, as programs for ``python -c``; each prints one line
#: once it is busy, then runs until it is killed
NEIGHBOURS = {
    "card": (
        "import torch\n"
        "x = torch.randn(64, 64, dtype=torch.float64, device='cuda')\n"
        "torch.cuda.synchronize()\n"
        "print('busy', flush=True)\n"
        "while True:\n"
        "    for _ in range(8):\n"
        "        x = (x @ x).clamp_(-1.0, 1.0)\n"
        "    torch.cuda.synchronize()\n"),
    "cpu": (
        "print('busy', flush=True)\n"
        "n = 0\n"
        "while True:\n"
        "    n = (n * 1103515245 + 12345) % 2147483648\n"),
    "cpu_all": (
        "import os, torch\n"
        "torch.set_num_threads(os.cpu_count())\n"
        "x = torch.randn(512, 512, dtype=torch.float64)\n"
        "print('busy', flush=True)\n"
        "while True:\n"
        "    x = (x @ x).clamp_(-1.0, 1.0)\n"),
}


def start_neighbours(kind):
    """Start a neighbour (``card3``: three ``card`` ones) and wait until
    each reports busy; returns the processes."""
    procs = []
    for k in (["card"] * 3 if kind == "card3" else [kind]):
        p = subprocess.Popen([sys.executable, "-c", NEIGHBOURS[k]],
                             stdout=subprocess.PIPE, text=True)
        procs.append(p)
        if p.stdout.readline().strip() != "busy":
            for q in procs:
                q.kill()
            raise RuntimeError(f"the {k} neighbour did not start")
    return procs


def main():
    import torch
    from cedarsim_tpu_torch.benchmarks import cmg_dff
    if not torch.cuda.is_available():
        raise SystemExit("card_sharing: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dff, setup_s = cmg_dff.setup(device=dev)
    cmg_dff.run("xla", 1e-11, dff=dff)      # warm-up: libraries, caches
    runs = []
    order = ["alone", *BESIDE] * 2 + ["alone"]
    for beside in order:
        procs = [] if beside == "alone" else start_neighbours(beside)
        try:
            r = cmg_dff.run("xla", TSTOP, dff=dff)
        finally:
            for p in procs:
                p.kill()
                p.wait()
        runs.append(dict(beside=beside, tran_s=r["wall_s"],
                         counts=[r["accepted"], r["rejected"], r["newton"],
                                 r["attempts"]],
                         ms_per_attempt=1e3 * r["wall_s"] / r["attempts"]))
        print(json.dumps(runs[-1]), flush=True)
    if len({tuple(r["counts"]) for r in runs}) != 1:
        raise AssertionError(f"the counts moved between runs: {runs}")
    by = {k: [r["tran_s"] for r in runs if r["beside"] == k]
          for k in ("alone", *BESIDE)}
    print(json.dumps({"card": card, "tstop": TSTOP, "setup_s": setup_s,
                      "runs": runs, "tran_s": by,
                      "slowdown": {k: min(v) / min(by["alone"])
                                   for k, v in by.items()}}))


if __name__ == "__main__":
    main()
