"""The BSIM-CMG ring oscillator's counts on the CPU, the port's and the JAX
package's, and where the two runs part (ROADMAP Queue C, C8).

    JAX_PLATFORMS=cpu python tests/cmg_ring_counts.py --tstop 5e-10

The circuit and options are ``tests/test_bsimcmg.py::
test_cmg_ring_oscillator``'s (3 stages, ``TranOptions(max_steps=4096)``,
the DC through ``NewtonOptions(gmin_steps=2, src_steps=2, restarts=0)``).
One JSON object is printed: each package's (accepted, rejected, Newton)
and wall, the largest difference of the two operating points, and the
first step at which the two time grids differ.  Over 0-0.5 ns this takes
minutes: the port walks the model eagerly (ROADMAP A20).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def ring(pkg, cls):
    """``test_cmg_ring_oscillator``'s circuit in package ``pkg``."""
    ckt = pkg.Circuit()
    vdd = ckt.net("vdd")
    ckt.add(pkg.VSource, "VDD", (vdd, ckt.gnd), dict(dc=1.0))
    nets = [ckt.net(f"n{i}") for i in range(3)]
    for i in range(3):
        inp, out = nets[i], nets[(i + 1) % 3]
        ckt.add(cls, f"MP{i}", (out, inp, vdd, vdd), dict(devtype=0, nfin=4))
        ckt.add(cls, f"MN{i}", (out, inp, ckt.gnd, ckt.gnd),
                dict(devtype=1, nfin=2))
        ckt.add(pkg.Capacitor, f"CL{i}", (out, ckt.gnd), dict(c=1e-15))
    ckt.ic("n0", 0.0)
    return ckt


def run(pkg, cls, tstop, **compile_kw):
    """(solution, wall s) of the ring's transient over 0-tstop."""
    t0 = time.perf_counter()
    comp = pkg.compile_circuit(ring(pkg, cls), **compile_kw)
    sol = pkg.tran(comp, (0.0, tstop), opts=pkg.TranOptions(max_steps=4096),
                   dc_opts=pkg.NewtonOptions(gmin_steps=2, src_steps=2,
                                             restarts=0))
    return sol, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tstop", type=float, default=5e-10)
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_platforms", "cpu")
    import cedarsim_tpu as J
    import cedarsim_tpu_torch as T
    from cedarsim_tpu.models import bsimcmg_class as j_cmg
    from cedarsim_tpu_torch.models import bsimcmg_class as t_cmg
    sj, wall_j = run(J, j_cmg(), args.tstop)
    st, wall_t = run(T, t_cmg(), args.tstop, device="cpu")
    tj, tt = np.asarray(sj.ts), np.asarray(st.ts)
    n = min(len(tj), len(tt))
    parted = np.nonzero(tj[:n] != tt[:n])[0]
    out = {"tstop": args.tstop,
           "fields": ["accepted", "rejected", "newton"],
           "port": [st.n_accepted, st.n_rejected, st.n_newton],
           "reference": [sj.n_accepted, sj.n_rejected, sj.n_newton],
           "port_s": wall_t, "reference_s": wall_j,
           "op_max_abs_diff_v": float(np.abs(np.asarray(sj.xs)[0]
                                             - np.asarray(st.xs)[0]).max()),
           "first_step_apart": int(parted[0]) if len(parted) else None}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.abspath(REPO))
    main()
