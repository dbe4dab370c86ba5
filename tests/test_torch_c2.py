"""ROADMAP Queue C, C2: where the port's and the reference's mixed chord
paths part on the 2-lane DFF over 0-1 ns (W·0.99 lane: 82 Newton
iterations in the port, 55 in the reference, the same accepted and
rejected steps).

The runs part at the very first factor, in one 2×2 block of the W·0.99
lane's Jacobian (``x_tp6.mp``'s drain and source, 2e-14 V apart).  The
reference evaluates its model under ``jax.jit`` there; this test holds the
port to the same JAX function evaluated op by op, at the first chord
step's state and time.  That the compiled evaluation differs from the op
by op one is a property of the JAX compiler, not of the port, so it is
recorded in ROADMAP Queue C (C2) and not asserted here.
"""

import os

import numpy as np
import torch

import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.benchmarks import kernel_times as kt

DFF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "benchmarks", "gf180_dff")


def test_c2_port_equals_the_reference_eval_op_by_op():
    comp, _, pb, x0 = kt.dff_lanes(torch, T, "cpu", lanes=2)
    with open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")) as f:
        text = f.read()
    cj = J.compile_circuit(J.elaborate(
        J.parse_spice(text, file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]))
    key = [k for k in cj.group_order if "bsim4" in k.lower()][0]
    p0 = dict(cj.params0)
    p0[key] = dict(p0[key], W=p0[key]["W"] * 0.99)
    # the first chord step of the W·0.99 lane: its warm DC, t = h0
    ctx = J.SimSpec.make(gmin=1e-15).with_mode("tran").at_time(1e-15)
    eager = [np.asarray(a) for a in cj.res_jacs_fwd(
        jnp.asarray(x0[0].numpy()), ctx, p0)]
    port = [a.numpy() for a in comp.res_jacs_fwd(
        x0[0], T.SimSpec.make(gmin=1e-15).with_mode("tran").at_time(1e-15),
        {k: {pn: v[0] for pn, v in g.items()} for k, g in pb.items()})]
    # the same (S, Q, G, C), x_tp6.mp's drain-source block included
    for a, b in zip(port, eager):
        assert np.abs(a - b).max() <= 1e-18
