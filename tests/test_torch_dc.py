"""The port's DC operating point (cedarsim_tpu_torch/analysis/dc.py) against
the JAX package's ``solve_dc`` on the gf180 DFF testbench (≤ 1e-9 V), a
closed-form divider, and lane independence of the batched ``dc_core``."""

import dataclasses
import os

import numpy as np
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.analysis.dc import dc_core

DFF_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                       "gf180_dff")


def _dff_text():
    with open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")) as f:
        return f.read()


def test_dff_tranop_matches_jax():
    text = _dff_text()
    cj = J.compile_circuit(J.elaborate(
        J.parse_spice(text, file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]))
    ct = T.compile_circuit(T.elaborate(
        T.parse_spice(text, file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]))
    rj = J.solve_dc(cj, ctx=J.SimSpec.make(gmin=1e-15), mode="tranop",
                    artifact_cache=False)
    rt = T.solve_dc(ct, ctx=T.SimSpec.make(gmin=1e-15), mode="tranop")
    assert bool(np.asarray(rj.converged)) and bool(rt.converged)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-9)
    assert abs(float(rt["q"]) - float(np.asarray(rj["q"]))) <= 1e-9


def test_divider_closed_form():
    text = """* divider
V1 in 0 3.0
R1 in mid 1k
R2 mid 0 2k
.end
"""
    ct = T.compile_circuit(T.elaborate(T.parse_spice(text)))
    r = T.solve_dc(ct)
    assert bool(r.converged)
    # 1e-12 S of gmin on every node pulls mid down by ~1.3e-9 V
    assert abs(float(r["mid"]) - 2.0) < 1e-8
    assert abs(float(r["v1.I"]) + 1e-3) < 1e-11


def test_dc_lanes_are_independent():
    """Per-lane warm DC (bench.py's light continuation) over a W scatter:
    each lane equals the same solve run alone."""
    ct = T.compile_circuit(T.elaborate(
        T.parse_spice(_dff_text(), file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]))
    ctx = T.SimSpec.make(gmin=1e-15)
    op = T.solve_dc(ct, ctx=ctx, mode="tranop")
    key = [k for k in ct.group_order if "bsim4" in k.lower()][0]
    light = dataclasses.replace(T.default_newton_options(ct), gmin_steps=2,
                                src_steps=2, restarts=0, gmin_start=1e-6)
    sc = torch.tensor([1.0, 1.01], dtype=torch.float64)
    pb = {k: dict(g) for k, g in ct.params0.items()}
    pb[key]["W"] = ct.params0[key]["W"][None, :] * sc[:, None]
    ctx_op = ctx.with_mode("tranop")
    both = dc_core(ct, pb, ctx_op, op.x.expand(2, ct.n_x), light)
    assert bool(both.converged.all())
    for i in range(2):
        p1 = {k: dict(g) for k, g in ct.params0.items()}
        p1[key]["W"] = pb[key]["W"][i]
        one = dc_core(ct, p1, ctx_op, op.x, light)
        torch.testing.assert_close(both.x[i], one.x, rtol=0, atol=1e-12)
    # the nominal lane starts at its own operating point
    torch.testing.assert_close(both.x[0], op.x, rtol=0, atol=1e-9)
