"""``cedarsim_tpu_torch.utils.profiling`` on the RC Newton step of
``tests/test_profiling.py``: the first call's wall, the aten operations of
one call by name (the histogram sums to the total) and the steady-state
run; and the op-count budget, the port's regression canary as the jaxpr
count is the JAX package's: one RC Newton step dispatches 181-183 aten
operations on the CPU (PyTorch 2.13), so the budget is 550, about three
times that.
"""

import torch

import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.utils.profiling import profile_compile, profile_run

#: about 3x the measured 181-183 aten operations of one RC Newton step
ATEN_BUDGET = 550


def _rc_newton():
    ckt = T.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(T.VSource, "V1", (vin, ckt.gnd), dict(dc=1.0))
    ckt.add(T.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(T.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    c = T.compile_circuit(ckt, device="cpu")
    ctx = T.SimSpec.make(mode="dcop")
    eye = 1e-12 * torch.eye(c.n_x, dtype=c.dtype)

    def step(x):
        S, _, G, _ = c.res_jacs_fwd(x, ctx, c.params0)
        return x + torch.linalg.solve(G + eye, -S)

    return step, torch.zeros(c.n_x, dtype=c.dtype)


def test_report_keys_and_counts():
    step, x0 = _rc_newton()
    rep = profile_compile(step, x0)
    for k in ("first_call_s", "aten_ops", "aten_histogram", "compiled"):
        assert k in rep, k
    assert "cuda_launches" not in rep          # a CPU call: no card keys
    assert rep["aten_ops"] > 0
    assert sum(rep["aten_histogram"].values()) == rep["aten_ops"]
    assert rep["aten_histogram"]["_linalg_solve_ex"] == 1
    run = profile_run(rep["compiled"], x0)
    assert run["mean_s"] > 0 and run["per_sec"] > 0
    x1 = rep["compiled"](x0)
    assert abs(float(x1[1]) - 1.0) < 1e-9      # one Newton step: vout = 1 V


def test_aten_op_count_budget():
    """The RC Newton step's operation count is a regression canary: an
    accidental loop over instances or an unrolled O(n) path trips it."""
    step, x0 = _rc_newton()
    rep = profile_compile(step, x0)
    assert rep["aten_ops"] < ATEN_BUDGET, rep["aten_ops"]
