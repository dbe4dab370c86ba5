"""The port's transient (cedarsim_tpu_torch/analysis/tran.py) against closed
forms and against the JAX package's ``tran``.

- RC step: the closed form one τ after the edge (5e-3 V), and the JAX
  package's run with the same options (1e-8 V, same step counts) for the
  charge-form trap, BE and the cap-form BDF2.
- gf180 DFF, 0-120 ns: two lanes (nominal W and W·1.01) through the mixed
  chord path (plain GESP kernels on the CPU) against the JAX package's
  one-lane runs of the same W with the exact solver: every node within
  1e-3 V at ten times, accepted steps within 10 %; the nominal lane equals
  a solo run of the port to 1e-12 V (lane independence).
- The package never imports JAX (a fresh interpreter).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis.tran import TranOptions as JTranOptions

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DFF_DIR = os.path.join(REPO, "benchmarks", "gf180_dff")


def _rc(P):
    ckt = P.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(P.VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=0.0, v2=3.3, td=1e-6, tr=1e-9, tf=1e-9, pw=4e-6,
                 per=10e-6))
    ckt.add(P.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(P.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    return P.compile_circuit(ckt)


def test_rc_closed_form_mixed():
    sol = T.tran(_rc(T), (0.0, 20e-6), opts=T.TranOptions(dense_lu="mixed"))
    assert sol.converged
    want = 3.3 * (1.0 - np.exp(-1.0))
    assert abs(sol.interp("vout", 2.001e-6) - want) < 5e-3


@pytest.mark.parametrize("method, formulation", [
    ("auto", "auto"), ("be", "charge"), ("bdf2", "cap")])
def test_rc_matches_jax(method, formulation):
    kw = dict(method=method, formulation=formulation, jac_reuse=1,
              dense_lu="jax", newton_impl="xla")
    sj = J.tran(_rc(J), (0.0, 20e-6), opts=JTranOptions(**kw))
    st = T.tran(_rc(T), (0.0, 20e-6), opts=T.TranOptions(**kw))
    assert st.converged and sj.converged
    assert (st.n_accepted, st.n_rejected, st.n_newton) == \
        (sj.n_accepted, sj.n_rejected, sj.n_newton)
    # same steps; step sizes agree to rounding of the controller, and the
    # states at those times to that shift times the slope (3.3 V per µs)
    np.testing.assert_allclose(st.ts, sj.ts, rtol=1e-8, atol=0)
    np.testing.assert_allclose(st.xs, sj.xs, rtol=0, atol=1e-8)
    # first-order BE misses the closed form by 0.07 V in both packages
    if method != "be":
        assert abs(st.interp("vout", 2.001e-6)
                   - 3.3 * (1.0 - np.exp(-1.0))) < 5e-3


def _dff_text():
    with open(os.path.join(DFF_DIR, "dff_tb_bsim4.cir")) as f:
        return f.read()


#: the chip smoke's options over a shorter window; the mixed path's float32
#: GESP factor needs the Jacobian-only shunt (see PERF.md)
_OPTS = dict(max_steps=8192, jac_reuse=1, newton_impl="xla",
             accept_slack=1.5)


def test_dff_lanes_mixed_vs_jax():
    tstop = 120e-9
    scale = (1.0, 1.01)
    cj = J.compile_circuit(J.elaborate(
        J.parse_spice(_dff_text(), file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]))
    kj = [k for k in cj.group_order if "bsim4" in k.lower()][0]
    refs = []
    for f in scale:
        pj = dict(cj.params0)
        pj[kj] = dict(pj[kj], W=pj[kj]["W"] * f)
        refs.append(J.tran(cj, (0.0, tstop), params=pj,
                           ctx=J.SimSpec.make(gmin=1e-15),
                           opts=JTranOptions(dense_lu="jax", **_OPTS)))
    ct = T.compile_circuit(T.elaborate(
        T.parse_spice(_dff_text(), file="dff_tb_bsim4.cir"),
        include_paths=[DFF_DIR]))
    ctx = T.SimSpec.make(gmin=1e-15)
    key = [k for k in ct.group_order if "bsim4" in k.lower()][0]
    sc = torch.tensor(scale, dtype=torch.float64)
    pb = {k: dict(g) for k, g in ct.params0.items()}
    pb[key]["W"] = ct.params0[key]["W"][None, :] * sc[:, None]
    opts = T.TranOptions(dense_lu="mixed", jac_shunt=1e-9, **_OPTS)
    lanes = T.tran(ct, (0.0, tstop), params=pb, ctx=ctx, opts=opts)
    t_chk = np.linspace(5e-9, tstop, 10)
    for lane, sj in zip(lanes, refs):
        assert sj.converged and lane.converged
        ref = sj.interp_state(t_chk)[:, :ct.n_nodes]
        got = np.stack([np.interp(t_chk, lane.ts, lane.xs[:, i])
                        for i in range(ct.n_nodes)], -1)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
        assert abs(lane.n_accepted - sj.n_accepted) <= 0.1 * sj.n_accepted
    nominal = lanes[0]
    # lane independence: the nominal lane equals the port run alone
    solo = T.tran(ct, (0.0, tstop), ctx=ctx, opts=opts)
    assert solo.n_accepted == nominal.n_accepted
    np.testing.assert_allclose(nominal.xs[:, :ct.n_nodes],
                               solo.xs[:, :ct.n_nodes], rtol=0, atol=1e-12)


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.abspath(REPO)!r})\n"
        "import cedarsim_tpu_torch as T\n"
        "ckt = T.Circuit()\n"
        "a, b = ckt.net('a'), ckt.net('b')\n"
        "ckt.add(T.VSourcePULSE, 'V1', (a, ckt.gnd), dict(v1=0.0, v2=1.0, "
        "td=1e-6, tr=1e-9, tf=1e-9, pw=4e-6, per=10e-6))\n"
        "ckt.add(T.Resistor, 'R1', (a, b), dict(r=1e3))\n"
        "ckt.add(T.Capacitor, 'C1', (b, ckt.gnd), dict(c=1e-9))\n"
        "sol = T.tran(T.compile_circuit(ckt), (0.0, 5e-6))\n"
        "assert sol.converged\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m.startswith('cedarsim_tpu.') or m == "
        "'cedarsim_tpu' for m in sys.modules)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
