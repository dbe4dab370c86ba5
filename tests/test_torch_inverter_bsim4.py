"""The CMOS inverter on the gf180 BSIM4 cards (``tests/test_inverter_
bsim4.py``), the port against the JAX package on the CPU: the VTC as one
batched ``dc_sweep`` of 41 points (every point within 1e-7 V of the JAX
package's: on the steep part of the curve, where the gain is ~20, Newton
stops from iterates that part in their last bits 3.6e-8 V apart, far
inside its own tolerance of 1e-4·|x| + 1e-9; rail to rail, monotone, its
switching threshold in the middle third) and the transient over 0-10
ns (the JAX package's accepted and rejected steps, the output within
1e-6 V at its accepted times; rail to rail, a propagation delay under
1 ns).
"""

import os
import warnings

import numpy as np

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu.analysis import sweeps as jsw
from cedarsim_tpu.core.compile import ensure_dynamic as jdyn

D = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "benchmarks", "gf180_dff")

NETLIST = """* bsim4 inverter
.option gmin=1e-15
.include "models_bsim4.spice"
VDD vdd 0 5.0
VIN in 0 {vin}
XP out in vdd vdd pfet_06v0 w=20u l=0.6u
XN out in 0 0 nfet_06v0 w=10u l=0.6u
CL out 0 50f
.end
"""


def _build(M, vin="PULSE(0 5 1n 0.2n 0.2n 4n 10n)", **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        nl = M.parse_spice(NETLIST.replace("{vin}", vin))
        return M.compile_circuit(M.elaborate(nl, include_paths=[D]), **kw)


def test_vtc():
    vin = np.linspace(0.0, 5.0, 41)
    ct = T.ensure_dynamic(_build(T, vin="0", device="cpu"), ["vin.dc"])
    cj = jdyn(_build(J, vin="0"), ["vin.dc"])
    rt = T.dc_sweep(ct, T.Sweep("vin.dc", vin), ctx=T.SimSpec.make(gmin=1e-15))
    rj = jsw.dc_sweep(cj, jsw.Sweep("vin.dc", vin),
                      ctx=J.SimSpec.make(gmin=1e-15))
    assert bool(rt.converged.all())
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-7)
    vout = rt.x[:, ct.node_names.index("out")].numpy()
    assert vout[0] > 4.9 and vout[-1] < 0.1
    assert np.all(np.diff(vout) < 1e-6)
    vm = float(np.interp(-2.5, -vout, vin))
    assert 1.6 < vm < 3.4, vm


def test_transient_propagation():
    st = T.tran(_build(T, device="cpu"), (0.0, 10e-9),
                ctx=T.SimSpec.make(gmin=1e-15),
                opts=T.TranOptions(max_steps=8192))
    sj = J.tran(_build(J), (0.0, 10e-9), ctx=J.SimSpec.make(gmin=1e-15),
                opts=J.TranOptions(max_steps=8192))
    assert st.converged and sj.converged
    assert (st.n_accepted, st.n_rejected) == (sj.n_accepted, sj.n_rejected)
    np.testing.assert_allclose(st["out"], np.asarray(sj["out"]), rtol=0,
                               atol=1e-6)
    t = np.linspace(0, 10e-9, 1000)
    vout = np.interp(t, st.ts, st["out"])
    vin = np.interp(t, st.ts, st["in"])
    assert vout[t < 0.9e-9].min() > 4.9
    assert vout[(t > 3e-9) & (t < 5e-9)].max() < 0.1
    tpd = t[np.argmax(vout < 2.5)] - t[np.argmax(vin > 2.5)]
    assert 0.0 < tpd < 1e-9, tpd
