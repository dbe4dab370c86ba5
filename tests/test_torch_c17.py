"""ROADMAP C17 and C18: |x|'s derivative at 0 and the pass switch's tie.

- C17: the Verilog-A ``abs`` takes the JAX package's derivative, ``jnp.abs``'s
  ``select(x >= 0, g, -g)``, +1 at 0, over float32 and float64 values
  alike (``core/dual.py::absolute``, ``fabs``'s rule).  BSIM4
  takes ``vds = abs(vds_r)`` (``bsim4.va:452``), so a device whose drain
  sits exactly on its source keeps its output conductance.  The float64
  header that ``va/emit.py`` records from a BSIM4 walk carries the select
  and no ``cs_sign`` (under the former sign(0) = 0 rule it did).
- The pass switch (``netlists.pass_switch``: one gf180 ``nfet_06v0`` with
  its gate at 5 V, IN driven by ``DC 0 AC 1``, a 10 kΩ load on OUT): at the
  JAX package's operating point, where OUT is exactly 0 V, the port's AC
  and OUT's noise at 1 kHz and 1 MHz within 1e-8 relative of the JAX
  package's (measured 1.76e-9 and 1.95e-12; under sign(0) = 0 the AC read
  0 where the JAX package reads 0.88992, a relative error of 0.89).  At
  100 MHz the port's AC is the solve of the JAX package's own (G, C) at
  that point, evaluated op by op, within 1e-12; the JAX package's ``ac``
  is 1.76e-7 off it there (its noise 1.95e-8 off the port's), because
  its compiled (G, C) at the tie differ from its op-by-op ones by 4.6e-18
  F in C (5e-4 of the entry: XLA's code at vds = 0), an error that grows
  with the frequency (1.76e-12 at 1 kHz); both held within 1e-6.
- C18: the port's own operating point of the switch is the JAX package's,
  OUT exactly 0 V, and its AC from it within 1e-8 of the JAX package's.
  The port's walk once divided a number by a tensor as torch's ``c / t``,
  ``t.reciprocal() * c`` (two roundings), where ``lax.div`` and the
  emitted walk divide once; at x = 0 that left a one-ulp difference in
  Vdsat's tangent, whose rounding residue in the tangent of the
  DELTA-smoothed Vdseff (identically 0 at vds = 0, ``bsim4.va:599``) gave
  ∂I_d/∂V_g = 3.2e-39 S and moved OUT to 1.4e-34 V in two Newton steps,
  the side of vds = 0 where BSIM4's Jacobian (min/max at their ties, the
  abs kink) puts the AC 2.5e-4 off.  ``core/dual.py::rdiv`` (the
  emitter's ``_pdiv`` and ``Dual.__rtruediv__`` call it) divides once
  over float64 values, bitwise numpy's division; over float32 values it
  keeps torch's two roundings (C18 stays open for float32: one division
  there moves the float32 DFF's AC against the JAX package's past the
  bounds of ``tests/test_torch_mixed_precision.py``).
- The BSIM4 DFF (``dff_tb_bsim4.cir``) at x = 0 in TRANOP mode, where
  every vds is 0: S, Q and G within 1e-24 of the JAX package's, relative
  to each array's largest entry (G measured 1.26e-29; 3.86e-14 under
  sign(0) = 0); C within 1e-18 (measured 4.30e-19: C2's class, the
  charges' last bits, where XLA's CPU code contracts multiply-adds and
  rounds ``exp`` apart from torch's).

One compile of each circuit per package (module scope).
"""

import os
import re
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cedarsim_tpu as J
import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.analysis.tran import fused_plan_for
from cedarsim_tpu_torch.benchmarks import netlists
from cedarsim_tpu_torch.core import dual as D
from cedarsim_tpu_torch.va import codegen

FREQS = np.array([1e3, 1e6])
HF = 1e8
GMIN = 1e-15


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _compile(P, text, file):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ckt = P.elaborate(P.parse_spice(text, file=file),
                          include_paths=[netlists.DFF_DIR])
    return P.compile_circuit(ckt, **({"device": "cpu"} if P is T else {}))


@pytest.fixture(scope="module")
def switch():
    """The switch in both packages: the JAX package's operating point, AC
    and noise (its op cache off), and the port's compiled circuit."""
    text = netlists.pass_switch("ac")
    cj, ct = _compile(J, text, "sw.cir"), _compile(T, text, "sw.cir")
    ctx = J.SimSpec.make(gmin=GMIN)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CEDARSIM_TPU_ARTIFACTS", "0")
        op = J.solve_dc(cj, ctx=ctx, artifact_cache=False)
        f = np.append(FREQS, HF)
        ac = np.asarray(J.ac(cj, f, ctx=ctx).v)
        psd = np.asarray(J.noise(cj, "out", f, ctx=ctx).psd)
        G, C = (np.asarray(a) for a in cj.jacobians(
            op.x, ctx.with_mode("ac"), cj.params0))
    return dict(x=np.array(op.x), ac=ac, psd=psd, G=G, C=C, ct=ct,
                b=np.asarray(cj.ac_rhs(cj.params0)),
                out=ct.node_names.index("out"))


def test_switch_ac_and_noise_at_the_jax_op(switch):
    ctx = T.SimSpec.make(gmin=GMIN)
    x = switch["x"]
    assert x[switch["out"]] == 0.0
    ac = T.ac(switch["ct"], FREQS, ctx=ctx, x_op=x)
    assert _rel(ac.v.numpy(), switch["ac"][:-1]) <= 1e-8
    assert np.abs(ac["out"]) == pytest.approx([0.88992] * 2, rel=1e-4)
    ns = T.noise(switch["ct"], "out", FREQS, ctx=ctx, x_op=x)
    assert _rel(ns.psd, switch["psd"][:-1]) <= 1e-8


def test_switch_at_100_mhz_is_the_jax_packages_linearisation(switch):
    ctx = T.SimSpec.make(gmin=GMIN)
    ac = T.ac(switch["ct"], [HF], ctx=ctx, x_op=switch["x"])
    want = np.linalg.solve(switch["G"] + 2j * np.pi * HF * switch["C"],
                           switch["b"])
    assert _rel(ac.v.numpy()[0], want) <= 1e-12
    # the JAX package's compiled linearisation at the tie (docstring)
    assert _rel(switch["ac"][-1], want) <= 1e-6
    ns = T.noise(switch["ct"], "out", [HF], ctx=ctx, x_op=switch["x"])
    assert _rel(ns.psd, switch["psd"][-1:]) <= 1e-6


def test_c18_the_ports_own_op_is_the_jax_packages(switch):
    ctx = T.SimSpec.make(gmin=GMIN)
    op = T.solve_dc(switch["ct"], ctx=ctx)
    assert bool(op.converged) and int(op.iters) == 2
    assert op.x[switch["out"]].item() == 0.0
    assert np.array_equal(op.x.numpy(), switch["x"])
    ac = T.ac(switch["ct"], FREQS, ctx=ctx)
    assert _rel(ac.v.numpy(), switch["ac"][:-1]) <= 1e-8


def test_c18_a_number_over_a_tensor_divides_once():
    rng = np.random.default_rng(18)
    t = rng.uniform(0.01, 10.0, 4096)
    c = 1.7315 * np.pi
    want = c / t
    tt = torch.from_numpy(t)
    assert np.array_equal(D.rdiv(c, tt).numpy(), want)
    dual = c / D.Dual(tt, torch.ones(1, t.size, dtype=torch.float64))
    assert np.array_equal(dual.v.numpy(), want)
    # torch's own c / t rounds twice, which the walk no longer takes over
    # float64 values; over float32 ones it still does (C18, float32 open)
    assert not np.array_equal((c / tt).numpy(), want)
    t32 = tt.float()
    assert torch.equal(D.rdiv(c, t32), c / t32)


@pytest.fixture(scope="module")
def dff_zero():
    """The BSIM4 DFF's (S, Q, G, C) at x = 0 in TRANOP mode, per package."""
    with open(os.path.join(netlists.DFF_DIR, "dff_tb_bsim4.cir")) as f:
        text = f.read()
    cj = _compile(J, text, "dff_tb_bsim4.cir")
    ct = _compile(T, text, "dff_tb_bsim4.cir")
    ctx = "tranop"
    ref = [np.asarray(a) for a in cj.res_jacs_fwd(
        jnp.zeros(cj.n_x), J.SimSpec.make(gmin=GMIN).with_mode(ctx),
        cj.params0)]
    got = [a.numpy() for a in ct.res_jacs_fwd(
        torch.zeros(ct.n_x, dtype=torch.float64),
        T.SimSpec.make(gmin=GMIN).with_mode(ctx))]
    return got, ref


@pytest.mark.parametrize("k,name,bound", [(0, "S", 1e-24), (1, "Q", 1e-24),
                                           (2, "G", 1e-24), (3, "C", 1e-18)])
def test_dff_at_zero_is_the_jax_packages(dff_zero, k, name, bound):
    got, ref = dff_zero
    assert np.all(np.isfinite(got[k])), name
    assert _rel(got[k], ref[k]) <= bound, name


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_abs_derivative_is_jaxs(dt):
    assert codegen._MATH1["abs"] is D.absolute is D.fabs
    y = D.absolute(D.Dual(torch.tensor([0.0, 2.0, -2.0], dtype=dt),
                          torch.ones(3, dtype=dt)))
    assert y.v.tolist() == [0.0, 2.0, 2.0]
    assert y.d.tolist() == [1.0, 1.0, -1.0]


def _sign_rule(x):
    """The former float64 rule: sign(0) = 0 at the kink."""
    v = D.val(x)
    return D._chain(torch.abs(v), x, torch.sign(v))


def _header():
    """The switch's fused-plan header, from a compile of its own (a plan
    is cached on its circuit)."""
    return fused_plan_for(*netlists.pass_switch_lanes("cpu")[:3]).header()


def test_float64_header_takes_the_select(monkeypatch):
    text = _header()
    calls = len(re.findall(r"cs_sign\(", text)) - 1     # its definition
    assert calls == 0
    assert re.search(r"= \(v\d+ \? v\d+ : v\d+\);", text)
    # the same walk under sign(0) = 0 records cs_sign for abs
    monkeypatch.setitem(codegen._MATH1, "abs", _sign_rule)
    old = _header()
    assert len(re.findall(r"cs_sign\(", old)) - 1 == 1
    assert old != text
