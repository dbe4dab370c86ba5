"""The port's CUDA GESP LU kernels on the card (skipped without one: a CUDA
kernel has no CPU mode).  This file imports no JAX, so it also runs on a
machine that has only PyTorch (``--noconftest`` skips ``tests/conftest.py``,
which sets JAX up for the other files):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

- Each GESP kernel bitwise equal to its plain PyTorch version on the same
  CUDA tensors (both round each multiply-add of the factor once, each term
  of the substitution twice), with one launch counted per call; the
  factor (B2) at n in {1, 8, 25, 31, 32, 33, 64, 122, 240} (both regimes
  and their edge) and B in {1, 8, 37, 256} (256: the level-1 cell D's
  lanes), the substitution (B3) at n from 1 to 240 (1, 2, 4 and 8 rows per
  lane) and the same B, each with its
  two launches bitwise equal; the factor's zero and tiny negative pivots
  boosted to +-1e-20 on the diagonal, as on the CPU.
- ``rounding.fma_f32`` on CUDA tensors bitwise C's ``fmaf``.
- The wrappers refuse what the kernels do not take, n = 241 before any
  launch.
- The mixed chord solve (kernels + two float64 refinement passes) against
  float64 ``torch.linalg.solve`` (1e-10 relative, well-conditioned systems).
- The RC step on the card through the mixed chord path, one lane as a
  batch: the closed form one τ after the edge (5e-3 V), with both kernels
  launched.
- The fused chord kernel against its plain version on a VA diode circuit
  and a BSIM4 inverter at B ∈ {1, 3, 8} lanes (seeded perturbation, BE
  start): equal (ok, Newton count), xn and Q within 1e-9 relative, S
  within 1e-9 of the currents' scale (S at the predictor: the converged S
  is a residual that cancels far below it); two launches bitwise equal;
  the wrapper refuses another dtype, a non-contiguous input or a CPU
  tensor; the scratch of hoisted model values is written before it is
  read (the same bits from a scratch of zeros and one of NaNs);
  ``tran(newton_impl="fused")`` launches once per step attempt.
- The fused chord kernel on the level-1 DFF's plan (the built-in ``Mos1``
  emitted, vto scattered per lane) against its plain version at B in {1,
  8, 37} lanes, as above; and on the PVT sweep's plan (the BSIM4 DFF, W
  and the supply per lane) at 16 and 256 lanes.
- The RC step as one stream under "mixed" takes the exact solve (no GESP
  launch), as the JAX package's unbatched chord pair does.
- The dense solves B4 (fused GESP, ``gesp_lu.lu_solve_gesp_f32``) and B5
  (partial pivoting, ``pivot_lu.lu_solve_pivot_f32``, rows shuffled per
  system) bitwise equal to their plain versions in both regimes and at
  their edges, n in {1, 2, 11, 25, 31, 32, 33, 64, 122, 240} and B in
  {1, 4, 37, 512}, two launches bitwise equal; non-finite where the plain
  version is on a zero pivot and on a column of NaNs; n = 241 is refused
  with the card's shared memory per block named; on a tie of magnitudes
  the pivoting kernel takes the first row, so it is bitwise the GESP
  kernel where no row is swapped, in each regime.
- The transient's exact float64 solves (``linalg.solve_lanes``,
  ``lu_factor_exact``, ``lu_solve_exact``), one library call a lane: each
  lane bitwise the same system alone at (L, n) in {(2, 243), (8, 25),
  (3, 452)}, where a lane of the one batched call is not; ẋ0's normal
  matrix ``linalg.normal_matrix`` bitwise the CPU's and within 1e-13 of
  ``C.mT @ C``.
- The sparse factor (S1, ``sparse_lu.factor``) and solve (S2,
  ``sparse_lu.solve_factored``) bitwise equal to their plain versions on
  seeded MNA-like plans of n 20 to 500 and on the 40-cell BSIM4 chain's
  plan and the 90-cell level-1 chain's (1,002 unknowns), at L in {1, 8}
  lanes, with values in shared memory and in device memory (by an
  ``nnz_f`` above a block's shared memory, and with the regime test
  replaced so that every size takes device memory), two launches bitwise
  equal, one launch counted per call; pivots boosted; the wrappers refuse
  another dtype or shape.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.analysis.tran import fused_plan_for
from cedarsim_tpu_torch.ops import fused_chord as fc
from cedarsim_tpu_torch.ops import gesp_lu, linalg, pivot_lu
from cedarsim_tpu_torch.va.codegen import load_va

DFF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "benchmarks", "gf180_dff")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _systems(seed, B, n):
    """Row-equilibrated, diagonally dominant systems (float64)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    A += (n + 8) * np.eye(n)
    A /= np.abs(A).max(-1, keepdims=True)
    return A, rng.standard_normal((B, n))


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def _bitwise(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("B, n", [(1, 25), (8, 25), (37, 25), (8, 64)])
def test_kernels_match_plain(cuda_device, B, n):
    A, b = _systems(B * n, B, n)
    A32 = torch.as_tensor(A, dtype=torch.float32, device=cuda_device)
    b32 = torch.as_tensor(b, dtype=torch.float32, device=cuda_device)
    f0 = gesp_lu.lu_factor_gesp_f32.launches
    s0 = gesp_lu.lu_subst_gesp_f32.launches
    lu_k = gesp_lu.lu_factor_gesp_f32(A32)
    lu_p = gesp_lu.lu_factor_gesp_f32_plain(A32)
    x_k = gesp_lu.lu_subst_gesp_f32(lu_p, b32)
    x_p = gesp_lu.lu_subst_gesp_f32_plain(lu_p, b32)
    torch.cuda.synchronize()
    assert gesp_lu.lu_factor_gesp_f32.launches == f0 + 1
    assert gesp_lu.lu_subst_gesp_f32.launches == s0 + 1
    assert _bitwise(lu_k, lu_p)
    assert _bitwise(x_k, x_p)


@pytest.mark.parametrize("n", [1, 8, 25, 31, 32, 33, 64, 122, 240])
@pytest.mark.parametrize("B", [1, 8, 16, 37, 256])
def test_factor_kernel_matches_plain(cuda_device, B, n):
    """B2 in both regimes (one warp per system at n <= 32, one block
    above) and at their edge: bitwise its plain version, two launches
    bitwise equal."""
    A, _ = _systems(5 * n + B, B, n)
    A32 = torch.as_tensor(A, dtype=torch.float32, device=cuda_device)
    f0 = gesp_lu.lu_factor_gesp_f32.launches
    lu1 = gesp_lu.lu_factor_gesp_f32(A32)
    lu2 = gesp_lu.lu_factor_gesp_f32(A32)
    lup = gesp_lu.lu_factor_gesp_f32_plain(A32)
    torch.cuda.synchronize()
    assert gesp_lu.lu_factor_gesp_f32.launches == f0 + 2
    assert bool(torch.isfinite(lu1).all())
    assert _bitwise(lu1, lu2)
    assert _bitwise(lu1, lup)


@pytest.mark.parametrize("n", [6, 40])
@pytest.mark.parametrize("pivot, boosted", [(0.0, 1e-20), (-1e-25, -1e-20)])
def test_factor_kernel_boosts_the_pivot(cuda_device, n, pivot, boosted):
    """A zero pivot is stored as +1e-20 and a tiny negative one as -1e-20,
    in each regime, as ``tests/test_torch_gesp_lu.py::
    test_gesp_pivot_boost_sign`` checks the plain factor; the rest of the
    factor is its plain version's, bitwise."""
    A, _ = _systems(7, 3, n)
    A[:, 2, :] = 0.0
    A[:, 2, 2] = pivot
    A[:, 2, 4] = 1.0          # keep the row nonzero off the diagonal
    A[:, :2, 2] = 0.0         # so that the pivot reaches step 2 unchanged
    A32 = torch.as_tensor(A, dtype=torch.float32, device=cuda_device)
    lu = gesp_lu.lu_factor_gesp_f32(A32)
    lup = gesp_lu.lu_factor_gesp_f32_plain(A32)
    torch.cuda.synchronize()
    want = torch.full((3,), boosted, dtype=torch.float32)
    assert torch.equal(lu[:, 2, 2].cpu(), want)
    fin = torch.isfinite(lup)
    assert torch.equal(torch.isfinite(lu), fin)
    assert _bitwise(torch.where(fin, lu, 0.0), torch.where(fin, lup, 0.0))


def test_fma_f32_on_the_card_is_libm_fmaf(cuda_device):
    """``rounding.fma_f32`` on CUDA tensors (float64 products and TwoSum
    on the card) against C's ``fmaf`` on the host, on every kind of triple
    of ``tests/test_torch_rounding.py``."""
    from cedarsim_tpu_torch.ops.rounding import fma_f32
    from test_torch_rounding import KINDS, libm_fmaf, triples
    for seed, kind in enumerate(KINDS):
        a, b, c = triples(kind, 4000, seed)
        got = fma_f32(*(torch.as_tensor(v, device=cuda_device)
                        for v in (a, b, c))).cpu().numpy()
        ref = libm_fmaf(a, b, c)
        same = (got.view(np.uint32) == ref.view(np.uint32)) | (
            np.isnan(got) & np.isnan(ref))
        assert same.all(), (kind, int((~same).sum()))


@pytest.mark.parametrize("n", [1, 25, 31, 32, 33, 64, 96, 122, 240])
@pytest.mark.parametrize("B", [1, 8, 16, 37, 256])
def test_subst_kernel_matches_plain(cuda_device, B, n):
    A, b = _systems(3 * n + B, B, n)
    A32 = torch.as_tensor(A, dtype=torch.float32, device=cuda_device)
    b32 = torch.as_tensor(b, dtype=torch.float32, device=cuda_device)
    lu = gesp_lu.lu_factor_gesp_f32_plain(A32)
    s0 = gesp_lu.lu_subst_gesp_f32.launches
    x1 = gesp_lu.lu_subst_gesp_f32(lu, b32)
    x2 = gesp_lu.lu_subst_gesp_f32(lu, b32)
    xp = gesp_lu.lu_subst_gesp_f32_plain(lu, b32)
    torch.cuda.synchronize()
    assert gesp_lu.lu_subst_gesp_f32.launches == s0 + 2
    assert _bitwise(x1, x2)
    assert bool(torch.isfinite(x1).all())
    assert _bitwise(x1, xp)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    A, b = _systems(3, 4, 25)
    A32 = torch.as_tensor(A, dtype=torch.float32, device=cuda_device)
    b32 = torch.as_tensor(b, dtype=torch.float32, device=cuda_device)
    with pytest.raises(TypeError):
        gesp_lu.lu_factor_gesp_f32(A32.double())
    with pytest.raises(ValueError):
        gesp_lu.lu_factor_gesp_f32(A32.transpose(1, 2))
    with pytest.raises(ValueError):
        gesp_lu.lu_subst_gesp_f32(A32, b32.cpu())
    with pytest.raises(ValueError):
        gesp_lu.lu_subst_gesp_f32(A32, b32[:, :24])
    # beyond a block's shared memory: refused before any launch
    A241 = torch.zeros(2, 241, 241, device=cuda_device)
    f0 = gesp_lu.lu_factor_gesp_f32.launches
    with pytest.raises(ValueError, match="shared memory per block"):
        gesp_lu.lu_factor_gesp_f32(A241)
    assert gesp_lu.lu_factor_gesp_f32.launches == f0


def test_mixed_chord_solve_matches_linalg(cuda_device):
    A, b = _systems(17, 8, 25)
    J = torch.as_tensor(A, dtype=torch.float64, device=cuda_device)
    rhs = torch.as_tensor(b, dtype=torch.float64, device=cuda_device)
    x = linalg.chord_solve_once(J, rhs)
    assert _rel(x, torch.linalg.solve(J, rhs)) <= 1e-10


def test_rc_closed_form_on_the_card(cuda_device):
    ckt = T.Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(T.VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=0.0, v2=3.3, td=1e-6, tr=1e-9, tf=1e-9, pw=4e-6,
                 per=10e-6))
    ckt.add(T.Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(T.Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    comp = T.compile_circuit(ckt, device=cuda_device)
    f0 = gesp_lu.lu_factor_gesp_f32.launches
    s0 = gesp_lu.lu_subst_gesp_f32.launches
    # one lane as a batch ([1, n_x]) takes the GESP kernels under "auto";
    # one stream ([n_x]) takes the exact solve, as the JAX package's does
    x0 = T.solve_dc(comp, mode="tranop").x[None]
    sol, = T.tran(comp, (0.0, 20e-6), opts=T.TranOptions(dense_lu="auto"),
                  x0=x0)
    assert sol.converged
    assert gesp_lu.lu_factor_gesp_f32.launches > f0
    assert gesp_lu.lu_subst_gesp_f32.launches > s0
    want = 3.3 * (1.0 - np.exp(-1.0))
    assert abs(sol.interp("vout", 2.001e-6) - want) < 5e-3
    f1 = gesp_lu.lu_factor_gesp_f32.launches
    one = T.tran(comp, (0.0, 20e-6), opts=T.TranOptions(dense_lu="mixed"))
    assert one.converged and gesp_lu.lu_factor_gesp_f32.launches == f1
    assert abs(one.interp("vout", 2.001e-6) - want) < 5e-3


# ------------------------------------------------------- fused chord kernel

VA_DIODE = """
module fdiode(a, c);
  inout a, c;
  electrical a, c;
  parameter real is_ = 1e-14 from (0:1];
  parameter real n = 1.0;
  real id, vd;
  analog begin
    vd = V(a, c);
    if (vd > -5.0 * n * $vt)
      id = is_ * (limexp(vd / (n * $vt)) - 1.0);
    else
      id = -is_;
    I(a, c) <+ id;
    I(a, c) <+ ddt(1e-13 * vd);
  end
endmodule
"""

INVERTER = """* BSIM4 inverter on the DFF's 5 V cards
.include "models_bsim4.spice"
vdd vdd 0 5.0
vin in 0 PULSE(0 5 2n 0.2n 0.2n 4n 10n)
xp out in vdd vdd pfet_06v0 w=2u l=0.6u
xn out in 0 0 nfet_06v0 w=1u l=0.6u
cl out 0 10f
"""

FUSED = dict(max_steps=4096, jac_reuse=1, formulation="cap",
             newton_impl="fused", newton_reltol=1e-4, newton_abstol=5e-7,
             res_tol=1e-3, jac_shunt=1e-7, res_rel=3e-5, rtol=1e-2,
             atol=1e-4)


def _circuit(which, dev):
    if which == "inverter":
        nl = T.parse_spice(INVERTER, file="inverter.cir")
        comp = T.compile_circuit(T.elaborate(nl, include_paths=[DFF_DIR]),
                                 device=dev)
        return comp, "W"
    diode = load_va(VA_DIODE)["fdiode"]
    ckt = T.Circuit()
    a, b = ckt.net("a"), ckt.net("b")
    ckt.add(T.VSourcePULSE, "V1", (a, ckt.gnd),
            dict(v1=0.0, v2=3.0, td=1e-9, tr=1e-10, tf=1e-10, pw=5e-9,
                 per=20e-9))
    ckt.add(T.Resistor, "R1", (a, b), dict(r=1000.0))
    ckt.add(diode, "D1", (b, ckt.gnd), dict(is_=1e-14))
    ckt.add(T.Capacitor, "C1", (b, ckt.gnd), dict(c=1e-12))
    return T.compile_circuit(ckt, device=dev, dynamic_params=("is_",)), "is_"


def _fused_case(which, B, dev):
    """(plan, kernel inputs, opts): B lanes with a param scatter at a BE
    start from the operating point, nodes perturbed by a seeded 0.05 V."""
    comp, pn = _circuit(which, dev)
    ctx = T.SimSpec.make()
    key = [k for k in comp.group_order if k.startswith("VA_")][0]
    pb = {k: dict(g) for k, g in comp.params0.items()}
    scale = torch.linspace(0.9, 1.2, B, dtype=comp.dtype, device=dev)
    pb[key][pn] = comp.params0[key][pn][None, :] * scale[:, None]
    op = T.solve_dc(comp, ctx=ctx, mode="tranop")
    rng = np.random.default_rng(B)
    pert = np.zeros((B, comp.n_x))
    pert[:, :comp.n_nodes] = rng.uniform(-0.05, 0.05, (B, comp.n_nodes))
    x0 = op.x.expand(B, comp.n_x).contiguous()
    x_pred = x0 + torch.as_tensor(pert, dtype=comp.dtype, device=dev)
    opts = T.TranOptions(**FUSED)
    plan = fused_plan_for(comp, ctx, pb)
    h, t = 1e-11, 2.5e-9
    tt = torch.full((B,), t, dtype=comp.dtype, device=dev)
    ctx_t = ctx.with_mode("tran")
    _, _, G, C = comp.res_jacs_fwd(x_pred, ctx_t.at_time(tt), pb)
    nv = comp.n_nodes + comp.n_internal
    J = C / h + G + opts.jac_shunt * torch.diag(
        (torch.arange(comp.n_x, device=dev) < nv).to(comp.dtype))
    args = plan.inputs(x_pred, J, plan.s_off(tt, ctx_t, pb),
                       torch.ones(B, dtype=comp.dtype, device=dev),
                       torch.full_like(tt, h), -x0, tt, pb)
    return plan, args, opts


def _check_fused_kernel(plan, args, opts):
    """The kernel against its plain version: one launch counted, equal (ok,
    nnwt), xn and Q within 1e-9 relative, S within 1e-9 of the currents'
    scale, two launches bitwise equal."""
    n0 = fc.fused_chord.launches
    k = fc.fused_chord(plan, *args, opts)
    p = fc.fused_chord_plain(plan, *args, opts)
    s_scale = fc.fused_chord_plain(
        plan, *args, dataclasses.replace(opts, max_newton=0))[1]
    torch.cuda.synchronize()
    assert fc.fused_chord.launches == n0 + 1
    assert torch.equal(k[3], p[3])
    assert int(k[3][:, 1].max()) >= 2          # the loop iterated
    assert _rel(k[0], p[0]) <= 1e-9
    assert _rel(k[2], p[2]) <= 1e-9
    assert float((k[1] - p[1]).abs().max()) <= 1e-9 * float(
        torch.maximum(p[1].abs().max(), s_scale.abs().max()))
    k2 = fc.fused_chord(plan, *args, opts)
    assert all(torch.equal(u, w) for u, w in zip(k, k2))


@pytest.mark.parametrize("B", [1, 8, 37])
def test_fused_kernel_matches_plain_mos1(cuda_device, B):
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    lv1 = kt.lv1_lanes(torch, T, cuda_device, lanes=B)
    plan = fused_plan_for(*lv1[:3])
    assert plan.nl_keys == ["Mos1"]
    args, opts = kt.fused_args(torch, T, plan, lv1, 1e-12)
    _check_fused_kernel(plan, args, opts)


@pytest.mark.parametrize("points", [16, 256])
def test_fused_kernel_matches_plain_pvt(cuda_device, points):
    """B1 on the PVT sweep's plan, where two lanes differ in two ways at
    once (W, an input of the BSIM4 group, and the supply, a source offset
    in s_off), at [points, 25] from the lanes' operating points, h = 1e-12
    and 1e-10."""
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt, pvt_sweep
    pvt = pvt_sweep.PVT(cuda_device)
    pb = pvt.chunk_params(*pvt_sweep.grid(points))
    x0, conv = pvt.lane_ops(pb)
    assert bool(conv.all())
    plan = fused_plan_for(pvt.comp, pvt.ctx, pb)
    assert sorted(fc.split_lanes(pvt.comp, pb)[1]) == [
        ("VA_bsim4", "W"), ("VSource", "dc")]
    for h in (1e-12, 1e-10):
        _check_fused_kernel(plan, *kt.fused_args(
            torch, T, plan, (pvt.comp, pvt.ctx, pb, x0), h))


@pytest.mark.parametrize("which", ["diode", "inverter"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_fused_kernel_matches_plain(cuda_device, which, B):
    _check_fused_kernel(*_fused_case(which, B, cuda_device))


def test_fused_kernel_is_deterministic(cuda_device):
    plan, args, opts = _fused_case("inverter", 8, cuda_device)
    a = fc.fused_chord(plan, *args, opts)
    b = fc.fused_chord(plan, *args, opts)
    torch.cuda.synchronize()
    assert all(torch.equal(u, w) for u, w in zip(a, b))


def test_fused_hoist_scratch_is_written_before_read(cuda_device,
                                                   monkeypatch):
    plan, args, opts = _fused_case("inverter", 3, cuda_device)
    outs = []
    for fill in (0.0, float("nan")):
        monkeypatch.setattr(plan, "hoist_scratch", lambda B, fill=fill: (
            torch.full((B, plan.n_inst, plan.max_hoist), fill,
                       dtype=torch.float64, device=cuda_device)))
        outs.append(fc.fused_chord(plan, *args, opts))
    torch.cuda.synchronize()
    assert int(outs[0][3][:, 1].max()) >= 2
    assert all(torch.equal(u, w) for u, w in zip(*outs))


def test_fused_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    plan, args, opts = _fused_case("diode", 3, cuda_device)
    x0, MT = args[0], args[1]
    with pytest.raises(TypeError):
        fc.fused_chord(plan, x0.float(), *args[1:], opts)
    with pytest.raises(ValueError):
        fc.fused_chord(plan, x0, MT.transpose(1, 2), *args[2:], opts)
    with pytest.raises(ValueError):
        fc.fused_chord(plan, x0, MT.cpu(), *args[2:], opts)


def test_fused_tran_on_the_card(cuda_device):
    comp, _ = _circuit("diode", cuda_device)
    fc.fused_chord.launches = 0
    sol = T.tran(comp, (0.0, 8e-9), opts=T.TranOptions(**FUSED))
    assert sol.converged
    assert fc.fused_chord.launches == sol.n_attempts > 0
    assert 0.45 < float(sol.interp("b", 4e-9)) < 0.9


# ------------------------------------------------- dense solves (B4, B5)

SOLVES = {"gesp": (gesp_lu.lu_solve_gesp_f32, gesp_lu.lu_solve_gesp_f32_plain),
          "pivot": (pivot_lu.lu_solve_pivot_f32,
                    pivot_lu.lu_solve_pivot_f32_plain)}


def _solve_case(kernel, B, n, dev):
    """Dominant systems; for the pivoting kernel with rows shuffled per
    system, so that it swaps at almost every step."""
    A, b = _systems(1000 + n, B, n)
    if kernel == "pivot":
        rng = np.random.default_rng(n)
        A = np.stack([a[rng.permutation(n)] for a in A])
    return (torch.as_tensor(A, dtype=torch.float32, device=dev),
            torch.as_tensor(b, dtype=torch.float32, device=dev))


#: (B, n) of the dense solves' checks: both regimes (one warp per system at
#: n <= 32, one block above) and their edges, up to the largest n a block's
#: shared memory holds; B = 512 (the bench's batch) only in the warp regime
DENSE_SHAPES = ([(37, 11), (512, 25), (64, 122), (4, 240)]
                + [(B, n) for n in (1, 2, 25, 31, 32) for B in (1, 37, 512)]
                + [(B, n) for n in (33, 64, 122, 240) for B in (1, 37)])


@pytest.mark.parametrize("kernel", ["gesp", "pivot"])
@pytest.mark.parametrize("B, n", DENSE_SHAPES)
def test_dense_solve_matches_plain(cuda_device, kernel, B, n):
    fn, plain = SOLVES[kernel]
    A, b = _solve_case(kernel, B, n, cuda_device)
    n0 = fn.launches
    x1 = fn(A, b)
    x2 = fn(A, b)
    xp = plain(A, b)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 2
    assert _bitwise(x1, x2)
    assert bool(torch.isfinite(x1).all())
    assert _bitwise(x1, xp)


@pytest.mark.parametrize("n", [9, 64])
def test_pivot_kernel_zero_pivot_is_not_finite(cuda_device, n):
    A, b = _solve_case("pivot", 4, n, cuda_device)
    A[:, :, 3] = 0.0
    x = pivot_lu.lu_solve_pivot_f32(A, b)
    xp = pivot_lu.lu_solve_pivot_f32_plain(A, b)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(xp).all())
    assert torch.equal(torch.isfinite(x), torch.isfinite(xp))


@pytest.mark.parametrize("kernel", ["gesp", "pivot"])
@pytest.mark.parametrize("n", [9, 64])
def test_dense_solve_nan_column(cuda_device, kernel, n):
    """A column of NaNs: the pivoting kernel never takes a NaN magnitude
    for the largest, so it keeps row k there, as its plain version does;
    both solves are non-finite where their plain versions are."""
    fn, plain = SOLVES[kernel]
    A, b = _solve_case(kernel, 4, n, cuda_device)
    A[:, :, 3] = float("nan")
    x = fn(A, b)
    xp = plain(A, b)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(xp).all())
    assert torch.equal(torch.isfinite(x), torch.isfinite(xp))


@pytest.mark.parametrize("n", [25, 64])
def test_pivot_kernel_ties_go_to_the_first_row(cuda_device, n):
    """On a tie of magnitudes the pivoting kernel takes the first row, so
    no row is exchanged and it is bitwise the GESP kernel, in each
    regime."""
    A, b = _solve_case("gesp", 8, n, cuda_device)
    A[:, 2, 0] = -A[:, 0, 0]
    x = pivot_lu.lu_solve_pivot_f32(A, b)
    xg = gesp_lu.lu_solve_gesp_f32(A, b)
    torch.cuda.synchronize()
    assert torch.equal(x, xg)


@pytest.mark.parametrize("kernel", ["gesp", "pivot"])
def test_dense_solve_refuses_n_241(cuda_device, kernel):
    fn, _ = SOLVES[kernel]
    A, b = _solve_case("gesp", 2, 241, cuda_device)
    n0 = fn.launches
    with pytest.raises(ValueError, match="shared memory per block"):
        fn(A, b)
    assert fn.launches == n0
    with pytest.raises(TypeError):
        fn(A[:, :25, :25].double().contiguous(), b[:, :25].double())


# ------------------------------------------------------ S1 and S2 (sparse)

def _sparse_case(n, seed, L, device):
    """A seeded MNA-like plan (``tests/test_torch_sparse_lu.py``'s
    generator) and L lanes of its values and right-hand sides."""
    from cedarsim_tpu_torch.ops import sparse_lu
    plan, A = _sparse_plan(n, seed)
    rng = np.random.default_rng(seed + 1)
    mats = np.stack([A * (1.0 + 0.05 * k) for k in range(L)])
    vals = sparse_lu.vals_from_dense(plan, torch.as_tensor(mats,
                                                           device=device))
    b = torch.as_tensor(rng.standard_normal((L, n)), device=device)
    return plan, vals, b


@functools.lru_cache(maxsize=None)
def _sparse_plan(n, seed):
    from cedarsim_tpu_torch.ops import sparse_lu
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] += 2.0 + rng.random()
        for _ in range(4):
            j = int(rng.integers(0, n))
            if j != i:
                v = -rng.random()
                A[i, j] += v
                A[j, i] += v * (0.5 + rng.random())
    for b in range(3):
        i, j = n - 1 - 2 * b, int(rng.integers(0, n // 2))
        A[i, j] += 1.0
        A[j, i] += 1.0
        A[i, i] = 0.0
    rr, cc = np.nonzero(A)
    return sparse_lu.build_plan(n, rr, cc, weights=A[rr, cc]), A


def _sparse_check(plan, vals, b, tau):
    """S1 and S2 against their plain versions: bitwise, twice."""
    from cedarsim_tpu_torch.ops import sparse_lu
    f0 = sparse_lu.factor.launches
    s0 = sparse_lu.solve_factored.launches
    f1 = sparse_lu.factor(plan, vals, tau)
    f2 = sparse_lu.factor(plan, vals, tau)
    fp = sparse_lu.factor_plain(plan, vals, tau)
    x1 = sparse_lu.solve_factored(plan, fp, b)
    x2 = sparse_lu.solve_factored(plan, fp, b)
    xp = sparse_lu.solve_factored_plain(plan, fp, b)
    torch.cuda.synchronize()
    assert sparse_lu.factor.launches == f0 + 2
    assert sparse_lu.solve_factored.launches == s0 + 2
    for k1, k2, p in ((f1, f2, fp), (x1, x2, xp)):
        assert torch.equal(k1.view(torch.int64), k2.view(torch.int64))
        assert torch.equal(k1.view(torch.int64), p.view(torch.int64))
    assert bool(torch.isfinite(xp).all())
    return fp, xp


@pytest.mark.parametrize("L", [1, 8])
@pytest.mark.parametrize("n", [20, 120, 500])
@pytest.mark.parametrize("regime", ["auto", "device memory"])
def test_sparse_kernels_match_plain(cuda_device, monkeypatch, n, L, regime):
    """At n = 500 the values exceed a block's shared memory on their own;
    "device memory" takes both kernels' device-memory regime at every n."""
    from cedarsim_tpu_torch.ops import sparse_lu
    if regime != "auto":
        monkeypatch.setattr(sparse_lu, "shared_regime", lambda *a: False)
    plan, vals, b = _sparse_case(n, n, L, cuda_device)
    # 0.3 boosts some pivots of these systems, TAU none
    for tau in (float(np.sqrt(np.finfo(np.float64).eps)), 0.3):
        _sparse_check(plan, vals, b, tau)
    fp = sparse_lu.factor_plain(plan, vals, 0.0)
    x = sparse_lu.solve_factored(plan, fp, b)
    A = torch.zeros(L, n, n, dtype=torch.float64, device=cuda_device)
    r = torch.as_tensor(plan.in_rows, dtype=torch.int64, device=cuda_device)
    c = torch.as_tensor(plan.in_cols, dtype=torch.int64, device=cuda_device)
    pos = torch.as_tensor(plan.in_pos, dtype=torch.int64, device=cuda_device)
    A[:, r, c] = vals[:, pos]
    ref = torch.linalg.solve(A, b)
    assert _rel(x, ref) < 1e-8


def test_sparse_factor_above_shared_memory(cuda_device):
    """An ``nnz_f`` above a block's shared memory takes both kernels'
    device-memory regime on its own (each keeps a lane's values in shared
    memory in its shared regime); both bitwise their plain versions."""
    from cedarsim_tpu_torch.ops import sparse_lu
    plan, vals, b = _sparse_case(420, 5, 2, cuda_device)
    sch = sparse_lu.schedule(plan, cuda_device)
    assert not sparse_lu.shared_regime(plan.nnz_f * 8, cuda_device)
    assert not sparse_lu.shared_regime(sch.factor_smem, cuda_device)
    assert not sparse_lu.shared_regime(sch.solve_smem, cuda_device)
    _sparse_check(plan, vals, b, float(np.sqrt(np.finfo(np.float64).eps)))


@pytest.mark.parametrize("L", [1, 8])
@pytest.mark.parametrize("regime", ["auto", "device memory"])
def test_sparse_kernels_on_the_level1_chain_90(cuda_device, monkeypatch, L,
                                               regime):
    """The 90-cell level-1 chain's plan (1,002 unknowns, 200 factor levels;
    ``benchmarks/sparse_crossover.py``'s largest) on seeded values with a
    dominant diagonal: S1 and S2 (both in shared memory under "auto")
    bitwise their plain versions in both regimes."""
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.core.sparse_ops import TAU, get_sparse_ops
    from cedarsim_tpu_torch.ops import sparse_lu
    plan = get_sparse_ops(netlists.chain(90, device="cpu")).plan
    assert plan.n == 1002
    if regime != "auto":
        monkeypatch.setattr(sparse_lu, "shared_regime", lambda *a: False)
    else:
        sch = sparse_lu.schedule(plan, cuda_device)
        assert sparse_lu.shared_regime(sch.factor_smem, cuda_device)
        assert sparse_lu.shared_regime(sch.solve_smem, cuda_device)
    rng = np.random.default_rng(90)
    v = rng.uniform(-1.0, 1.0, (L, plan.nnz_f))
    v[:, plan.diag_pos] = 4.0 + rng.uniform(0.0, 1.0, (L, plan.n))
    b = torch.as_tensor(rng.standard_normal((L, plan.n)), device=cuda_device)
    _sparse_check(plan, torch.as_tensor(v, device=cuda_device), b, TAU)


@pytest.mark.parametrize("L", [1, 8])
def test_sparse_kernels_on_the_bsim4_chain(cuda_device, L):
    """The 40-cell BSIM4 chain's plan (452 unknowns) on its equilibrated
    Jacobian at a seeded state: S1 and S2 bitwise their plain versions."""
    from cedarsim_tpu_torch.benchmarks import netlists
    from cedarsim_tpu_torch.core.sparse_ops import TAU, get_sparse_ops
    comp = netlists.chain(40, models="bsim4", device=cuda_device)
    sops = get_sparse_ops(comp)
    assert comp.n_x == 452 and sops.plan.nnz_f * 8 > 48 * 1024
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0.0, 5.0, (L, comp.n_x)),
                        device=cuda_device)
    ctx = T.SimSpec.make(gmin=1e-15).with_mode("tranop")
    S, _, G, _ = comp.evaluate(x, ctx, comp.lane_params(None, L),
                               jac="sparse")
    J = sops.add_diag(G, 1e-12)
    f, dr, _ = sops.factorize(J)
    from cedarsim_tpu_torch.ops import sparse_lu
    v, _, _ = sops.equilibrate(J)
    _sparse_check(sops.plan, v, S * dr, TAU)
    assert torch.equal(f, sparse_lu.factor_plain(sops.plan, v, TAU))


def test_sparse_wrappers_refuse(cuda_device):
    from cedarsim_tpu_torch.ops import sparse_lu
    plan, vals, b = _sparse_case(20, 1, 2, cuda_device)
    with pytest.raises(TypeError):
        sparse_lu.factor(plan, vals.float(), 0.0)
    with pytest.raises(ValueError):
        sparse_lu.factor(plan, vals[:, :-1], 0.0)
    with pytest.raises(ValueError):
        sparse_lu.solve_factored(plan, vals, b[:, :-1])


# ------------------------------------------- exact solves and ẋ0 (C6, C7)

@pytest.mark.parametrize("L, n", [(2, 243), (8, 25), (3, 452)])
def test_exact_solves_lanes_are_single_lanes(cuda_device, L, n):
    """The transient's exact float64 solves, one library call a lane: each
    lane of ``solve_lanes``, ``lu_factor_exact`` and ``lu_solve_exact``
    bitwise the same system alone (a batched cuSOLVER or MAGMA call is
    not, at these shapes)."""
    rng = np.random.default_rng(L * 1000 + n)
    A = torch.as_tensor(rng.standard_normal((L, n, n)) + n * np.eye(n),
                        device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((L, n)), device=cuda_device)
    x = linalg.solve_lanes(A, b)
    fct = linalg.lu_factor_exact(A)
    y = linalg.lu_solve_exact(*fct, b)
    for i in range(L):
        assert torch.equal(x[i], linalg.solve_lanes(A[i:i + 1],
                                                    b[i:i + 1])[0])
        one = linalg.lu_factor_exact(A[i:i + 1])
        assert torch.equal(fct[0][i], one[0][0])
        assert torch.equal(y[i], linalg.lu_solve_exact(*one, b[i:i + 1])[0])
    assert _rel(x, torch.linalg.solve(A, b)) < 1e-12


@pytest.mark.parametrize("L, n", [(2, 243), (8, 25), (3, 452)])
def test_batched_exact_solve_is_not_lane_bitwise(cuda_device, L, n):
    """Why the transient's exact solves go a lane at a time on the card: a
    lane of one batched ``torch.linalg`` factor or solve (cuBLAS's batched
    LU below 512 unknowns) is not bitwise the same system alone
    (cuSOLVER's), at C6's shape (2 lanes of 243 unknowns) among others."""
    rng = np.random.default_rng(L * 1000 + n)
    A = torch.as_tensor(rng.standard_normal((L, n, n)) + n * np.eye(n),
                        device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((L, n)), device=cuda_device)
    LU = torch.linalg.lu_factor_ex(A)[0]
    x = torch.linalg.solve_ex(A, b)[0]
    alone = [(torch.linalg.lu_factor_ex(A[i:i + 1])[0][0],
              torch.linalg.solve_ex(A[i:i + 1], b[i:i + 1])[0][0])
             for i in range(L)]
    assert not all(torch.equal(LU[i], lu) and torch.equal(x[i], xi)
                   for i, (lu, xi) in enumerate(alone))
    assert linalg._lanes_apart(A)


@pytest.mark.parametrize("L, n", [(1, 452), (3, 61)])
def test_normal_matrix_is_the_cpus(cuda_device, L, n):
    """CᵀC in its fixed order (products and sums rounded one by one): on
    the card bitwise the CPU's, within 1e-13 of ``C.mT @ C``."""
    rng = np.random.default_rng(n)
    C = rng.standard_normal((L, n, n)) * 1e-13
    Mc = linalg.normal_matrix(torch.as_tensor(C, device=cuda_device))
    M = linalg.normal_matrix(torch.as_tensor(C))
    assert torch.equal(Mc.cpu(), M)
    ref = torch.as_tensor(C).mT @ torch.as_tensor(C)
    assert float((M - ref).abs().max() / ref.abs().max()) <= 1e-13
