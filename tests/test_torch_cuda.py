"""The port's CUDA GESP LU kernels on the card (skipped without one: a CUDA
kernel has no CPU mode).  This file imports no JAX, so it also runs on a
machine that has only PyTorch (``--noconftest`` skips ``tests/conftest.py``,
which sets JAX up for the other files):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

- Each kernel against its plain PyTorch version on the same CUDA tensors
  (1e-5 relative: float32 with FMA contraction and another summation order),
  with one launch counted per call.
- The wrappers refuse what the kernels do not take.
- The mixed chord solve (kernels + two float64 refinement passes) against
  float64 ``torch.linalg.solve`` (1e-10 relative, well-conditioned systems).
- The RC step on the card through the mixed chord path: the closed form one
  τ after the edge (5e-3 V), with both kernels launched.
"""

import numpy as np
import pytest
import torch

import cedarsim_tpu_torch as T
from cedarsim_tpu_torch.ops import gesp_lu, linalg

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
    assert _rel(lu_k, lu_p) <= 1e-5
    assert _rel(x_k, x_p) <= 1e-5


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
    sol = T.tran(comp, (0.0, 20e-6), opts=T.TranOptions(dense_lu="auto"))
    assert sol.converged
    assert gesp_lu.lu_factor_gesp_f32.launches > f0
    assert gesp_lu.lu_subst_gesp_f32.launches > s0
    want = 3.3 * (1.0 - np.exp(-1.0))
    assert abs(sol.interp("vout", 2.001e-6) - want) < 5e-3
