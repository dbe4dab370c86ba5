"""Batched no-pivot GESP LU in float32: the CUDA kernels of
``csrc/gesp_lu.cu`` and their plain PyTorch versions.

``lu_factor_gesp_f32`` replaces ``cedarsim_tpu/ops/pallas_lu.py::
_lu_factor_sublane_kernel``, ``lu_subst_gesp_f32`` replaces
``_lu_subst_sublane_kernel`` and ``lu_solve_gesp_f32`` (factor and solve in
one launch) replaces ``_lu_sublane_kernel``.  Each wrapper takes the plain
version for a tensor on the CPU and launches its kernel for a CUDA tensor;
there is no other path.  The kernels are compiled with ``nvcc`` at first
use (``ops/cuda_lib.py``) and loaded with ``ctypes``.  Each wrapper
counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from cedarsim_tpu_torch.ops import cuda_lib
from cedarsim_tpu_torch.ops.rounding import fma_f32

#: pivot magnitude below which GESP boosts the pivot to ±TAU
TAU = 1e-20

SOURCE = os.path.join(cuda_lib.CSRC, "gesp_lu.cu")
#: static shared memory of the fused solve's and the factor's block kernels,
#: as ptxas reports it (the argmax buffers belong to the pivoting
#: instantiation)
_SOLVE_STATIC_SMEM = 0

_LIB = {}


def build():
    """Compile (if not built yet for this source) and load the kernel
    library.  Returns a dict with the loaded ``lib``, the ``path`` of the
    shared object, the build ``seconds`` (0.0 when it was already built)
    and nvcc's ``log`` (registers and shared memory per kernel)."""
    if "lib" in _LIB:
        return _LIB
    b = cuda_lib.build_library("gesp_lu", SOURCE)
    lib = b["lib"]
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gesp_factor_f32.argtypes = [p, p, i, i, ll, ll, ll, ll, p]
    lib.gesp_factor_f32.restype = i
    lib.gesp_subst_f32.argtypes = [p, p, p, i, i, ll, ll, ll, ll, p]
    lib.gesp_subst_f32.restype = i
    lib.gesp_solve_f32.argtypes = [p, p, p, i, i, ll, ll, ll, ll, p]
    lib.gesp_solve_f32.restype = i
    _LIB.update(b)
    return _LIB


def max_n(device):
    """The most unknowns whose systems both the GESP factor (B2) and the
    substitution (B3) hold in a block's shared memory on ``device`` (its
    own limit, ``cuda_lib.smem_per_block``; 240 on an H100)."""
    return _max_n(cuda_lib.smem_per_block(device))


@functools.lru_cache(maxsize=None)
def _max_n(limit):
    # counted up once per shared-memory limit: resolve_impl asks each call
    def fits(n):
        return (cuda_lib.dense_solve_smem(n, _SOLVE_STATIC_SMEM) <= limit
                and 4 * n * (n | 1) <= limit)
    n = 0
    while fits(n + 1):
        n += 1
    return n


# ------------------------------------------------------------------ factor

def lu_factor_gesp_f32_plain(A):
    """Plain PyTorch GESP factor: A [B, n, n] float32 (row-equilibrated) →
    packed LU [B, n, n] (unit-L multipliers below the diagonal, U with the
    boosted pivot on and above it).  Each multiplier is one IEEE division
    and each update one fused multiply-add (one rounding), as in the kernel
    and in the Pallas factor under XLA, so the three give the same bits."""
    LU = A.clone()
    n = A.shape[-1]
    tau = torch.tensor(TAU, dtype=A.dtype, device=A.device)
    for k in range(n):
        piv = LU[:, k, k]
        piv = torch.where(piv.abs() < tau, torch.where(piv < 0, -tau, tau),
                          piv)
        mult = LU[:, k + 1:, k] / piv[:, None]
        LU[:, k + 1:, k + 1:] = fma_f32(-mult[:, :, None],
                                        LU[:, k, None, k + 1:],
                                        LU[:, k + 1:, k + 1:])
        LU[:, k + 1:, k] = mult
        LU[:, k, k] = piv
    return LU


def lu_factor_gesp_f32(A):
    """GESP factor of a batch A [B, n, n] float32.  CPU tensors take
    :func:`lu_factor_gesp_f32_plain`; CUDA tensors launch
    ``gesp_factor_f32`` or raise: B4's elimination without b, one warp per
    system with the system in registers at n <= 32, one thread block per
    system with the matrix in shared memory above (so n <= 240 on an
    H100)."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"lu_factor_gesp_f32: expected [B, n, n], got "
                         f"{tuple(A.shape)}")
    if A.device.type == "cpu":
        return lu_factor_gesp_f32_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"lu_factor_gesp_f32: unsupported device {A.device}")
    B, n, _ = A.shape
    cuda_lib.check_f32("A", A, (B, n, n))
    cuda_lib.check_smem("lu_factor_gesp_f32", A.device,
                        cuda_lib.dense_solve_smem(n, _SOLVE_STATIC_SMEM))
    LU = torch.empty_like(A)
    if B == 0 or n == 0:
        return LU
    lib = build()["lib"]
    err = lib.gesp_factor_f32(
        A.data_ptr(), LU.data_ptr(), B, n, n * n, n, n * n, n,
        cuda_lib.current_stream(A.device))
    cuda_lib.raise_on(err, "gesp_factor_f32")
    lu_factor_gesp_f32.launches += 1
    return LU


lu_factor_gesp_f32.launches = 0


# ------------------------------------------------------------ substitution

def lu_subst_gesp_f32_plain(LU, b):
    """Plain PyTorch substitution with a packed GESP LU: y = L⁻¹b (unit
    diagonal), x = U⁻¹y with U's stored diagonal.  LU [B, n, n], b [B, n],
    float32 → x [B, n].  Column order, as the kernel: step k of the forward
    pass subtracts L[i, k]·y_k from every row i > k; step k of the back pass
    divides y_k by U[k, k] and subtracts U[i, k]·x_k from every row i < k.
    So each y_i collects its terms in increasing k forwards and decreasing
    k backwards, each product and each difference rounded on its own (the
    kernel's ``__fmul_rn`` and ``__fsub_rn``)."""
    n = LU.shape[-1]
    y = b.clone()
    for k in range(n - 1):
        y[:, k + 1:] -= LU[:, k + 1:, k] * y[:, k, None]
    for k in range(n - 1, -1, -1):
        y[:, k] = y[:, k] / LU[:, k, k]
        y[:, :k] -= LU[:, :k, k] * y[:, k, None]
    return y


def lu_subst_gesp_f32(LU, b):
    """Solve with a packed GESP LU: LU [B, n, n], b [B, n] float32 → x
    [B, n].  CPU tensors take :func:`lu_subst_gesp_f32_plain`; CUDA tensors
    launch ``gesp_subst_f32`` (one warp per system, the system staged in
    shared memory at row stride n | 1, so n <= 241 on an H100) or raise."""
    B, n = cuda_lib.check_system("lu_subst_gesp_f32", LU, b)
    if LU.device.type == "cpu":
        return lu_subst_gesp_f32_plain(LU, b)
    cuda_lib.check_f32("LU", LU, (B, n, n))
    cuda_lib.check_f32("b", b, (B, n))
    cuda_lib.check_smem("lu_subst_gesp_f32", LU.device, 4 * n * (n | 1))
    x = torch.empty_like(b)
    if B == 0 or n == 0:
        return x
    lib = build()["lib"]
    err = lib.gesp_subst_f32(
        LU.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, n * n, n, n, n,
        cuda_lib.current_stream(LU.device))
    cuda_lib.raise_on(err, "gesp_subst_f32")
    lu_subst_gesp_f32.launches += 1
    return x


lu_subst_gesp_f32.launches = 0


# ------------------------------------------------------- fused solve (B4)

def lu_solve_gesp_f32_plain(A, b):
    """Plain PyTorch GESP solve in the fused kernel's order: each factor
    step boosts its pivot, divides each row's entry in column k by it once
    (the multiplier), updates the trailing block and eliminates b with the
    same multipliers; the back substitution runs in column order, step k
    dividing y_k by U's diagonal boosted again and subtracting U[i, k]·x_k
    from every row i < k.  A [B, n, n], b [B, n] float32 → x [B, n]."""
    A = A.clone()
    b = b.clone()
    n = A.shape[-1]
    tau = torch.tensor(TAU, dtype=A.dtype, device=A.device)

    def boost(p):
        return torch.where(p.abs() < tau, torch.where(p < 0, -tau, tau), p)

    for k in range(n):
        mult = A[:, k + 1:, k] / boost(A[:, k, k])[:, None]
        A[:, k + 1:, k + 1:] = fma_f32(-mult[:, :, None],
                                       A[:, k, None, k + 1:],
                                       A[:, k + 1:, k + 1:])
        b[:, k + 1:] = fma_f32(-mult, b[:, k, None], b[:, k + 1:])
    return back_substitute(A, b, boost)


def back_substitute(U, y, diag=None):
    """Column-order back substitution, the dense solves' (B4, B5) order: for
    k from n - 1 down, x_k = y_k / diag(U[k, k]), then y_i -= U[i, k]·x_k
    for every i < k, one rounding in float32 (the kernels' fused
    multiply-add).  ``diag`` maps the stored diagonal to the divisor (B4
    boosts it again; B5 divides by it as it is).  U [B, n, n] (read on and
    above the diagonal), y [B, n] float32 (or float64, rounded as PyTorch
    rounds) → x [B, n]."""
    y = y.clone()
    for k in range(U.shape[-1] - 1, -1, -1):
        d = U[:, k, k] if diag is None else diag(U[:, k, k])
        y[:, k] = y[:, k] / d
        if y.dtype == torch.float32:
            y[:, :k] = fma_f32(-U[:, :k, k], y[:, k, None], y[:, :k])
        else:
            y[:, :k] -= U[:, :k, k] * y[:, k, None]
    return y


def lu_solve_gesp_f32(A, b):
    """GESP factor and solve of a batch in one launch: A [B, n, n], b
    [B, n] float32 → x [B, n].  CPU tensors take
    :func:`lu_solve_gesp_f32_plain`; CUDA tensors launch
    ``gesp_solve_f32`` or raise: one warp per system with the system in
    registers at n <= 32, one thread block per system with [A | b] in
    shared memory above (so n <= 240 on an H100)."""
    B, n = cuda_lib.check_system("lu_solve_gesp_f32", A, b)
    if A.device.type == "cpu":
        return lu_solve_gesp_f32_plain(A, b)
    cuda_lib.check_f32("A", A, (B, n, n))
    cuda_lib.check_f32("b", b, (B, n))
    cuda_lib.check_smem("lu_solve_gesp_f32", A.device,
                        cuda_lib.dense_solve_smem(n, _SOLVE_STATIC_SMEM))
    x = torch.empty_like(b)
    if B == 0 or n == 0:
        return x
    lib = build()["lib"]
    err = lib.gesp_solve_f32(
        A.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, n * n, n, n, n,
        cuda_lib.current_stream(A.device))
    cuda_lib.raise_on(err, "gesp_solve_f32")
    lu_solve_gesp_f32.launches += 1
    return x


lu_solve_gesp_f32.launches = 0
