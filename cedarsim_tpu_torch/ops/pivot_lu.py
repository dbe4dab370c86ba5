"""Batched LU solve with partial pivoting in float32: the CUDA kernel of
``csrc/pivot_lu.cu`` and its plain PyTorch version.

``lu_solve_pivot_f32`` replaces ``cedarsim_tpu/ops/pallas_lu.py::
_lu_solve_kernel`` (launched by ``lu_solve_batched_f32``).  The wrapper
takes the plain version for a tensor on the CPU and launches the kernel for
a CUDA tensor; there is no other path.  The kernel is compiled with
``nvcc`` at first use (``ops/cuda_lib.py``) and loaded with ``ctypes``;
the wrapper counts its launches in ``lu_solve_pivot_f32.launches``.

The semantics are the Pallas kernel's (``pallas_lu.py:70-120``): the pivot
row is the first row of largest magnitude (ties to the smallest index);
the pivot is boosted to ±1e-30 only for the multipliers; back substitution
divides by the stored diagonal, so an exactly zero pivot gives a
non-finite x, as it does there.
"""

from __future__ import annotations

import ctypes
import os

import torch

from cedarsim_tpu_torch.ops import cuda_lib

#: pivot magnitude below which the multipliers' divisor is boosted to ±TINY
TINY = 1e-30

SOURCE = os.path.join(cuda_lib.CSRC, "pivot_lu.cu")
#: static shared memory of the kernel (the 8 warps' argmax winners, value
#: and row, and the pivot row): 80 bytes with alignment, as ptxas reports
_STATIC_SMEM = 80

_LIB = {}


def build():
    """Compile (if not built yet for this source) and load the kernel
    library: a dict with ``lib``, ``path``, nvcc's ``seconds`` (0.0 when it
    was already built) and its ``log``."""
    if "lib" in _LIB:
        return _LIB
    b = cuda_lib.build_library("pivot_lu", SOURCE)
    lib = b["lib"]
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pivot_solve_f32.argtypes = [p, p, p, i, i, ll, ll, ll, ll, p]
    lib.pivot_solve_f32.restype = i
    _LIB.update(b)
    return _LIB


def lu_solve_pivot_f32_plain(A, b):
    """Plain PyTorch partial-pivoting solve in the kernel's order.  A
    [B, n, n], b [B, n] float32 → x [B, n]."""
    A = A.clone()
    b = b.clone()
    B, n, _ = A.shape
    rows = torch.arange(B, device=A.device)
    tiny = torch.tensor(TINY, dtype=A.dtype, device=A.device)
    for k in range(n):
        mag = A[:, k:, k].abs()
        # a NaN magnitude counts below every number, as in the kernel;
        # argmax gives the first of equal maxima
        mag = torch.where(torch.isnan(mag), torch.full_like(mag, -1.0), mag)
        p = k + torch.argmax(mag, dim=1)
        rk, rp = A[:, k].clone(), A[rows, p].clone()
        A[:, k], A[rows, p] = rp, rk
        bk, bp = b[:, k].clone(), b[rows, p].clone()
        b[:, k], b[rows, p] = bp, bk
        piv = A[:, k, k]
        safe = torch.where(piv.abs() < tiny,
                           torch.where(piv < 0, -tiny, tiny), piv)
        mult = A[:, k + 1:, k] / safe[:, None]
        A[:, k + 1:, k + 1:] -= mult[:, :, None] * A[:, k, None, k + 1:]
        b[:, k + 1:] -= mult * b[:, k, None]
    x = torch.zeros_like(b)
    for i in range(n - 1, -1, -1):
        x[:, i] = ((b[:, i] - (A[:, i, i + 1:] * x[:, i + 1:]).sum(-1))
                   / A[:, i, i])
    return x


def lu_solve_pivot_f32(A, b):
    """Partial-pivoting LU solve of a batch: A [B, n, n], b [B, n] float32
    → x [B, n].  CPU tensors take :func:`lu_solve_pivot_f32_plain`; CUDA
    tensors launch ``pivot_solve_f32`` (one thread block per system, A and
    b in shared memory, so n <= 240 on an H100) or raise."""
    B, n = cuda_lib.check_system("lu_solve_pivot_f32", A, b)
    if A.device.type == "cpu":
        return lu_solve_pivot_f32_plain(A, b)
    cuda_lib.check_f32("A", A, (B, n, n))
    cuda_lib.check_f32("b", b, (B, n))
    cuda_lib.check_smem("lu_solve_pivot_f32", A.device,
                        4 * n * (n + 1) + _STATIC_SMEM)
    x = torch.empty_like(b)
    if B == 0 or n == 0:
        return x
    lib = build()["lib"]
    err = lib.pivot_solve_f32(
        A.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, n * n, n, n, n,
        cuda_lib.current_stream(A.device))
    cuda_lib.raise_on(err, "pivot_solve_f32")
    lu_solve_pivot_f32.launches += 1
    return x


lu_solve_pivot_f32.launches = 0
