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
from cedarsim_tpu_torch.ops.ad import refuse_tangent
from cedarsim_tpu_torch.ops.gesp_lu import back_substitute
from cedarsim_tpu_torch.ops.rounding import fma_f32

#: pivot magnitude below which the multipliers' divisor is boosted to ±TINY
TINY = 1e-30

SOURCE = os.path.join(cuda_lib.CSRC, "pivot_lu.cu")
#: static shared memory of the block kernels (the 8 warps' argmax winners:
#: key, row and entry), as ptxas reports it
_STATIC_SMEM = 96

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
    """Plain PyTorch partial-pivoting solve in the kernel's order: step k
    takes the first row of largest |A[i, k]| (i >= k, NaN below every
    number), exchanges it with row k, divides each row's entry in column k
    by the pivot (boosted to ±TINY) once and updates the trailing block and
    b; then the column-order back substitution with the stored diagonal
    (``gesp_lu.back_substitute``).  A [B, n, n], b [B, n] float32 → x
    [B, n]."""
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
        A[:, k + 1:, k + 1:] = fma_f32(-mult[:, :, None],
                                       A[:, k, None, k + 1:],
                                       A[:, k + 1:, k + 1:])
        b[:, k + 1:] = fma_f32(-mult, b[:, k, None], b[:, k + 1:])
    return back_substitute(A, b)


def lu_solve_pivot_f32(A, b):
    """Partial-pivoting LU solve of a batch: A [B, n, n], b [B, n] float32
    → x [B, n].  CPU tensors take :func:`lu_solve_pivot_f32_plain`; CUDA
    tensors launch ``pivot_solve_f32`` or raise: one warp per system with
    the system in registers at n <= 32, one thread block per system with
    [A | b] in shared memory above (so n <= 240 on an H100)."""
    B, n = cuda_lib.check_system("lu_solve_pivot_f32", A, b)
    refuse_tangent("lu_solve_pivot_f32", A, b)
    if A.device.type == "cpu":
        return lu_solve_pivot_f32_plain(A, b)
    cuda_lib.check_f32("A", A, (B, n, n))
    cuda_lib.check_f32("b", b, (B, n))
    cuda_lib.check_smem("lu_solve_pivot_f32", A.device,
                        cuda_lib.dense_solve_smem(n, _STATIC_SMEM))
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
