"""Batched no-pivot GESP LU in float32: the CUDA kernels of
``csrc/gesp_lu.cu`` and their plain PyTorch versions.

``lu_factor_gesp_f32`` replaces ``cedarsim_tpu/ops/pallas_lu.py::
_lu_factor_sublane_kernel`` and ``lu_subst_gesp_f32`` replaces
``_lu_subst_sublane_kernel``.  Each wrapper takes the plain version for a
tensor on the CPU and launches its kernel for a CUDA tensor; there is no
other path.  The kernels are compiled with ``nvcc`` at first use into
``build/kernels/`` beside the package (keyed on a hash of the source) and
loaded with ``ctypes``.  Each wrapper counts its kernel launches in its
``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

#: pivot magnitude below which GESP boosts the pivot to ±TAU
TAU = 1e-20

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "gesp_lu.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found: the GESP LU kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build():
    """Compile (if not built yet for this source) and load the kernel
    library.  Returns a dict with the loaded ``lib``, the ``path`` of the
    shared object, the build ``seconds`` (0.0 when it was already built)
    and nvcc's ``log`` (registers and shared memory per kernel)."""
    if "lib" in _LIB:
        return _LIB
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    path = os.path.join(BUILD_DIR, f"gesp_lu_{tag[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.isfile(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gesp_factor_f32.argtypes = [p, p, i, i, ll, ll, ll, ll, p]
    lib.gesp_factor_f32.restype = i
    lib.gesp_subst_f32.argtypes = [p, p, p, i, i, ll, ll, ll, ll, p]
    lib.gesp_subst_f32.restype = i
    _LIB.update(lib=lib, path=path, seconds=seconds, log=log)
    return _LIB


def _check(name, t, shape):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# ------------------------------------------------------------------ factor

def lu_factor_gesp_f32_plain(A):
    """Plain PyTorch GESP factor: A [B, n, n] float32 (row-equilibrated) →
    packed LU [B, n, n] (unit-L multipliers below the diagonal, U with the
    boosted pivot on and above it)."""
    LU = A.clone()
    n = A.shape[-1]
    tau = torch.tensor(TAU, dtype=A.dtype, device=A.device)
    for k in range(n):
        piv = LU[:, k, k]
        piv = torch.where(piv.abs() < tau, torch.where(piv < 0, -tau, tau),
                          piv)
        mult = LU[:, k + 1:, k] / piv[:, None]
        LU[:, k + 1:, k + 1:] -= mult[:, :, None] * LU[:, k, None, k + 1:]
        LU[:, k + 1:, k] = mult
        LU[:, k, k] = piv
    return LU


def lu_factor_gesp_f32(A):
    """GESP factor of a batch A [B, n, n] float32.  CPU tensors take
    :func:`lu_factor_gesp_f32_plain`; CUDA tensors launch
    ``gesp_factor_f32`` (one thread block per matrix) or raise."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"lu_factor_gesp_f32: expected [B, n, n], got "
                         f"{tuple(A.shape)}")
    if A.device.type == "cpu":
        return lu_factor_gesp_f32_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"lu_factor_gesp_f32: unsupported device {A.device}")
    B, n, _ = A.shape
    _check("A", A, (B, n, n))
    LU = torch.empty_like(A)
    if B == 0 or n == 0:
        return LU
    lib = build()["lib"]
    err = lib.gesp_factor_f32(
        A.data_ptr(), LU.data_ptr(), B, n, n * n, n, n * n, n,
        torch.cuda.current_stream(A.device).cuda_stream)
    _raise_on(err, "gesp_factor_f32")
    lu_factor_gesp_f32.launches += 1
    return LU


lu_factor_gesp_f32.launches = 0


# ------------------------------------------------------------ substitution

def lu_subst_gesp_f32_plain(LU, b):
    """Plain PyTorch substitution with a packed GESP LU: y = L⁻¹b (unit
    diagonal), x = U⁻¹y with U's stored diagonal.  LU [B, n, n], b [B, n],
    float32 → x [B, n]."""
    n = LU.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        y[:, i] = b[:, i] - (LU[:, i, :i] * y[:, :i]).sum(-1)
    x = torch.zeros_like(b)
    for i in range(n - 1, -1, -1):
        x[:, i] = ((y[:, i] - (LU[:, i, i + 1:] * x[:, i + 1:]).sum(-1))
                   / LU[:, i, i])
    return x


def lu_subst_gesp_f32(LU, b):
    """Solve with a packed GESP LU: LU [B, n, n], b [B, n] float32 → x
    [B, n].  CPU tensors take :func:`lu_subst_gesp_f32_plain`; CUDA tensors
    launch ``gesp_subst_f32`` (one warp per system) or raise."""
    if LU.dim() != 3 or LU.shape[1] != LU.shape[2]:
        raise ValueError(f"lu_subst_gesp_f32: expected LU [B, n, n], got "
                         f"{tuple(LU.shape)}")
    B, n, _ = LU.shape
    if b.device != LU.device:
        raise ValueError(f"lu_subst_gesp_f32: LU on {LU.device}, b on "
                         f"{b.device}")
    if LU.device.type == "cpu":
        return lu_subst_gesp_f32_plain(LU, b)
    if LU.device.type != "cuda":
        raise ValueError(f"lu_subst_gesp_f32: unsupported device {LU.device}")
    _check("LU", LU, (B, n, n))
    _check("b", b, (B, n))
    x = torch.empty_like(b)
    if B == 0 or n == 0:
        return x
    lib = build()["lib"]
    err = lib.gesp_subst_f32(
        LU.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, n * n, n, n, n,
        torch.cuda.current_stream(LU.device).cuda_stream)
    _raise_on(err, "gesp_subst_f32")
    lu_subst_gesp_f32.launches += 1
    return x


lu_subst_gesp_f32.launches = 0
