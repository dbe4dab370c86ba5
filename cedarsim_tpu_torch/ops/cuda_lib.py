"""What the port's CUDA kernel modules share: the build of a ``csrc/``
source into a shared library with a plain C interface, loaded with
``ctypes``, and the checks a wrapper makes around a launch.

Every kernel module builds this way: ``nvcc`` for ``sm_90a`` at first use,
into ``build/kernels/`` beside the package, under a name keyed on a hash of
the source, the ``csrc/`` headers it includes, any generated header and
the flags, so a changed source builds
anew and an unchanged one loads at once.  A failed build or launch raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
#: the flags of every kernel library: Hopper's ``sm_90a``, a shared object,
#: and ptxas's registers, shared memory and spills in the log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: opt-in shared memory per block of an H100 (bytes); on a card the card's
#: own value is read
H100_SMEM_PER_BLOCK = 232448


def nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


#: one lock a library (its path stem): threads that build the same library
#: at once (two fused plans that emit the same source) share one nvcc run
#: and its temporary files
_BUILD_LOCKS = {}
_BUILD_LOCKS_GUARD = threading.Lock()


def build_library(prefix, source, flags=NVCC_FLAGS, header=None):
    """Compile ``source`` (if not built yet) and load it.  ``header``, if
    given, is ``(macro, text)``: the text is written beside the library and
    its path passed to nvcc as ``-D<macro>="<path>"``.  Returns a dict with
    the loaded ``lib``, the shared object's ``path``, nvcc's ``seconds``
    (0.0 when it was already built) and its ``log`` (kept beside the
    library, so a library built earlier still reports ptxas's lines).
    Threads of one process build a library once."""
    src = _source_bytes(source)
    hdr = header[1].encode() if header else b""
    tag = hashlib.sha256(src + b"\0" + hdr + b"\0"
                         + " ".join(flags).encode()).hexdigest()
    stem = os.path.join(BUILD_DIR, f"{prefix}_{tag[:16]}")
    with _BUILD_LOCKS_GUARD:
        lock = _BUILD_LOCKS.setdefault(stem, threading.Lock())
    with lock:
        return _build_locked(stem, source, flags, header, hdr)


def _build_locked(stem, source, flags, header, hdr):
    path, log_path = stem + ".so", stem + ".log"
    seconds = 0.0
    if os.path.isfile(path):
        with open(log_path) as f:
            log = f.read()
    else:
        os.makedirs(BUILD_DIR, exist_ok=True)
        defines = []
        if header:
            with open(stem + ".cuh", "wb") as f:
                f.write(hdr)
            defines = [f'-D{header[0]}="{stem}.cuh"']
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *flags, *defines, "-o", tmp, source],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{os.path.basename(source)}:\n{log[-20000:]}")
        with open(f"{log_path}.{os.getpid()}.tmp", "w") as f:
            f.write(log)
        os.replace(f"{log_path}.{os.getpid()}.tmp", log_path)
        os.replace(tmp, path)
    return dict(lib=ctypes.CDLL(path), path=path, seconds=seconds, log=log)


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_bytes(source):
    """The bytes a library is keyed on: the source and each header it
    includes by a quoted name from its own directory (``csrc/*.cuh``)."""
    with open(source, "rb") as f:
        parts = [f.read()]
    for name in _LOCAL_INCLUDE.findall(parts[0]):
        with open(os.path.join(os.path.dirname(source), name.decode()),
                  "rb") as f:
            parts.append(f.read())
    return b"\0".join(parts)


def raise_on(err, what):
    """Raise if a launch function returned a CUDA error (it returns
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def smem_per_block(device):
    """The shared memory one block may opt into on ``device`` (bytes): the
    card's own value, or an H100's where there is no card."""
    if device.type != "cuda":
        return H100_SMEM_PER_BLOCK
    index = device.index
    return _smem_optin(torch.cuda.current_device() if index is None
                       else index)


@functools.lru_cache(maxsize=None)
def _smem_optin(index):
    # read once per card: a wrapper checks it at every launch
    prop = torch.cuda.get_device_properties(index)
    return getattr(prop, "shared_memory_per_block_optin",
                   H100_SMEM_PER_BLOCK)


def current_stream(device):
    """The handle of the current CUDA stream on ``device``, an int for the
    launch functions: the stream PyTorch's own operators use next, the
    capturing one under CUDA graph capture.  It equals
    ``torch.cuda.current_stream(device).cuda_stream`` without building a
    Stream object, which costs a few µs at every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_smem(what, device, need):
    """Raise if a block needs more shared memory than the card gives one
    (the dense solves keep a whole system in shared memory and never fall
    back)."""
    limit = smem_per_block(device)
    if need > limit:
        raise ValueError(
            f"{what}: the system needs {need} bytes of shared memory per "
            f"block; the card ({torch.cuda.get_device_name(device)}) gives "
            f"a block at most {limit} bytes of shared memory (n <= 240 on "
            "an H100)")


def dense_solve_smem(n, static_bytes):
    """Dynamic shared memory per block of the dense solves and the GESP
    factor (``csrc/dense_solve.cuh``, B4, B5 and B2) at n unknowns: none at
    n <= 32 (one warp per system, in registers; the factor's 16.5 KB of
    static staging always fits); above, [A | b] at an odd row stride
    ((n + 1) | 1 floats, ``block_ld``) and one column of n floats, plus
    the kernel's ``static_bytes``."""
    if n <= 32:
        return 0
    return 4 * (n * ((n + 1) | 1) + n) + static_bytes


def check_f32(name, t, shape):
    """A kernel's float32 operand: its dtype, shape and contiguity."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_system(what, A, b):
    """The checks of a batched solve's wrapper before it picks a path: A
    [B, n, n] and b [B, n] on one device, the CPU or a card.  Returns
    (B, n)."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{what}: expected A [B, n, n], got "
                         f"{tuple(A.shape)}")
    B, n, _ = A.shape
    if b.device != A.device:
        raise ValueError(f"{what}: A on {A.device}, b on {b.device}")
    if tuple(b.shape) != (B, n):
        raise ValueError(f"{what}: expected b of shape {(B, n)}, got "
                         f"{tuple(b.shape)}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {A.device}")
    return B, n
