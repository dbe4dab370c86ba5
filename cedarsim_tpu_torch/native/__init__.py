"""Native (C++) host components, built on demand with the system toolchain
(counterpart of ``cedarsim_tpu/native/__init__.py``).

``symbolic.cpp`` is a byte-for-byte copy of the JAX package's: the sparse
symbolic-factorization planner (KLU's symbolic half: a minimum-degree
ordering and the fill count of an elimination order), which
``ops/sparse.py`` calls through ``ctypes``.  It is a host planner, not a
device path: ``g++`` builds it at first use into ``build/native/`` beside
the package (the JAX package builds into ``~/.cache``), and where no
compiler is found the pure-Python fallbacks of ``ops/sparse.py`` give the
same answers.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")

_lib = None
_tried = False


def _build():
    src = os.path.join(_HERE, "symbolic.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, "libcsim_symbolic.so")
    if (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src)):
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def get_lib():
    """ctypes handle to the native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = _build()
        lib = ctypes.CDLL(path)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.csim_md_order.argtypes = [ctypes.c_int, ip, ip, ip]
        lib.csim_md_order.restype = ctypes.c_int
        lib.csim_symbolic_fill.argtypes = [ctypes.c_int, ip, ip, ip, ip]
        lib.csim_symbolic_fill.restype = ctypes.c_longlong
        _lib = lib
    except Exception:
        _lib = None
    return _lib
