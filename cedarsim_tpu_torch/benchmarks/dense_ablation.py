"""Where the dense solves' and the GESP factor's time goes: B4, B5 and B2
(``csrc/dense_solve.cuh``) built whole, with one part cut, and with one
other design of a part, each timed on the card.

    python -m cedarsim_tpu_torch.benchmarks.dense_ablation [--out FILE]

Each variant is the header with one textual cut, compiled by nvcc into its
own library under ``build/ablation/`` (the header's anonymous namespace
keeps each library's kernels its own):

* ``whole``: the kernels as the port runs them;
* ``no_update``: the trailing update skipped (the warp regime's row
  updates, B2's updates right of each panel, the block regime's pass over
  the trailing block);
* ``no_back``: the back substitution skipped;
* ``fast_division``: every IEEE division replaced by ``__fdividef``;
* ``row_smem`` (another design, not a cut): in the solves' warp regime
  the pivot row reaches the lanes through shared memory (the pivot's lane
  stores its row, one ``__syncwarp``, every lane reads it back,
  double-buffered by the step's parity) instead of one shuffle per column;
* ``factor_steps``, ``factor_panel8`` (other designs): B2's warp regime
  with panels of 1 step (the solves' step loop: each step's updates, then
  the rotation) or of 8 steps instead of 4;
* ``one_system_per_block`` (another launch): one warp per block in the
  warp regime instead of four.

A cut kernel computes the wrong x; only its time is read.  The other
designs compute the same bits (the same operands reach each FMA, in the
same order); B2's outputs are checked bitwise against its plain version
in every variant (``b2_bitwise_equal_to_plain``).  The time of a
part is the whole kernel's time less the variant's.  Device µs per launch
by CUDA-graph replay (``kernel_times.device_ms``) on the dense-LU bench's
systems at its two shapes and the n-sweep's edges.  One JSON object is
printed, with the card's name and power limit.  Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

#: (what is cut, [(text in the header, its replacement)])
CUTS = {
    "whole": [],
    "no_update": [
        ("    for (int r0 = warp; r0 < mr; r0 +=",
         "    for (int r0 = warp; r0 < mr * 0; r0 +="),
        ("      if (8 * g < live) {", "      if (8 * g < live * 0) {"),
        ("      if (8 * g + 7 >= kPanel && 8 * g < live) {",
         "      if (8 * g + 7 >= kPanel && 8 * g < live * 0) {")],
    "no_back": [
        ("  if (warp != 0) return;  // no block barrier below", "  return;"),
        ("  for (int k = n - 1; k >= 0; --k) {\n    const float rk = r[NP - 1];",
         "  for (int k = n - 1; k >= n; --k) {\n    const float rk = r[NP - 1];"),
    ],
    "fast_division": [
        ("    const float m = (below ? r[0] : piv) / piv;",
         "    const float m = __fdividef(below ? r[0] : piv, piv);"),
        ("      m[s] = (below[s] ? r[s] : piv) / piv;",
         "      m[s] = __fdividef(below[s] ? r[s] : piv, piv);"),
        ("    const float xk = __shfl_sync(kFull, y, src) / d;",
         "    const float xk = __fdividef(__shfl_sync(kFull, y, src), d);"),
        ("        s[i * ld + k] = (i == p ? s[k * ld + k] : s[i * ld + k]) / piv;",
         "        s[i * ld + k] = __fdividef("
         "i == p ? s[k * ld + k] : s[i * ld + k], piv);"),
        ("        s[i * ld + k1] = c / piv1;",
         "        s[i * ld + k1] = __fdividef(c, piv1);"),
        ("    const float xk = __shfl_sync(kFull, pick<CM>(y, k >> 5), k & 31) /\n"
         "                     Rule<PIVOT>::diag(s[k * ld + k]);",
         "    const float xk = __fdividef(__shfl_sync(kFull, pick<CM>(y, k >> 5),"
         " k & 31), Rule<PIVOT>::diag(s[k * ld + k]));"),
    ],
}
CUTS["row_smem"] = [
    ("    const int live = n - k;  // r[1 .. live - 1] hold columns k + 1 .. n - 1\n",
     "    const int live = n - k;  // r[1 .. live - 1] hold columns k + 1 .. n - 1\n"
     "    __shared__ __align__(16) float row_s[kWarpSystems][2][NP];\n"
     "    float* rowbuf = row_s[threadIdx.x >> 5][k & 1];\n"
     "    if (lane == src) {\n"
     "#pragma unroll\n"
     "      for (int j = 0; j < NP; ++j) rowbuf[j] = r[j];\n"
     "    }\n"
     "    __syncwarp();\n"),
    ("            const float t = __shfl_sync(kFull, r[j], src);",
     "            const float t = rowbuf[j];")]
CUTS["factor_steps"] = [("constexpr int kPanel = 4;", "constexpr int kPanel = 1;")]
CUTS["factor_panel8"] = [("constexpr int kPanel = 4;", "constexpr int kPanel = 8;")]
CUTS["one_system_per_block"] = [("constexpr int kWarpSystems = 4;",
                                 "constexpr int kWarpSystems = 1;")]
#: (B, n): the bench's two shapes and the regimes' edges
SHAPES = ((512, 25), (512, 32), (64, 33), (64, 122), (64, 240))
#: (B, n) of the GESP factor: the transient's shape and the regimes' edges
FACTOR_SHAPES = ((8, 8), (8, 16), (8, 25), (8, 32), (8, 33), (8, 122))
ENTRY = ('extern "C" int solve_{tag}(const float* A, const float* b, '
         'float* x, int B, int n, long long ab, long long ar, long long bb, '
         'long long xb, void* s) {{ return dense_solve::solve<{pivot}>('
         'A, b, x, B, n, ab, ar, bb, xb, s); }}\n')
FACTOR_ENTRY = ('extern "C" int factor_gesp(const float* A, float* LU, int B, '
                'int n, long long ab, long long ar, long long lb, '
                'long long lr, void* s) { return dense_solve::dispatch<false, '
                'true>(A, nullptr, LU, B, n, ab, ar, 0, lb, lr, s); }\n')


def build(out_dir):
    """Compile every variant (one nvcc each, all at once); returns {name:
    ctypes library}."""
    from cedarsim_tpu_torch.ops import cuda_lib
    with open(os.path.join(cuda_lib.CSRC, "dense_solve.cuh")) as f:
        header = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, cuts in CUTS.items():
        text = header
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"{name}: the cut no longer matches "
                                   f"dense_solve.cuh: {old!r}")
            text = text.replace(old, new)
        with open(os.path.join(out_dir, f"{name}.cuh"), "w") as f:
            f.write(text)
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(f'#include "{name}.cuh"\n'
                    + ENTRY.format(tag="gesp", pivot="false")
                    + ENTRY.format(tag="pivot", pivot="true")
                    + FACTOR_ENTRY)
        procs[name] = subprocess.Popen(
            [cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for fn in (lib.solve_gesp, lib.solve_pivot):
            fn.argtypes = [p, p, p, i, i, ll, ll, ll, ll, p]
            fn.restype = i
        lib.factor_gesp.argtypes = [p, p, i, i, ll, ll, ll, ll, p]
        lib.factor_gesp.restype = i
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("dense_ablation: no CUDA device")
    import numpy as np
    from cedarsim_tpu_torch.benchmarks import kernel_times as kt
    from cedarsim_tpu_torch.benchmarks import lu_bench
    from cedarsim_tpu_torch.ops import cuda_lib, gesp_lu
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    libs = build(os.path.join(here, "build", "ablation"))
    dev = torch.device("cuda", 0)
    times = {}
    for B, n in SHAPES:
        A, b = lu_bench.make_systems(B, n)
        A32 = torch.as_tensor(A, dtype=torch.float32, device=dev)
        b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
        x = torch.empty_like(b32)
        for name, lib in libs.items():
            for kernel, fn in (("B4", lib.solve_gesp),
                               ("B5", lib.solve_pivot)):
                def run(fn=fn):
                    cuda_lib.raise_on(fn(
                        A32.data_ptr(), b32.data_ptr(), x.data_ptr(), B, n,
                        n * n, n, n, n, cuda_lib.current_stream(dev)), name)
                    return x
                times[f"{kernel} {name} {B}x{n}"] = kt.device_ms(run) * 1e3
    same = {}
    for B, n in FACTOR_SHAPES:
        A, _ = kt.dominant_systems(np.random.default_rng(n), B, n)
        A32 = torch.as_tensor(A, dtype=torch.float32, device=dev)
        ref = gesp_lu.lu_factor_gesp_f32_plain(A32)
        for name, lib in libs.items():
            LU = torch.empty_like(A32)

            def run(lib=lib, LU=LU):
                cuda_lib.raise_on(lib.factor_gesp(
                    A32.data_ptr(), LU.data_ptr(), B, n, n * n, n, n * n, n,
                    cuda_lib.current_stream(dev)), name)
                return LU
            times[f"B2 {name} {B}x{n}"] = kt.device_ms(run) * 1e3
            same[f"B2 {name} {B}x{n}"] = torch.equal(
                run().view(torch.int32), ref.view(torch.int32))
    res = {"card": kt.smi(), "device_us": times,
           "b2_bitwise_equal_to_plain": same}
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return res


if __name__ == "__main__":
    main()
