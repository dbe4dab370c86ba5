// Batched no-pivot GESP LU for small dense systems, in float32, for Hopper
// (sm_90a).  Three kernels with a plain C interface, loaded with ctypes by
// cedarsim_tpu_torch/ops/gesp_lu.py:
//
//   gesp_factor_f32  replaces the Pallas kernel
//       cedarsim_tpu/ops/pallas_lu.py::_lu_factor_sublane_kernel
//       (launched by lu_factor_batched_sublane_f32): the FACTOR
//       instantiation of dense_solve.cuh, B4's elimination without b.
//   gesp_subst_f32   replaces the Pallas kernel
//       cedarsim_tpu/ops/pallas_lu.py::_lu_subst_sublane_kernel
//       (launched by lu_subst_batched_sublane_f32).
//   gesp_solve_f32   replaces the Pallas kernel
//       cedarsim_tpu/ops/pallas_lu.py::_lu_sublane_kernel
//       (launched by lu_solve_batched_sublane_f32): factor and solve in one
//       launch, b eliminated in each factor step, the boost applied again
//       to U's diagonal in the back substitution.
//
// GESP: no pivoting; a pivot p with |p| < 1e-20 becomes -1e-20 if p < 0 and
// +1e-20 otherwise (so p = 0 gives +1e-20), and the boosted pivot is stored
// on the diagonal.  The packed LU holds the unit-L multipliers below the
// diagonal and U on and above it.  The substitution divides by the stored
// diagonal as it is: it does not boost again.  The fused solve keeps no LU:
// it boosts each pivot for its multipliers and again for the division of
// its back substitution, as the Pallas kernel does.
//
// Rounding.  Every update is one fused multiply-add (one rounding of
// a - m u) and every multiplier one IEEE division, as in the plain versions
// (ops/gesp_lu.py, through ops/rounding.py::fma_f32) and in the Pallas
// factor under XLA; the substitution rounds each product and each
// difference, as its plain version does (__fmul_rn and __fsub_rn, which
// nvcc never contracts into an FMA).  So each kernel is bitwise its plain
// version.
//
// What bounds these kernels on an H100.  At the transient's shape (n = 25,
// B = lanes, a handful) the work is a few thousand flops per matrix, far
// below what one SM does in the time a launch takes: launch latency and the
// chain of n (factor) or 2n (substitution) dependent steps bound them.
//
// What the design does about it.  The factor is the elimination of the
// fused solve (dense_solve.cuh), whose note says what bounds it and what
// the design does: one warp per system with the system in registers at
// n <= 32, with no shared memory and no barrier in the elimination (the
// rows leave through shared memory, so that the stores are coalesced); one
// block per system above, the matrix in shared memory, the steps taken in
// pairs with one pass over the trailing block for both.  Its shared memory
// caps n at 240 (232,320 of the 232,448 bytes a block may hold).  The
// substitution is a chain of 2n dependent steps, so its time is the length
// of one step: one warp per system and one system per block (8 lanes on 8
// SMs), the system staged once into shared memory with all its loads in
// flight, then column-order steps of one shuffle and one multiply-subtract,
// with no barrier and no device-memory load inside the chain
// (gesp_subst_kernel below); n (n | 1) floats staged cap n at 241.
// Launch latency is not hidden here: CUDA graphs are later work.
//
// The fused solve (B4) is the PIVOT = false instantiation of the dense
// solve shared with the pivoting solve (B5), dense_solve.cuh.

#include <cuda_runtime.h>

#include "dense_solve.cuh"

namespace {

using dense_solve::allow_smem;
using dense_solve::pick;

// One warp per system, one system per block.  Lane l owns the rows
// i = l + 32 r (r < R) and keeps y_i in a register.  Step k of the forward
// pass broadcasts y_k with one shuffle and every row below subtracts
// L_ik y_k; step k of the back pass broadcasts y_k, every lane divides it by
// the stored U_kk (the same operands, so the same bits) and every row above
// subtracts U_ik x_k, each product and difference rounded on its own.  The
// column reads LU[i][k] come from the system staged in shared memory at row
// stride n | 1 (odd, so the 32 lanes of a column read hit 32 banks); they
// do not depend on the broadcast value.
template <int R>
__global__ void gesp_subst_kernel(const float* __restrict__ LU,
                                  const float* __restrict__ b,
                                  float* __restrict__ x, int n,
                                  long long lu_batch, long long lu_row,
                                  long long b_batch, long long x_batch) {
  extern __shared__ float s[];  // n rows of stride n | 1: the packed LU
  const int lane = threadIdx.x;
  const int ld = n | 1;
  const float* lu = LU + (long long)blockIdx.x * lu_batch;
  const float* bb = b + (long long)blockIdx.x * b_batch;
  const int nn = n * n;
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n, j = e - i * n;
    s[i * ld + j] = lu[(long long)i * lu_row + j];
  }
  float y[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    y[r] = i < n ? bb[i] : 0.0f;
  }
  __syncwarp();
  // forward substitution with unit L, column by column
#pragma unroll 4
  for (int k = 0; k < n - 1; ++k) {
    const float yk = __shfl_sync(0xffffffffu, pick<R>(y, k >> 5), k & 31);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i > k && i < n) {
        y[r] = __fsub_rn(y[r], __fmul_rn(s[i * ld + k], yk));
      }
    }
  }
  // back substitution with U's stored (already boosted) diagonal
#pragma unroll 4
  for (int k = n - 1; k >= 0; --k) {
    const float xk =
        __shfl_sync(0xffffffffu, pick<R>(y, k >> 5), k & 31) / s[k * ld + k];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i == k) {
        y[r] = xk;
      } else if (i < k) {
        y[r] = __fsub_rn(y[r], __fmul_rn(s[i * ld + k], xk));
      }
    }
  }
  float* xx = x + (long long)blockIdx.x * x_batch;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < n) xx[i] = y[r];
  }
}

template <int R>
cudaError_t launch_subst(const float* LU, const float* b, float* x, int B,
                         int n, long long lu_batch, long long lu_row,
                         long long b_batch, long long x_batch,
                         cudaStream_t stream) {
  const size_t smem = (size_t)n * (n | 1) * sizeof(float);
  static size_t smem_set = 48 * 1024;
  cudaError_t err = allow_smem(gesp_subst_kernel<R>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  gesp_subst_kernel<R><<<B, 32, smem, stream>>>(LU, b, x, n, lu_batch,
                                                lu_row, b_batch, x_batch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A, LU: [B, n, n] float32 with the given batch and row strides (elements;
// columns contiguous), n <= 240 on an H100.  Returns cudaGetLastError()
// after the launch.
int gesp_factor_f32(const float* A, float* LU, int B, int n,
                    long long a_batch, long long a_row, long long lu_batch,
                    long long lu_row, void* stream) {
  return dense_solve::dispatch<false, true>(A, nullptr, LU, B, n, a_batch,
                                            a_row, 0, lu_batch, lu_row,
                                            stream);
}

// LU: [B, n, n], b and x: [B, n], float32, strides in elements, n <= 256
// (and n (n | 1) floats within a block's shared memory).  Returns
// cudaGetLastError() after the launch.
int gesp_subst_f32(const float* LU, const float* b, float* x, int B, int n,
                   long long lu_batch, long long lu_row, long long b_batch,
                   long long x_batch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n <= 32) {
    return (int)launch_subst<1>(LU, b, x, B, n, lu_batch, lu_row, b_batch,
                                x_batch, st);
  }
  if (n <= 64) {
    return (int)launch_subst<2>(LU, b, x, B, n, lu_batch, lu_row, b_batch,
                                x_batch, st);
  }
  if (n <= 128) {
    return (int)launch_subst<4>(LU, b, x, B, n, lu_batch, lu_row, b_batch,
                                x_batch, st);
  }
  if (n <= 256) {
    return (int)launch_subst<8>(LU, b, x, B, n, lu_batch, lu_row, b_batch,
                                x_batch, st);
  }
  return (int)cudaErrorInvalidValue;
}

// A: [B, n, n], b and x: [B, n], float32, strides in elements (columns
// contiguous).  Returns cudaGetLastError() after the launch.
int gesp_solve_f32(const float* A, const float* b, float* x, int B, int n,
                   long long a_batch, long long a_row, long long b_batch,
                   long long x_batch, void* stream) {
  return dense_solve::solve<false>(A, b, x, B, n, a_batch, a_row, b_batch,
                                   x_batch, stream);
}

}  // extern "C"
