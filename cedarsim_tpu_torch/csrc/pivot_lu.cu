// Batched LU solve with partial pivoting for small dense systems, in
// float32, for Hopper (sm_90a).  One kernel with a plain C interface,
// loaded with ctypes by cedarsim_tpu_torch/ops/pivot_lu.py:
//
//   pivot_solve_f32  replaces the Pallas kernel
//       cedarsim_tpu/ops/pallas_lu.py::_lu_solve_kernel
//       (launched by lu_solve_batched_f32).
//
// Semantics kept from the Pallas kernel: in step k the pivot row is the
// row i >= k of largest |A[i, k]|, ties going to the smallest row index;
// rows k and p of A and b are swapped; the multipliers divide by the pivot
// boosted to +-1e-30 when |pivot| < 1e-30 (0 -> +1e-30), and b is
// eliminated with them; back substitution divides by the stored diagonal
// as it is, so an exactly zero pivot gives a non-finite x.  A NaN
// magnitude counts below every number (the plain version does the same),
// so a column of NaNs keeps row k.
//
// What bounds it on an H100.  At the bench's shapes ([512, 25] and
// [64, 122]) a system is 10^4-10^6 flops and 2.6-60 KB: the bound is the n
// dependent steps, each with a block-wide argmax and three barriers, not
// the card's rates (PERF.md).
//
// Design.  One thread block per system, A and b in shared memory (n² + n
// floats, so n <= 240).  Step k: each thread scans rows k + tid, k + tid +
// blockDim, ... for its best (|A[i, k]|, i); warps reduce with shuffles,
// comparing indices on ties, and warp 0 reduces the warps' winners.  The
// threads swap the two rows column by column, then each warp owns rows
// i > k for the trailing update (lanes over columns j > k, lane 0
// eliminating b_i), as the fused GESP solve does.  Warp 0 substitutes
// backwards.

#include <cuda_runtime.h>

namespace {

constexpr float kTiny = 1e-30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (v, i) beats (bv, bi): a larger magnitude, or an equal one at a smaller
// row index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
pivot_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                   float* __restrict__ x, int n, long long a_batch,
                   long long a_row, long long b_batch, long long x_batch) {
  extern __shared__ float s[];  // n × n row-major, then b (n)
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int piv_row;
  float* sb = s + n * n;
  const float* a = A + (long long)blockIdx.x * a_batch;
  const float* bb = b + (long long)blockIdx.x * b_batch;
  const int nn = n * n;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    s[e] = a[(long long)(e / n) * a_row + (e % n)];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) sb[i] = bb[i];
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int k = 0; k < n; ++k) {
    // block-wide argmax of |A[i, k]| over i >= k; NaN never wins (-1 start)
    float bv = -1.0f;
    int bi = k;
    for (int i = k + threadIdx.x; i < n; i += blockDim.x) {
      const float v = fabsf(s[i * n + k]);
      if (v > bv) { bv = v; bi = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : -1.0f;
      bi = lane < kWarps ? red_i[lane] : k;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) piv_row = bi;
    }
    __syncthreads();
    const int p = piv_row;
    if (p != k) {  // uniform over the block
      for (int j = k + threadIdx.x; j < n; j += blockDim.x) {
        const float t = s[k * n + j];
        s[k * n + j] = s[p * n + j];
        s[p * n + j] = t;
      }
      if (threadIdx.x == 0) {
        const float t = sb[k];
        sb[k] = sb[p];
        sb[p] = t;
      }
    }
    __syncthreads();
    float piv = s[k * n + k];
    if (fabsf(piv) < kTiny) piv = piv < 0.0f ? -kTiny : kTiny;
    const float* rk = s + k * n;
    for (int i = k + 1 + warp; i < n; i += kWarps) {
      float* ri = s + i * n;
      const float m = ri[k] / piv;
      for (int j = k + 1 + lane; j < n; j += 32) ri[j] -= m * rk[j];
      if (lane == 0) sb[i] -= m * sb[k];
    }
    __syncthreads();
  }
  if (warp != 0) return;  // no block barrier below
  // back substitution with the stored (unboosted) diagonal
  for (int i = n - 1; i >= 0; --i) {
    const float* ri = s + i * n;
    float acc = 0.0f;
    for (int j = i + 1 + lane; j < n; j += 32) acc += ri[j] * sb[j];
    acc = warp_sum(acc);
    if (lane == 0) sb[i] = (sb[i] - acc) / ri[i];
    __syncwarp();
  }
  float* xx = x + (long long)blockIdx.x * x_batch;
  for (int j = lane; j < n; j += 32) xx[j] = sb[j];
}

}  // namespace

extern "C" {

// A: [B, n, n], b and x: [B, n], float32, strides in elements (columns
// contiguous).  Returns cudaGetLastError() after the launch.
int pivot_solve_f32(const float* A, const float* b, float* x, int B, int n,
                    long long a_batch, long long a_row, long long b_batch,
                    long long x_batch, void* stream) {
  const size_t smem = (size_t)n * (n + 1) * sizeof(float);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        pivot_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  pivot_solve_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      A, b, x, n, a_batch, a_row, b_batch, x_batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
