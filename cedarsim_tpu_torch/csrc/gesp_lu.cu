// Batched no-pivot GESP LU for small dense systems, in float32, for Hopper
// (sm_90a).  Two kernels with a plain C interface, loaded with ctypes by
// cedarsim_tpu_torch/ops/gesp_lu.py:
//
//   gesp_factor_f32  replaces the Pallas kernel
//       cedarsim_tpu/ops/pallas_lu.py::_lu_factor_sublane_kernel
//       (launched by lu_factor_batched_sublane_f32).
//   gesp_subst_f32   replaces the Pallas kernel
//       cedarsim_tpu/ops/pallas_lu.py::_lu_subst_sublane_kernel
//       (launched by lu_subst_batched_sublane_f32).
//
// GESP: no pivoting; a pivot p with |p| < 1e-20 becomes -1e-20 if p < 0 and
// +1e-20 otherwise (so p = 0 gives +1e-20), and the boosted pivot is stored
// on the diagonal.  The packed LU holds the unit-L multipliers below the
// diagonal and U on and above it.  The substitution divides by the stored
// diagonal as it is: it does not boost again.
//
// What bounds these kernels on an H100.  At the transient's shape (n = 25,
// B = lanes, a handful) the work is a few thousand flops per matrix, far
// below what one SM does in the time a launch takes: launch latency and the
// n sequential elimination steps, each ending in a barrier, bound them.  At
// large n the bound is shared memory per matrix: the factor keeps the whole
// matrix in shared memory, n² · 4 bytes, which caps n at 240 (230,400 of the
// 232,448 bytes a block may hold).
//
// What the simple design does about it.  One thread block per matrix for
// the factor, so B matrices run on B SMs in one launch and the n steps of a
// matrix never leave shared memory; the threads of the block share the
// trailing update of each step.  One warp per system for the substitution:
// a row is a dot product that the warp splits across its lanes and reduces
// with shuffles, and a warp needs no block barrier between rows.  Launch
// latency is not hidden here: batching several matrices per block, CUDA
// graphs and tensor-core (wgmma) trailing updates are later work.

#include <cuda_runtime.h>

namespace {

constexpr float kTau = 1e-20f;
constexpr int kFactorThreads = 256;
constexpr int kSubstWarps = 4;

__global__ void gesp_factor_kernel(const float* __restrict__ A,
                                   float* __restrict__ LU, int n,
                                   long long a_batch, long long a_row,
                                   long long lu_batch, long long lu_row) {
  extern __shared__ float s[];  // n × n, row-major
  const float* a = A + (long long)blockIdx.x * a_batch;
  float* lu = LU + (long long)blockIdx.x * lu_batch;
  const int nn = n * n;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    s[e] = a[(long long)(e / n) * a_row + (e % n)];
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    float piv = s[k * n + k];
    if (fabsf(piv) < kTau) piv = piv < 0.0f ? -kTau : kTau;
    // multipliers of the rows below the pivot, stored in column k
    for (int i = k + 1 + threadIdx.x; i < n; i += blockDim.x) {
      s[i * n + k] = s[i * n + k] / piv;
    }
    __syncthreads();
    // trailing update of the (n-k-1)² block; the boosted pivot goes onto
    // the diagonal (row k and column k are not read-modified here)
    const int m = n - k - 1;
    for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
      const int i = k + 1 + e / m;
      const int j = k + 1 + e % m;
      s[i * n + j] -= s[i * n + k] * s[k * n + j];
    }
    if (threadIdx.x == 0) s[k * n + k] = piv;
    __syncthreads();
  }
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    lu[(long long)(e / n) * lu_row + (e % n)] = s[e];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void gesp_subst_kernel(const float* __restrict__ LU,
                                  const float* __restrict__ b,
                                  float* __restrict__ x, int B, int n,
                                  long long lu_batch, long long lu_row,
                                  long long b_batch, long long x_batch) {
  extern __shared__ float s[];  // kSubstWarps × n: the running solution
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sys = blockIdx.x * kSubstWarps + warp;
  if (sys >= B) return;  // whole warps exit together: no block barrier below
  const float* lu = LU + (long long)sys * lu_batch;
  const float* bb = b + (long long)sys * b_batch;
  float* y = s + warp * n;
  // forward substitution with unit L: y_i = b_i - sum_{j<i} L_ij y_j
  for (int i = 0; i < n; ++i) {
    const float* row = lu + (long long)i * lu_row;
    float acc = 0.0f;
    for (int j = lane; j < i; j += 32) acc += row[j] * y[j];
    acc = warp_sum(acc);
    if (lane == 0) y[i] = bb[i] - acc;
    __syncwarp();
  }
  // back substitution with U's stored (already boosted) diagonal
  for (int i = n - 1; i >= 0; --i) {
    const float* row = lu + (long long)i * lu_row;
    float acc = 0.0f;
    for (int j = i + 1 + lane; j < n; j += 32) acc += row[j] * y[j];
    acc = warp_sum(acc);
    if (lane == 0) y[i] = (y[i] - acc) / row[i];
    __syncwarp();
  }
  float* xx = x + (long long)sys * x_batch;
  for (int j = lane; j < n; j += 32) xx[j] = y[j];
}

}  // namespace

extern "C" {

// A, LU: [B, n, n] float32 with the given batch and row strides (elements;
// columns contiguous).  Returns cudaGetLastError() after the launch.
int gesp_factor_f32(const float* A, float* LU, int B, int n,
                    long long a_batch, long long a_row, long long lu_batch,
                    long long lu_row, void* stream) {
  const size_t smem = (size_t)n * n * sizeof(float);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        gesp_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  gesp_factor_kernel<<<B, kFactorThreads, smem, (cudaStream_t)stream>>>(
      A, LU, n, a_batch, a_row, lu_batch, lu_row);
  return (int)cudaGetLastError();
}

// LU: [B, n, n], b and x: [B, n], float32, strides in elements.  Returns
// cudaGetLastError() after the launch.
int gesp_subst_f32(const float* LU, const float* b, float* x, int B, int n,
                   long long lu_batch, long long lu_row, long long b_batch,
                   long long x_batch, void* stream) {
  const int blocks = (B + kSubstWarps - 1) / kSubstWarps;
  const size_t smem = (size_t)kSubstWarps * n * sizeof(float);
  gesp_subst_kernel<<<blocks, kSubstWarps * 32, smem,
                      (cudaStream_t)stream>>>(LU, b, x, B, n, lu_batch,
                                              lu_row, b_batch, x_batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
