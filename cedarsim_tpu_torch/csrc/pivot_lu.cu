// Batched LU solve with partial pivoting for small dense systems, in
// float32, for Hopper (sm_90a).  One entry point with a plain C interface,
// loaded with ctypes by cedarsim_tpu_torch/ops/pivot_lu.py:
//
//   pivot_solve_f32  replaces the Pallas kernel
//       cedarsim_tpu/ops/pallas_lu.py::_lu_solve_kernel
//       (launched by lu_solve_batched_f32).
//
// Semantics kept from the Pallas kernel: in step k the pivot row is the
// row at position >= k of largest |A[i, k]|, ties going to the smaller
// position; rows k and p of A and b are exchanged; the multipliers divide
// by the pivot boosted to +-1e-30 when |pivot| < 1e-30 (0 -> +1e-30), and
// b is eliminated with them; back substitution divides by the stored
// diagonal as it is, so an exactly zero pivot gives a non-finite x.  A NaN
// magnitude counts below every number (the plain version does the same),
// so a column of NaNs keeps row k.
//
// The kernels are the PIVOT = true instantiation of dense_solve.cuh, shared
// with the fused GESP solve (B4): its note says what bounds them on an H100
// (the n dependent elimination steps and their latency, not the card's
// rates) and what the design does about it.  At n <= 32 one warp holds a
// system in registers: the pivot search is two warp reductions on
// (|A[i, k]|, position) and the row exchange swaps two lanes' position
// registers.  Above, one block holds it in shared memory and takes the
// steps in pairs, one pass over the trailing block for two steps; lane 0
// of each warp reduces the next pair's first argmax over its rows inside
// that pass, and the second is a warp reduction in the pair's own phases.

#include <cuda_runtime.h>

#include "dense_solve.cuh"

extern "C" {

// A: [B, n, n], b and x: [B, n], float32, strides in elements (columns
// contiguous).  Returns cudaGetLastError() after the launch.
int pivot_solve_f32(const float* A, const float* b, float* x, int B, int n,
                    long long a_batch, long long a_row, long long b_batch,
                    long long x_batch, void* stream) {
  return dense_solve::solve<true>(A, b, x, B, n, a_batch, a_row, b_batch,
                                  x_batch, stream);
}

}  // extern "C"
