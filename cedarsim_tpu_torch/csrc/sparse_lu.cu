// Leveled static-pattern sparse LU for circuit Jacobians, in float64, for
// Hopper (sm_90a).  Two kernels with a plain C interface, loaded with
// ctypes by cedarsim_tpu_torch/ops/sparse_lu.py:
//
//   sparse_factor_f64 (S1) runs the level schedule of
//       cedarsim_tpu/ops/sparse_lu.py::factor, which is XLA there, not
//       Pallas (a jax.lax.fori_loop over packed level bands, one compiled
//       program per factor).
//   sparse_solve_f64  (S2) runs cedarsim_tpu/ops/sparse_lu.py::
//       solve_factored the same way.
//
// The plan (ops/sparse_lu.py::build_plan) fixes the pattern with its fill,
// the permutations and the levels: pivots of one level update disjoint
// positions of later levels, so a level is one parallel step.  The host
// groups each level's terms by destination once per plan (a CSR of
// destinations, term offsets and terms in the plan's list order).
//
// S1, per level: the L entries divided by their pivot boosted to +-tau
// (|p| < tau becomes -tau if p < 0, else +tau; a thread boosts the pivot it
// reads), then, after a barrier, each destination minus its L*U products
// in list order (one thread a destination) while the level's boosted
// pivots are written back (no update reads or writes a pivot of its own
// level); a barrier.  At the end every pivot is boosted once more.
// S2: y = b[rperm]; forward levels, each row minus its f*y terms in list
// order; backward levels, each row of the level minus the sum of its f*x
// terms taken from zero (segment_sum's order), divided by its pivot;
// out[cperm] = x.  Built with --fmad=false, every product and difference
// rounds on its own, as in the plain versions (ops/sparse_lu.py::
// factor_plain, solve_factored_plain), so each kernel is bitwise its
// plain version.
//
// What bounds them on an H100.  The plan the 40-cell BSIM4 chain runs (built
// with the probe weights) has n = 452, 6,645 values, 32 factor levels and
// 26 forward and 26 backward solve levels: a factor moves 2 x 53 KB, a few
// nanoseconds of the card's memory rate.  So few levels cannot explain the
// measured ~94 us (S1) and ~200 us (S2) on their own; the likely bound is
// the widest destinations, hub rows (the clock and supply nets) whose
// hundreds of terms one thread sums in list order, a chain of dependent
// loads and adds on one SM per lane.  That is not yet measured (PERF.md,
// open questions).
//
// What the design does about it.  One block per lane, and the level loop
// inside the kernel: one launch per factor or solve instead of the several
// launches a level an eager loop would take.  A lane's values stay in
// shared memory while nnz_f doubles fit a block (the dynamic opt-in above
// 48 KB; 29,056 values on an H100), so the dependent reads of a level hit
// shared memory; above that they stay in device memory in the same kernel
// (the output array, factored in place), a second regime, not a fallback.
// S2 keeps a lane's unknowns in shared memory the same way and reads the
// factored values, each once, through the read-only path, as every
// schedule array is.  Spreading one lane over several SMs and supernodal
// or blocked levels are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double boosted(double p, double tau) {
  return fabs(p) < tau ? (p < 0.0 ? -tau : tau) : p;
}

struct FactorSchedule {
  const int* div_off;    // [levels + 1] into div_dst / div_piv
  const int* div_dst;    // L entries to divide
  const int* div_piv;    // their pivots
  const int* piv_off;    // [levels + 1] into piv
  const int* piv;        // each level's distinct pivots, to write back
  const int* dst_off;    // [levels + 1] into dst
  const int* dst;        // each level's update destinations
  const int* term_off;   // [destinations + 1] into term_l / term_u
  const int* term_l;     // L entry of each term
  const int* term_u;     // U entry of each term
  const int* diag;       // [n] every pivot's position
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
sparse_factor_kernel(const double* __restrict__ vals, double* out, int nnz_f,
                     int n, int n_levels, double tau, FactorSchedule s) {
  extern __shared__ double smem[];
  const long long base = static_cast<long long>(blockIdx.x) * nnz_f;
  double* v = kShared ? smem : out + base;
  for (int i = threadIdx.x; i < nnz_f; i += blockDim.x) v[i] = vals[base + i];
  __syncthreads();
  for (int lv = 0; lv < n_levels; ++lv) {
    const int d1 = __ldg(s.div_off + lv + 1);
    for (int t = __ldg(s.div_off + lv) + threadIdx.x; t < d1;
         t += blockDim.x) {
      const int dd = __ldg(s.div_dst + t);
      v[dd] = v[dd] / boosted(v[__ldg(s.div_piv + t)], tau);
    }
    __syncthreads();
    const int p1 = __ldg(s.piv_off + lv + 1);
    for (int t = __ldg(s.piv_off + lv) + threadIdx.x; t < p1;
         t += blockDim.x) {
      const int p = __ldg(s.piv + t);
      v[p] = boosted(v[p], tau);
    }
    const int u1 = __ldg(s.dst_off + lv + 1);
    for (int t = __ldg(s.dst_off + lv) + threadIdx.x; t < u1;
         t += blockDim.x) {
      const int d = __ldg(s.dst + t);
      const int k1 = __ldg(s.term_off + t + 1);
      double acc = v[d];
      for (int k = __ldg(s.term_off + t); k < k1; ++k)
        acc = acc - v[__ldg(s.term_l + k)] * v[__ldg(s.term_u + k)];
      v[d] = acc;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = __ldg(s.diag + i);
    v[p] = boosted(v[p], tau);
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < nnz_f; i += blockDim.x)
      out[base + i] = v[i];
  }
}

struct SolveSchedule {
  const int* rperm;        // [n] row of A supplying permuted row i
  const int* cperm;        // [n] column of A of permuted column j
  const int* fw_off;       // [forward levels + 1] into fw_row
  const int* fw_row;       // each forward level's rows with terms
  const int* fw_term_off;  // [rows + 1] into fw_pos / fw_col
  const int* fw_pos;       // L entry of each term
  const int* fw_col;       // the unknown it multiplies
  const int* bw_off;       // [backward levels + 1] into bw_row
  const int* bw_row;       // each backward level's rows
  const int* bw_diag;      // their pivots' positions
  const int* bw_term_off;  // [rows + 1] into bw_pos / bw_col
  const int* bw_pos;       // U entry of each term
  const int* bw_col;       // the unknown it multiplies
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
sparse_solve_kernel(const double* __restrict__ f,
                    const double* __restrict__ b, double* __restrict__ x,
                    double* work, int nnz_f, int n, int n_fwd, int n_bwd,
                    SolveSchedule s) {
  extern __shared__ double smem[];
  const double* fl = f + static_cast<long long>(blockIdx.x) * nnz_f;
  const long long base = static_cast<long long>(blockIdx.x) * n;
  double* y = kShared ? smem : work + base;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    y[i] = b[base + __ldg(s.rperm + i)];
  __syncthreads();
  for (int lv = 0; lv < n_fwd; ++lv) {
    const int r1 = __ldg(s.fw_off + lv + 1);
    for (int t = __ldg(s.fw_off + lv) + threadIdx.x; t < r1;
         t += blockDim.x) {
      const int r = __ldg(s.fw_row + t);
      const int k1 = __ldg(s.fw_term_off + t + 1);
      double acc = y[r];
      for (int k = __ldg(s.fw_term_off + t); k < k1; ++k)
        acc = acc - __ldg(fl + __ldg(s.fw_pos + k)) * y[__ldg(s.fw_col + k)];
      y[r] = acc;
    }
    __syncthreads();
  }
  for (int lv = 0; lv < n_bwd; ++lv) {
    const int r1 = __ldg(s.bw_off + lv + 1);
    for (int t = __ldg(s.bw_off + lv) + threadIdx.x; t < r1;
         t += blockDim.x) {
      const int r = __ldg(s.bw_row + t);
      const int k1 = __ldg(s.bw_term_off + t + 1);
      double acc = 0.0;
      for (int k = __ldg(s.bw_term_off + t); k < k1; ++k)
        acc = acc + __ldg(fl + __ldg(s.bw_pos + k)) * y[__ldg(s.bw_col + k)];
      y[r] = (y[r] - acc) / __ldg(fl + __ldg(s.bw_diag + t));
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    x[base + __ldg(s.cperm + i)] = y[i];
}

// The dynamic shared memory a kernel may take, raised once to what a
// launch needs (above 48 KB a kernel must opt in).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int* allowed, int bytes) {
  if (bytes <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

int factor_allowed = 48 * 1024;
int solve_allowed = 48 * 1024;

}  // namespace

extern "C" {

// vals, out: [L, nnz_f] float64, contiguous (out may not alias vals).
// shared: 1 keeps a lane's values in shared memory (nnz_f * 8 bytes must
// fit a block), 0 factors them in place in out.  Returns
// cudaGetLastError() after the launch.
int sparse_factor_f64(const double* vals, double* out, int L, int nnz_f,
                      int n, int n_levels, double tau, const int* div_off,
                      const int* div_dst, const int* div_piv,
                      const int* piv_off, const int* piv, const int* dst_off,
                      const int* dst, const int* term_off, const int* term_l,
                      const int* term_u, const int* diag, int shared,
                      void* stream) {
  const FactorSchedule s{div_off, div_dst, div_piv, piv_off, piv, dst_off,
                         dst,     term_off, term_l, term_u, diag};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared) {
    const int bytes = nnz_f * static_cast<int>(sizeof(double));
    cudaError_t err =
        allow_smem(sparse_factor_kernel<true>, &factor_allowed, bytes);
    if (err != cudaSuccess) return err;
    sparse_factor_kernel<true><<<L, kThreads, bytes, st>>>(
        vals, out, nnz_f, n, n_levels, tau, s);
  } else {
    sparse_factor_kernel<false><<<L, kThreads, 0, st>>>(
        vals, out, nnz_f, n, n_levels, tau, s);
  }
  return cudaGetLastError();
}

// f: [L, nnz_f], b, x: [L, n] float64, contiguous; work: [L, n] scratch
// for the unknowns when shared is 0 (unused, and may be x, when 1).
// Returns cudaGetLastError() after the launch.
int sparse_solve_f64(const double* f, const double* b, double* x,
                     double* work, int L, int nnz_f, int n, int n_fwd,
                     int n_bwd, const int* rperm, const int* cperm,
                     const int* fw_off, const int* fw_row,
                     const int* fw_term_off, const int* fw_pos,
                     const int* fw_col, const int* bw_off, const int* bw_row,
                     const int* bw_diag, const int* bw_term_off,
                     const int* bw_pos, const int* bw_col, int shared,
                     void* stream) {
  const SolveSchedule s{rperm,  cperm,  fw_off,  fw_row,      fw_term_off,
                        fw_pos, fw_col, bw_off,  bw_row,      bw_diag,
                        bw_term_off, bw_pos, bw_col};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared) {
    const int bytes = n * static_cast<int>(sizeof(double));
    cudaError_t err =
        allow_smem(sparse_solve_kernel<true>, &solve_allowed, bytes);
    if (err != cudaSuccess) return err;
    sparse_solve_kernel<true><<<L, kThreads, bytes, st>>>(
        f, b, x, work, nnz_f, n, n_fwd, n_bwd, s);
  } else {
    sparse_solve_kernel<false><<<L, kThreads, 0, st>>>(
        f, b, x, work, nnz_f, n, n_fwd, n_bwd, s);
  }
  return cudaGetLastError();
}

}  // extern "C"
