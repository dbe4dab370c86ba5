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
// destinations, term offsets and terms in the plan's list order), deals the
// destinations longest first, and records where each level's terms start.
//
// S1, per level: (1) the L entries divided by their pivot boosted to +-tau
// (|p| < tau becomes -tau if p < 0, else +tau; a thread boosts the pivot it
// reads); (2) the level's boosted pivots written back and every product
// L*U of the level formed into a scratch, one term a thread (no product
// reads a pivot); (3) each destination minus its products in list order,
// one destination a thread.  A barrier after each phase.  At the end every
// pivot is boosted once more.  S2: y = b[rperm]; per forward level every
// product f*y formed, then each row minus its products in list order; per
// backward level every product f*x formed, then each row's products summed
// from zero (segment_sum's order) and the row's (y - sum) divided by its
// pivot; out[cperm] = x.  Built with --fmad=false, every product and
// difference rounds on its own, as in the plain versions (ops/
// sparse_lu.py::factor_plain, solve_factored_plain), so a product is the
// same number whether a thread forms it beside its subtraction or in a
// phase of its own, and each kernel is bitwise its plain version.
//
// What bounds them on an H100 (measured with benchmarks/sparse_levels.py,
// which times a plan cut after each level, on the 40-cell BSIM4 chain's
// plan: n = 452, 6,645 values, 32 factor and 26 + 26 solve levels, one
// lane; an H100 80GB HBM3 at 700 W).  Not bytes (2 x 53 KB move in a few
// hundredths of a microsecond) but chains of dependent latencies.  The
// design this one replaced gave a thread a whole destination and had it
// walk the terms in order, each term an index load from device memory,
// then a gather that depends on it, then the subtraction: S2's five hub
// rows (the clock and supply nets; 410, 408, 412, 410 and 99 terms, one
// row a level) took 125 of its 202 us, about 73 ns a term, and a level of
// short rows 1-2.5 us; S1's first seven levels, where the busiest of 256
// threads walks 33-90 terms, took 54 of its 87 us.
//
// What the design does about it.  Products of a level do not depend on
// each other or on the running sum, so every thread forms them at once
// (coalesced index loads, consecutive threads on consecutive terms), and
// only the subtractions stay in order, each a shared-memory load beside a
// dependent difference: a hub row costs the latency of its float64
// subtractions, a few nanoseconds a term.  A lane's values, its unknowns
// (S2) and the products of its widest level live in shared memory, staged
// with cp.async at the start (all copies in flight at once), together
// with each level's offsets.  The schedule streams from device memory,
// each thread's first item of each phase read one level ahead, while the
// level before runs, and S2's rows take their products eight at a time
// (chain).  Without both, S1 took 56.95 us and S2 55.70, against 42.36
// and 41.22 (sparse_levels.py on the same card and plan, seeded values):
// the read-ahead is worth 15.4 us of S1 and 6.7 of S2, the unrolled chain
// 2.7-9.2 us of S2, while in S1 it cost 1.4 (so S1's destinations
// subtract one product at a time).  Staging S2's whole schedule in shared
// memory instead (values, unknowns, products and 14,508 ints: 118.5 KB)
// took 44.39 us, and the 90-cell level-1 chain's plan would need 264.5
// KB, above a block's 227 KB.  Reading offsets two levels ahead, warps
// with no item skipping the read-ahead and an inline ld.global.nc in
// place of __ldg saved 0.9-1.2 us of either kernel together, too little
// for their code.  What is left is each phase's chain of dependent
// shared-memory loads, float64 operations (S1's division above all) and
// the barrier, a fraction of a microsecond a level.  512 threads a block:
// the 40-cell chain's widest solve level (412 terms) forms its products in
// one pass, S1's widest (4,116) in nine.  A plan whose values and products
// do not fit a block's shared memory runs the same code on device memory
// (the output array, factored in place, and a workspace for the products
// and unknowns): a second regime, not a fallback.  One block per lane: at
// one lane, one SM of 132 works.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ double boosted(double p, double tau) {
  return fabs(p) < tau ? (p < 0.0 ? -tau : tau) : p;
}

// count elements from device memory into shared memory, all copies in
// flight at once (cp.async); the caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
}

// acc minus prod[a], prod[a + 1], ..., prod[e - 1], in that order, each
// difference rounded on its own: a destination of S1.
__device__ __forceinline__ double minus(double acc, const double* prod,
                                        int a, int e) {
  for (int j = a; j < e; ++j) acc -= prod[j];
  return acc;
}

// The same for a row of S2 (kAdd: acc + each product instead), the
// products loaded eight at a time, the next eight while eight differences
// run, so that the chain waits on one load and then on the differences
// alone (S2's hub rows take 99-412 terms; the unrolled loop is slower in
// S1, see the header).
template <bool kAdd>
__device__ __forceinline__ double chain(double acc, const double* prod,
                                        int a, int e) {
  double p[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) p[q] = a + q < e ? prod[a + q] : 0.0;
  for (int j = a + 8; j < e; j += 8) {
    double r[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) r[q] = j + q < e ? prod[j + q] : 0.0;
#pragma unroll
    for (int q = 0; q < 8; ++q) acc = kAdd ? acc + p[q] : acc - p[q];
#pragma unroll
    for (int q = 0; q < 8; ++q) p[q] = r[q];
    a = j;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (a + q >= e) break;
    acc = kAdd ? acc + p[q] : acc - p[q];
  }
  return acc;
}

struct FactorSchedule {
  const int* div_off;    // [levels + 1] into div_dst / div_piv
  const int* div_dst;    // L entries to divide
  const int* div_piv;    // their pivots
  const int* piv_off;    // [levels + 1] into piv
  const int* piv;        // each level's distinct pivots, to write back
  const int* dst_off;    // [levels + 1] into dst
  const int* dst;        // each level's destinations, longest first
  const int* term_off;   // [destinations + 1] into term_l / term_u
  const int* term_l;     // L entry of each term
  const int* term_u;     // U entry of each term
  const int* lev_term;   // [levels + 1] each level's first term
  const int* diag;       // [n] every pivot's position
};

// The four level offsets S1 reads (in shared memory in the shared regime,
// else the schedule's own arrays).
struct FactorLevels {
  const int* div;
  const int* piv;
  const int* dst;
  const int* term;
  int levels;
};

// One level's items of each phase, [lo, hi): divisions, pivots, terms,
// destinations (all empty past the last level).
struct FactorRange {
  int d0, d1, p0, p1, k0, k1, u0, u1;
};

__device__ __forceinline__ FactorRange factor_range(const FactorLevels& o,
                                                    int lv) {
  if (lv >= o.levels) return FactorRange{0, 0, 0, 0, 0, 0, 0, 0};
  return FactorRange{o.div[lv],  o.div[lv + 1],  o.piv[lv], o.piv[lv + 1],
                     o.term[lv], o.term[lv + 1], o.dst[lv], o.dst[lv + 1]};
}

// A thread's first item of each phase of one level (-1: none).
struct FactorItems {
  int dd, dp, p, l, u, d, a, e;
};

__device__ __forceinline__ FactorItems factor_items(const FactorSchedule& s,
                                                    const FactorRange& g) {
  FactorItems it{-1, 0, -1, -1, 0, -1, 0, 0};
  const int t = threadIdx.x;
  if (g.d0 + t < g.d1) {
    it.dd = __ldg(s.div_dst + g.d0 + t);
    it.dp = __ldg(s.div_piv + g.d0 + t);
  }
  if (g.p0 + t < g.p1) it.p = __ldg(s.piv + g.p0 + t);
  if (g.k0 + t < g.k1) {
    it.l = __ldg(s.term_l + g.k0 + t);
    it.u = __ldg(s.term_u + g.k0 + t);
  }
  if (g.u0 + t < g.u1) {
    it.d = __ldg(s.dst + g.u0 + t);
    it.a = __ldg(s.term_off + g.u0 + t);
    it.e = __ldg(s.term_off + g.u0 + t + 1);
  }
  return it;
}

// Per level, three phases, a barrier after each; a thread with no item in
// a phase goes straight to its barrier.  A thread's first item of each
// phase is read one level ahead (see the header).
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
sparse_factor_kernel(const double* __restrict__ vals, double* out,
                     double* work, int nnz_f, int n, int n_levels, int width,
                     double tau, FactorSchedule s) {
  extern __shared__ double smem[];
  const long long base = static_cast<long long>(blockIdx.x) * nnz_f;
  const int t = threadIdx.x;
  double* v;
  double* prod;
  FactorLevels o{s.div_off, s.piv_off, s.dst_off, s.lev_term, n_levels};
  if (kShared) {
    v = smem;
    prod = smem + nnz_f;
    int* offs = reinterpret_cast<int*>(prod + width);
    const int m = n_levels + 1;
    stage(v, vals + base, nnz_f);
    stage(offs, s.div_off, m);
    stage(offs + m, s.piv_off, m);
    stage(offs + 2 * m, s.dst_off, m);
    stage(offs + 3 * m, s.lev_term, m);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    o = FactorLevels{offs, offs + m, offs + 2 * m, offs + 3 * m, n_levels};
  } else {
    v = out + base;
    prod = work + static_cast<long long>(blockIdx.x) * width;
    for (int i = t; i < nnz_f; i += kThreads) v[i] = vals[base + i];
  }
  __syncthreads();
  FactorRange g = factor_range(o, 0);
  FactorItems cur = factor_items(s, g);
  for (int lv = 0; lv < n_levels; ++lv) {
    const FactorRange g_next = factor_range(o, lv + 1);
    const FactorItems nxt = factor_items(s, g_next);
    // (1) the L entries divided by their boosted pivots
    if (cur.dd >= 0) {
      v[cur.dd] = v[cur.dd] / boosted(v[cur.dp], tau);
      for (int i = g.d0 + t + kThreads; i < g.d1; i += kThreads) {
        const int dd = __ldg(s.div_dst + i);
        v[dd] = v[dd] / boosted(v[__ldg(s.div_piv + i)], tau);
      }
    }
    __syncthreads();
    // (2) the pivots written back; every product of the level formed
    if (cur.p >= 0) {
      v[cur.p] = boosted(v[cur.p], tau);
      for (int i = g.p0 + t + kThreads; i < g.p1; i += kThreads) {
        const int p = __ldg(s.piv + i);
        v[p] = boosted(v[p], tau);
      }
    }
    if (cur.l >= 0) {
      prod[t] = v[cur.l] * v[cur.u];
#pragma unroll 4
      for (int k = g.k0 + t + kThreads; k < g.k1; k += kThreads)
        prod[k - g.k0] = v[__ldg(s.term_l + k)] * v[__ldg(s.term_u + k)];
    }
    __syncthreads();
    // (3) each destination minus its products, in list order
    if (cur.d >= 0) {
      v[cur.d] = minus(v[cur.d], prod, cur.a - g.k0, cur.e - g.k0);
      for (int i = g.u0 + t + kThreads; i < g.u1; i += kThreads) {
        const int d = __ldg(s.dst + i);
        v[d] = minus(v[d], prod, __ldg(s.term_off + i) - g.k0,
                     __ldg(s.term_off + i + 1) - g.k0);
      }
    }
    __syncthreads();
    cur = nxt;
    g = g_next;
  }
  for (int i = t; i < n; i += kThreads) {
    const int p = __ldg(s.diag + i);
    v[p] = boosted(v[p], tau);
  }
  if (kShared) {
    __syncthreads();
    for (int i = t; i < nnz_f; i += kThreads) out[base + i] = v[i];
  }
}

struct SolveSchedule {
  const int* rperm;        // [n] row of A supplying permuted row i
  const int* cperm;        // [n] column of A of permuted column j
  const int* fw_off;       // [forward levels + 1] into fw_row
  const int* fw_row;       // each forward level's rows, longest first
  const int* fw_term_off;  // [rows + 1] into fw_pos / fw_col
  const int* fw_pos;       // L entry of each term
  const int* fw_col;       // the unknown it multiplies
  const int* fw_lev_term;  // [forward levels + 1] each level's first term
  const int* bw_off;       // [backward levels + 1] into bw_row
  const int* bw_row;       // each backward level's rows, longest first
  const int* bw_diag;      // their pivots' positions
  const int* bw_term_off;  // [rows + 1] into bw_pos / bw_col
  const int* bw_pos;       // U entry of each term
  const int* bw_col;       // the unknown it multiplies
  const int* bw_lev_term;  // [backward levels + 1] each level's first term
};

// One sweep: its level offsets into rows and terms (in shared memory in the
// shared regime), its rows and its terms.
struct Sweep {
  const int* off;
  const int* lev_term;
  const int* row;
  const int* term_off;
  const int* pos;
  const int* col;
  const int* diag;  // backward only
  int levels;
};

// One level's terms [k0, k1) and rows [r0, r1) (empty past the last).
struct SolveRange {
  int k0, k1, r0, r1;
};

__device__ __forceinline__ SolveRange solve_range(const Sweep& w, int lv) {
  if (lv >= w.levels) return SolveRange{0, 0, 0, 0};
  return SolveRange{w.lev_term[lv], w.lev_term[lv + 1], w.off[lv],
                    w.off[lv + 1]};
}

// A thread's first product term and first row of one level (-1: none).
struct SolveItems {
  int pos, col, row, a, e, diag;
};

template <bool kBackward>
__device__ __forceinline__ SolveItems solve_items(const Sweep& w,
                                                  const SolveRange& g) {
  SolveItems it{-1, 0, -1, 0, 0, 0};
  const int t = threadIdx.x;
  if (g.k0 + t < g.k1) {
    it.pos = __ldg(w.pos + g.k0 + t);
    it.col = __ldg(w.col + g.k0 + t);
  }
  if (g.r0 + t < g.r1) {
    it.row = __ldg(w.row + g.r0 + t);
    it.a = __ldg(w.term_off + g.r0 + t);
    it.e = __ldg(w.term_off + g.r0 + t + 1);
    if (kBackward) it.diag = __ldg(w.diag + g.r0 + t);
  }
  return it;
}

// Row r of a level done from its products prod[a, e): forward, y[r] minus
// them in order; backward, (y[r] - their sum from zero) / the pivot.
template <bool kBackward>
__device__ __forceinline__ void finish_row(const double* fv, double* y,
                                           const double* prod, int r, int a,
                                           int e, int diag) {
  if (kBackward)
    y[r] = (y[r] - chain<true>(0.0, prod, a, e)) / fv[diag];
  else
    y[r] = chain<false>(y[r], prod, a, e);
}

// One sweep, per level two phases, a barrier after each, in the way of
// sparse_factor_kernel.
template <bool kBackward>
__device__ __forceinline__ void sweep(const Sweep& w, const double* fv,
                                      double* y, double* prod) {
  const int t = threadIdx.x;
  SolveRange g = solve_range(w, 0);
  SolveItems cur = solve_items<kBackward>(w, g);
  for (int lv = 0; lv < w.levels; ++lv) {
    const SolveRange g_next = solve_range(w, lv + 1);
    const SolveItems nxt = solve_items<kBackward>(w, g_next);
    if (cur.pos >= 0) {
      prod[t] = fv[cur.pos] * y[cur.col];
#pragma unroll 4
      for (int k = g.k0 + t + kThreads; k < g.k1; k += kThreads)
        prod[k - g.k0] = fv[__ldg(w.pos + k)] * y[__ldg(w.col + k)];
    }
    __syncthreads();
    if (cur.row >= 0) {
      finish_row<kBackward>(fv, y, prod, cur.row, cur.a - g.k0,
                            cur.e - g.k0, cur.diag);
      for (int i = g.r0 + t + kThreads; i < g.r1; i += kThreads)
        finish_row<kBackward>(fv, y, prod, __ldg(w.row + i),
                              __ldg(w.term_off + i) - g.k0,
                              __ldg(w.term_off + i + 1) - g.k0,
                              kBackward ? __ldg(w.diag + i) : 0);
    }
    __syncthreads();
    cur = nxt;
    g = g_next;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
sparse_solve_kernel(const double* __restrict__ f,
                    const double* __restrict__ b, double* __restrict__ x,
                    double* work, int nnz_f, int n, int n_fwd, int n_bwd,
                    int width, SolveSchedule s) {
  extern __shared__ double smem[];
  const double* fl = f + static_cast<long long>(blockIdx.x) * nnz_f;
  const long long base = static_cast<long long>(blockIdx.x) * n;
  Sweep fw{s.fw_off, s.fw_lev_term, s.fw_row, s.fw_term_off,
           s.fw_pos, s.fw_col,      nullptr,  n_fwd};
  Sweep bw{s.bw_off, s.bw_lev_term, s.bw_row,  s.bw_term_off,
           s.bw_pos, s.bw_col,      s.bw_diag, n_bwd};
  const double* fv = fl;
  double* y;
  if (kShared) {
    double* sf = smem;
    y = smem + nnz_f;
    int* offs = reinterpret_cast<int*>(y + n + width);
    const int mf = n_fwd + 1, mb = n_bwd + 1;
    stage(sf, fl, nnz_f);
    stage(offs, s.fw_off, mf);
    stage(offs + mf, s.fw_lev_term, mf);
    stage(offs + 2 * mf, s.bw_off, mb);
    stage(offs + 2 * mf + mb, s.bw_lev_term, mb);
    __pipeline_commit();
    fv = sf;
    fw.off = offs;
    fw.lev_term = offs + mf;
    bw.off = offs + 2 * mf;
    bw.lev_term = offs + 2 * mf + mb;
  } else {
    y = work + static_cast<long long>(blockIdx.x) * (n + width);
  }
  double* prod = y + n;
  for (int i = threadIdx.x; i < n; i += kThreads)
    y[i] = b[base + __ldg(s.rperm + i)];
  if (kShared) __pipeline_wait_prior(0);
  __syncthreads();
  sweep<false>(fw, fv, y, prod);
  sweep<true>(bw, fv, y, prod);
  for (int i = threadIdx.x; i < n; i += kThreads)
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

// Threads per block of both kernels.
int sparse_lu_threads() { return kThreads; }

// vals, out: [L, nnz_f] float64, contiguous (out may not alias vals);
// width: the most terms of any level.  shared: 1 keeps a lane's values,
// the products of a level and the four level offsets in shared memory
// (8 * (nnz_f + width) + 16 * (n_levels + 1) bytes must fit a block; work
// unused), 0 factors in place in out with the products in work [L, width].
// Returns cudaGetLastError() after the launch.
int sparse_factor_f64(const double* vals, double* out, double* work, int L,
                      int nnz_f, int n, int n_levels, int width, double tau,
                      const int* div_off, const int* div_dst,
                      const int* div_piv, const int* piv_off, const int* piv,
                      const int* dst_off, const int* dst, const int* term_off,
                      const int* term_l, const int* term_u,
                      const int* lev_term, const int* diag, int shared,
                      void* stream) {
  const FactorSchedule s{div_off,  div_dst, div_piv, piv_off,
                         piv,      dst_off, dst,     term_off,
                         term_l,   term_u,  lev_term, diag};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared) {
    const int bytes = 8 * (nnz_f + width) + 16 * (n_levels + 1);
    cudaError_t err =
        allow_smem(sparse_factor_kernel<true>, &factor_allowed, bytes);
    if (err != cudaSuccess) return err;
    sparse_factor_kernel<true><<<L, kThreads, bytes, st>>>(
        vals, out, work, nnz_f, n, n_levels, width, tau, s);
  } else {
    sparse_factor_kernel<false><<<L, kThreads, 0, st>>>(
        vals, out, work, nnz_f, n, n_levels, width, tau, s);
  }
  return cudaGetLastError();
}

// f: [L, nnz_f], b, x: [L, n] float64, contiguous; width: the most terms
// of any solve level.  shared: 1 keeps a lane's values, unknowns, the
// products of a level and the four level offsets in shared memory
// (8 * (nnz_f + n + width) + 8 * (n_fwd + n_bwd + 2) bytes must fit a
// block; work unused), 0 keeps the unknowns and products in work
// [L, n + width].  Returns cudaGetLastError() after the launch.
int sparse_solve_f64(const double* f, const double* b, double* x,
                     double* work, int L, int nnz_f, int n, int n_fwd,
                     int n_bwd, int width, const int* rperm,
                     const int* cperm, const int* fw_off, const int* fw_row,
                     const int* fw_term_off, const int* fw_pos,
                     const int* fw_col, const int* fw_lev_term,
                     const int* bw_off, const int* bw_row,
                     const int* bw_diag, const int* bw_term_off,
                     const int* bw_pos, const int* bw_col,
                     const int* bw_lev_term, int shared, void* stream) {
  const SolveSchedule s{rperm,       cperm,  fw_off,  fw_row,
                        fw_term_off, fw_pos, fw_col,  fw_lev_term,
                        bw_off,      bw_row, bw_diag, bw_term_off,
                        bw_pos,      bw_col, bw_lev_term};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared) {
    const int bytes = 8 * (nnz_f + n + width) + 8 * (n_fwd + n_bwd + 2);
    cudaError_t err =
        allow_smem(sparse_solve_kernel<true>, &solve_allowed, bytes);
    if (err != cudaSuccess) return err;
    sparse_solve_kernel<true><<<L, kThreads, bytes, st>>>(
        f, b, x, work, nnz_f, n, n_fwd, n_bwd, width, s);
  } else {
    sparse_solve_kernel<false><<<L, kThreads, 0, st>>>(
        f, b, x, work, nnz_f, n, n_fwd, n_bwd, width, s);
  }
  return cudaGetLastError();
}

}  // extern "C"
