// The one elimination and the one substitution of the two batched dense
// float32 solves, for Hopper (sm_90a), templated on pivoting:
//
//   PIVOT = false: gesp_lu.cu::gesp_solve_f32 (B4), replacing the Pallas
//       kernel cedarsim_tpu/ops/pallas_lu.py::_lu_sublane_kernel.  No
//       pivoting; the pivot is boosted to +-1e-20 (|p| < 1e-20; 0 -> +1e-20)
//       for the multipliers and U's diagonal again for the back
//       substitution.
//   PIVOT = true: pivot_lu.cu::pivot_solve_f32 (B5), replacing
//       pallas_lu.py::_lu_solve_kernel.  Partial pivoting: in step k the
//       pivot is the row at position >= k of largest |A[i, k]|, ties to the
//       smaller position, a NaN magnitude below every number; the pivot is
//       boosted to +-1e-30 for the multipliers only, and the back
//       substitution divides by the stored diagonal (so an exactly zero
//       pivot gives a non-finite x).
//   FACTOR = true (with PIVOT = false): gesp_lu.cu::gesp_factor_f32 (B2),
//       replacing pallas_lu.py::_lu_factor_sublane_kernel.  B4's
//       elimination without b and without the back substitution; it writes
//       the packed LU: the multipliers below the diagonal, U above it and
//       the boosted pivot on it.
//
// All instantiations run the same operations in the same order, so where
// no row is exchanged and no pivot is below 1e-20 they give the same bits
// (and B2's factor is the elimination that B4 runs).  Step k computes each
// row's multiplier once, m_i = A[i, k] / pivot, updates A[i, j] -= m_i
// A[k, j] (j > k, one fused multiply-add) and b_i -= m_i b_k; the back
// substitution runs in column order: x_k = y_k / U[k, k], then every row
// above subtracts U[i, k] x_k.
//
// What bounds them on an H100.  At the dense-LU bench's shapes ([512, 25]
// and [64, 122]) a system is 10^4-10^6 flops and 2.6-60 KB, so the card's
// rates are far away (bound 0.4-1.2 µs a launch): the n dependent
// elimination steps and the latency of each bound the time.  A block per
// system with every step ending in one to four block barriers, and a
// trailing update whose loads wait for the previous row's stores, spends
// 0.9 µs a step at n = 25 and 2.3 µs at n = 122 on an H100 (PERF.md).
//
// What the design does about it: two regimes, dispatched on n.
//
// n <= 32 (solve_warp_kernel): one warp per system, kWarpSystems systems
// per block, no shared memory and no block barrier.  Lane i holds row i of
// A (8, 16 or 32 registers) and b_i; lanes i >= n hold no row and take no
// part in the arithmetic (the exact equivalent of the Pallas wrapper's
// identity padding).  Step k: for B5 the argmax over the lanes at position
// >= k in two warp reductions (__reduce_max_sync on |A[i, k]|'s bits, then
// __reduce_min_sync on the positions that hold it), then an exchange of
// the two lanes' position registers (the same exchange as a physical row
// swap: the same bits, the same tie rule); the pivot row's entries are
// broadcast with one shuffle each, and each lane below divides its own
// A[i, k] once and updates its row and b_i.  Every lane then rotates its
// row by one register, so that the next step's column is again in r[0]
// and every register index stays static in a loop that is not unrolled;
// the back substitution rotates back.  The lanes that are not below divide
// the pivot by itself rather than a zero (a zero dividend takes the
// division's slow path for the whole warp).  The factor takes the same
// steps in panels of four (factor_panels), which keeps the trailing
// updates of a panel free of divisions and branches.
//
// 32 < n <= 240 (solve_block_kernel): one block of 256 threads per system,
// [A | b] (b as column n, at an odd row stride, so that a column's 32
// reads hit 32 banks) in shared memory, the multipliers in place below the
// diagonal.  Each update reads and writes one float of shared memory for
// two flops, so the steps go in pairs: one pass over the trailing block
// applies both steps to each entry it loads (the same two roundings in the
// same order as two passes, so the same bits), which halves that traffic.
// Before the pass, phases of O(n) work make what it reads: step k's pivot
// (B5: from the eight warps' winners, the physical exchange of rows k and
// p in columns > k, b included) and multipliers; step k's update of column
// k + 1 and step k + 1's pivot, pivot row and multipliers.  B4 takes three
// block barriers a pair of steps, B5 four.  In the pass lane l holds
// columns k+2+l+32c (c < CM, the two pivot rows' values for them in
// registers) and warp w rows k+2+w+8r, RU rows at a time with all their
// loads issued before any store, so that they are in flight together; lane
// 0 of each warp, which holds column k+2, reduces its rows' argmax for the
// next pair as it goes.  Warp 0 then substitutes backwards as
// gesp_subst_kernel does (y in registers, CM rows a lane, U's column k read
// from shared memory).

#pragma once

#include <cuda_runtime.h>

namespace dense_solve {
namespace {  // each kernel library keeps its own copy

constexpr unsigned kFull = 0xffffffffu;
// systems (warps) per block in the register regime
constexpr int kWarpSystems = 4;
// threads per system in the shared-memory regime, and its warps
constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / 32;
// shared-memory elements a trailing-update thread has in flight
constexpr int kInFlight = 16;
// device-memory loads a thread has in flight while a system is staged
constexpr int kStage = 8;
// no row: the argmax key of a lane or warp without a candidate
constexpr int kNoRow = 1 << 30;

__device__ __forceinline__ float boost(float p, float tau) {
  return fabsf(p) < tau ? (p < 0.0f ? -tau : tau) : p;
}

// the two boosting rules: the multipliers' divisor and the back
// substitution's (the factor stores the multipliers' divisor on the
// diagonal)
template <bool PIVOT>
struct Rule;
template <>
struct Rule<false> {
  __device__ __forceinline__ static float mult(float p) {
    return boost(p, 1e-20f);
  }
  __device__ __forceinline__ static float diag(float d) {
    return boost(d, 1e-20f);
  }
};
template <>
struct Rule<true> {
  __device__ __forceinline__ static float mult(float p) {
    return boost(p, 1e-30f);
  }
  __device__ __forceinline__ static float diag(float d) { return d; }
};

// the argmax key of an entry as an unsigned integer that orders like its
// magnitude: the bits of |v| plus one (the bits of a non-negative float
// order as the float does), NaN 0
__device__ __forceinline__ unsigned magnitude_key(float v) {
  const float a = fabsf(v);
  return a == a ? __float_as_uint(a) + 1u : 0u;
}

// y[r] for a row slot r known only at run time, without indexing the
// register array (an indexed read would put it in local memory)
template <int R>
__device__ __forceinline__ float pick(const float (&y)[R], int r) {
  float v = y[0];
#pragma unroll
  for (int q = 1; q < R; ++q) {
    if (q == r) v = y[q];
  }
  return v;
}

// Opt a kernel into `bytes` of dynamic shared memory (needed above 48 KB).
// `done` is that kernel's own record of what it was given: the attribute
// belongs to one kernel function, so each kernel keeps its own.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* done) {
  if (bytes <= *done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = bytes;
  return err;
}

// ------------------------------------------------- n <= 32: one warp each

// The steps of one panel of the factor's warp regime
constexpr int kPanel = 4;

// The factor's elimination in the warp regime (B2): lane `lane` holds row
// `lane` in r, column k0 + j in r[j] at the start of the panel of steps
// k0 .. k0 + kPanel - 1.  Each step is the solves' step above (the same
// multiplier, one IEEE division, and the same fused multiply-add on each
// entry, in the same order of steps, so the same bits), but the steps of a
// panel are taken together: first the panel's own columns, step by step,
// which make the kPanel multipliers and leave each column of the packed LU
// in its register (the multiplier below the pivot, the boosted pivot on
// the pivot's lane); then the columns to the right, each 8-column group
// applying the panel's steps in order.  The chain that bounds a step
// (broadcast the pivot, divide, update the next column) runs once a step
// in the panel, and the trailing updates of kPanel steps, independent
// across columns, follow it with no division or branch between them; the
// rotation runs once a panel.  A last panel past n changes nothing (no
// lane is below its steps).  After it, column j sits in r[(j - R) mod NP],
// R = kPanel ceil(n / kPanel).
template <int NP>
__device__ __forceinline__ void factor_panels(float (&r)[NP], int n,
                                              int lane) {
  static_assert(NP % 8 == 0 && kPanel <= NP, "panels of at most NP steps");
  const bool own = lane < n;
  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const int live = n - k0;  // r[0 .. live - 1] hold columns k0 .. n - 1
    float m[kPanel];
    bool below[kPanel];
#pragma unroll
    for (int s = 0; s < kPanel; ++s) {
      const int k = k0 + s;
      const float piv =
          Rule<false>::mult(__shfl_sync(kFull, r[s], k & 31));
      below[s] = own && lane > k;
      // as in the solves: lanes not below divide the pivot by itself
      m[s] = (below[s] ? r[s] : piv) / piv;
#pragma unroll
      for (int j = s + 1; j < kPanel; ++j) {
        const float t = __shfl_sync(kFull, r[j], k & 31);
        const float upd = __fmaf_rn(-m[s], t, r[j]);
        r[j] = below[s] && j < live ? upd : r[j];
      }
      r[s] = below[s] ? m[s] : (own && lane == k ? piv : r[s]);
    }
#pragma unroll
    for (int g = 0; g < NP / 8; ++g) {
      if (8 * g + 7 >= kPanel && 8 * g < live) {  // warp-uniform
#pragma unroll
        for (int s = 0; s < kPanel; ++s) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int j = 8 * g + q;
            if (j >= kPanel) {
              const float t = __shfl_sync(kFull, r[j], (k0 + s) & 31);
              const float upd = __fmaf_rn(-m[s], t, r[j]);
              r[j] = below[s] && j < live ? upd : r[j];
            }
          }
        }
      }
    }
    float done[kPanel];
#pragma unroll
    for (int j = 0; j < kPanel; ++j) done[j] = r[j];
#pragma unroll
    for (int j = 0; j < NP - kPanel; ++j) r[j] = r[j + kPanel];
#pragma unroll
    for (int j = 0; j < kPanel; ++j) r[NP - kPanel + j] = done[j];
  }
}

// Rows of the warp regime's staging buffer: the factor writes its rows
// there and copies them out a row at a time, so that its stores are
// coalesced (the odd stride keeps the 32 lanes' writes of a column on 32
// banks)
constexpr int kStageLd = 33;

// NP: the registers of a row, 8, 16 or 32 >= n.  The step loop is not
// unrolled (an unrolled elimination is tens of kilobytes of straight-line
// code, run once, and waits on instruction fetch), so a register index
// that followed k would be a run-time index, which the compiler serves
// from local memory or long select chains.  Instead every lane rotates
// its row by one register after each step: column k of step k is always
// in r[0] and column k + j in r[j], and after the n steps column j sits in
// r[(j - n) mod NP] on every lane; the back substitution rotates the other
// way, so that column k of its step k is always in r[NP - 1].  The factor
// (FACTOR) eliminates in panels (factor_panels) and writes its rows out
// through shared memory.
//
// x, x_batch, x_row: the output, x [B, n] (x_row unused) or, for the
// factor, the packed LU [B, n, n] (b unused).
template <bool PIVOT, int NP, bool FACTOR>
__global__ void __launch_bounds__(32 * kWarpSystems)
solve_warp_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x, int B, int n, long long a_batch,
                  long long a_row, long long b_batch, long long x_batch,
                  long long x_row) {
  static_assert(!(PIVOT && FACTOR), "the factor does not pivot");
  const int lane = threadIdx.x & 31;
  const long long sys = (long long)blockIdx.x * kWarpSystems +
                        (threadIdx.x >> 5);
  if (sys >= B) return;  // the whole warp leaves together
  const bool own = lane < n;
  const float* a = A + sys * a_batch + (long long)lane * a_row;
  float r[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) r[j] = (own && j < n) ? a[j] : 0.0f;
  if constexpr (FACTOR) {
    factor_panels<NP>(r, n, lane);
    // row `lane` into the warp's rows of the staging buffer, then each
    // row out with one coalesced store
    __shared__ float stage[kWarpSystems][32 * kStageLd];
    float* st = stage[threadIdx.x >> 5];
    const int turned = (n + kPanel - 1) / kPanel * kPanel;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int j = (q + turned) & (NP - 1);  // r[q] holds column j
      if (own && j < n) st[lane * kStageLd + j] = r[q];
    }
    __syncwarp();
    float* lu = x + sys * x_batch;
    for (int i = 0; i < n; ++i) {
      if (lane < n) lu[(long long)i * x_row + lane] = st[i * kStageLd + lane];
    }
    return;
  }
  float y = own ? b[sys * b_batch + lane] : 0.0f;
  int pos = lane;  // the position of this lane's row
  for (int k = 0; k < n; ++k) {
    int src = k;  // the lane at position k
    if (PIVOT) {
      // the argmax in two warp reductions: the largest key, then the
      // smallest position holding it (keys of candidates only; NaN is 0,
      // below every number)
      const bool cand = own && pos >= k;
      const unsigned key = cand ? magnitude_key(r[0]) : 0u;
      const unsigned top = __reduce_max_sync(kFull, key);
      const int bi = (int)__reduce_min_sync(
          kFull, cand && key == top ? (unsigned)pos : (unsigned)kNoRow);
      // the exchange (bi is the same on every lane)
      pos = pos == k ? bi : (pos == bi ? k : pos);
      src = __ffs(__ballot_sync(kFull, own && pos == k)) - 1;
    }
    const float piv = Rule<PIVOT>::mult(__shfl_sync(kFull, r[0], src));
    const float yk = __shfl_sync(kFull, y, src);
    const bool below = own && pos > k;
    // the lanes that are not below divide the pivot by itself: a zero
    // dividend would send the warp down the division's slow path
    const float m = (below ? r[0] : piv) / piv;
    const int live = n - k;  // r[1 .. live - 1] hold columns k + 1 .. n - 1
#pragma unroll
    for (int g = 0; g < NP / 8; ++g) {
      if (8 * g < live) {  // warp-uniform: the group holds a live column
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = 8 * g + q;
          if (j > 0) {
            const float t = __shfl_sync(kFull, r[j], src);
            const float upd = __fmaf_rn(-m, t, r[j]);
            r[j] = below && j < live ? upd : r[j];
          }
        }
      }
    }
    const float yupd = __fmaf_rn(-m, yk, y);
    y = below ? yupd : y;
    const float first = r[0];
#pragma unroll
    for (int j = 0; j < NP - 1; ++j) r[j] = r[j + 1];
    r[NP - 1] = first;
  }
  // back substitution in column order (column n - 1 is in r[NP - 1])
  for (int k = n - 1; k >= 0; --k) {
    const float rk = r[NP - 1];  // U[pos, k]
    const int src =
        PIVOT ? __ffs(__ballot_sync(kFull, own && pos == k)) - 1 : k;
    const float d = Rule<PIVOT>::diag(__shfl_sync(kFull, rk, src));
    const float xk = __shfl_sync(kFull, y, src) / d;
    const float upd = __fmaf_rn(-rk, xk, y);
    y = pos == k ? xk : (own && pos < k ? upd : y);  // selects
#pragma unroll
    for (int j = NP - 1; j > 0; --j) r[j] = r[j - 1];
    r[0] = rk;
  }
  if (own) x[sys * x_batch + pos] = y;
}

template <bool PIVOT, bool FACTOR, int NP>
cudaError_t launch_warp(const float* A, const float* b, float* x, int B,
                        int n, long long a_batch, long long a_row,
                        long long b_batch, long long x_batch, long long x_row,
                        cudaStream_t stream) {
  const int blocks = (B + kWarpSystems - 1) / kWarpSystems;
  solve_warp_kernel<PIVOT, NP, FACTOR>
      <<<blocks, 32 * kWarpSystems, 0, stream>>>(
          A, b, x, B, n, a_batch, a_row, b_batch, x_batch, x_row);
  return cudaGetLastError();
}

// ------------------------------------- 32 < n <= 240: one block per system

// The row stride of [A | b] in shared memory: n + 1 entries, rounded up to
// an odd count so that the 32 reads of a column hit 32 banks.  The block's
// dynamic shared memory is n rows at that stride and one column of n
// floats (step k's update of column k + 1):
// 232,320 bytes at n = 240, of an H100 block's 232,448.
__host__ __device__ __forceinline__ int block_ld(int n) { return (n + 1) | 1; }

inline size_t block_smem(int n) {
  return ((size_t)n * block_ld(n) + (size_t)n) * sizeof(float);
}

// The row of the best of the eight warps' winners (the larger key, then
// the smaller row); its warp goes to *w
__device__ __forceinline__ int block_winner(const unsigned* red_k,
                                            const int* red_i, int* w) {
  unsigned bk = red_k[0];
  int bi = red_i[0];
  *w = 0;
#pragma unroll
  for (int q = 1; q < kBlockWarps; ++q) {
    if (red_k[q] > bk || (red_k[q] == bk && red_i[q] < bi)) {
      bk = red_k[q];
      bi = red_i[q];
      *w = q;
    }
  }
  return bi;
}

// Steps k and k + 1 of the elimination take one pass over the trailing
// block (rows and columns > k + 1): each entry is loaded once, updated with
// step k's multiplier and then step k + 1's (the same two roundings, in
// the same order, as two passes) and stored once.  Before the pass, O(n)
// phases make what it reads: step k's multipliers (into column k), step
// k's update of column k + 1 (into `col`) and, after step k + 1's pivot is
// known, its pivot row (row k + 1, updated by step k) and multipliers
// (into column k + 1).  B5 needs four block barriers a pair, B4 three.
// The factor (FACTOR) stages no b, stores each boosted pivot on the
// diagonal, and writes the packed LU back instead of substituting; an odd
// n's last step is its pivot alone.  x, x_batch, x_row as in the warp
// regime.
template <bool PIVOT, int CM, bool FACTOR>
__global__ void __launch_bounds__(kBlockThreads)
solve_block_kernel(const float* __restrict__ A, const float* __restrict__ b,
                   float* __restrict__ x, int n, long long a_batch,
                   long long a_row, long long b_batch, long long x_batch,
                   long long x_row) {
  static_assert(!(PIVOT && FACTOR), "the factor does not pivot");
  constexpr int RU = kInFlight / (2 * CM);  // rows a thread has in flight
  // [A | b]: n rows of n + 1 entries at stride ld, then step k's update of
  // column k + 1
  extern __shared__ float s[];
  __shared__ unsigned red_k[kBlockWarps];  // B5: each warp's argmax key,
  __shared__ int red_i[kBlockWarps];       // its row,
  __shared__ float red_s[kBlockWarps];     // and its entry
  const int ld = block_ld(n);
  float* col = s + n * ld;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* a = A + (long long)blockIdx.x * a_batch;
  const int nn = n * n;
  const int nc = FACTOR ? n : n + 1;  // the staged columns: A, then b
  // staged kStage elements a thread at a time, all loads before any store
  for (int e0 = tid; e0 < nn; e0 += kBlockThreads * kStage) {
    float v[kStage];
    int at[kStage];
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int e = e0 + q * kBlockThreads;
      const int i = e / n;
      at[q] = i * ld + (e - i * n);
      v[q] = e < nn ? a[(long long)i * a_row + (e - i * n)] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      if (e0 + q * kBlockThreads < nn) s[at[q]] = v[q];
    }
  }
  if constexpr (!FACTOR) {
    const float* bb = b + (long long)blockIdx.x * b_batch;
    for (int i = tid; i < n; i += kBlockThreads) s[i * ld + n] = bb[i];
  }
  if (PIVOT) {
    __syncthreads();
    // the argmax of column 0: lane 0 of warp w over rows w, w + 8, ...
    if (lane == 0) {
      unsigned bk = 0u;
      int bi = kNoRow;
      float bs = 0.0f;
      for (int i = warp; i < n; i += kBlockWarps) {
        const float v = s[i * ld];
        const unsigned key = magnitude_key(v);
        if (key > bk || (key == bk && i < bi)) {
          bk = key;
          bi = i;
          bs = v;
        }
      }
      red_k[warp] = bk;
      red_i[warp] = bi;
      red_s[warp] = bs;
    }
  }
  __syncthreads();
  for (int k = 0; k + 1 < n; k += 2) {
    const int k1 = k + 1;
    // phase 1: step k's pivot (B5: the winner, exchanged with row k in
    // columns > k) and multipliers, into column k of the rows below
    int p = k;
    float pk;
    if (PIVOT) {
      int w;
      p = block_winner(red_k, red_i, &w);
      pk = red_s[w];
      if (p != k) {  // the same in every thread; columns k + 1 .. n (b)
        for (int j = k1 + tid; j < nc; j += kBlockThreads) {
          const float t = s[k * ld + j];
          s[k * ld + j] = s[p * ld + j];
          s[p * ld + j] = t;
        }
      }
    } else {
      pk = s[k * ld + k];
    }
    {
      const float piv = Rule<PIVOT>::mult(pk);
      const int i = k1 + tid;  // n <= 240 < kBlockThreads
      if (i < n) {
        s[i * ld + k] = (i == p ? s[k * ld + k] : s[i * ld + k]) / piv;
      }
    }
    __syncthreads();
    int p1 = k1;
    float pk1;
    if (PIVOT) {
      // phase 2: step k's update of column k + 1 (rows > k) and its argmax
      if (tid == 0) s[k * ld + k] = pk;
      const int i = k1 + tid;
      unsigned key = 0u;
      if (i < n) {
        const float c =
            __fmaf_rn(-s[i * ld + k], s[k * ld + k1], s[i * ld + k1]);
        col[i] = c;
        key = magnitude_key(c);
      }
      const unsigned top = __reduce_max_sync(kFull, key);
      const int at = (int)__reduce_min_sync(
          kFull, i < n && key == top ? (unsigned)i : (unsigned)kNoRow);
      if (lane == 0) {
        red_k[warp] = top;
        red_i[warp] = at;
      }
      __syncthreads();
      // phase 3: step k + 1's pivot, its row (exchanged with row p1 in
      // columns > k + 1, and updated by step k) and its multipliers, into
      // column k + 1 of the rows below
      int w;
      p1 = block_winner(red_k, red_i, &w);
      pk1 = col[p1];
    } else {
      // phase 2-3 (no pivoting): step k's update of column k + 1 and of
      // the pivot entry, computed in each thread that needs it (the same
      // operands, so the same bits), then step k + 1's multipliers; the
      // factor stores step k's boosted pivot (no thread reads it again)
      pk1 = __fmaf_rn(-s[k1 * ld + k], s[k * ld + k1], s[k1 * ld + k1]);
      if (FACTOR && tid == 0) s[k * ld + k] = Rule<PIVOT>::mult(pk);
    }
    {
      const float piv1 = Rule<PIVOT>::mult(pk1);
      const int i = k1 + 1 + tid;
      if (i < n) {
        const float c =
            PIVOT ? (i == p1 ? col[k1] : col[i])
                  : __fmaf_rn(-s[i * ld + k], s[k * ld + k1], s[i * ld + k1]);
        s[i * ld + k1] = c / piv1;
      }
      const int j = k1 + 1 + tid;
      if (j < nc) {
        // the pivot row of step k + 1, updated by step k with its own
        // multiplier; the row it displaces moves to row p1 as it is
        const float rk1 = s[k1 * ld + j];
        const float rp = s[p1 * ld + j];
        s[k1 * ld + j] = __fmaf_rn(-s[p1 * ld + k], s[k * ld + j], rp);
        if (p1 != k1) s[p1 * ld + j] = rk1;
      }
    }
    if (PIVOT && tid == 0) s[k1 * ld + k1] = pk1;
    __syncthreads();
    // phase 4: the trailing block, rows and columns k + 2 .. (b is column
    // n), with both steps; B4 puts step k + 1's pivot on the diagonal
    if (!PIVOT && tid == 0) {
      s[k1 * ld + k1] = FACTOR ? Rule<PIVOT>::mult(pk1) : pk1;
    }
    const int k2 = k + 2;
    const int mr = n - k2;
    float u0[CM], u1[CM];
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      const int j = k2 + lane + 32 * c;
      u0[c] = j < nc ? s[k * ld + j] : 0.0f;
      u1[c] = j < nc ? s[k1 * ld + j] : 0.0f;
    }
    unsigned bk = 0u;  // lane 0: the argmax of column k + 2 over its rows
    int bi = kNoRow;
    float bs = 0.0f;
    for (int r0 = warp; r0 < mr; r0 += kBlockWarps * RU) {
      float m0[RU], m1[RU];
      float v[RU][CM];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int i = k2 + r0 + kBlockWarps * u;
        // row p1 now holds the row that was k + 1: its step-k multiplier
        // is in row k + 1's column k
        m0[u] = i < n ? s[(i == p1 ? k1 : i) * ld + k] : 0.0f;
        m1[u] = i < n ? s[i * ld + k1] : 0.0f;
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          const int j = k2 + lane + 32 * c;
          v[u][c] = (i < n && j < nc) ? s[i * ld + j] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < RU; ++u) {
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          v[u][c] = __fmaf_rn(-m1[u], u1[c],
                              __fmaf_rn(-m0[u], u0[c], v[u][c]));
        }
      }
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int i = k2 + r0 + kBlockWarps * u;
        if (i < n) {
#pragma unroll
          for (int c = 0; c < CM; ++c) {
            const int j = k2 + lane + 32 * c;
            if (j < nc) s[i * ld + j] = v[u][c];
          }
          if (PIVOT) {  // every lane, selects; lane 0's is column k + 2
            const unsigned key = magnitude_key(v[u][0]);
            const bool win = key > bk || (key == bk && i < bi);
            bk = win ? key : bk;
            bi = win ? i : bi;
            bs = win ? v[u][0] : bs;
          }
        }
      }
    }
    if (PIVOT && lane == 0) {
      red_k[warp] = bk;
      red_i[warp] = bi;
      red_s[warp] = bs;
    }
    __syncthreads();
  }
  if constexpr (FACTOR) {
    // an odd n's last step: its boosted pivot; then the packed LU out
    if ((n & 1) && tid == 0) {
      s[(n - 1) * ld + n - 1] = Rule<PIVOT>::mult(s[(n - 1) * ld + n - 1]);
    }
    __syncthreads();
    float* lu = x + (long long)blockIdx.x * x_batch;
    for (int e = tid; e < nn; e += kBlockThreads) {
      const int i = e / n;
      lu[(long long)i * x_row + (e - i * n)] = s[i * ld + (e - i * n)];
    }
    return;
  }
  if (warp != 0) return;  // no block barrier below
  // back substitution in column order, y_i in lane i % 32, slot i / 32
  float y[CM];
#pragma unroll
  for (int r = 0; r < CM; ++r) {
    const int i = lane + 32 * r;
    y[r] = i < n ? s[i * ld + n] : 0.0f;
  }
#pragma unroll 4
  for (int k = n - 1; k >= 0; --k) {
    const float xk = __shfl_sync(kFull, pick<CM>(y, k >> 5), k & 31) /
                     Rule<PIVOT>::diag(s[k * ld + k]);
#pragma unroll
    for (int r = 0; r < CM; ++r) {  // selects, not branches
      const int i = lane + 32 * r;
      const float u = i < k ? s[i * ld + k] : 0.0f;
      const float upd = __fmaf_rn(-u, xk, y[r]);
      y[r] = i == k ? xk : (i < k ? upd : y[r]);
    }
  }
  float* xx = x + (long long)blockIdx.x * x_batch;
#pragma unroll
  for (int r = 0; r < CM; ++r) {
    const int i = lane + 32 * r;
    if (i < n) xx[i] = y[r];
  }
}

template <bool PIVOT, bool FACTOR, int CM>
cudaError_t launch_block(const float* A, const float* b, float* x, int B,
                         int n, long long a_batch, long long a_row,
                         long long b_batch, long long x_batch,
                         long long x_row, cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;
  const size_t smem = block_smem(n);
  cudaError_t err =
      allow_smem(solve_block_kernel<PIVOT, CM, FACTOR>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  solve_block_kernel<PIVOT, CM, FACTOR><<<B, kBlockThreads, smem, stream>>>(
      A, b, x, n, a_batch, a_row, b_batch, x_batch, x_row);
  return cudaGetLastError();
}

// The regime and the registers a row or a lane's columns take, by n.  The
// factor (FACTOR, gesp_lu.cu::gesp_factor_f32) passes b = nullptr, x = LU
// and x_row = LU's row stride.
template <bool PIVOT, bool FACTOR>
int dispatch(const float* A, const float* b, float* x, int B, int n,
             long long a_batch, long long a_row, long long b_batch,
             long long x_batch, long long x_row, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n <= 8) {
    return (int)launch_warp<PIVOT, FACTOR, 8>(
        A, b, x, B, n, a_batch, a_row, b_batch, x_batch, x_row, st);
  }
  if (n <= 16) {
    return (int)launch_warp<PIVOT, FACTOR, 16>(
        A, b, x, B, n, a_batch, a_row, b_batch, x_batch, x_row, st);
  }
  if (n <= 32) {
    return (int)launch_warp<PIVOT, FACTOR, 32>(
        A, b, x, B, n, a_batch, a_row, b_batch, x_batch, x_row, st);
  }
  if (n <= 64) {
    return (int)launch_block<PIVOT, FACTOR, 2>(
        A, b, x, B, n, a_batch, a_row, b_batch, x_batch, x_row, st);
  }
  if (n <= 128) {
    return (int)launch_block<PIVOT, FACTOR, 4>(
        A, b, x, B, n, a_batch, a_row, b_batch, x_batch, x_row, st);
  }
  if (n <= 256) {
    return (int)launch_block<PIVOT, FACTOR, 8>(
        A, b, x, B, n, a_batch, a_row, b_batch, x_batch, x_row, st);
  }
  return (int)cudaErrorInvalidValue;
}

// A: [B, n, n], b and x: [B, n], float32, strides in elements (columns
// contiguous), 1 <= n <= 240 on an H100.  Returns cudaGetLastError() after
// the launch.
template <bool PIVOT>
int solve(const float* A, const float* b, float* x, int B, int n,
          long long a_batch, long long a_row, long long b_batch,
          long long x_batch, void* stream) {
  return dispatch<PIVOT, false>(A, b, x, B, n, a_batch, a_row, b_batch,
                                x_batch, 0, stream);
}

}  // namespace
}  // namespace dense_solve
