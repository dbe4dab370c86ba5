// Fused chord-Newton solve for a batch of transient lanes, in float64 or,
// built with -DFC_REAL=float, in float32.
//
// Replaces the Pallas kernels cedarsim_tpu/ops/fused_chord.py::
// FusedChordPlan.build_kernel_batched (B1, :632) and ::build_kernel (B1',
// :526; here the same kernel at B = 1).  One launch runs the whole chord
// loop of one step attempt for every lane:
//
//   x = x0 + d, v = vanch + (c0/h) d
//   f = G_lin x + s_off + S_nl(x) + C_lin v + dQ_nl(x)[v]
//   dx = -(f * rinv) MT        (MT = inv(J/r)^T, made per lane outside)
//   a non-finite dx is zeroed, max|dx| is capped at 5, d += dx
//   done when no residual entry exceeds res_rel*(|S|+|ic|) + res_tol and no
//   update entry exceeds reltol*|x0 + d| + abstol, or after max_newton
//
// The nonlinear models S_nl, Q_nl and their charge tangent come from the
// header emitted from the Verilog-A interpreter (va/emit.py), included as
// FC_MODEL_HEADER; it defines fc_pre(group, dyn, t, h), fc_eval(group, lv,
// lvd, h, s, q, qd), FC_MAX_LVAR, FC_MAX_LROW, FC_MAX_DYN and FC_MAX_HOIST.
//
// What bounds it on an H100: the loop is serial (at most max_newton
// iterations, each a model walk, a dense n x n product and two block
// reductions), so a launch is latency-bound; one block per lane keeps 8
// lanes on 8 of the 132 SMs.  The per-instance model walk is one long
// straight-line float64 function per thread (divisions, pow, exp, sqrt),
// bound by its dependent long-latency operations and by registers (ptxas -v
// reports them and any spills).
//
// The design: one block per lane, one thread per device instance (threads
// loop when there are more), every per-lane row, this lane's MT and the
// per-instance row contributions in shared memory.  The part of each model
// walk that reads only the instance's params and the time (the size- and
// temperature-dependent parameter algebra) runs once per instance at the
// start of the launch, fc_pre, into a per-lane scratch in device memory
// (hs, written and read only by the thread that owns the instance); every
// evaluation of the loop runs only the rest, fc_eval, reading those values
// from hs.  The constant G_lin/C_lin come
// transposed, so the threads of a row loop read neighbouring addresses;
// each thread's row bounds of the scatter are loaded once per launch.  The
// scatter of instance rows into the circuit rows is a fixed-order sum over
// a precomputed per-row list, and every reduction is a block vote or a max,
// so a lane's result does not depend on scheduling: two launches on the
// same inputs give the same bits, and the same bits as the walk without the
// cut (the same operations in the same order, built with --fmad=false).
//
// The scalar type `real` (FC_REAL, double unless the build defines it) is
// that of the loop: the model walk (the header is emitted for it), the
// iterate, the residual and the convergence test.  In float32 this is the
// Pallas kernel's precision contract (cedarsim_tpu/ops/fused_chord.py:
// 41-53): the per-step inputs arrive in float64 and are rounded once as
// they are loaded, the plan's constants arrive in float32, and the state
// leaves in float64 as x0 + d with the float32 correction d added to the
// float64 predictor (the Pallas wrapper's x_init + dn); S and Q leave
// widened.  The one exception is the direction: MT stays float64 in shared
// memory and -(f * rinv) MT is summed in float64 on the FP64 cores, then
// rounded to `real`.  The Pallas kernel's float32 product cannot hold the
// BSIM-CMG DFF's chord: cond(J/r) is ~2e10 there, so rounding MT to
// float32 alone moves the direction by volts and no step above ~1.5 ps
// converges (tests/test_torch_mixed_precision.py); the H100 has the
// float64 units the TPU lacked, and the product is n^2 of the walk's
// thousands of operations.  No tensor cores (no TF32), no fast-math
// intrinsics.

#include <cuda_runtime.h>
#include <math.h>

#include FC_MODEL_HEADER

#ifndef FC_REAL
#define FC_REAL double
#define FC_BITS 64
#endif
#define FC_CAT2(a, b) a##b
#define FC_CAT(a, b) FC_CAT2(a, b)

namespace {

typedef FC_REAL real;

struct Args {
  const double* x0;     // [B, n] predictor (the anchor of the iterate)
  const double* MT;     // [B, n, n] inv(J/r)^T
  const double* rinv;   // [B, n] 1/r
  const double* soff;   // [B, n] linear-group offset S_lin(0, t)
  const double* vanch;  // [B, n] (c0 x0 + xdh)/h
  const double* coef;   // [B, 2] (c0/h, t)
  const int* live;      // [B] 0: the lane enters done
  const real* GlinT;    // [n, n] G_lin transposed (column j at j * n)
  const real* ClinT;    // [n, n] C_lin transposed
  const real* qoff;     // [n]
  const int* inst_group;  // [n_inst]
  const int* inst_var;    // [n_inst, FC_MAX_LVAR], n = ground / pad
  const real* dyn;        // [B, n_inst, FC_MAX_DYN]
  const int* row_ptr;     // [n + 1]
  const int* ent_slot;    // [nnz] instance * FC_MAX_LROW + local row
  const real* ent_scale;  // [B, nnz] $mult on KCL rows, else 1
  real* hs;               // [B, n_inst, FC_MAX_HOIST] scratch: fc_pre's values
  double* xn;           // [B, n]
  double* S;            // [B, n]
  double* Q;            // [B, n]
  int* stat;            // [B, 2] (ok, Newton iterations)
  int n, n_inst, nnz, max_newton;
  real reltol, abstol, res_rel, res_tol;
};

// the state a lane leaves with: in float64 the iterate x0 + d as it is; in
// float32 the float64 predictor plus the widened correction
__device__ __forceinline__ double state_out(double x0g, double x0s,
                                            double d) {
  return x0s + d;
}
__device__ __forceinline__ double state_out(double x0g, float x0s, float d) {
  return x0g + (double)d;
}

__device__ real block_max(real v, real* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  real m = red[0];
  for (int i = 1; i < nw; ++i) m = fmax(m, red[i]);
  return m;
}

// S, Q and the charge tangent ic at the iterate x0 + d; e0/e1 are this
// thread's row bounds of the scatter (its row is tid: n <= blockDim.x)
// (not inlined: the model walk is long, and the kernel calls this twice)
__device__ __noinline__ void parts(const Args& a, int b, real c0h,
                                   const real* x0, const real* d,
                                   const real* va, const real* so,
                                   const real* hs, int e0, int e1,
                                   real* x, real* v,
                                   real* S, real* Q, real* ic,
                                   real* is, real* iq, real* iqd) {
  const int n = a.n, tid = threadIdx.x, nt = blockDim.x;
  if (tid < n) {
    x[tid] = x0[tid] + d[tid];
    v[tid] = va[tid] + c0h * d[tid];
  }
  __syncthreads();
  for (int k = tid; k < a.n_inst; k += nt) {
    real lv[FC_MAX_LVAR], lvd[FC_MAX_LVAR];
    real s[FC_MAX_LROW], q[FC_MAX_LROW], qd[FC_MAX_LROW];
    for (int j = 0; j < FC_MAX_LVAR; ++j) {
      const int idx = a.inst_var[k * FC_MAX_LVAR + j];
      lv[j] = idx < n ? x[idx] : real(0);
      lvd[j] = idx < n ? v[idx] : real(0);
    }
    for (int r = 0; r < FC_MAX_LROW; ++r) s[r] = q[r] = qd[r] = real(0);
    fc_eval(a.inst_group[k], lv, lvd, hs + (size_t)k * FC_MAX_HOIST, s, q,
            qd);
    for (int r = 0; r < FC_MAX_LROW; ++r) {
      is[k * FC_MAX_LROW + r] = s[r];
      iq[k * FC_MAX_LROW + r] = q[r];
      iqd[k * FC_MAX_LROW + r] = qd[r];
    }
  }
  __syncthreads();
  if (tid < n) {
    const int i = tid;
    real sv = 0, qv = 0, cv = 0;
    for (int j = 0; j < n; ++j) {
      const real gij = a.GlinT[(size_t)j * n + i];
      const real cij = a.ClinT[(size_t)j * n + i];
      sv += gij * x[j];
      qv += cij * x[j];
      cv += cij * v[j];
    }
    sv += so[i];
    qv += a.qoff[i];
    const real* scale = a.ent_scale + (size_t)b * a.nnz;
    for (int e = e0; e < e1; ++e) {
      const real sc = scale[e];
      const int sl = a.ent_slot[e];
      sv += is[sl] * sc;
      qv += iq[sl] * sc;
      cv += iqd[sl] * sc;
    }
    S[i] = sv;
    Q[i] = qv;
    ic[i] = cv;
  }
  __syncthreads();
}

__global__ void fused_chord_kernel(Args a) {
  extern __shared__ real sm[];
  const int n = a.n, b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  real* x0 = sm;
  real* d = x0 + n;
  real* x = d + n;
  real* v = x + n;
  real* S = v + n;
  real* Q = S + n;
  real* ic = Q + n;
  real* g = ic + n;
  real* dx = g + n;
  real* ri = dx + n;
  real* so = ri + n;
  real* va = so + n;
  double* MT = (double*)(va + n);  // float64 in both forms (12 n is even)
  real* is = (real*)(MT + (size_t)n * n);
  real* iq = is + (size_t)a.n_inst * FC_MAX_LROW;
  real* iqd = iq + (size_t)a.n_inst * FC_MAX_LROW;
  real* red = iqd + (size_t)a.n_inst * FC_MAX_LROW;
  real* hs = a.hs + (size_t)b * a.n_inst * FC_MAX_HOIST;  // lane b's part

  const size_t rb = (size_t)b * n;
  for (int i = tid; i < n; i += nt) {
    x0[i] = a.x0[rb + i];
    d[i] = real(0);
    ri[i] = a.rinv[rb + i];
    so[i] = a.soff[rb + i];
    va[i] = a.vanch[rb + i];
  }
  for (int k = tid; k < n * n; k += nt) MT[k] = a.MT[(size_t)b * n * n + k];
  const real c0h = a.coef[2 * b], t = a.coef[2 * b + 1];
  // the launch-invariant part of every instance's model walk, once
  for (int k = tid; k < a.n_inst; k += nt) {
    fc_pre(a.inst_group[k], a.dyn + ((size_t)b * a.n_inst + k) * FC_MAX_DYN,
           t, hs + (size_t)k * FC_MAX_HOIST);
  }
  const int e0 = tid < n ? a.row_ptr[tid] : 0;
  const int e1 = tid < n ? a.row_ptr[tid + 1] : 0;
  __syncthreads();
  parts(a, b, c0h, x0, d, va, so, hs, e0, e1, x, v, S, Q, ic, is, iq,
        iqd);

  bool done = a.live[b] == 0;
  int it = 0;
  while (!done && it < a.max_newton) {
    for (int i = tid; i < n; i += nt) g[i] = (S[i] + ic[i]) * ri[i];
    __syncthreads();
    int bad_mine = 0;
    for (int i = tid; i < n; i += nt) {
      double acc = 0.0;
      for (int k = 0; k < n; ++k)
        acc += (double)g[k] * MT[(size_t)k * n + i];
      const real r = (real)(-acc);
      dx[i] = r;
      bad_mine |= !isfinite(r);
    }
    const bool bad = __syncthreads_or(bad_mine) != 0;
    real m = 0;
    for (int i = tid; i < n; i += nt)
      m = fmax(m, bad ? real(0) : fabs(dx[i]));
    const real mx = block_max(m, red);
    const real cap = mx > real(5) ? real(5) / fmax(mx, real(5)) : real(1);
    for (int i = tid; i < n; i += nt) {
      const real di = bad ? real(0) : dx[i] * cap;
      dx[i] = di;
      d[i] += di;
    }
    __syncthreads();
    parts(a, b, c0h, x0, d, va, so, hs, e0, e1, x, v, S, Q, ic, is, iq,
        iqd);
    int viol = 0;
    for (int i = tid; i < n; i += nt) {
      const real fn = S[i] + ic[i];
      const real sc = fabs(ic[i]) + fabs(S[i]);
      viol |= fabs(fn) > a.res_rel * sc + a.res_tol;
      viol |= fabs(dx[i]) > a.reltol * fabs(x0[i] + d[i]) + a.abstol;
    }
    done = __syncthreads_or(viol) == 0 && !bad;
    ++it;
  }
  int nonfin = 0;
  for (int i = tid; i < n; i += nt) nonfin |= !isfinite(d[i]);
  const bool ok = done && __syncthreads_or(nonfin) == 0;
  for (int i = tid; i < n; i += nt) {
    a.xn[rb + i] = state_out(a.x0[rb + i], x0[i], d[i]);
    a.S[rb + i] = S[i];
    a.Q[rb + i] = Q[i];
  }
  if (tid == 0) {
    a.stat[2 * b] = ok ? 1 : 0;
    a.stat[2 * b + 1] = it;
  }
}

}  // namespace

// n <= threads (one circuit row per thread).  Returns cudaGetLastError()
// after the launch.  The entry is fused_chord_f64 or, in float32,
// fused_chord_f32: the plan's constants, dyn and hs in `real`, the rest
// float64.
extern "C" int FC_CAT(fused_chord_f, FC_BITS)(
    const double* x0, const double* MT, const double* rinv,
    const double* soff, const double* vanch, const double* coef,
    const int* live, const real* GlinT, const real* ClinT,
    const real* qoff, const int* inst_group, const int* inst_var,
    const real* dyn, const int* row_ptr, const int* ent_slot,
    const real* ent_scale, real* hs, double* xn, double* S, double* Q,
    int* stat, int B, int n, int n_inst, int nnz, int max_newton,
    double reltol, double abstol, double res_rel, double res_tol,
    int threads, long long smem, void* stream) {
  if (n > threads) return (int)cudaErrorInvalidValue;
  Args a{x0, MT, rinv, soff, vanch, coef, live, GlinT, ClinT, qoff,
         inst_group, inst_var, dyn, row_ptr, ent_slot, ent_scale, hs, xn,
         S, Q, stat, n, n_inst, nnz, max_newton, (real)reltol,
         (real)abstol, (real)res_rel, (real)res_tol};
  // opt into more than 48 KB of dynamic shared memory once per size: the
  // attribute belongs to the kernel function, so this records what it was
  // given
  static long long smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_chord_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  fused_chord_kernel<<<B, threads, (size_t)smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
