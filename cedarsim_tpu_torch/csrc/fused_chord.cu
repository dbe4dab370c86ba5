// Fused chord-Newton solve for a batch of transient lanes, float64.
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
// FC_MODEL_HEADER; it defines fc_eval(group, ...), FC_MAX_LVAR,
// FC_MAX_LROW and FC_MAX_DYN.
//
// What bounds it on an H100: the loop is serial (at most max_newton
// iterations, each a model walk, a dense n x n product and two block
// reductions), so a launch is latency-bound; one block per lane keeps 8
// lanes on 8 of the 132 SMs.  The per-instance model walk is one long
// straight-line function per thread, bound by registers (ptxas -v reports
// them and any spills).  The simple design: one block per lane, one thread
// per device instance (threads loop when there are more), every per-lane
// row, this lane's MT and the per-instance row contributions in shared
// memory, the constant G_lin/C_lin/q_off read from global memory (L2).
// The scatter of instance rows into the circuit rows is a fixed-order sum
// over a precomputed per-row list, and every reduction is a block vote or a
// max, so a lane's result does not depend on scheduling: two launches on
// the same inputs give the same bits.

#include <cuda_runtime.h>
#include <math.h>

#include FC_MODEL_HEADER

namespace {

struct Args {
  const double* x0;     // [B, n] predictor (the anchor of the iterate)
  const double* MT;     // [B, n, n] inv(J/r)^T
  const double* rinv;   // [B, n] 1/r
  const double* soff;   // [B, n] linear-group offset S_lin(0, t)
  const double* vanch;  // [B, n] (c0 x0 + xdh)/h
  const double* coef;   // [B, 2] (c0/h, t)
  const int* live;      // [B] 0: the lane enters done
  const double* Glin;   // [n, n]
  const double* Clin;   // [n, n]
  const double* qoff;   // [n]
  const int* inst_group;  // [n_inst]
  const int* inst_var;    // [n_inst, FC_MAX_LVAR], n = ground / pad
  const double* dyn;      // [B, n_inst, FC_MAX_DYN]
  const int* row_ptr;     // [n + 1]
  const int* ent_slot;    // [nnz] instance * FC_MAX_LROW + local row
  const double* ent_scale;  // [B, nnz] $mult on KCL rows, else 1
  double* xn;           // [B, n]
  double* S;            // [B, n]
  double* Q;            // [B, n]
  int* stat;            // [B, 2] (ok, Newton iterations)
  int n, n_inst, nnz, max_newton;
  double reltol, abstol, res_rel, res_tol;
};

__device__ double block_max(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  double m = red[0];
  for (int i = 1; i < nw; ++i) m = fmax(m, red[i]);
  return m;
}

// S, Q and the charge tangent ic at the iterate x0 + d
// (not inlined: the model walk is long, and the kernel calls this twice)
__device__ __noinline__ void parts(const Args& a, int b, double c0h,
                                   double t, const double* x0,
                                   const double* d, const double* va,
                                   const double* so, double* x, double* v,
                                   double* S, double* Q, double* ic,
                                   double* is, double* iq, double* iqd) {
  const int n = a.n, tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < n; i += nt) {
    x[i] = x0[i] + d[i];
    v[i] = va[i] + c0h * d[i];
  }
  __syncthreads();
  for (int k = tid; k < a.n_inst; k += nt) {
    double lv[FC_MAX_LVAR], lvd[FC_MAX_LVAR];
    double s[FC_MAX_LROW], q[FC_MAX_LROW], qd[FC_MAX_LROW];
    for (int j = 0; j < FC_MAX_LVAR; ++j) {
      const int idx = a.inst_var[k * FC_MAX_LVAR + j];
      lv[j] = idx < n ? x[idx] : 0.0;
      lvd[j] = idx < n ? v[idx] : 0.0;
    }
    for (int r = 0; r < FC_MAX_LROW; ++r) s[r] = q[r] = qd[r] = 0.0;
    fc_eval(a.inst_group[k], lv, lvd,
            a.dyn + ((size_t)b * a.n_inst + k) * FC_MAX_DYN, t, s, q, qd);
    for (int r = 0; r < FC_MAX_LROW; ++r) {
      is[k * FC_MAX_LROW + r] = s[r];
      iq[k * FC_MAX_LROW + r] = q[r];
      iqd[k * FC_MAX_LROW + r] = qd[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    double sv = 0.0, qv = 0.0, cv = 0.0;
    const double* gr = a.Glin + (size_t)i * n;
    const double* cr = a.Clin + (size_t)i * n;
    for (int j = 0; j < n; ++j) {
      sv += gr[j] * x[j];
      qv += cr[j] * x[j];
      cv += cr[j] * v[j];
    }
    sv += so[i];
    qv += a.qoff[i];
    for (int e = a.row_ptr[i]; e < a.row_ptr[i + 1]; ++e) {
      const double sc = a.ent_scale[(size_t)b * a.nnz + e];
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
  extern __shared__ double sm[];
  const int n = a.n, b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  double* x0 = sm;
  double* d = x0 + n;
  double* x = d + n;
  double* v = x + n;
  double* S = v + n;
  double* Q = S + n;
  double* ic = Q + n;
  double* g = ic + n;
  double* dx = g + n;
  double* ri = dx + n;
  double* so = ri + n;
  double* va = so + n;
  double* MT = va + n;
  double* is = MT + (size_t)n * n;
  double* iq = is + (size_t)a.n_inst * FC_MAX_LROW;
  double* iqd = iq + (size_t)a.n_inst * FC_MAX_LROW;
  double* red = iqd + (size_t)a.n_inst * FC_MAX_LROW;

  const size_t rb = (size_t)b * n;
  for (int i = tid; i < n; i += nt) {
    x0[i] = a.x0[rb + i];
    d[i] = 0.0;
    ri[i] = a.rinv[rb + i];
    so[i] = a.soff[rb + i];
    va[i] = a.vanch[rb + i];
  }
  for (int k = tid; k < n * n; k += nt) MT[k] = a.MT[(size_t)b * n * n + k];
  const double c0h = a.coef[2 * b], t = a.coef[2 * b + 1];
  __syncthreads();
  parts(a, b, c0h, t, x0, d, va, so, x, v, S, Q, ic, is, iq, iqd);

  bool done = a.live[b] == 0;
  int it = 0;
  while (!done && it < a.max_newton) {
    for (int i = tid; i < n; i += nt) g[i] = (S[i] + ic[i]) * ri[i];
    __syncthreads();
    int bad_mine = 0;
    for (int i = tid; i < n; i += nt) {
      double acc = 0.0;
      for (int k = 0; k < n; ++k) acc += g[k] * MT[(size_t)k * n + i];
      dx[i] = -acc;
      bad_mine |= !isfinite(-acc);
    }
    const bool bad = __syncthreads_or(bad_mine) != 0;
    double m = 0.0;
    for (int i = tid; i < n; i += nt) m = fmax(m, bad ? 0.0 : fabs(dx[i]));
    const double mx = block_max(m, red);
    const double cap = mx > 5.0 ? 5.0 / fmax(mx, 5.0) : 1.0;
    for (int i = tid; i < n; i += nt) {
      const double di = bad ? 0.0 : dx[i] * cap;
      dx[i] = di;
      d[i] += di;
    }
    __syncthreads();
    parts(a, b, c0h, t, x0, d, va, so, x, v, S, Q, ic, is, iq, iqd);
    int viol = 0;
    for (int i = tid; i < n; i += nt) {
      const double fn = S[i] + ic[i];
      const double sc = fabs(ic[i]) + fabs(S[i]);
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
    a.xn[rb + i] = x0[i] + d[i];
    a.S[rb + i] = S[i];
    a.Q[rb + i] = Q[i];
  }
  if (tid == 0) {
    a.stat[2 * b] = ok ? 1 : 0;
    a.stat[2 * b + 1] = it;
  }
}

}  // namespace

extern "C" int fused_chord_f64(
    const double* x0, const double* MT, const double* rinv,
    const double* soff, const double* vanch, const double* coef,
    const int* live, const double* Glin, const double* Clin,
    const double* qoff, const int* inst_group, const int* inst_var,
    const double* dyn, const int* row_ptr, const int* ent_slot,
    const double* ent_scale, double* xn, double* S, double* Q, int* stat,
    int B, int n, int n_inst, int nnz, int max_newton, double reltol,
    double abstol, double res_rel, double res_tol, int threads,
    long long smem, void* stream) {
  Args a{x0, MT, rinv, soff, vanch, coef, live, Glin, Clin, qoff,
         inst_group, inst_var, dyn, row_ptr, ent_slot, ent_scale, xn, S, Q,
         stat, n, n_inst, nnz, max_newton, reltol, abstol, res_rel,
         res_tol};
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_chord_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_chord_kernel<<<B, threads, (size_t)smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
