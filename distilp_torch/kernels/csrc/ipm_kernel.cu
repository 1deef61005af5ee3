// K1: batched Mehrotra predictor-corrector for boxed LPs,
//     min c'v  s.t.  A v = b,  l <= v <= u,
// one thread block per LP, the whole chunked iteration loop in one launch.
//
// Replaces distilp_tpu/ops/ipm.py::_ipm_single under ipm_solve_batch (the
// vmapped jit/lax device program of the JAX package). Per element it computes
// what the vmapped reference computes: box-width column equilibration, warm
// iterates projected into the box, then per step the residuals, the normal
// matrix A diag(theta) A' + reg I, one Cholesky shared by the predictor and
// corrector back-solves, ratio tests, a finite-guarded update, and the
// convergence test on the residuals taken at the START of the step. An element
// stops at the first chunk boundary after it converged, which is what the
// vmapped while_loop's per-element select amounts to. The epilogue evaluates
// the Lagrangian bound and the reduced costs in float64 from the (unscaled)
// iteration-dtype A upcast, exactly as the reference does.
//
// A non-positive (or NaN) Cholesky pivot makes the whole factor NaN, as
// jax.scipy.linalg.cho_factor does; the finite guard then zeroes the step.
//
// What bounds it on an H100: at the shapes of the 16-device fleet (m=97,
// n=209, B<=16 LPs) the work is ~2*m^2*n/2 FLOPs for the normal matrix plus a
// sequential m^3/3 Cholesky and four triangular solves per step: latency of
// one block per LP, not the card's rates (the batch fills 16 of 132 SMs). The
// design keeps every n- and m-vector in shared memory and the m*m factor in a
// per-block global workspace (L2-resident: 37.6 KB at m=97, 149 KB at m=193);
// A is shared by the batch and read through L1/L2. Above what a block can opt
// into (M > 172 devices in float32, M > 86 in float64: (24 n + 4 m + 32)
// elements per LP) the wrapper hands the kernel a global workspace for the
// vectors instead, so every shape the reference accepts launches. Shared-memory residency of
// the factor, tensor-core products and a blocked Cholesky are later work.

#include "common.cuh"

namespace {

using namespace dtk;

template <typename T>
struct Tiny;
template <>
struct Tiny<float> {
  static __device__ __forceinline__ float v() { return 1e-30f; }
};
template <>
struct Tiny<double> {
  static __device__ __forceinline__ double v() { return 1e-300; }
};

// out[i] = sum_j (A[i,j] * cs[j]) * vec[j]   (one warp per row)
template <typename T>
__device__ void mv_A(const T* __restrict__ A, const T* cs, const T* vec, T* out,
                     int m, int n) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = wid; i < m; i += nw) {
    const T* row = A + (size_t)i * n;
    T acc = T(0);
    for (int j = lane; j < n; j += 32) acc += (row[j] * cs[j]) * vec[j];
    acc = warp_reduce(acc, Sum());
    if (lane == 0) out[i] = acc;
  }
}

// out[j] = sum_i (A[i,j] * cs[j]) * vec[i]   (one thread per column)
template <typename T>
__device__ void mv_At(const T* __restrict__ A, const T* cs, const T* vec, T* out,
                      int m, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const T csj = cs[j];
    T acc = T(0);
    for (int i = 0; i < m; ++i) acc += (A[(size_t)i * n + j] * csj) * vec[i];
    out[j] = acc;
  }
}

__device__ __forceinline__ long tri_start(long k, long m) {
  return k * m - k * (k - 1) / 2;
}

// Column of the column-major lower-triangle linear index e.
__device__ __forceinline__ int tri_col(long e, int m) {
  const double b = 2.0 * m + 1.0;
  long k = (long)floor((b - sqrt(b * b - 8.0 * (double)e)) * 0.5);
  if (k < 0) k = 0;
  if (k > m - 1) k = m - 1;
  while (k > 0 && tri_start(k, m) > e) --k;
  while (k < m - 1 && tri_start(k + 1, m) <= e) ++k;
  return (int)k;
}

// W (column-major lower) = As diag(theta) As' + reg I, As = A diag(cs).
// At is A transposed (n, m) so that a warp's rows i are adjacent in memory.
template <typename T>
__device__ void normal_matrix(const T* __restrict__ At, const T* cs,
                              const T* theta, T reg, T* W, int m, int n) {
  const long tri = (long)m * (m + 1) / 2;
  for (long e = threadIdx.x; e < tri; e += blockDim.x) {
    const int k = tri_col(e, m);
    const int i = k + (int)(e - tri_start(k, m));
    T acc = T(0);
    for (int j = 0; j < n; ++j) {
      const T* r = At + (size_t)j * m;
      const T c = cs[j];
      const T ai = r[i] * c;
      const T ak = r[k] * c;
      acc += (ai * theta[j]) * ak;
    }
    if (i == k) acc += reg;
    W[(size_t)k * m + i] = acc;
  }
}

// In-place left-looking Cholesky of W (column-major lower). Returns false
// (uniformly across the block) at the first pivot that is not > 0.
template <typename T>
__device__ bool cholesky(T* W, int m) {
  for (int j = 0; j < m; ++j) {
    for (int i = j + threadIdx.x; i < m; i += blockDim.x) {
      T s = W[(size_t)j * m + i];
      for (int p = 0; p < j; ++p) s -= W[(size_t)p * m + i] * W[(size_t)p * m + j];
      W[(size_t)j * m + i] = s;
    }
    __syncthreads();
    const T d = W[(size_t)j * m + j];
    if (!(d > T(0))) return false;
    const T ljj = sqrt(d);
    __syncthreads();
    for (int i = j + 1 + threadIdx.x; i < m; i += blockDim.x) W[(size_t)j * m + i] /= ljj;
    if (threadIdx.x == 0) W[(size_t)j * m + j] = ljj;
    __syncthreads();
  }
  return true;
}

// v := (L L')^{-1} v by warp 0 (forward then backward substitution).
template <typename T>
__device__ void cho_solve_warp(const T* W, int m, T* v) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < m; ++j) {
    const T zj = v[j] / W[(size_t)j * m + j];
    __syncwarp();
    if (lane == 0) v[j] = zj;
    for (int i = j + 1 + lane; i < m; i += 32) v[i] -= W[(size_t)j * m + i] * zj;
    __syncwarp();
  }
  for (int i = m - 1; i >= 0; --i) {
    T acc = T(0);
    for (int p = i + 1 + lane; p < m; p += 32) acc += W[(size_t)i * m + p] * v[p];
    acc = warp_reduce(acc, Sum());
    const T xi = (v[i] - acc) / W[(size_t)i * m + i];
    __syncwarp();
    if (lane == 0) v[i] = xi;
    __syncwarp();
  }
}

template <typename T>
struct Vecs {
  // n-vectors
  T *cs, *cm, *act, *x, *w, *z, *f, *xs, *wv, *theta, *rd, *ru, *g, *rc1, *rc2,
      *dx, *dw, *dz, *df, *dxa, *dwa, *dza, *dfa, *tn;
  // m-vectors
  T *bhat, *y, *rp, *dy;
  T* red;  // 32 reduction slots
};

constexpr int N_VECS = 24;
constexpr int M_VECS = 4;

// Elements of one LP's vectors: N_VECS n-vectors, M_VECS m-vectors and the
// 32 reduction slots.
__host__ __device__ inline size_t vec_len(int m, int n) {
  return (size_t)N_VECS * n + (size_t)M_VECS * m + 32;
}

template <typename T>
__device__ Vecs<T> carve(T* base, int m, int n) {
  Vecs<T> s;
  T** nv[N_VECS] = {&s.cs, &s.cm, &s.act, &s.x, &s.w, &s.z, &s.f, &s.xs,
                    &s.wv, &s.theta, &s.rd, &s.ru, &s.g, &s.rc1, &s.rc2, &s.dx,
                    &s.dw, &s.dz, &s.df, &s.dxa, &s.dwa, &s.dza, &s.dfa, &s.tn};
  T* p = base;
  for (int q = 0; q < N_VECS; ++q) {
    *nv[q] = p;
    p += n;
  }
  T** mv[M_VECS] = {&s.bhat, &s.y, &s.rp, &s.dy};
  for (int q = 0; q < M_VECS; ++q) {
    *mv[q] = p;
    p += m;
  }
  s.red = p;
  return s;
}

// Largest step along dv keeping v >= 0 on active columns (NaN-propagating).
template <typename T>
__device__ T max_step(const T* v, const T* dv, const T* act, int n, T* red) {
  const T inf = T(INFINITY);
  T r = inf;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const T d = dv[j];
    const T q = (act[j] > T(0) && d < T(0)) ? (-v[j]) / d : inf;
    r = nan_min(r, q);
  }
  r = block_reduce(r, Min(), red);
  return nan_min(T(1), T(0.9995) * r);
}

// Newton direction for complementarity right-hand sides (rc1, rc2).
template <typename T>
__device__ void directions(const Vecs<T>& s, const T* A, const T* W, bool chol_ok,
                           T* dx, T* dw, T* dz, T* df, int m, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const T gj = (s.rd[j] - s.rc1[j] / s.xs[j]) + (s.rc2[j] - s.f[j] * s.ru[j]) / s.wv[j];
    s.g[j] = gj;
    s.tn[j] = s.theta[j] * gj;
  }
  __syncthreads();
  mv_A(A, s.cs, s.tn, s.dy, m, n);
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) s.dy[i] = s.rp[i] + s.dy[i];
  __syncthreads();
  if (threadIdx.x < 32) {
    if (chol_ok) {
      cho_solve_warp(W, m, s.dy);
    } else {
      for (int i = threadIdx.x; i < m; i += 32) s.dy[i] = T(NAN);
    }
  }
  __syncthreads();
  mv_At(A, s.cs, s.dy, s.tn, m, n);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const T dxj = s.theta[j] * (s.tn[j] - s.g[j]);
    const T dwj = s.ru[j] - dxj;
    dx[j] = dxj;
    dw[j] = dwj;
    dz[j] = (s.rc1[j] - s.z[j] * dxj) / s.xs[j];
    df[j] = (s.rc2[j] - s.f[j] * dwj) / s.wv[j];
  }
  __syncthreads();
}

// kGlobalVecs selects where the per-LP vectors live at compile time, so the
// shared-memory instance keeps shared-memory loads and stores (a pointer
// chosen at run time would be a generic one). vec_ws is not __restrict__:
// threads exchange values through it across __syncthreads (the block
// reductions' slots, the vectors of mv_A/mv_At), and a restrict-qualified
// base lets the compiler reuse a value it loaded before the barrier.
template <typename T, bool kGlobalVecs>
__global__ void ipm_kernel(
    const T* __restrict__ A_all, const T* __restrict__ At_all, long a_stride,
    const T* __restrict__ b_all, const T* __restrict__ c_all,
    const T* __restrict__ l_all, const T* __restrict__ u_all,
    const T* __restrict__ wv_all, const T* __restrict__ wy_all,
    const T* __restrict__ wz_all, const T* __restrict__ wf_all,
    const uint8_t* __restrict__ wok, const uint8_t* __restrict__ skip, int m,
    int n, int chunk, int n_chunks, T tol, T reg, T* __restrict__ ws_all,
    T* vec_ws, T* __restrict__ v_out, double* __restrict__ bound_out,
    T* __restrict__ obj_out,
    T* __restrict__ rp_out, T* __restrict__ rd_out, T* __restrict__ mu_out,
    uint8_t* __restrict__ conv_out, double* __restrict__ reduced_out,
    T* __restrict__ y_out, T* __restrict__ z_out, T* __restrict__ f_out,
    int* __restrict__ iters_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.x;
  const T* A = A_all + (size_t)e * a_stride;
  const T* At = At_all + (size_t)e * a_stride;
  const T* b = b_all + (size_t)e * m;
  const T* c = c_all + (size_t)e * n;
  const T* l = l_all + (size_t)e * n;
  const T* u = u_all + (size_t)e * n;
  T* W = ws_all + (size_t)e * m * m;
  // The per-LP vectors live in shared memory when they fit a block, else in
  // this block's slice of the global workspace (same arithmetic either way).
  T* vbase = kGlobalVecs ? vec_ws + (size_t)e * vec_len(m, n)
                         : reinterpret_cast<T*>(smem_raw);
  Vecs<T> s = carve<T>(vbase, m, n);
  const int tid = threadIdx.x;
  const int bs = blockDim.x;

  // ---- setup: equilibration, cold start, warm projection ----
  T cnt = T(0);
  for (int j = tid; j < n; j += bs) {
    const T rr = u[j] - l[j];
    const bool active = rr > T(0);
    const T csj = active ? rr : T(1);
    s.cs[j] = csj;
    s.act[j] = active ? T(1) : T(0);
    s.cm[j] = active ? c[j] * csj : T(0);
    s.x[j] = T(0.5);
    s.w[j] = T(1) - T(0.5);
    s.z[j] = T(1);
    s.f[j] = T(1);
    s.tn[j] = l[j];
    cnt += s.act[j];
  }
  for (int i = tid; i < m; i += bs) s.y[i] = T(0);
  const T n_active = nan_max(block_reduce(cnt, Sum(), s.red), T(1));
  __syncthreads();
  // b_hat = b - A l   (unscaled A: cs is not applied to the box shift)
  {
    const int lane = tid & 31, wid = tid >> 5, nw = bs >> 5;
    for (int i = wid; i < m; i += nw) {
      const T* row = A + (size_t)i * n;
      T acc = T(0);
      for (int j = lane; j < n; j += 32) acc += row[j] * s.tn[j];
      acc = warp_reduce(acc, Sum());
      if (lane == 0) s.bhat[i] = b[i] - acc;
    }
  }
  if (wok != nullptr) {
    const T* wv = wv_all + (size_t)e * n;
    const T* wy = wy_all + (size_t)e * m;
    const T* wz = wz_all + (size_t)e * n;
    const T* wf = wf_all + (size_t)e * n;
    bool fin = true;
    for (int j = tid; j < n; j += bs)
      fin = fin && is_finite(wv[j]) && is_finite(wz[j]) && is_finite(wf[j]);
    for (int i = tid; i < m; i += bs) fin = fin && is_finite(wy[i]);
    fin = __syncthreads_and(fin) && wok[e] != 0;
    if (fin) {
      for (int j = tid; j < n; j += bs) {
        T xw = (clip(wv[j], l[j], u[j]) - l[j]) / s.cs[j];
        xw = clip(xw, T(0.01), T(0.99));
        s.x[j] = xw;
        s.w[j] = T(1) - xw;
        s.z[j] = clip(wz[j] * s.cs[j], T(1e-2), T(1e4));
        s.f[j] = clip(wf[j] * s.cs[j], T(1e-2), T(1e4));
      }
      for (int i = tid; i < m; i += bs) s.y[i] = wy[i];
    }
  }
  __syncthreads();
  T bmax = T(0), cmax = T(0);
  for (int i = tid; i < m; i += bs) bmax = nan_max(bmax, fabs(s.bhat[i]));
  for (int j = tid; j < n; j += bs) cmax = nan_max(cmax, fabs(s.cm[j]));
  const T b_scale = T(1) + block_reduce(bmax, Max(), s.red);
  const T c_scale = T(1) + block_reduce(cmax, Max(), s.red);
  const T two_na = T(2) * n_active;

  bool done = skip != nullptr && skip[e] != 0;
  int it = 0;

  // ---- chunked Mehrotra loop ----
  for (int ci = 0; ci < n_chunks && !done; ++ci) {
    for (int st = 0; st < chunk && !done; ++st) {
      ++it;
      for (int j = tid; j < n; j += bs) s.tn[j] = s.x[j] * s.act[j];
      __syncthreads();
      mv_A(A, s.cs, s.tn, s.rp, m, n);
      mv_At(A, s.cs, s.y, s.rd, m, n);
      __syncthreads();
      T rpmax = T(0), rdmax = T(0), xz = T(0), wf = T(0);
      for (int i = tid; i < m; i += bs) {
        const T r = s.bhat[i] - s.rp[i];
        s.rp[i] = r;
        rpmax = nan_max(rpmax, fabs(r));
      }
      for (int j = tid; j < n; j += bs) {
        const T a = s.act[j];
        const T rdj = (((s.cm[j] - s.rd[j]) - s.z[j]) + s.f[j]) * a;
        s.rd[j] = rdj;
        rdmax = nan_max(rdmax, fabs(rdj));
        s.ru[j] = ((T(1) - s.x[j]) - s.w[j]) * a;
        xz += (s.x[j] * a) * s.z[j];
        wf += (s.w[j] * a) * s.f[j];
        const bool active = a > T(0);
        const T xsj = active ? s.x[j] : T(1);
        const T wsj = active ? s.w[j] : T(1);
        s.xs[j] = xsj;
        s.wv[j] = wsj;
        s.theta[j] = a / (s.z[j] / xsj + s.f[j] / wsj);
      }
      rpmax = block_reduce(rpmax, Max(), s.red);
      rdmax = block_reduce(rdmax, Max(), s.red);
      xz = block_reduce(xz, Sum(), s.red);
      wf = block_reduce(wf, Sum(), s.red);
      const T mu = (xz + wf) / two_na;

      normal_matrix(At, s.cs, s.theta, reg, W, m, n);
      __syncthreads();
      const bool chol_ok = cholesky(W, m);
      __syncthreads();

      // predictor
      for (int j = tid; j < n; j += bs) {
        s.rc1[j] = -s.x[j] * s.z[j];
        s.rc2[j] = -s.w[j] * s.f[j];
      }
      __syncthreads();
      directions(s, A, W, chol_ok, s.dxa, s.dwa, s.dza, s.dfa, m, n);
      const T ap_a = nan_min(max_step(s.x, s.dxa, s.act, n, s.red),
                             max_step(s.w, s.dwa, s.act, n, s.red));
      const T ad_a = nan_min(max_step(s.z, s.dza, s.act, n, s.red),
                             max_step(s.f, s.dfa, s.act, n, s.red));
      T s1 = T(0), s2 = T(0);
      for (int j = tid; j < n; j += bs) {
        const T a = s.act[j];
        s1 += ((s.x[j] + ap_a * s.dxa[j]) * a) * (s.z[j] + ad_a * s.dza[j]);
        s2 += ((s.w[j] + ap_a * s.dwa[j]) * a) * (s.f[j] + ad_a * s.dfa[j]);
      }
      s1 = block_reduce(s1, Sum(), s.red);
      s2 = block_reduce(s2, Sum(), s.red);
      const T mu_aff = (s1 + s2) / two_na;
      const T q = mu_aff / (mu + Tiny<T>::v());
      const T sigma = clip((q * q) * q, T(0), T(1));
      const T smu = sigma * mu;

      // corrector
      for (int j = tid; j < n; j += bs) {
        s.rc1[j] = (smu - s.x[j] * s.z[j]) - s.dxa[j] * s.dza[j];
        s.rc2[j] = (smu - s.w[j] * s.f[j]) - s.dwa[j] * s.dfa[j];
      }
      __syncthreads();
      directions(s, A, W, chol_ok, s.dx, s.dw, s.dz, s.df, m, n);
      T ap = nan_min(max_step(s.x, s.dx, s.act, n, s.red),
                     max_step(s.w, s.dw, s.act, n, s.red));
      T ad = nan_min(max_step(s.z, s.dz, s.act, n, s.red),
                     max_step(s.f, s.df, s.act, n, s.red));
      bool fin = true;
      for (int j = tid; j < n; j += bs)
        fin = fin && is_finite(s.dx[j]) && is_finite(s.dw[j]) && is_finite(s.dz[j]) &&
              is_finite(s.df[j]);
      for (int i = tid; i < m; i += bs) fin = fin && is_finite(s.dy[i]);
      fin = __syncthreads_and(fin) && is_finite(ap) && is_finite(ad);
      if (!fin) {
        ap = T(0);
        ad = T(0);
      }
      for (int j = tid; j < n; j += bs) {
        const T dxj = fin ? s.dx[j] : T(0);
        const T dwj = fin ? s.dw[j] : T(0);
        const T dzj = fin ? s.dz[j] : T(0);
        const T dfj = fin ? s.df[j] : T(0);
        s.x[j] = s.x[j] + ap * dxj;
        s.w[j] = s.w[j] + ap * dwj;
        s.z[j] = s.z[j] + ad * dzj;
        s.f[j] = s.f[j] + ad * dfj;
      }
      for (int i = tid; i < m; i += bs) {
        const T dyi = fin ? s.dy[i] : T(0);
        s.y[i] = s.y[i] + ad * dyi;
      }
      __syncthreads();
      done = (mu < tol) && (rpmax < tol * b_scale) && (rdmax < tol * c_scale);
    }
  }

  // ---- final residuals (iteration dtype) ----
  for (int j = tid; j < n; j += bs) s.tn[j] = s.x[j] * s.act[j];
  __syncthreads();
  mv_A(A, s.cs, s.tn, s.rp, m, n);
  mv_At(A, s.cs, s.y, s.rd, m, n);
  __syncthreads();
  T rpmax = T(0), rdmax = T(0), xz = T(0), wf = T(0);
  for (int i = tid; i < m; i += bs) rpmax = nan_max(rpmax, fabs(s.bhat[i] - s.rp[i]));
  for (int j = tid; j < n; j += bs) {
    const T a = s.act[j];
    const T rdj = ((s.cm[j] - s.rd[j]) - s.z[j]) + s.f[j];
    rdmax = nan_max(rdmax, fabs(rdj * a));
    xz += (s.x[j] * a) * s.z[j];
    wf += (s.w[j] * a) * s.f[j];
  }
  rpmax = block_reduce(rpmax, Max(), s.red);
  rdmax = block_reduce(rdmax, Max(), s.red);
  xz = block_reduce(xz, Sum(), s.red);
  wf = block_reduce(wf, Sum(), s.red);

  // ---- float64 certificate from the unscaled A upcast ----
  __shared__ double red_d[32];
  double bh_y = 0.0;
  {
    const int lane = tid & 31, wid = tid >> 5, nw = bs >> 5;
    for (int i = wid; i < m; i += nw) {
      const T* row = A + (size_t)i * n;
      double acc = 0.0;
      for (int j = lane; j < n; j += 32) acc += (double)row[j] * (double)l[j];
      acc = warp_reduce(acc, Sum());
      if (lane == 0) bh_y += ((double)b[i] - acc) * (double)s.y[i];
    }
  }
  double lag = 0.0, shift = 0.0;
  T objt = T(0);
  for (int j = tid; j < n; j += bs) {
    double acc = 0.0;
    for (int i = 0; i < m; ++i) acc += (double)A[(size_t)i * n + j] * (double)s.y[i];
    const double red = (double)c[j] - acc;
    reduced_out[(size_t)e * n + j] = red;
    const double r64 = (double)((u[j] - l[j]) * s.act[j]);
    lag += r64 * nan_min(0.0, red);
    shift += (double)c[j] * (double)l[j];
    const bool active = s.act[j] > T(0);
    const T vj = l[j] + (active ? s.cs[j] * s.x[j] : T(0));
    v_out[(size_t)e * n + j] = vj;
    objt += c[j] * vj;
    z_out[(size_t)e * n + j] = active ? s.z[j] / s.cs[j] : T(0);
    f_out[(size_t)e * n + j] = active ? s.f[j] / s.cs[j] : T(0);
  }
  bh_y = block_reduce(bh_y, Sum(), red_d);
  lag = block_reduce(lag, Sum(), red_d);
  shift = block_reduce(shift, Sum(), red_d);
  objt = block_reduce(objt, Sum(), s.red);
  for (int i = tid; i < m; i += bs) y_out[(size_t)e * m + i] = s.y[i];
  if (tid == 0) {
    double bound = bh_y + lag;
    if (!isfinite(bound)) bound = -INFINITY;
    bound_out[e] = bound + shift;
    obj_out[e] = objt;
    rp_out[e] = rpmax;
    rd_out[e] = rdmax;
    mu_out[e] = (xz + wf) / two_na;
    conv_out[e] = done ? 1 : 0;
    iters_out[e] = it;
  }
}

template <typename T>
size_t smem_bytes(int m, int n) {
  return sizeof(T) * vec_len(m, n);
}

// Bytes of the global vector workspace a batch of B LPs needs: 0 when one
// LP's vectors, beside the kernel's static shared memory, fit what a block
// can opt into on `device` (the shared route), else B * vec_len elements.
template <typename T>
int vec_ws_bytes(int device, int B, int m, int n, size_t* bytes) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, ipm_kernel<T, false>);
  if (err != cudaSuccess) return (int)err;
  const size_t sm = smem_bytes<T>(m, n);
  *bytes = sm + attr.sharedSizeBytes <= (size_t)optin ? 0 : (size_t)B * sm;
  return 0;
}

template <typename T>
int launch(const T* A, const T* At, long a_stride, const T* b, const T* c,
           const T* l, const T* u, const T* wv, const T* wy, const T* wz,
           const T* wf, const uint8_t* wok, const uint8_t* skip, int B, int m,
           int n, int chunk, int n_chunks, double tol, double reg, T* ws,
           T* vec_ws, T* v, double* bound, T* obj, T* rp, T* rd, T* mu,
           uint8_t* conv, double* reduced, T* y, T* z, T* f, int* iters,
           int threads, cudaStream_t stream) {
  // vec_ws (B * vec_len(m, n) elements, or null) is the global-memory route
  // the wrapper picks when the vectors exceed what a block can opt into.
  if (vec_ws != nullptr) {
    ipm_kernel<T, true><<<B, threads, 0, stream>>>(
        A, At, a_stride, b, c, l, u, wv, wy, wz, wf, wok, skip, m, n, chunk,
        n_chunks, (T)tol, (T)reg, ws, vec_ws, v, bound, obj, rp, rd, mu, conv,
        reduced, y, z, f, iters);
    return (int)cudaGetLastError();
  }
  const size_t sm = smem_bytes<T>(m, n);
  if (sm > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ipm_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
    if (err != cudaSuccess) return (int)err;
  }
  ipm_kernel<T, false><<<B, threads, sm, stream>>>(
      A, At, a_stride, b, c, l, u, wv, wy, wz, wf, wok, skip, m, n, chunk,
      n_chunks, (T)tol, (T)reg, ws, vec_ws, v, bound, obj, rp, rd, mu, conv,
      reduced, y, z, f, iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dtk_ipm_vec_ws_bytes(int device, int B, int m, int n, int is_f64,
                         size_t* bytes) {
  return is_f64 ? vec_ws_bytes<double>(device, B, m, n, bytes)
                : vec_ws_bytes<float>(device, B, m, n, bytes);
}

int dtk_ipm_f32(const float* A, const float* At, long a_stride, const float* b,
                const float* c, const float* l, const float* u, const float* wv,
                const float* wy, const float* wz, const float* wf,
                const uint8_t* wok, const uint8_t* skip, int B, int m, int n,
                int chunk, int n_chunks, double tol, double reg, float* ws,
                float* vec_ws, float* v, double* bound, float* obj, float* rp,
                float* rd, float* mu, uint8_t* conv, double* reduced, float* y, float* z,
                float* f, int* iters, int threads, void* stream) {
  return launch<float>(A, At, a_stride, b, c, l, u, wv, wy, wz, wf, wok, skip,
                       B, m, n, chunk, n_chunks, tol, reg, ws, vec_ws, v, bound,
                       obj, rp, rd, mu, conv, reduced, y, z, f, iters, threads,
                       (cudaStream_t)stream);
}

int dtk_ipm_f64(const double* A, const double* At, long a_stride,
                const double* b, const double* c, const double* l,
                const double* u, const double* wv, const double* wy,
                const double* wz, const double* wf, const uint8_t* wok,
                const uint8_t* skip, int B, int m, int n, int chunk,
                int n_chunks, double tol, double reg, double* ws,
                double* vec_ws, double* v, double* bound, double* obj,
                double* rp, double* rd, double* mu,
                uint8_t* conv, double* reduced, double* y, double* z, double* f,
                int* iters, int threads, void* stream) {
  return launch<double>(A, At, a_stride, b, c, l, u, wv, wy, wz, wf, wok, skip,
                        B, m, n, chunk, n_chunks, tol, reg, ws, vec_ws, v, bound,
                        obj, rp, rd, mu, conv, reduced, y, z, f, iters, threads,
                        (cudaStream_t)stream);
}

}  // extern "C"
