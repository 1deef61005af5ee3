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
// The convergence trace (B13): with a trace buffer (B, rows, 6) each block
// writes one row for every chunk it runs, [cumulative steps, rp, rd, mu, 0,
// 1] with the norms of the scaled system at the chunk's end (the
// reference's chunk_diag). Those are the residuals the next step computes
// at its start, so the first step of each chunk writes the previous
// chunk's row and the final-residual block the last one: no extra product.
// A block that stopped writes nothing further: its later rows stay zero, as
// the vmapped while_loop's per-element select leaves them. The iteration
// never reads the trace, so traced and untraced results are bit-identical.
//
// A non-positive (or NaN) Cholesky pivot makes the whole factor NaN, as
// jax.scipy.linalg.cho_factor does; the finite guard then zeroes the step.
// A non-finite theta does the same (the dense normal matrix would be
// non-finite everywhere). The sparse products assume finite boxes: with an
// infinite box width the dense products' 0 * inf terms, which make the
// reference's residual norms NaN, are not formed (both take zero steps).
//
// What bounds it on an H100: latency of one block per LP, not the card's
// rates (at the 16-device fleet's shapes, m=97, n=209, B<=16 LPs, the batch
// fills 16 of 132 SMs). A is sparse (2.4% nonzero at m=97, 0.31% at m=769),
// so the design works from its structure, built once per A by the wrapper:
// A v and A' y run over the nonzeros, and the normal matrix is formed entry
// by entry over its structural entries' contributing columns (1488
// multiply-adds at m=97 where a dense loop does 993 377). The vectors and
// the packed lower factor live in shared memory where both fit (m=97 f32:
// 19 KB of factor; the MoE per-node A, m=258: 134 KB). The whole block
// factors (left-looking, a thread per row with independent partial sums,
// so the loads stream; the diagonal keeps reciprocals) and solves (one
// warp's register-resident 32-row diagonal blocks, the block's updates).
// What does not fit keeps the factor in a per-block global workspace, read
// through L1/L2 by the same code, and above that (M > 172 devices in
// float32, M > 86 in float64) the vectors too, so every shape the
// reference accepts launches. The library picks the route from its own
// layout (dtk_ipm_workspace). Several SMs per LP, a fill-reducing ordering
// and CUDA graphs are later work.

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

// A's sparse structure, built once per A by the wrapper
// (distilp_torch/ops/ipm.py::ipm_sparsity) as one int32 buffer:
//   a_ptr (m+1), a_col (nnz), a_pos (nnz)   rows of A: columns, and each
//                                           nonzero's place in column order
//   t_ptr (n+1), t_row (nnz)                rows of A' (columns of A)
//   w_ptr (nent+1), w_row (nent), w_col (nent)   W's structural lower
//                                           entries (i >= k; every diagonal)
//   w_j, w_pi, w_pk (ncontrib each)         each entry's contributing
//                                           columns j, ascending, with the
//                                           places of A[i,j] and A[k,j]
// The values of A are given in column order (per LP for a per-node A).
struct Sparsity {
  const int *a_ptr, *a_col, *a_pos, *t_ptr, *t_row, *w_ptr, *w_row, *w_col, *w_j, *w_pi,
      *w_pk;
  int nent;
};

__device__ __forceinline__ Sparsity unpack(const int* sp, int m, int n, int nnz, int nent,
                                           int ncontrib) {
  Sparsity S;
  S.a_ptr = sp;
  S.a_col = S.a_ptr + m + 1;
  S.a_pos = S.a_col + nnz;
  S.t_ptr = S.a_pos + nnz;
  S.t_row = S.t_ptr + n + 1;
  S.w_ptr = S.t_row + nnz;
  S.w_row = S.w_ptr + nent + 1;
  S.w_col = S.w_row + nent;
  S.w_j = S.w_col + nent;
  S.w_pi = S.w_j + ncontrib;
  S.w_pk = S.w_pi + ncontrib;
  S.nent = nent;
  return S;
}

// out[i] = sum_j (A[i,j] * cs[j]) * vec[j] over row i's nonzeros (one warp
// per row).
template <typename T>
__device__ void mv_A(const Sparsity& S, const T* val, const T* cs, const T* vec, T* out,
                     int m) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = wid; i < m; i += nw) {
    T acc = T(0);
    for (int p = S.a_ptr[i] + lane; p < S.a_ptr[i + 1]; p += 32) {
      const int j = S.a_col[p];
      acc += (val[S.a_pos[p]] * cs[j]) * vec[j];
    }
    acc = warp_reduce(acc, Sum());
    if (lane == 0) out[i] = acc;
  }
}

// out[j] = sum_i (A[i,j] * cs[j]) * vec[i] over column j's nonzeros, i
// ascending (one thread per column).
template <typename T>
__device__ void mv_At(const Sparsity& S, const T* val, const T* cs, const T* vec, T* out,
                      int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const T csj = cs[j];
    T acc = T(0);
    for (int q = S.t_ptr[j]; q < S.t_ptr[j + 1]; ++q) acc += (val[q] * csj) * vec[S.t_row[q]];
    out[j] = acc;
  }
}

// Packed column-major lower storage with 32-bit indices (m(m+1)/2 < 2^31
// for every m whose factor fits a card): column k starts at col_start(k).
__device__ __forceinline__ int col_start(int k, int m) { return k * m - k * (k - 1) / 2; }
__host__ __device__ __forceinline__ long tri_len(long m) { return m * (m + 1) / 2; }

// W (packed lower) = As diag(theta) As' + reg I, As = A diag(cs), entry by
// entry over its contributing columns only, in ascending j with the dense
// sum's expression: a finite theta gives the dense sum (the skipped terms
// are exact zeros). The caller handles a non-finite theta (the dense sum
// would be non-finite everywhere: the factor fails).
template <typename T>
__device__ void normal_matrix(const Sparsity& S, const T* val, const T* cs, const T* theta,
                              T reg, T* W, int m) {
  const long tri = tri_len(m);
  for (long e = threadIdx.x; e < tri; e += blockDim.x) W[e] = T(0);
  __syncthreads();
  for (int e = threadIdx.x; e < S.nent; e += blockDim.x) {
    const int i = S.w_row[e], k = S.w_col[e];
    T acc = T(0);
    for (int q = S.w_ptr[e]; q < S.w_ptr[e + 1]; ++q) {
      const int j = S.w_j[q];
      const T c = cs[j];
      const T ai = val[S.w_pi[q]] * c;
      const T ak = val[S.w_pk[q]] * c;
      acc += (ai * theta[j]) * ak;
    }
    if (i == k) acc += reg;
    W[col_start(k, m) + (i - k)] = acc;
  }
}

// In-place Cholesky W = L L' of the packed lower W, left-looking, four
// columns at a time (a group [j, j+4)):
// A: a thread per row i >= j subtracts from its row's group entries the dot
//    products with rows j..j+3 over the finished columns p < j (row i's
//    entry loaded once for the four, four independent sums);
// B: after a barrier, every thread factors the group's 4x4 diagonal block
//    from the same broadcast values (so all agree, and a pivot that is not
//    > 0 fails the whole block at once), then finishes its rows' group
//    entries with it; thread 0 writes the diagonal block itself after the
//    next barrier, once nobody reads it any more.
// Two barriers a group instead of two a column: the block's few active
// warps make the factor latency-bound. The diagonal keeps 1 / L[j,j], which
// is what the solves use. Returns false (uniformly across the block) at the
// first pivot that is not > 0.
constexpr int CHOL_GROUP = 4;

template <typename T>
__device__ bool cholesky(T* W, int m) {
  constexpr int G = CHOL_GROUP;
  T Lb[G][G], rb[G];  // the group's diagonal block: L below, 1 / L[a,a]
  // Thread 0 stores the diagonal block of the group at column gj (gn columns).
  auto store_block = [&](int gj, int gn) {
#pragma unroll
    for (int a = 0; a < G; ++a) {
      if (a >= gn) continue;
#pragma unroll
      for (int b2 = 0; b2 < a; ++b2) W[col_start(gj + b2, m) - b2 + a] = Lb[a][b2];
      W[col_start(gj + a, m)] = rb[a];
    }
  };
  int prev_j = -1, prev_nb = 0;
  for (int j = 0; j < m; j += G) {
    const int nb = min(G, m - j);
    int cs[G];  // W[i, j + t] at cs[t] + i
#pragma unroll
    for (int t = 0; t < G; ++t) cs[t] = col_start(min(j + t, m - 1), m) - (j + t);
    if (threadIdx.x == 0 && prev_j >= 0) store_block(prev_j, prev_nb);
    for (int i = j + threadIdx.x; i < m; i += blockDim.x) {
      T acc[G] = {};
      int cp = 0;  // col_start(p) - p: W[r, p] at cp + r
      for (int p = 0; p < j; cp += m - p - 1, ++p) {
        const T wi = W[cp + i];
#pragma unroll
        for (int t = 0; t < G; ++t)
          if (t < nb) acc[t] += wi * W[cp + j + t];
      }
#pragma unroll
      for (int t = 0; t < G; ++t)
        if (t < nb && j + t <= i) W[cs[t] + i] -= acc[t];
    }
    __syncthreads();
    bool ok = true;
#pragma unroll
    for (int a = 0; a < G; ++a) {
      if (a >= nb) continue;
#pragma unroll
      for (int b2 = 0; b2 <= a; ++b2) {
        T v = W[cs[b2] + j + a];
#pragma unroll
        for (int t = 0; t < b2; ++t) v -= Lb[a][t] * Lb[b2][t];
        if (b2 == a) {
          ok = ok && v > T(0);
          rb[a] = rsqrt(v);
        } else {
          Lb[a][b2] = v * rb[b2];
        }
      }
    }
    if (!ok) return false;
    for (int i = j + nb + threadIdx.x; i < m; i += blockDim.x) {
      T l[G];
#pragma unroll
      for (int t = 0; t < G; ++t) {
        if (t >= nb) continue;
        T v = W[cs[t] + i];
#pragma unroll
        for (int u = 0; u < t; ++u) v -= l[u] * Lb[t][u];
        l[t] = v * rb[t];
        W[cs[t] + i] = l[t];
      }
    }
    __syncthreads();
    prev_j = j;
    prev_nb = nb;
  }
  if (threadIdx.x == 0 && prev_j >= 0) store_block(prev_j, prev_nb);
  return true;
}

// v := (L L')^{-1} v with the packed factor (its diagonal holds 1 / L[j,j]),
// by the whole block in blocks of 32 rows: warp 0 solves each diagonal
// block, a lane a row holding its row's (or column's) entries of the block
// in registers and the solved values passed by shuffles, then every thread
// updates the remaining rows with it. Contains __syncthreads.
template <typename T>
__device__ void cho_solve(const T* W, int m, T* v) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int J = 0; J < m; J += 32) {  // L z = v
    const int nb = min(32, m - J);
    if (wid == 0) {
      const bool in = lane < nb;
      const int row = J + lane;
      T vi = in ? v[row] : T(0);
      const T rd = in ? W[col_start(row, m)] : T(0);
      T lrow[32];  // L[row, J + k] for k < lane
      int ck = col_start(J, m);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        lrow[k] = (in && k < lane) ? W[ck + lane - k] : T(0);
        ck += m - (J + k);
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const T zk = __shfl_sync(FULL, vi * rd, k);
        const T upd = vi - lrow[k] * zk;
        vi = lane == k ? zk : (lane > k ? upd : vi);
      }
      if (in) v[row] = vi;
    }
    __syncthreads();
    for (int i = J + nb + threadIdx.x; i < m; i += blockDim.x) {
      T acc = v[i];
      int q = col_start(J, m) + i - J;  // L[i, J]
      for (int j = J; j < J + nb; q += m - j - 1, ++j) acc -= W[q] * v[j];
      v[i] = acc;
    }
    __syncthreads();
  }
  for (int Ie = m; Ie > 0; Ie -= 32) {  // L' x = z
    const int I0 = max(Ie - 32, 0), nb = Ie - I0;
    if (wid == 0) {
      const bool in = lane < nb;
      const int row = I0 + lane;
      T vi = in ? v[row] : T(0);
      const int cr = in ? col_start(row, m) : 0;
      const T rd = in ? W[cr] : T(0);
      T lcol[32];  // L[I0 + ii, row] for ii > lane
#pragma unroll
      for (int ii = 0; ii < 32; ++ii) lcol[ii] = (in && ii > lane && ii < nb) ? W[cr + ii - lane] : T(0);
#pragma unroll
      for (int ii = 31; ii >= 0; --ii) {
        const T xi = __shfl_sync(FULL, vi * rd, ii);
        const T upd = vi - lcol[ii] * xi;
        vi = lane == ii ? xi : (lane < ii ? upd : vi);
      }
      if (in) v[row] = vi;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < I0; i += blockDim.x) {
      const T* col = W + col_start(i, m) - i;
      T acc = T(0);
      for (int p = I0; p < Ie; ++p) acc += col[p] * v[p];
      v[i] -= acc;
    }
    __syncthreads();
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
__device__ void directions(const Vecs<T>& s, const Sparsity& S, const T* val, const T* W,
                           bool chol_ok, T* dx, T* dw, T* dz, T* df, int m, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const T gj = (s.rd[j] - s.rc1[j] / s.xs[j]) + (s.rc2[j] - s.f[j] * s.ru[j]) / s.wv[j];
    s.g[j] = gj;
    s.tn[j] = s.theta[j] * gj;
  }
  __syncthreads();
  mv_A(S, val, s.cs, s.tn, s.dy, m);
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) s.dy[i] = s.rp[i] + s.dy[i];
  __syncthreads();
  if (chol_ok) {
    cho_solve(W, m, s.dy);
  } else {
    for (int i = threadIdx.x; i < m; i += blockDim.x) s.dy[i] = T(NAN);
    __syncthreads();
  }
  mv_At(S, val, s.cs, s.dy, s.tn, n);
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

// One convergence-trace row (B13): [cumulative steps, rp, rd, mu,
// restarts (none in an IPM), live].
template <typename T>
__device__ __forceinline__ void trace_row(T* row, int it, T rp, T rd, T mu) {
  row[0] = T(it);
  row[1] = rp;
  row[2] = rd;
  row[3] = mu;
  row[4] = T(0);
  row[5] = T(1);
}

// kGlobalVecs and kSharedFactor select where the per-LP vectors and the
// factor live at compile time, so the shared-memory instances keep
// shared-memory loads and stores (a pointer chosen at run time would be a
// generic one). vec_ws is not __restrict__: threads exchange values through
// it across __syncthreads (the block reductions' slots, the vectors of
// mv_A/mv_At), and a restrict-qualified base lets the compiler reuse a
// value it loaded before the barrier. The dense A serves the one-off box
// shift and the float64 certificate; the iteration reads the sparse values.
template <typename T, bool kGlobalVecs, bool kSharedFactor>
__global__ void ipm_kernel(
    const T* __restrict__ A_all, long a_stride, const int* __restrict__ sp, int nnz,
    int nent, int ncontrib, const T* __restrict__ val_all, long val_stride,
    const T* __restrict__ b_all, const T* __restrict__ c_all,
    const T* __restrict__ l_all, const T* __restrict__ u_all,
    const T* __restrict__ wv_all, const T* __restrict__ wy_all,
    const T* __restrict__ wz_all, const T* __restrict__ wf_all,
    const uint8_t* __restrict__ wok, const uint8_t* __restrict__ skip, int m,
    int n, int chunk, int n_chunks, T tol, T reg, T* ws_all,
    T* vec_ws, T* __restrict__ v_out, double* __restrict__ bound_out,
    T* __restrict__ obj_out,
    T* __restrict__ rp_out, T* __restrict__ rd_out, T* __restrict__ mu_out,
    uint8_t* __restrict__ conv_out, double* __restrict__ reduced_out,
    T* __restrict__ y_out, T* __restrict__ z_out, T* __restrict__ f_out,
    int* __restrict__ iters_out, T* __restrict__ trace_out, int trace_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.x;
  const T* A = A_all + (size_t)e * a_stride;
  const T* val = val_all + (size_t)e * val_stride;
  const Sparsity S = unpack(sp, m, n, nnz, nent, ncontrib);
  const T* b = b_all + (size_t)e * m;
  const T* c = c_all + (size_t)e * n;
  const T* l = l_all + (size_t)e * n;
  const T* u = u_all + (size_t)e * n;
  // The per-LP vectors live in shared memory when they fit a block, else in
  // this block's slice of the global workspace (same arithmetic either way);
  // the packed factor follows them in shared memory when both fit.
  T* vbase = kGlobalVecs ? vec_ws + (size_t)e * vec_len(m, n)
                         : reinterpret_cast<T*>(smem_raw);
  T* W = kSharedFactor ? vbase + vec_len(m, n) : ws_all + (size_t)e * tri_len(m);
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
  int chunks_run = 0;
  for (int ci = 0; ci < n_chunks && !done; ++ci) {
    ++chunks_run;
    for (int st = 0; st < chunk && !done; ++st) {
      ++it;
      for (int j = tid; j < n; j += bs) s.tn[j] = s.x[j] * s.act[j];
      __syncthreads();
      mv_A(S, val, s.cs, s.tn, s.rp, m);
      mv_At(S, val, s.cs, s.y, s.rd, n);
      __syncthreads();
      T rpmax = T(0), rdmax = T(0), xz = T(0), wf = T(0);
      bool theta_fin = true;
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
        const T th = a / (s.z[j] / xsj + s.f[j] / wsj);
        s.theta[j] = th;
        theta_fin = theta_fin && is_finite(th);
      }
      rpmax = block_reduce(rpmax, Max(), s.red);
      rdmax = block_reduce(rdmax, Max(), s.red);
      xz = block_reduce(xz, Sum(), s.red);
      wf = block_reduce(wf, Sum(), s.red);
      const T mu = (xz + wf) / two_na;
      // The residuals a step takes at its start are those of the state the
      // previous chunk left: the first step of a chunk writes that chunk's
      // trace row.
      if (trace_out != nullptr && st == 0 && ci > 0 && tid == 0)
        trace_row(trace_out + ((size_t)e * trace_rows + ci - 1) * 6, it - 1, rpmax, rdmax,
                  mu);

      // A non-finite theta_j makes every entry of the dense sum non-finite
      // (0 * theta_j where A has a zero), so the factor fails.
      bool chol_ok = __syncthreads_and(theta_fin);
      if (chol_ok) {
        normal_matrix(S, val, s.cs, s.theta, reg, W, m);
        __syncthreads();
        chol_ok = cholesky(W, m);
      }
      __syncthreads();

      // predictor
      for (int j = tid; j < n; j += bs) {
        s.rc1[j] = -s.x[j] * s.z[j];
        s.rc2[j] = -s.w[j] * s.f[j];
      }
      __syncthreads();
      directions(s, S, val, W, chol_ok, s.dxa, s.dwa, s.dza, s.dfa, m, n);
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
      directions(s, S, val, W, chol_ok, s.dx, s.dw, s.dz, s.df, m, n);
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
  mv_A(S, val, s.cs, s.tn, s.rp, m);
  mv_At(S, val, s.cs, s.y, s.rd, n);
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
  // The trace row of the last chunk the block ran is the final state's.
  if (trace_out != nullptr && tid == 0 && chunks_run > 0)
    trace_row(trace_out + ((size_t)e * trace_rows + chunks_run - 1) * 6, it, rpmax, rdmax,
              (xz + wf) / two_na);

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

// Where one LP's vectors and factor live (route 0: both in shared memory;
// 1: the vectors in shared memory, the factor global; 2: both global), from
// what a block can opt into on `device` beside each instance's static
// shared memory, and the bytes of the global workspaces a batch of B LPs
// needs on that route.
template <typename T>
int workspace(int device, int B, int m, int n, int* route, size_t* vec_bytes,
              size_t* factor_bytes) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes both, vecs;
  err = cudaFuncGetAttributes(&both, ipm_kernel<T, false, true>);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&vecs, ipm_kernel<T, false, false>);
  if (err != cudaSuccess) return (int)err;
  const size_t vb = sizeof(T) * vec_len(m, n), fb = sizeof(T) * (size_t)tri_len(m);
  if (vb + fb + both.sharedSizeBytes <= (size_t)optin) {
    *route = 0;
    *vec_bytes = 0;
    *factor_bytes = 0;
  } else if (vb + vecs.sharedSizeBytes <= (size_t)optin) {
    *route = 1;
    *vec_bytes = 0;
    *factor_bytes = (size_t)B * fb;
  } else {
    *route = 2;
    *vec_bytes = (size_t)B * vb;
    *factor_bytes = (size_t)B * fb;
  }
  return 0;
}

template <typename T, bool kGlobalVecs, bool kSharedFactor>
int launch_route(size_t smem, const T* A, long a_stride, const int* sp, int nnz, int nent,
                 int ncontrib, const T* val, long val_stride, const T* b, const T* c,
                 const T* l, const T* u, const T* wv, const T* wy, const T* wz,
                 const T* wf, const uint8_t* wok, const uint8_t* skip, int B, int m,
                 int n, int chunk, int n_chunks, double tol, double reg, T* ws,
                 T* vec_ws, T* v, double* bound, T* obj, T* rp, T* rd, T* mu,
                 uint8_t* conv, double* reduced, T* y, T* z, T* f, int* iters,
                 T* trace, int trace_rows, int threads, cudaStream_t stream) {
  auto kernel = ipm_kernel<T, kGlobalVecs, kSharedFactor>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, threads, smem, stream>>>(
      A, a_stride, sp, nnz, nent, ncontrib, val, val_stride, b, c, l, u, wv, wy, wz, wf,
      wok, skip, m, n, chunk, n_chunks, (T)tol, (T)reg, ws, vec_ws, v, bound, obj, rp, rd,
      mu, conv, reduced, y, z, f, iters, trace, trace_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* A, long a_stride, const int* sp, int nnz, int nent, int ncontrib,
           const T* val, long val_stride, const T* b, const T* c,
           const T* l, const T* u, const T* wv, const T* wy, const T* wz,
           const T* wf, const uint8_t* wok, const uint8_t* skip, int B, int m,
           int n, int chunk, int n_chunks, double tol, double reg, T* ws,
           T* vec_ws, T* v, double* bound, T* obj, T* rp, T* rd, T* mu,
           uint8_t* conv, double* reduced, T* y, T* z, T* f, int* iters,
           T* trace, int trace_rows, int threads, cudaStream_t stream) {
  // The workspaces the wrapper allocates name the route (dtk_ipm_workspace):
  // no factor workspace: route 0; a factor workspace alone: route 1; both:
  // route 2.
  const size_t vb = sizeof(T) * vec_len(m, n), fb = sizeof(T) * (size_t)tri_len(m);
  if (ws == nullptr && vec_ws == nullptr)
    return launch_route<T, false, true>(vb + fb, A, a_stride, sp, nnz, nent, ncontrib, val,
                                        val_stride, b, c, l, u, wv, wy, wz, wf, wok, skip,
                                        B, m, n, chunk, n_chunks, tol, reg, ws, vec_ws, v,
                                        bound, obj, rp, rd, mu, conv, reduced, y, z, f,
                                        iters, trace, trace_rows, threads, stream);
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  if (vec_ws == nullptr)
    return launch_route<T, false, false>(vb, A, a_stride, sp, nnz, nent, ncontrib, val,
                                         val_stride, b, c, l, u, wv, wy, wz, wf, wok, skip,
                                         B, m, n, chunk, n_chunks, tol, reg, ws, vec_ws, v,
                                         bound, obj, rp, rd, mu, conv, reduced, y, z, f,
                                         iters, trace, trace_rows, threads, stream);
  return launch_route<T, true, false>(0, A, a_stride, sp, nnz, nent, ncontrib, val,
                                      val_stride, b, c, l, u, wv, wy, wz, wf, wok, skip, B,
                                      m, n, chunk, n_chunks, tol, reg, ws, vec_ws, v, bound,
                                      obj, rp, rd, mu, conv, reduced, y, z, f, iters,
                                      trace, trace_rows, threads, stream);
}

}  // namespace

extern "C" {

int dtk_ipm_workspace(int device, int B, int m, int n, int is_f64, int* route,
                      size_t* vec_bytes, size_t* factor_bytes) {
  return is_f64 ? workspace<double>(device, B, m, n, route, vec_bytes, factor_bytes)
                : workspace<float>(device, B, m, n, route, vec_bytes, factor_bytes);
}

int dtk_ipm_f32(const float* A, long a_stride, const int* sp, int nnz, int nent,
                int ncontrib, const float* val, long val_stride, const float* b,
                const float* c, const float* l, const float* u, const float* wv,
                const float* wy, const float* wz, const float* wf,
                const uint8_t* wok, const uint8_t* skip, int B, int m, int n,
                int chunk, int n_chunks, double tol, double reg, float* ws,
                float* vec_ws, float* v, double* bound, float* obj, float* rp,
                float* rd, float* mu, uint8_t* conv, double* reduced, float* y, float* z,
                float* f, int* iters, float* trace, int trace_rows, int threads,
                void* stream) {
  return launch<float>(A, a_stride, sp, nnz, nent, ncontrib, val, val_stride, b, c, l, u,
                       wv, wy, wz, wf, wok, skip, B, m, n, chunk, n_chunks, tol, reg, ws,
                       vec_ws, v, bound, obj, rp, rd, mu, conv, reduced, y, z, f, iters,
                       trace, trace_rows, threads, (cudaStream_t)stream);
}

int dtk_ipm_f64(const double* A, long a_stride, const int* sp, int nnz, int nent,
                int ncontrib, const double* val, long val_stride, const double* b,
                const double* c, const double* l, const double* u, const double* wv,
                const double* wy, const double* wz, const double* wf, const uint8_t* wok,
                const uint8_t* skip, int B, int m, int n, int chunk,
                int n_chunks, double tol, double reg, double* ws,
                double* vec_ws, double* v, double* bound, double* obj,
                double* rp, double* rd, double* mu,
                uint8_t* conv, double* reduced, double* y, double* z, double* f,
                int* iters, double* trace, int trace_rows, int threads, void* stream) {
  return launch<double>(A, a_stride, sp, nnz, nent, ncontrib, val, val_stride, b, c, l, u,
                        wv, wy, wz, wf, wok, skip, B, m, n, chunk, n_chunks, tol, reg, ws,
                        vec_ws, v, bound, obj, rp, rd, mu, conv, reduced, y, z, f, iters,
                        trace, trace_rows, threads, (cudaStream_t)stream);
}

}  // extern "C"
