// K5: batched restarted Halpern PDHG for boxed LPs that share one A,
//     min c'v  s.t.  A v = b,  l <= v <= u,
// the whole solve of up to BMAX elements in ONE cooperative launch.
//
// Replaces distilp_tpu/ops/pdhg.py::_pdhg_single under pdhg_solve_batch (the
// vmapped jit/lax device program of the JAX package). Per element it computes
// what the vmapped reference computes: box-width column equilibration and an
// inf-norm row equilibration (both kept as per-element VECTORS: A is only read
// as A, never as a scaled (B, m, n) copy), diagonal Pock-Chambolle steps from
// the two |A| reductions, the best-of-two warm entry (projected warm point or
// cold start, whichever has the smaller weighted fixed-point residual), then
// per step T(x, y), the weighted fixed-point residual, the Halpern average, the
// adaptive restart, the non-finite rollback; the convergence test once per
// chunk with the batch-wide early exit; and the float64 Lagrangian certificate
// with float64 accumulation over the iteration-dtype A, the reduced-cost sign
// split and v back in original coordinates. An element that converged (or is
// skipped) is frozen whole, as the batched while_loop's per-element select
// freezes its carry; iters_run counts only the steps it executed.
//
// Structure. A grid of one block per SM runs every phase; grid.sync() sits
// between the phases that need a whole vector: per step (1) the column phase,
// one warp per column j of A' (a second, transposed copy of A so both products
// read rows contiguously), computes (A' (row_s y))_j for every element, Tx_j,
// the Halpern candidate and cs_a (2 Tx - x)_j; (2) the row phase, one warp per
// row i of A, computes (A z)_i, Ty_i and its Halpern candidate; (3) every block
// reduces the per-block residual partials and non-finite flags, takes the
// restart / rollback decisions and commits its share of x and y. The operator
// products are this kernel's own loops (no library call). Cross-block sums are
// per-block partials reduced in a fixed order by every block (no float
// atomics), so a run is reproducible and every block takes the same decisions:
// the per-element scalars (anchor residual, Halpern counter, done, iteration
// count) are held identically in every block's shared memory.
//
// Trouble spots and what the code does about them:
// - NaN propagation: clip, min and max are common.cuh's NaN-propagating
//   versions (jnp.clip / jnp.minimum semantics; fminf/fmaxf drop NaN).
// - Step guards: tau_j = 0.9 / max(col_1n, 1e-12) only where col_1n > 1e-12
//   (and the column is active), else 0; sigma likewise. A zero-step lane
//   enters the residual as where(step > 0, d^2, 0) / max(step, 1e-30).
// - The initial anchor residual is max(res0, 1e-30), NaN-propagating.
// - The Halpern counter t is an int reset to 0 on restart; w = (t+1)/(t+2) in
//   the iteration dtype.
// - The restart test (res <= restart_tol * res_a) | (res > res_a) is a
//   discrete branch: summation order can flip it in float32, which is why
//   only the float64 certificate is held in float32 against the plain version.
// - The rollback needs "is the whole new iterate finite" before committing:
//   the column and row phases flag non-finite values of BOTH candidates (the
//   restart point T(z) and the Halpern point), so the commit phase picks the
//   flag of the branch it takes without another pass.
//
// What bounds it on an H100. Each step streams A twice (A z and A' y), 2 m n
// elements: at M=512 devices (m=3073, n=6657) A is 81.8 MB in float32 and does
// not fit the 50 MB L2, so a step is bound by 2 * 81.8 MB over 3.35 TB/s
// (~49 us). At M=128 (m=769, n=1665) both copies (10.2 MB) stay in L2 and the
// limit is latency: three grid barriers and a short reduction per step.
// That is the bound of this dense kernel, not of the function: the fleet LPs'
// A is about 0.08% nonzero (15 744 of 3073 x 6657 at M=512), so the least
// work is A read once plus 4 operations per nonzero per step. A sparse layout
// of A, fewer barriers per step and a persistent frontier are later work.

#include <cooperative_groups.h>

#include "common.cuh"

#ifndef DTK_PDHG_THREADS
#define DTK_PDHG_THREADS 512
#endif

namespace cg = cooperative_groups;

namespace {

using namespace dtk;

constexpr int THREADS = DTK_PDHG_THREADS;
constexpr int NWARP = THREADS / 32;
constexpr int BMAX = 16;          // elements per launch (ops/pdhg.py BMAX)
constexpr int BLOCKS_PER_SM = 1;  // every block re-reduces the partials

// (B, n) column vectors of the workspace
enum { V_CSA, V_CM, V_TAU, V_X, V_XA, V_TX, V_XH, V_ZB, V_ZX, V_XW, N_COLV };
// (B, m) row vectors
enum { R_ROWS, R_BS, R_SIG, R_Y, R_YA, R_YS, R_TY, R_YH, R_YW, R_YSW, N_ROWV };
// per-(block, element) partials in the iteration dtype
enum { C_RP, C_OBJ, C_BY, C_LAG, C_RD, C_CMAX, C_BMAX, C_OBJV, C_Q, N_C };
// ... and in float64
enum { D_BY, D_LAG, D_SHIFT, N_D };

struct Or {
  __device__ __forceinline__ int operator()(int a, int b) const { return a | b; }
};

template <typename T>
struct Params {
  const T* A;   // (m, n)
  const T* At;  // (n, m)
  const T* b;
  const T* c;
  const T* l;
  const T* u;
  const T* wv;           // warm v (B, n) or null
  const T* wy;           // warm y (B, m)
  const uint8_t* wok;    // warm usable (ok and every component finite)
  const uint8_t* skip;   // or null
  int B, m, n, chunk, n_chunks;
  T tol, rt;
  T* colv;
  T* rowv;
  T* pc;      // (G, B, N_C)
  double* pd; // (G, B, N_D)
  int* pf;    // (G, B) non-finite flags of a step
  T* v_out;
  double* bound_out;
  T* obj_out;
  T* rp_out;
  T* rd_out;
  T* mu_out;
  uint8_t* conv_out;
  double* reduced_out;
  T* y_out;
  T* z_out;
  T* f_out;
  int* iters_out;
};

// Per-block state; every block holds the same values.
template <typename T>
struct Blk {
  T sw[NWARP * BMAX];  // per-warp partials of the current phase
  T rv[N_C][BMAX];     // grid-reduced partials
  T res_a[BMAX], w[BMAX], bscale[BMAX], cscale[BMAX], resw[BMAX];
  double swd[NWARP * BMAX];
  double rvd[N_D][BMAX];
  int swi[NWARP * BMAX];
  int rvi[BMAX];
  int t[BMAX], it[BMAX], done[BMAX], restart[BMAX], fin[BMAX], usew[BMAX];
};

template <typename T>
__device__ __forceinline__ T* colv(const Params<T>& p, int v) {
  return p.colv + (size_t)v * p.B * p.n;
}
template <typename T>
__device__ __forceinline__ T* rowv(const Params<T>& p, int v) {
  return p.rowv + (size_t)v * p.B * p.m;
}

__device__ __forceinline__ bool on(unsigned mask, int e) { return (mask >> e) & 1u; }

// acc[e] = sum_k S(row[k]) * S(vec[e*stride + k]) over k < len, for the
// elements of ``mask``; one warp, every lane ends with every element's sum.
template <typename S, typename TA, typename TV>
__device__ __forceinline__ void warp_dots(const TA* __restrict__ row, const TV* vec,
                                          long stride, int len, unsigned mask,
                                          int B, S (&acc)[BMAX]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < BMAX; ++e) acc[e] = S(0);
  int k = lane;
  for (; k + 96 < len; k += 128) {
    const S a0 = S(row[k]), a1 = S(row[k + 32]), a2 = S(row[k + 64]), a3 = S(row[k + 96]);
#pragma unroll
    for (int e = 0; e < BMAX; ++e) {
      if (e < B && on(mask, e)) {
        const TV* v = vec + e * stride + k;
        acc[e] += a0 * S(v[0]);
        acc[e] += a1 * S(v[32]);
        acc[e] += a2 * S(v[64]);
        acc[e] += a3 * S(v[96]);
      }
    }
  }
  for (; k < len; k += 32) {
    const S a = S(row[k]);
#pragma unroll
    for (int e = 0; e < BMAX; ++e)
      if (e < B && on(mask, e)) acc[e] += a * S(vec[e * stride + k]);
  }
#pragma unroll
  for (int e = 0; e < BMAX; ++e)
    if (e < B && on(mask, e)) acc[e] = warp_reduce(acc[e], Sum());
}

// acc[lane] without dynamic register indexing.
template <typename S>
__device__ __forceinline__ S pick(const S (&acc)[BMAX], int lane) {
  S r = S(0);
#pragma unroll
  for (int e = 0; e < BMAX; ++e)
    if (e == lane) r = acc[e];
  return r;
}

// Per-lane values (lane e holds element e) of every warp -> one partial per
// (block, element), combined over the warps in a fixed order. Every thread of
// the block calls it.
template <typename T, typename Op>
__device__ void block_partial(T v, Op op, T init, T* sw, T* dst, int nslot,
                              int slot, int B, bool accumulate) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane < BMAX) sw[wid * BMAX + lane] = lane < B ? v : init;
  __syncthreads();
  if ((int)threadIdx.x < B) {
    const int e = threadIdx.x;
    T r = init;
    for (int q = 0; q < NWARP; ++q) r = op(r, sw[q * BMAX + e]);
    const size_t i = ((size_t)blockIdx.x * B + e) * nslot + slot;
    dst[i] = accumulate ? op(dst[i], r) : r;
  }
  __syncthreads();
}

// out[e] = op over every block's partial (fixed order). Every block computes
// the same value. Call after a grid sync; follow by __syncthreads.
template <typename T, typename Op>
__device__ void grid_reduce(const T* part, int nslot, int slot, int B, Op op,
                            T init, T* out) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int e = wid; e < B; e += NWARP) {
    T v = init;
    for (int g = lane; g < (int)gridDim.x; g += 32)
      v = op(v, part[((size_t)g * B + e) * nslot + slot]);
    v = warp_reduce(v, op);
    if (lane == 0) out[e] = v;
  }
}

// Column phase of T(x, y): Tx = clip(x - tau (cm - cs_a (A' ys)), 0, 1) and
// zb = cs_a (2 Tx - x); the weighted residual's column part goes to the C_Q
// partial; with ``halpern`` also the Halpern candidate and the flags.
template <typename T>
__device__ void t_cols(const Params<T>& p, Blk<T>& s, const T* x, const T* ys,
                       unsigned mask, bool halpern) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int gw = blockIdx.x * NWARP + wid, tw = gridDim.x * NWARP;
  const int B = p.B, m = p.m, n = p.n;
  T* csa = colv(p, V_CSA);
  T* cm = colv(p, V_CM);
  T* tau = colv(p, V_TAU);
  T* tx_o = colv(p, V_TX);
  T* xh_o = colv(p, V_XH);
  T* zb = colv(p, V_ZB);
  T* xa = colv(p, V_XA);
  T q = T(0);
  int fl = 0;
  for (int j = gw; j < n; j += tw) {
    T acc[BMAX];
    warp_dots(p.At + (size_t)j * m, ys, m, m, mask, B, acc);
    const T g = pick(acc, lane);
    if (lane < B && on(mask, lane)) {
      const size_t k = (size_t)lane * n + j;
      const T ca = csa[k], tk = tau[k], xj = x[k];
      const T tx = clip(xj - tk * (cm[k] - ca * g), T(0), T(1));
      tx_o[k] = tx;
      zb[k] = ca * (T(2) * tx - xj);
      const T dx = tx - xj;
      q += (tk > T(0) ? dx * dx : T(0)) / nan_max(tk, T(1e-30));
      if (halpern) {
        const T w = s.w[lane];
        const T xh = w * tx + (T(1) - w) * xa[k];
        xh_o[k] = xh;
        fl |= (is_finite(tx) ? 0 : 1) | (is_finite(xh) ? 0 : 2);
      }
    }
  }
  block_partial(q, Sum(), T(0), s.sw, p.pc, N_C, C_Q, B, false);
  if (halpern) block_partial(fl, Or(), 0, s.swi, p.pf, 1, 0, B, false);
}

// Row phase of T(x, y): Ty = y + sigma (b_s - row_s (A zb)); adds the row part
// of the residual (and of the flags) to the column phase's partials.
template <typename T>
__device__ void t_rows(const Params<T>& p, Blk<T>& s, const T* y, unsigned mask,
                       bool halpern) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int gw = blockIdx.x * NWARP + wid, tw = gridDim.x * NWARP;
  const int B = p.B, m = p.m, n = p.n;
  T* rows = rowv(p, R_ROWS);
  T* bs = rowv(p, R_BS);
  T* sig = rowv(p, R_SIG);
  T* ty_o = rowv(p, R_TY);
  T* yh_o = rowv(p, R_YH);
  T* ya = rowv(p, R_YA);
  const T* zb = colv(p, V_ZB);
  T q = T(0);
  int fl = 0;
  for (int i = gw; i < m; i += tw) {
    T acc[BMAX];
    warp_dots(p.A + (size_t)i * n, zb, n, n, mask, B, acc);
    const T az = pick(acc, lane);
    if (lane < B && on(mask, lane)) {
      const size_t k = (size_t)lane * m + i;
      const T sg = sig[k], yi = y[k];
      const T ty = yi + sg * (bs[k] - rows[k] * az);
      ty_o[k] = ty;
      const T dy = ty - yi;
      q += (sg > T(0) ? dy * dy : T(0)) / nan_max(sg, T(1e-30));
      if (halpern) {
        const T w = s.w[lane];
        const T yh = w * ty + (T(1) - w) * ya[k];
        yh_o[k] = yh;
        fl |= (is_finite(ty) ? 0 : 1) | (is_finite(yh) ? 0 : 2);
      }
    }
  }
  block_partial(q, Sum(), T(0), s.sw, p.pc, N_C, C_Q, B, true);
  if (halpern) block_partial(fl, Or(), 0, s.swi, p.pf, 1, 0, B, true);
}

// Residual norms and objective pieces at the committed (x, y), as the
// reference's conv_stats: max|b_s - opA(x)|, cm'x, b_s'y, act'min(0, red)
// and max|red - min(0, red) act| with red = cm - opAT(y).
template <typename T>
__device__ void stats(const Params<T>& p, Blk<T>& s, unsigned mask) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int gw = blockIdx.x * NWARP + wid, tw = gridDim.x * NWARP;
  const int B = p.B, m = p.m, n = p.n;
  const T* csa = colv(p, V_CSA);
  const T* cm = colv(p, V_CM);
  const T* x = colv(p, V_X);
  const T* zx = colv(p, V_ZX);
  const T* rows = rowv(p, R_ROWS);
  const T* bs = rowv(p, R_BS);
  const T* y = rowv(p, R_Y);
  const T* ys = rowv(p, R_YS);
  T rp = T(0), obj = T(0), by = T(0), lag = T(0), rd = T(0);
  for (int task = gw; task < n + m; task += tw) {
    T acc[BMAX];
    if (task < n) {
      const int j = task;
      warp_dots(p.At + (size_t)j * m, ys, m, m, mask, B, acc);
      const T g = pick(acc, lane);
      if (lane < B && on(mask, lane)) {
        const size_t k = (size_t)lane * n + j;
        const T red = cm[k] - csa[k] * g;
        const T act = csa[k] > T(0) ? T(1) : T(0);
        const T neg = nan_min(T(0), red);
        obj += cm[k] * x[k];
        lag += act * neg;
        rd = nan_max(rd, fabs(red - neg * act));
      }
    } else {
      const int i = task - n;
      warp_dots(p.A + (size_t)i * n, zx, n, n, mask, B, acc);
      const T az = pick(acc, lane);
      if (lane < B && on(mask, lane)) {
        const size_t k = (size_t)lane * m + i;
        rp = nan_max(rp, fabs(bs[k] - rows[k] * az));
        by += bs[k] * y[k];
      }
    }
  }
  block_partial(rp, Max(), T(0), s.sw, p.pc, N_C, C_RP, B, false);
  block_partial(obj, Sum(), T(0), s.sw, p.pc, N_C, C_OBJ, B, false);
  block_partial(by, Sum(), T(0), s.sw, p.pc, N_C, C_BY, B, false);
  block_partial(lag, Sum(), T(0), s.sw, p.pc, N_C, C_LAG, B, false);
  block_partial(rd, Max(), T(0), s.sw, p.pc, N_C, C_RD, B, false);
}

template <typename T>
__device__ void reduce_stats(const Params<T>& p, Blk<T>& s) {
  grid_reduce(p.pc, N_C, C_RP, p.B, Max(), T(0), s.rv[C_RP]);
  grid_reduce(p.pc, N_C, C_OBJ, p.B, Sum(), T(0), s.rv[C_OBJ]);
  grid_reduce(p.pc, N_C, C_BY, p.B, Sum(), T(0), s.rv[C_BY]);
  grid_reduce(p.pc, N_C, C_LAG, p.B, Sum(), T(0), s.rv[C_LAG]);
  grid_reduce(p.pc, N_C, C_RD, p.B, Max(), T(0), s.rv[C_RD]);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) pdhg_kernel(Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Blk<T>& s = *reinterpret_cast<Blk<T>*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, m = p.m, n = p.n;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int gw = blockIdx.x * NWARP + wid, tw = gridDim.x * NWARP;
  const long gtid = (long)blockIdx.x * THREADS + tid;
  const long gthreads = (long)gridDim.x * THREADS;
  const unsigned all = B >= 32 ? ~0u : ((1u << B) - 1u);
  const bool warm = p.wv != nullptr;

  T* csa = colv(p, V_CSA);
  T* cm = colv(p, V_CM);
  T* tau = colv(p, V_TAU);
  T* x = colv(p, V_X);
  T* xa = colv(p, V_XA);
  T* zx = colv(p, V_ZX);
  T* xw = colv(p, V_XW);
  T* rows = rowv(p, R_ROWS);
  T* bs = rowv(p, R_BS);
  T* sig = rowv(p, R_SIG);
  T* y = rowv(p, R_Y);
  T* ya = rowv(p, R_YA);
  T* ys = rowv(p, R_YS);
  T* yw = rowv(p, R_YW);
  T* ysw = rowv(p, R_YSW);

  // ---- setup 1 (columns, elementwise): scalings, cold x, warm projection ----
  for (int e = 0; e < B; ++e) {
    T cmax = T(0);
    for (long j = gtid; j < n; j += gthreads) {
      const size_t k = (size_t)e * n + j;
      const T r = p.u[k] - p.l[k];
      const bool active = r > T(0);
      const T col_s = active ? r : T(1);
      csa[k] = active ? r : T(0);
      const T cmk = active ? p.c[k] * col_s : T(0);
      cm[k] = cmk;
      cmax = nan_max(cmax, fabs(cmk));
      x[k] = T(0.5);
      if (warm) {
        const T xv = (clip(p.wv[k], p.l[k], p.u[k]) - p.l[k]) / col_s;
        xw[k] = clip(xv, T(0), T(1));
      }
    }
    cmax = block_reduce(cmax, Max(), s.sw);
    if (tid == 0) p.pc[((size_t)blockIdx.x * B + e) * N_C + C_CMAX] = cmax;
  }
  grid.sync();

  // ---- setup 2 (rows): row_s, b_s, sigma, cold/warm duals ----
  T bmax = T(0);
  for (int i = gw; i < m; i += tw) {
    const T* arow = p.A + (size_t)i * n;
    T mx[BMAX], al[BMAX], acs[BMAX];
#pragma unroll
    for (int e = 0; e < BMAX; ++e) mx[e] = al[e] = acs[e] = T(0);
    for (int j = lane; j < n; j += 32) {
      const T a = arow[j], aa = fabs(a);
#pragma unroll
      for (int e = 0; e < BMAX; ++e) {
        if (e < B) {
          const T ca = csa[(size_t)e * n + j];
          mx[e] = nan_max(mx[e], aa * ca);
          al[e] += a * p.l[(size_t)e * n + j];
          acs[e] += aa * ca;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < BMAX; ++e) {
      if (e < B) {
        mx[e] = warp_reduce(mx[e], Max());
        al[e] = warp_reduce(al[e], Sum());
        acs[e] = warp_reduce(acs[e], Sum());
      }
    }
    const T rmax = pick(mx, lane), alv = pick(al, lane), acv = pick(acs, lane);
    if (lane < B) {
      const size_t k = (size_t)lane * m + i;
      const T rs = T(1) / nan_max(rmax, T(1e-12));
      rows[k] = rs;
      const T bsk = (p.b[k] - alv) * rs;
      bs[k] = bsk;
      bmax = nan_max(bmax, fabs(bsk));
      const T r1 = rs * acv;
      sig[k] = r1 > T(1e-12) ? T(0.9) / nan_max(r1, T(1e-12)) : T(0);
      y[k] = T(0);
      ys[k] = T(0);
      if (warm) {
        const T ywk = p.wy[k] / rs;
        yw[k] = ywk;
        ysw[k] = rs * ywk;
      }
    }
  }
  block_partial(bmax, Max(), T(0), s.sw, p.pc, N_C, C_BMAX, B, false);
  grid.sync();

  // ---- setup 3 (columns): tau; b_scale, c_scale ----
  for (int j = gw; j < n; j += tw) {
    T acc[BMAX];
    const T* arow = p.At + (size_t)j * m;
#pragma unroll
    for (int e = 0; e < BMAX; ++e) acc[e] = T(0);
    for (int i = lane; i < m; i += 32) {
      const T aa = fabs(arow[i]);
#pragma unroll
      for (int e = 0; e < BMAX; ++e)
        if (e < B) acc[e] += aa * rows[(size_t)e * m + i];
    }
#pragma unroll
    for (int e = 0; e < BMAX; ++e)
      if (e < B) acc[e] = warp_reduce(acc[e], Sum());
    const T g = pick(acc, lane);
    if (lane < B) {
      const size_t k = (size_t)lane * n + j;
      const T ca = csa[k];
      const T c1 = ca * g;
      const T tk = c1 > T(1e-12) ? T(0.9) / nan_max(c1, T(1e-12)) : T(0);
      tau[k] = ca > T(0) ? tk : T(0);
    }
  }
  grid_reduce(p.pc, N_C, C_CMAX, B, Max(), T(0), s.rv[C_CMAX]);
  grid_reduce(p.pc, N_C, C_BMAX, B, Max(), T(0), s.rv[C_BMAX]);
  __syncthreads();
  if (tid < B) {
    s.cscale[tid] = T(1) + s.rv[C_CMAX][tid];
    s.bscale[tid] = T(1) + s.rv[C_BMAX][tid];
  }
  grid.sync();

  // ---- warm entry: best of the projected warm point and the cold start ----
  if (warm) {
    t_cols(p, s, xw, ysw, all, false);
    grid.sync();
    t_rows(p, s, yw, all, false);
    grid.sync();
    grid_reduce(p.pc, N_C, C_Q, B, Sum(), T(0), s.rv[C_Q]);
    __syncthreads();
    if (tid < B) s.resw[tid] = sqrt(s.rv[C_Q][tid]);
    grid.sync();  // every block has read the partials
  }
  t_cols(p, s, x, ys, all, false);
  grid.sync();
  t_rows(p, s, y, all, false);
  grid.sync();
  grid_reduce(p.pc, N_C, C_Q, B, Sum(), T(0), s.rv[C_Q]);
  __syncthreads();
  if (tid < B) {
    const T res_c = sqrt(s.rv[C_Q][tid]);
    T res0 = res_c;
    bool use_w = false;
    if (warm) {
      const T rw = s.resw[tid];
      const T rwf = is_finite(rw) ? rw : T(INFINITY);
      use_w = p.wok[tid] != 0 && rwf <= res_c;
      if (use_w) res0 = rw;
    }
    s.usew[tid] = use_w ? 1 : 0;
    s.res_a[tid] = nan_max(res0, T(1e-30));
    s.t[tid] = 0;
    s.it[tid] = 0;
    s.done[tid] = (p.skip != nullptr && p.skip[tid] != 0) ? 1 : 0;
  }
  __syncthreads();
  for (long idx = gtid; idx < (long)B * n; idx += gthreads) {
    const int e = (int)(idx / n);
    if (s.usew[e]) x[idx] = xw[idx];
    xa[idx] = x[idx];
    zx[idx] = csa[idx] * x[idx];
  }
  for (long idx = gtid; idx < (long)B * m; idx += gthreads) {
    const int e = (int)(idx / m);
    if (s.usew[e]) {
      y[idx] = yw[idx];
      ys[idx] = ysw[idx];
    }
    ya[idx] = y[idx];
  }
  grid.sync();

  // ---- chunked Halpern loop ----
  const T* tx = colv(p, V_TX);
  const T* xh = colv(p, V_XH);
  const T* ty = rowv(p, R_TY);
  const T* yh = rowv(p, R_YH);
  for (int ci = 0; ci < p.n_chunks; ++ci) {
    unsigned live = 0;
    for (int e = 0; e < B; ++e)
      if (!s.done[e]) live |= 1u << e;
    if (live == 0) break;
    for (int st = 0; st < p.chunk; ++st) {
      if (tid < B) {
        const T tf = T(s.t[tid]);
        s.w[tid] = (tf + T(1)) / (tf + T(2));
      }
      __syncthreads();
      t_cols(p, s, x, ys, live, true);
      grid.sync();
      t_rows(p, s, y, live, true);
      grid.sync();
      grid_reduce(p.pc, N_C, C_Q, B, Sum(), T(0), s.rv[C_Q]);
      grid_reduce(p.pf, 1, 0, B, Or(), 0, s.rvi);
      __syncthreads();
      if (tid < B && on(live, tid)) {
        const T res = sqrt(s.rv[C_Q][tid]);
        const T ra = s.res_a[tid];
        const bool rs = (res <= p.rt * ra) || (res > ra);
        const int fl = s.rvi[tid];
        s.restart[tid] = rs ? 1 : 0;
        s.fin[tid] = rs ? !(fl & 1) : !(fl & 2);
        s.res_a[tid] = rs ? res : ra;
        s.t[tid] = rs ? 0 : s.t[tid] + 1;
        s.it[tid] += 1;
      }
      __syncthreads();
      for (long idx = gtid; idx < (long)B * n; idx += gthreads) {
        const int e = (int)(idx / n);
        if (!on(live, e)) continue;
        const bool rs = s.restart[e];
        const T xn = rs ? tx[idx] : xh[idx];
        if (rs) xa[idx] = tx[idx];
        if (s.fin[e]) {
          x[idx] = xn;
          zx[idx] = csa[idx] * xn;
        }
      }
      for (long idx = gtid; idx < (long)B * m; idx += gthreads) {
        const int e = (int)(idx / m);
        if (!on(live, e)) continue;
        const bool rs = s.restart[e];
        const T yn = rs ? ty[idx] : yh[idx];
        if (rs) ya[idx] = ty[idx];
        if (s.fin[e]) {
          y[idx] = yn;
          ys[idx] = rows[idx] * yn;
        }
      }
      grid.sync();
    }
    // convergence: primal feasibility and relative duality gap
    stats(p, s, live);
    grid.sync();
    reduce_stats(p, s);
    if (tid < B && on(live, tid)) {
      const T bsc = s.bscale[tid], csc = s.cscale[tid];
      const T obj = s.rv[C_OBJ][tid];
      const T gap = fabs(obj - (s.rv[C_BY][tid] + s.rv[C_LAG][tid]));
      const bool conv = (s.rv[C_RP][tid] < p.tol * bsc) &&
                        (gap < p.tol * (bsc + csc + fabs(obj)));
      if (conv) s.done[tid] = 1;
    }
    grid.sync();  // every block has read the partials and the done flags
  }

  // ---- epilogue 1: final residuals; v, y in original units ----
  stats(p, s, all);
  {
    T objv = T(0);
    double shift = 0.0;
    for (int j = gw; j < n; j += tw) {
      if (lane < B) {
        const size_t k = (size_t)lane * n + j;
        const T vj = p.l[k] + (csa[k] > T(0) ? csa[k] * x[k] : T(0));
        p.v_out[k] = vj;
        objv += p.c[k] * vj;
        shift += (double)p.c[k] * (double)p.l[k];
      }
    }
    for (int i = gw; i < m; i += tw)
      if (lane < B) {
        const size_t k = (size_t)lane * m + i;
        p.y_out[k] = y[k] * rows[k];
      }
    block_partial(objv, Sum(), T(0), s.sw, p.pc, N_C, C_OBJV, B, false);
    block_partial(shift, Sum(), 0.0, s.swd, p.pd, N_D, D_SHIFT, B, false);
  }
  grid.sync();

  // ---- epilogue 2: float64 certificate, reduced costs and box duals ----
  {
    double by64 = 0.0, lag64 = 0.0;
    for (int task = gw; task < n + m; task += tw) {
      double acc[BMAX];
      if (task < n) {
        const int j = task;
        warp_dots(p.At + (size_t)j * m, p.y_out, m, m, all, B, acc);
        const double g = pick(acc, lane);
        if (lane < B) {
          const size_t k = (size_t)lane * n + j;
          const double red = (double)p.c[k] - g;
          p.reduced_out[k] = red;
          const bool active = csa[k] > T(0);
          const double r64 = (double)((p.u[k] - p.l[k]) * (active ? T(1) : T(0)));
          lag64 += r64 * nan_min(0.0, red);
          const T ro = (T)red;
          p.z_out[k] = active ? nan_max(ro, T(0)) : T(0);
          p.f_out[k] = active ? nan_max(-ro, T(0)) : T(0);
        }
      } else {
        const int i = task - n;
        warp_dots(p.A + (size_t)i * n, p.l, n, n, all, B, acc);
        const double al = pick(acc, lane);
        if (lane < B) {
          const size_t k = (size_t)lane * m + i;
          by64 += ((double)p.b[k] - al) * (double)p.y_out[k];
        }
      }
    }
    block_partial(by64, Sum(), 0.0, s.swd, p.pd, N_D, D_BY, B, false);
    block_partial(lag64, Sum(), 0.0, s.swd, p.pd, N_D, D_LAG, B, false);
  }
  grid.sync();

  // ---- epilogue 3: scalars (block 0) ----
  if (blockIdx.x == 0) {
    reduce_stats(p, s);
    grid_reduce(p.pc, N_C, C_OBJV, B, Sum(), T(0), s.rv[C_OBJV]);
    for (int d = 0; d < N_D; ++d) grid_reduce(p.pd, N_D, d, B, Sum(), 0.0, s.rvd[d]);
    __syncthreads();
    if (tid < B) {
      const int e = tid;
      double bound = s.rvd[D_BY][e] + s.rvd[D_LAG][e];
      if (!is_finite(bound)) bound = -INFINITY;
      p.bound_out[e] = bound + s.rvd[D_SHIFT][e];
      p.obj_out[e] = s.rv[C_OBJV][e];
      p.rp_out[e] = s.rv[C_RP][e];
      p.rd_out[e] = s.rv[C_RD][e];
      p.mu_out[e] = fabs(s.rv[C_OBJ][e] - (s.rv[C_BY][e] + s.rv[C_LAG][e])) /
                    (s.bscale[e] + s.cscale[e]);
      p.conv_out[e] = s.done[e] ? 1 : 0;
      p.iters_out[e] = s.it[e];
    }
  }
}

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

template <typename T>
size_t ws_bytes(int B, int m, int n, int G) {
  return align_up(sizeof(double) * (size_t)G * B * N_D) +
         align_up(sizeof(T) * (size_t)G * B * N_C) +
         align_up(sizeof(int) * (size_t)G * B) +
         align_up(sizeof(T) * (size_t)N_COLV * B * n) +
         align_up(sizeof(T) * (size_t)N_ROWV * B * m);
}

template <typename T>
int grid_size(int* G) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, pdhg_kernel<T>, THREADS,
                                                      sizeof(Blk<T>));
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *G = sms * (occ < BLOCKS_PER_SM ? occ : BLOCKS_PER_SM);
  return 0;
}

template <typename T>
int launch(const T* A, const T* At, const T* b, const T* c, const T* l,
           const T* u, const T* wv, const T* wy, const uint8_t* wok,
           const uint8_t* skip, int B, int m, int n, int chunk, int n_chunks,
           double tol, double rt, void* ws, long ws_len, T* v, double* bound,
           T* obj, T* rp, T* rd, T* mu, uint8_t* conv, double* reduced, T* y,
           T* z, T* f, int* iters, cudaStream_t stream) {
  if (B < 1 || B > BMAX) return (int)cudaErrorInvalidValue;
  int G = 0;
  int gerr = grid_size<T>(&G);
  if (gerr != 0) return gerr;
  if ((size_t)ws_len < ws_bytes<T>(B, m, n, G)) return (int)cudaErrorInvalidValue;
  unsigned char* w = static_cast<unsigned char*>(ws);
  Params<T> p;
  p.A = A;
  p.At = At;
  p.b = b;
  p.c = c;
  p.l = l;
  p.u = u;
  p.wv = wv;
  p.wy = wy;
  p.wok = wok;
  p.skip = skip;
  p.B = B;
  p.m = m;
  p.n = n;
  p.chunk = chunk;
  p.n_chunks = n_chunks;
  p.tol = (T)tol;
  p.rt = (T)rt;
  p.pd = reinterpret_cast<double*>(w);
  w += align_up(sizeof(double) * (size_t)G * B * N_D);
  p.pc = reinterpret_cast<T*>(w);
  w += align_up(sizeof(T) * (size_t)G * B * N_C);
  p.pf = reinterpret_cast<int*>(w);
  w += align_up(sizeof(int) * (size_t)G * B);
  p.colv = reinterpret_cast<T*>(w);
  w += align_up(sizeof(T) * (size_t)N_COLV * B * n);
  p.rowv = reinterpret_cast<T*>(w);
  p.v_out = v;
  p.bound_out = bound;
  p.obj_out = obj;
  p.rp_out = rp;
  p.rd_out = rd;
  p.mu_out = mu;
  p.conv_out = conv;
  p.reduced_out = reduced;
  p.y_out = y;
  p.z_out = z;
  p.f_out = f;
  p.iters_out = iters;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(pdhg_kernel<T>, dim3(G), dim3(THREADS),
                                                args, sizeof(Blk<T>), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Workspace bytes of one launch of B elements (0 when the grid cannot be
// sized on the current device).
size_t dtk_pdhg_ws_bytes(int B, int m, int n, int is_f64) {
  int G = 0;
  if (is_f64) {
    if (grid_size<double>(&G) != 0) return 0;
    return ws_bytes<double>(B, m, n, G);
  }
  if (grid_size<float>(&G) != 0) return 0;
  return ws_bytes<float>(B, m, n, G);
}

int dtk_pdhg_f32(const float* A, const float* At, const float* b, const float* c,
                 const float* l, const float* u, const float* wv, const float* wy,
                 const uint8_t* wok, const uint8_t* skip, int B, int m, int n,
                 int chunk, int n_chunks, double tol, double rt, void* ws,
                 long ws_len, float* v, double* bound, float* obj, float* rp,
                 float* rd, float* mu, uint8_t* conv, double* reduced, float* y,
                 float* z, float* f, int* iters, void* stream) {
  return launch<float>(A, At, b, c, l, u, wv, wy, wok, skip, B, m, n, chunk,
                       n_chunks, tol, rt, ws, ws_len, v, bound, obj, rp, rd, mu,
                       conv, reduced, y, z, f, iters, (cudaStream_t)stream);
}

int dtk_pdhg_f64(const double* A, const double* At, const double* b,
                 const double* c, const double* l, const double* u,
                 const double* wv, const double* wy, const uint8_t* wok,
                 const uint8_t* skip, int B, int m, int n, int chunk,
                 int n_chunks, double tol, double rt, void* ws, long ws_len,
                 double* v, double* bound, double* obj, double* rp, double* rd,
                 double* mu, uint8_t* conv, double* reduced, double* y,
                 double* z, double* f, int* iters, void* stream) {
  return launch<double>(A, At, b, c, l, u, wv, wy, wok, skip, B, m, n, chunk,
                        n_chunks, tol, rt, ws, ws_len, v, bound, obj, rp, rd, mu,
                        conv, reduced, y, z, f, iters, (cudaStream_t)stream);
}

}  // extern "C"
