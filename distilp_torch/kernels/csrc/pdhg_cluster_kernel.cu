// K5, the cluster route: batched restarted Halpern PDHG for boxed LPs,
//     min c'v  s.t.  A v = b,  l <= v <= u,
// one thread-block cluster per element that keeps the element's whole LP in
// the cluster's shared memory and reads A only as its sparse structure. Both
// entries of K5 take it: one A shared by the batch (its values with a batch
// stride of 0) and one A per element (B11: each element's values on the
// batch's union structure, stride nnz).
//
// Replaces distilp_tpu/ops/pdhg.py::_pdhg_single under pdhg_solve_batch
// (pdhg.py:520; the per-element case, a_axis = 0, pdhg.py:569): the vmapped
// jit/lax device program of the JAX package. Per element it computes what
// pdhg_kernel.cu computes (whose header is the specification): box-width
// column and inf-norm row equilibration kept as vectors, diagonal
// Pock-Chambolle steps, the best-of-two warm entry and the skip mask; per
// step T(x, y), the weighted fixed-point residual, the Halpern average, the
// adaptive restart and the non-finite rollback; the convergence test once per
// chunk; the float64 Lagrangian certificate with float64 accumulation and the
// reduced-cost sign split; the convergence trace rows (B13). The reference's
// elements are independent (the vmapped while_loop freezes a finished
// element's carry), so an element that converged simply leaves its loop.
//
// What bounds it on an H100. The least work is A's values and structure read
// once and 4 operations a nonzero a step: at the fleet's M=128 root (769 x
// 1665, 3936 nonzeros) that is 0.0016 ms for the whole solve, so the
// function is bound by neither bytes nor operations but by the latency of
// its ~2000 dependent steps. The grid route (pdhg_kernel.cu) spreads an
// element over the whole card and pays three grid syncs (~1.1 us each) a
// step. Here a step costs a few barriers inside one block or one cluster.
//
// Design.
// - One cluster of C CTAs per element (C in 1, 2, 4, 8, chosen by the host
//   from the element's bytes: ops/pdhg.py::pdhg_route), launched with
//   cudaLaunchKernelEx and a cluster dimension; no cooperative launch, no
//   grid sync. Clusters beyond what the card holds at once run in waves.
// - CTA r owns a contiguous block of rows and one of columns, balanced by
//   bytes (ops/pdhg.py::cluster_plan, once per structure). It keeps in its
//   shared memory their part of the structure (rows of A with their column
//   indices and values, rows of A' with their row indices and values: no
//   indirection through each nonzero's place), its share of every row and
//   column vector, and a replica of the two vectors the products gather
//   across blocks: z over columns for A z, row_s y over rows for A'(row_s y).
// - After the column phase and after the commit each CTA writes its owned
//   slice into every CTA's replica through distributed shared memory
//   (map_shared_rank), then the cluster barrier (barrier.cluster arrive and
//   wait: 0.63-0.69 us on the H100 for C = 1 to 8, against 0.023 us for
//   __syncthreads, chip_k5_profile.py); with C = 1 these are plain
//   shared-memory writes and __syncthreads(). A step takes three such
//   barriers, a chunk one more.
// - Every array sits at a 32-bit offset from the dynamic shared memory's
//   base (struct Ctx), and each phase is a functor over its rows or
//   columns: no pointer is held in a closure, so every access is a
//   shared-memory load or store.
// - A thread per row and a thread per column (a row has ~5 nonzeros, a
//   column ~2.4). A row or column longer than long_nnz (the fleet LPs have
//   one M-long row and one 2M-long column) gets a warp, summed with a
//   fixed-order shuffle tree, from the host's lists.
// - Every decision is identical in every thread of the cluster without
//   atomics: each warp writes its partial of a step's scalars (residual,
//   non-finite flags, convergence statistics, certificate sums) to its
//   CTA's slots, and after the barrier every thread folds all C x NWARP
//   slots in rank order (with C > 1 each warp through DSMEM, lane-strided,
//   then a fixed butterfly) into the same value. The
//   element's scalars (anchor residual, Halpern counter, steps, done) live
//   in every thread's registers: no pass of one warp and no further
//   barrier stands between a step's reduction and its commit.
// - Rank 0 writes the per-element scalars and the trace rows; per-row and
//   per-column outputs are written by their owners. A final barrier keeps
//   every CTA's shared memory alive until rank 0 has read it.
//
// Trouble spots, as pdhg_kernel.cu: NaN-propagating clip/min/max
// (common.cuh), the step guards, the restart test as a discrete branch (so
// only the float64 certificate is held in float32 against the plain
// version), both candidates' non-finite flags gathered in their phases so the
// commit can roll back without another pass.

#include <cooperative_groups.h>

#include "common.cuh"

#ifndef DTK_PDHGC_THREADS
#define DTK_PDHGC_THREADS 512
#endif

namespace cg = cooperative_groups;

// The dynamic shared memory of a CTA of the kernel below.
extern __shared__ __align__(16) unsigned char dtk_pdhgc_smem[];

namespace {

using namespace dtk;

constexpr int THREADS = DTK_PDHGC_THREADS;
constexpr int NWARP = THREADS / 32;
constexpr int CLUSTER_MAX = 8;                          // ops/pdhg.py CLUSTER_SIZES
constexpr int LONG_WARPS = NWARP >= 8 ? NWARP / 4 : 1;  // warps for long rows or columns
constexpr size_t HEAD_BYTES = 2048;                     // ops/pdhg.py HEAD_BYTES
constexpr size_t SMEM_LIMIT = 232448;                   // an H100 block's dynamic shared memory

// Column vectors of an element (owned columns); V_XH holds the warm x until
// the loop starts. Row vectors likewise; R_YH holds the warm y.
enum { V_CSA, V_CM, V_TAU, V_X, V_XA, V_TX, V_XH, N_COLV };
enum { R_ROWS, R_BS, R_SIG, R_Y, R_YA, R_TY, R_YH, N_ROWV };
// Per-warp partial slots in the iteration dtype, in float64, and flags.
enum { S_Q, S_RP, S_OBJ, S_BY, S_LAG, S_RD, S_CMAX, S_BMAX, S_OBJV, N_S };
enum { D_BY, D_LAG, D_SHIFT, N_D };

struct Or {
  __device__ __forceinline__ int operator()(int a, int b) const { return a | b; }
};

// The head of every CTA's shared memory (same offsets in every CTA): the
// per-warp slots other CTAs read. The element's scalars (anchor residual,
// Halpern counter, steps, done) live in registers, the same in every
// thread of the cluster.
template <typename T>
struct Head {
  T ws[N_S][NWARP];
  double wd[N_D][NWARP];
  int wf[NWARP];
};
static_assert(sizeof(Head<double>) <= HEAD_BYTES, "Head outgrew HEAD_BYTES");

__host__ __device__ __forceinline__ size_t al16(size_t x) { return (x + 15) & ~(size_t)15; }

// Shared-memory bytes of a CTA owning nr rows (zr nonzeros) and nc columns
// (zc nonzeros) of an (m, n) element; ops/pdhg.py::cluster_smem_bytes is the
// same sum. The carve in the kernel follows this order.
template <typename T>
__host__ __device__ size_t smem_bytes(int m, int n, int nr, int nc, int zr, int zc) {
  const size_t t = sizeof(T);
  return HEAD_BYTES + al16(t * n) + al16(t * m) + al16(4 * (size_t)(nr + 1)) +
         al16(4 * (size_t)zr) + al16(4 * (size_t)(nc + 1)) + al16(4 * (size_t)zc) +
         al16(t * zr) + al16(t * zc) + N_COLV * al16(t * nc) + N_ROWV * al16(t * nr);
}

template <typename T>
struct Params {
  // The structure as ops/ipm.py::ipm_sparsity lays it out.
  const int *a_ptr, *a_col, *a_pos, *t_ptr, *t_row;
  // The ownership plan: row starts (C+1), column starts (C+1), long-row and
  // long-column list starts (C+1 each), then the lists (local indices).
  const int* plan;
  const T* vals;  // element e's values in column order at vals + e * vstride
  long vstride;
  const T* b;
  const T* c;
  const T* l;
  const T* u;
  const T* wv;           // warm v (B, n) or null
  const T* wy;           // warm y (B, m)
  const uint8_t* wok;    // warm usable (ok and every component finite)
  const uint8_t* skip;   // or null
  int m, n, C, chunk, n_chunks, long_nnz;
  T tol, rt;
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
  T* trace;  // (B, trace_rows, 6) or null
  int trace_rows;
};

// One CTA's part of its element: what it owns and where each of its arrays
// sits in its shared memory (byte offsets from the dynamic shared memory's
// base, in smem_bytes' order), so every access is a 32-bit shared address.
struct Ctx {
  int C, L;
  int r0, nr, c0, nc;
  const int* lr;  // this CTA's long rows (local indices; global memory)
  const int* lc;
  int nlr, nlc;
  unsigned colR, rowR, rptr, rcol, cptr, crow, rval, cval, cv, rv;
  size_t eb, er;  // element e's offsets in the (B, n) and (B, m) inputs and outputs
};

template <typename V>
__device__ __forceinline__ V* sm(unsigned off) {
  return reinterpret_cast<V*>(dtk_pdhgc_smem + off);
}
// Vector v of owned column j (row i): a column's (row's) vectors sit side
// by side, so one address serves all of them.
template <typename T>
__device__ __forceinline__ T& colv(const Ctx& k, int v, int j) {
  return sm<T>(k.cv)[j * N_COLV + v];
}
template <typename T>
__device__ __forceinline__ T& rowv(const Ctx& k, int v, int i) {
  return sm<T>(k.rv)[i * N_ROWV + v];
}

// A step's residual term: float32 divides by a fast reciprocal (its only
// use is the restart test and the norms, held in float32 by the bound);
// float64 divides exactly.
__device__ __forceinline__ float qdiv(float a, float b) { return __fdividef(a, b); }
__device__ __forceinline__ double qdiv(double a, double b) { return a / b; }

// Every thread of the CTA (C = 1) or of the cluster waits for every other;
// the cluster barrier's arrive releases and its wait acquires this CTA's and
// the others' shared-memory writes (DSMEM included). Called by whole warps.
__device__ __forceinline__ void csync(int C) {
  if (C == 1) {
    __syncthreads();
    return;
  }
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// v into entry idx of the replica at R in every CTA of the cluster.
template <typename T>
__device__ __forceinline__ void bcast(cg::cluster_group& cl, const Ctx& k, unsigned R, int idx,
                                      T v) {
  T* loc = sm<T>(R) + idx;
  if (k.C == 1) {
    *loc = v;
    return;
  }
  for (int r = 0; r < k.C; ++r) *cl.map_shared_rank(loc, r) = v;
}

// A warp's partial into its slot (every lane of the warp calls it).
template <typename V, typename Op>
__device__ __forceinline__ void wpart(V v, Op op, V* slot) {
  v = warp_reduce(v, op);
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
}

// op over every warp slot of every CTA in rank order: the same value in
// every thread of the cluster. With C = 1 each thread folds its CTA's
// slots in order (broadcast loads, no shuffle); with C > 1 each warp reads
// them through DSMEM lane-strided and folds them with a butterfly. Called
// by whole warps after the barrier that published the slots.
template <typename V, typename Op>
__device__ __forceinline__ V creduce(cg::cluster_group& cl, int C, V* slot, Op op, V init) {
  V v = init;
  if (C == 1) {
#pragma unroll
    for (int w = 0; w < NWARP; ++w) v = op(v, slot[w]);
    return v;
  }
  for (int k = threadIdx.x & 31; k < C * NWARP; k += 32) {
    const int r = k / NWARP;
    v = op(v, cl.map_shared_rank(slot, r)[k - r * NWARP]);
  }
  return warp_reduce(v, op);
}

// sum over the nonzeros q of segment ii of S(val[q]) (its magnitude with
// ABS) times S(vec[idx[q]]): in ascending order by one thread, or
// lane-strided by a whole warp and summed by its butterfly (every lane gets
// the sum).
template <typename S, bool ABS, typename T, typename V>
__device__ __forceinline__ S seg_dot(const int* ptr, const int* idx, const T* val, const V* vec,
                                     int ii, bool warp) {
  const int q0 = ptr[ii], q1 = ptr[ii + 1];
  S acc = S(0);
  if (warp) {
    for (int q = q0 + (threadIdx.x & 31); q < q1; q += 32)
      acc += S(ABS ? fabs(val[q]) : val[q]) * S(vec[idx[q]]);
    acc = warp_reduce(acc, Sum());
  } else {
    for (int q = q0; q < q1; ++q) acc += S(ABS ? fabs(val[q]) : val[q]) * S(vec[idx[q]]);
  }
  return acc;
}

// f(ii, warp) for every owned segment ii < count: the long ones (the host's
// list) by the first warps, one warp each, the others one a thread over the
// remaining threads. Every thread of the block calls it; f is called by a
// whole warp for a long segment (and acts in its lane 0).
template <typename F>
__device__ __forceinline__ void walk(const int* ptr, int count, const int* longs, int nlong,
                                     int long_nnz, F& f) {
  const int wid = threadIdx.x >> 5;
  const int wl = nlong < LONG_WARPS ? nlong : LONG_WARPS;
  if (wid < wl) {
    for (int k = wid; k < nlong; k += wl) f(longs[k], true);
  } else {
    for (int i = threadIdx.x - wl * 32; i < count; i += THREADS - wl * 32)
      if (ptr[i + 1] - ptr[i] <= long_nnz) f(i, false);
  }
}

// Setup 2, a row: row_s, b_s, sigma, cold/warm duals (the column replica
// holds cs_a); the largest |b_s| into bmax.
template <typename T>
struct SetupRow {
  const Params<T>& p;
  const Ctx& k;
  cg::cluster_group& cl;
  T bmax;
  __device__ __forceinline__ void operator()(int ii, bool warp) {
    const int lane = threadIdx.x & 31;
    const int* rptr = sm<int>(k.rptr);
    const int* rcol = sm<int>(k.rcol);
    const T* rval = sm<T>(k.rval);
    const T* colR = sm<T>(k.colR);
    T rmax = T(0), alv = T(0), acv = T(0);
    for (int q = rptr[ii] + (warp ? lane : 0); q < rptr[ii + 1]; q += warp ? 32 : 1) {
      const int j = rcol[q];
      const T a = rval[q], aa = fabs(a), ca = colR[j];
      rmax = nan_max(rmax, aa * ca);
      alv += a * p.l[k.eb + j];
      acv += aa * ca;
    }
    if (warp) {
      rmax = warp_reduce(rmax, Max());
      alv = warp_reduce(alv, Sum());
      acv = warp_reduce(acv, Sum());
      if (lane != 0) return;
    }
    const size_t g = k.er + k.r0 + ii;
    const T rsc = T(1) / nan_max(rmax, T(1e-12));
    rowv<T>(k, R_ROWS, ii) = rsc;
    const T bsk = (p.b[g] - alv) * rsc;
    rowv<T>(k, R_BS, ii) = bsk;
    bmax = nan_max(bmax, fabs(bsk));
    const T r1 = rsc * acv;
    rowv<T>(k, R_SIG, ii) = r1 > T(1e-12) ? T(0.9) / nan_max(r1, T(1e-12)) : T(0);
    rowv<T>(k, R_Y, ii) = T(0);
    if (p.wv != nullptr) rowv<T>(k, R_YH, ii) = p.wy[g] / rsc;
    bcast(cl, k, k.rowR, k.r0 + ii, rsc);
  }
};

// Setup 3, a column: tau (the row replica holds row_s).
template <typename T>
struct SetupCol {
  const Ctx& k;
  __device__ __forceinline__ void operator()(int jj, bool warp) {
    const T g = seg_dot<T, true>(sm<int>(k.cptr), sm<int>(k.crow), sm<T>(k.cval),
                                 sm<T>(k.rowR), jj, warp);
    if (warp && (threadIdx.x & 31) != 0) return;
    const T ca = colv<T>(k, V_CSA, jj);
    const T c1 = ca * g;
    const T tk = c1 > T(1e-12) ? T(0.9) / nan_max(c1, T(1e-12)) : T(0);
    colv<T>(k, V_TAU, jj) = ca > T(0) ? tk : T(0);
  }
};

// Column phase of T(x, y), a column: Tx = clip(x - tau (cm - cs_a (A' ys)),
// 0, 1) and zb = cs_a (2 Tx - x) into every column replica (the row replica
// holds row_s ys); the weighted residual's column part into q; with Halpern
// weight wgt also the Halpern candidate and the non-finite flags of both.
template <typename T>
struct ColPhase {
  const Ctx& k;
  cg::cluster_group& cl;
  int xv;  // the column vector holding x
  bool halpern;
  T wgt, q;
  int fl;
  __device__ __forceinline__ void operator()(int jj, bool warp) {
    const T g = seg_dot<T, false>(sm<int>(k.cptr), sm<int>(k.crow), sm<T>(k.cval),
                                  sm<T>(k.rowR), jj, warp);
    if (warp && (threadIdx.x & 31) != 0) return;
    const T ca = colv<T>(k, V_CSA, jj), tk = colv<T>(k, V_TAU, jj), xj = colv<T>(k, xv, jj);
    const T txv = clip(xj - tk * (colv<T>(k, V_CM, jj) - ca * g), T(0), T(1));
    colv<T>(k, V_TX, jj) = txv;
    bcast(cl, k, k.colR, k.c0 + jj, ca * (T(2) * txv - xj));
    const T dx = txv - xj;
    q += qdiv(tk > T(0) ? dx * dx : T(0), nan_max(tk, T(1e-30)));
    if (halpern) {
      const T xhv = wgt * txv + (T(1) - wgt) * colv<T>(k, V_XA, jj);
      colv<T>(k, V_XH, jj) = xhv;
      fl |= (is_finite(txv) ? 0 : 1) | (is_finite(xhv) ? 0 : 2);
    }
  }
};

// Row phase of T(x, y), a row: Ty = y + sigma (b_s - row_s (A zb)) (the
// column replica holds zb); the residual's row part (and flags).
template <typename T>
struct RowPhase {
  const Ctx& k;
  int yv;  // the row vector holding y
  bool halpern;
  T wgt, q;
  int fl;
  __device__ __forceinline__ void operator()(int ii, bool warp) {
    const T az = seg_dot<T, false>(sm<int>(k.rptr), sm<int>(k.rcol), sm<T>(k.rval),
                                   sm<T>(k.colR), ii, warp);
    if (warp && (threadIdx.x & 31) != 0) return;
    const T sg = rowv<T>(k, R_SIG, ii), yi = rowv<T>(k, yv, ii);
    const T tyv = yi + sg * (rowv<T>(k, R_BS, ii) - rowv<T>(k, R_ROWS, ii) * az);
    rowv<T>(k, R_TY, ii) = tyv;
    const T dy = tyv - yi;
    q += qdiv(sg > T(0) ? dy * dy : T(0), nan_max(sg, T(1e-30)));
    if (halpern) {
      const T yhv = wgt * tyv + (T(1) - wgt) * rowv<T>(k, R_YA, ii);
      rowv<T>(k, R_YH, ii) = yhv;
      fl |= (is_finite(tyv) ? 0 : 1) | (is_finite(yhv) ? 0 : 2);
    }
  }
};

// The convergence statistics at the committed (x, y), as the reference's
// conv_stats (the column replica holds cs_a x, the row replica row_s y):
// max|b_s - opA(x)|, cm'x, b_s'y, act'min(0, red) and
// max|red - min(0, red) act| with red = cm - opAT(y).
template <typename T>
struct StatsCol {
  const Ctx& k;
  T obj, lag, rd;
  __device__ __forceinline__ void operator()(int jj, bool warp) {
    const T g = seg_dot<T, false>(sm<int>(k.cptr), sm<int>(k.crow), sm<T>(k.cval),
                                  sm<T>(k.rowR), jj, warp);
    if (warp && (threadIdx.x & 31) != 0) return;
    const T ca = colv<T>(k, V_CSA, jj), cmj = colv<T>(k, V_CM, jj);
    const T red = cmj - ca * g;
    const T act = ca > T(0) ? T(1) : T(0);
    const T neg = nan_min(T(0), red);
    obj += cmj * colv<T>(k, V_X, jj);
    lag += act * neg;
    rd = nan_max(rd, fabs(red - neg * act));
  }
};

template <typename T>
struct StatsRow {
  const Ctx& k;
  T rp, by;
  __device__ __forceinline__ void operator()(int ii, bool warp) {
    const T az = seg_dot<T, false>(sm<int>(k.rptr), sm<int>(k.rcol), sm<T>(k.rval),
                                   sm<T>(k.colR), ii, warp);
    if (warp && (threadIdx.x & 31) != 0) return;
    const T bs = rowv<T>(k, R_BS, ii);
    rp = nan_max(rp, fabs(bs - rowv<T>(k, R_ROWS, ii) * az));
    by += bs * rowv<T>(k, R_Y, ii);
  }
};

// The float64 certificate's column part (the row replica holds y in
// original units): reduced costs, the box duals, the Lagrangian term.
template <typename T>
struct CertCol {
  const Params<T>& p;
  const Ctx& k;
  double lag64;
  __device__ __forceinline__ void operator()(int jj, bool warp) {
    const double g = seg_dot<double, false>(sm<int>(k.cptr), sm<int>(k.crow), sm<T>(k.cval),
                                            sm<T>(k.rowR), jj, warp);
    if (warp && (threadIdx.x & 31) != 0) return;
    const size_t gi = k.eb + k.c0 + jj;
    const double red = (double)p.c[gi] - g;
    p.reduced_out[gi] = red;
    const bool active = colv<T>(k, V_CSA, jj) > T(0);
    const double r64 = (double)((p.u[gi] - p.l[gi]) * (active ? T(1) : T(0)));
    lag64 += r64 * nan_min(0.0, red);
    const T ro = (T)red;
    p.z_out[gi] = active ? nan_max(ro, T(0)) : T(0);
    p.f_out[gi] = active ? nan_max(-ro, T(0)) : T(0);
  }
};

// Its row part: (b - A l)' y.
template <typename T>
struct CertRow {
  const Params<T>& p;
  const Ctx& k;
  double by64;
  __device__ __forceinline__ void operator()(int ii, bool warp) {
    const double al = seg_dot<double, false>(sm<int>(k.rptr), sm<int>(k.rcol), sm<T>(k.rval),
                                             p.l + k.eb, ii, warp);
    if (warp && (threadIdx.x & 31) != 0) return;
    by64 += ((double)p.b[k.er + k.r0 + ii] - al) * (double)sm<T>(k.rowR)[k.r0 + ii];
  }
};

// The weighted fixed-point residual at (x, y) held in the column and row
// vectors xv, yv (the row replica holds row_s y), the same in every thread.
template <typename T>
__device__ __forceinline__ T residual(const Ctx& k, cg::cluster_group& cl, Head<T>& h, int xv,
                                      int yv) {
  ColPhase<T> cp{k, cl, xv, false, T(0), T(0), 0};
  walk(sm<int>(k.cptr), k.nc, k.lc, k.nlc, k.L, cp);
  csync(k.C);
  RowPhase<T> rp{k, yv, false, T(0), cp.q, 0};
  walk(sm<int>(k.rptr), k.nr, k.lr, k.nlr, k.L, rp);
  wpart(rp.q, Sum(), h.ws[S_Q]);
  csync(k.C);
  return sqrt(creduce(cl, k.C, h.ws[S_Q], Sum(), T(0)));
}

// The statistics' partials into their slots.
template <typename T>
__device__ __forceinline__ void stats(const Ctx& k, Head<T>& h) {
  StatsCol<T> sc{k, T(0), T(0), T(0)};
  walk(sm<int>(k.cptr), k.nc, k.lc, k.nlc, k.L, sc);
  StatsRow<T> sr{k, T(0), T(0)};
  walk(sm<int>(k.rptr), k.nr, k.lr, k.nlr, k.L, sr);
  wpart(sr.rp, Max(), h.ws[S_RP]);
  wpart(sc.obj, Sum(), h.ws[S_OBJ]);
  wpart(sr.by, Sum(), h.ws[S_BY]);
  wpart(sc.lag, Sum(), h.ws[S_LAG]);
  wpart(sc.rd, Max(), h.ws[S_RD]);
}

}  // namespace

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    pdhg_cluster_kernel(const __grid_constant__ Params<T> p) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = p.C;
  const int rank = (int)cl.block_rank();
  const int e = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int m = p.m, n = p.n;
  const bool warm = p.wv != nullptr;

  // ---- this CTA's rows and columns, and its shared-memory layout ----
  Ctx k;
  {
    const int* rs = p.plan;
    const int* cs = rs + C + 1;
    const int* lrp = cs + C + 1;
    const int* lcp = lrp + C + 1;
    k.C = C;
    k.L = p.long_nnz;
    k.r0 = rs[rank];
    k.nr = rs[rank + 1] - k.r0;
    k.c0 = cs[rank];
    k.nc = cs[rank + 1] - k.c0;
    k.lr = lcp + C + 1 + lrp[rank];
    k.lc = lcp + C + 1 + lrp[C] + lcp[rank];
    k.nlr = lrp[rank + 1] - lrp[rank];
    k.nlc = lcp[rank + 1] - lcp[rank];
    k.eb = (size_t)e * n;
    k.er = (size_t)e * m;
  }
  const int nr = k.nr, nc = k.nc, r0 = k.r0, c0 = k.c0;
  const int qr0 = p.a_ptr[r0], zr = p.a_ptr[r0 + nr] - qr0;
  const int qc0 = p.t_ptr[c0], zc = p.t_ptr[c0 + nc] - qc0;
  {
    unsigned cur = (unsigned)HEAD_BYTES;
    auto take = [&](size_t bytes) {
      const unsigned at = cur;
      cur += (unsigned)al16(bytes);
      return at;
    };
    k.colR = take(sizeof(T) * n);
    k.rowR = take(sizeof(T) * m);
    k.rptr = take(4 * (size_t)(nr + 1));
    k.rcol = take(4 * (size_t)zr);
    k.cptr = take(4 * (size_t)(nc + 1));
    k.crow = take(4 * (size_t)zc);
    k.rval = take(sizeof(T) * zr);
    k.cval = take(sizeof(T) * zc);
    k.cv = take(N_COLV * al16(sizeof(T) * nc));
    k.rv = take(N_ROWV * al16(sizeof(T) * nr));
  }
  Head<T>& h = *sm<Head<T>>(0);

  // ---- the structure's part and the element's values ----
  {
    const T* va = p.vals + (size_t)e * p.vstride;
    int* rptr = sm<int>(k.rptr);
    int* rcol = sm<int>(k.rcol);
    int* cptr = sm<int>(k.cptr);
    int* crow = sm<int>(k.crow);
    T* rval = sm<T>(k.rval);
    T* cval = sm<T>(k.cval);
    for (int i = tid; i <= nr; i += THREADS) rptr[i] = p.a_ptr[r0 + i] - qr0;
    for (int q = tid; q < zr; q += THREADS) {
      rcol[q] = p.a_col[qr0 + q];
      rval[q] = va[p.a_pos[qr0 + q]];
    }
    for (int j = tid; j <= nc; j += THREADS) cptr[j] = p.t_ptr[c0 + j] - qc0;
    for (int q = tid; q < zc; q += THREADS) {
      crow[q] = p.t_row[qc0 + q];
      cval[q] = va[qc0 + q];
    }
  }
  // The element's scalars, the same in every thread of the cluster.
  int done = (p.skip != nullptr && p.skip[e] != 0) ? 1 : 0;
  int t = 0, it = 0, nre = 0;
  csync(C);  // every CTA of the cluster runs (DSMEM) and holds its structure

  // ---- setup 1 (owned columns): scalings, cold x, warm projection ----
  {
    T cmax = T(0);
    for (int jj = tid; jj < nc; jj += THREADS) {
      const size_t g = k.eb + c0 + jj;
      const T r = p.u[g] - p.l[g];
      const bool active = r > T(0);
      const T col_s = active ? r : T(1);
      const T ca = active ? r : T(0);
      colv<T>(k, V_CSA, jj) = ca;
      const T cmk = active ? p.c[g] * col_s : T(0);
      colv<T>(k, V_CM, jj) = cmk;
      cmax = nan_max(cmax, fabs(cmk));
      colv<T>(k, V_X, jj) = T(0.5);
      if (warm) {
        const T xv = (clip(p.wv[g], p.l[g], p.u[g]) - p.l[g]) / col_s;
        colv<T>(k, V_XH, jj) = clip(xv, T(0), T(1));
      }
      bcast(cl, k, k.colR, c0 + jj, ca);
    }
    wpart(cmax, Max(), h.ws[S_CMAX]);
  }
  csync(C);

  // ---- setup 2 (owned rows): row_s, b_s, sigma, cold/warm duals ----
  {
    SetupRow<T> sr{p, k, cl, T(0)};
    walk(sm<int>(k.rptr), nr, k.lr, k.nlr, k.L, sr);
    wpart(sr.bmax, Max(), h.ws[S_BMAX]);
  }
  csync(C);

  // ---- setup 3 (owned columns): tau; b_scale, c_scale ----
  {
    SetupCol<T> sc{k};
    walk(sm<int>(k.cptr), nc, k.lc, k.nlc, k.L, sc);
  }
  const T cscale = T(1) + creduce(cl, C, h.ws[S_CMAX], Max(), T(0));
  const T bscale = T(1) + creduce(cl, C, h.ws[S_BMAX], Max(), T(0));
  csync(C);  // the row replica (row_s) is read no more

  // ---- warm entry: best of the projected warm point and the cold start ----
  T resw = T(0);
  if (warm) {
    for (int ii = tid; ii < nr; ii += THREADS)
      bcast(cl, k, k.rowR, r0 + ii, rowv<T>(k, R_ROWS, ii) * rowv<T>(k, R_YH, ii));
    csync(C);
    resw = residual(k, cl, h, V_XH, R_YH);
  }
  for (int ii = tid; ii < nr; ii += THREADS) bcast(cl, k, k.rowR, r0 + ii, T(0));
  csync(C);
  const T res_c = residual(k, cl, h, V_X, R_Y);
  T res_a;
  bool usew = false;
  {
    T res0 = res_c;
    if (warm) {
      const T rwf = is_finite(resw) ? resw : T(INFINITY);
      usew = p.wok[e] != 0 && rwf <= res_c;
      if (usew) res0 = resw;
    }
    res_a = nan_max(res0, T(1e-30));
  }
  for (int jj = tid; jj < nc; jj += THREADS) {
    if (usew) colv<T>(k, V_X, jj) = colv<T>(k, V_XH, jj);
    colv<T>(k, V_XA, jj) = colv<T>(k, V_X, jj);
  }
  for (int ii = tid; ii < nr; ii += THREADS) {
    if (usew) {
      rowv<T>(k, R_Y, ii) = rowv<T>(k, R_YH, ii);
      bcast(cl, k, k.rowR, r0 + ii, rowv<T>(k, R_ROWS, ii) * rowv<T>(k, R_YH, ii));
    }
    rowv<T>(k, R_YA, ii) = rowv<T>(k, R_Y, ii);
  }
  csync(C);

  // ---- chunked Halpern loop ----
  for (int ci = 0; ci < p.n_chunks && !done; ++ci) {
    const int t0 = t;
    for (int st = 0; st < p.chunk; ++st) {
      const T tf = T(t);
      const T wgt = (tf + T(1)) / (tf + T(2));
      ColPhase<T> cp{k, cl, V_X, true, wgt, T(0), 0};
      walk(sm<int>(k.cptr), nc, k.lc, k.nlc, k.L, cp);
      csync(C);
      RowPhase<T> rp{k, R_Y, true, wgt, cp.q, cp.fl};
      walk(sm<int>(k.rptr), nr, k.lr, k.nlr, k.L, rp);
      wpart(rp.q, Sum(), h.ws[S_Q]);
      wpart(rp.fl, Or(), h.wf);
      csync(C);
      // Every warp takes the step's decisions from the cluster's partials.
      const T res = sqrt(creduce(cl, C, h.ws[S_Q], Sum(), T(0)));
      const int f = creduce(cl, C, h.wf, Or(), 0);
      const bool rst = (res <= p.rt * res_a) || (res > res_a);
      const bool fin = rst ? !(f & 1) : !(f & 2);
      res_a = rst ? res : res_a;
      t = rst ? 0 : t + 1;
      it += 1;
      const bool last = st == p.chunk - 1;
      for (int jj = tid; jj < nc; jj += THREADS) {
        const T txv = colv<T>(k, V_TX, jj);
        if (rst) colv<T>(k, V_XA, jj) = txv;
        if (fin) colv<T>(k, V_X, jj) = rst ? txv : colv<T>(k, V_XH, jj);
        if (last) bcast(cl, k, k.colR, c0 + jj, colv<T>(k, V_CSA, jj) * colv<T>(k, V_X, jj));
      }
      for (int ii = tid; ii < nr; ii += THREADS) {
        const T tyv = rowv<T>(k, R_TY, ii);
        if (rst) rowv<T>(k, R_YA, ii) = tyv;
        if (fin) {
          const T yn = rst ? tyv : rowv<T>(k, R_YH, ii);
          rowv<T>(k, R_Y, ii) = yn;
          bcast(cl, k, k.rowR, r0 + ii, rowv<T>(k, R_ROWS, ii) * yn);
        }
      }
      csync(C);
    }
    // convergence: primal feasibility and relative duality gap
    stats(k, h);
    csync(C);
    const T rp = creduce(cl, C, h.ws[S_RP], Max(), T(0));
    const T obj = creduce(cl, C, h.ws[S_OBJ], Sum(), T(0));
    const T by = creduce(cl, C, h.ws[S_BY], Sum(), T(0));
    const T lag = creduce(cl, C, h.ws[S_LAG], Sum(), T(0));
    const T rd = creduce(cl, C, h.ws[S_RD], Max(), T(0));
    const T gap = fabs(obj - (by + lag));
    if ((rp < p.tol * bscale) && (gap < p.tol * (bscale + cscale + fabs(obj)))) done = 1;
    // A chunk without a restart advances t by exactly chunk: a shortfall
    // counts one restart chunk (the reference's column).
    if (t != t0 + p.chunk) nre += 1;
    if (p.trace != nullptr && rank == 0 && tid == 0 && ci < p.trace_rows) {
      T* row = p.trace + ((size_t)e * p.trace_rows + ci) * 6;
      row[0] = T(it);
      row[1] = rp;
      row[2] = rd;
      row[3] = gap / (bscale + cscale);
      row[4] = T(nre);
      row[5] = T(1);
    }
  }

  // ---- epilogue 1: final residuals; v in original units ----
  for (int jj = tid; jj < nc; jj += THREADS)
    bcast(cl, k, k.colR, c0 + jj, colv<T>(k, V_CSA, jj) * colv<T>(k, V_X, jj));
  for (int ii = tid; ii < nr; ii += THREADS)
    bcast(cl, k, k.rowR, r0 + ii, rowv<T>(k, R_ROWS, ii) * rowv<T>(k, R_Y, ii));
  csync(C);
  stats(k, h);
  {
    T objv = T(0);
    double shift = 0.0;
    for (int jj = tid; jj < nc; jj += THREADS) {
      const size_t g = k.eb + c0 + jj;
      const T ca = colv<T>(k, V_CSA, jj);
      const T vj = p.l[g] + (ca > T(0) ? ca * colv<T>(k, V_X, jj) : T(0));
      p.v_out[g] = vj;
      objv += p.c[g] * vj;
      shift += (double)p.c[g] * (double)p.l[g];
    }
    wpart(objv, Sum(), h.ws[S_OBJV]);
    wpart(shift, Sum(), h.wd[D_SHIFT]);
  }
  csync(C);
  // ---- epilogue 2: y in original units, into y_out and the row replica ----
  for (int ii = tid; ii < nr; ii += THREADS) {
    const T yo = rowv<T>(k, R_Y, ii) * rowv<T>(k, R_ROWS, ii);
    p.y_out[k.er + r0 + ii] = yo;
    bcast(cl, k, k.rowR, r0 + ii, yo);
  }
  csync(C);
  // ---- epilogue 3: float64 certificate, reduced costs and box duals ----
  {
    CertCol<T> cc{p, k, 0.0};
    walk(sm<int>(k.cptr), nc, k.lc, k.nlc, k.L, cc);
    CertRow<T> cr{p, k, 0.0};
    walk(sm<int>(k.rptr), nr, k.lr, k.nlr, k.L, cr);
    wpart(cr.by64, Sum(), h.wd[D_BY]);
    wpart(cc.lag64, Sum(), h.wd[D_LAG]);
  }
  csync(C);
  // ---- epilogue 4: the element's scalars (rank 0) ----
  if (rank == 0 && tid < 32) {
    const T rp = creduce(cl, C, h.ws[S_RP], Max(), T(0));
    const T obj = creduce(cl, C, h.ws[S_OBJ], Sum(), T(0));
    const T by = creduce(cl, C, h.ws[S_BY], Sum(), T(0));
    const T lag = creduce(cl, C, h.ws[S_LAG], Sum(), T(0));
    const T rd = creduce(cl, C, h.ws[S_RD], Max(), T(0));
    const T objv = creduce(cl, C, h.ws[S_OBJV], Sum(), T(0));
    const double by64 = creduce(cl, C, h.wd[D_BY], Sum(), 0.0);
    const double lag64 = creduce(cl, C, h.wd[D_LAG], Sum(), 0.0);
    const double shift = creduce(cl, C, h.wd[D_SHIFT], Sum(), 0.0);
    if (tid == 0) {
      double bound = by64 + lag64;
      if (!is_finite(bound)) bound = -INFINITY;
      p.bound_out[e] = bound + shift;
      p.obj_out[e] = objv;
      p.rp_out[e] = rp;
      p.rd_out[e] = rd;
      p.mu_out[e] = fabs(obj - (by + lag)) / (bscale + cscale);
      p.conv_out[e] = done ? 1 : 0;
      p.iters_out[e] = it;
    }
  }
  csync(C);  // no CTA leaves while rank 0 reads its slots
}

namespace {

cudaLaunchConfig_t config(int grid, int C, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The largest cluster size (of 8, 4, 2, 1) the card schedules with a full
// block of shared memory per CTA; 0 when none.
template <typename T>
int max_cluster() {
  cudaError_t err = cudaFuncSetAttribute(pdhg_cluster_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_LIMIT);
  if (err != cudaSuccess) return 0;
  for (int C = CLUSTER_MAX; C >= 1; C /= 2) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config(C, C, SMEM_LIMIT, 0, &attr);
    int nclus = 0;
    err = cudaOccupancyMaxActiveClusters(&nclus, (const void*)pdhg_cluster_kernel<T>, &cfg);
    if (err == cudaSuccess && nclus >= 1) return C;
    cudaGetLastError();
  }
  return 0;
}

// Lets the kernel take a full block of dynamic shared memory on the current
// device: once a device and dtype (dtk_pdhgc_prepare), never inside a launch,
// so a launch captured into a CUDA graph sets nothing and queries nothing.
template <typename T>
int prepare() {
  return (int)cudaFuncSetAttribute(pdhg_cluster_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)SMEM_LIMIT);
}

// One launch: B clusters of C CTAs, smem bytes of shared memory each (the
// largest CTA's smem_bytes). The kernel must be prepared on this device.
template <typename T>
int launch(Params<T> p, int B, int smem, cudaStream_t stream) {
  if (B < 1 || p.C < 1 || p.C > CLUSTER_MAX || (p.C & (p.C - 1)) != 0 || smem < 0 ||
      (size_t)smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (p.vstride < 0) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(B * p.C, p.C, (size_t)smem, stream, &attr);
  void* args[] = {&p};
  cudaError_t err = cudaLaunchKernelExC(&cfg, (const void*)pdhg_cluster_kernel<T>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_entry(const int* sp, const int* plan, int C, int nnz, const T* vals, long vstride,
                 const T* b, const T* c, const T* l, const T* u, const T* wv, const T* wy,
                 const uint8_t* wok, const uint8_t* skip, int B, int m, int n, int chunk,
                 int n_chunks, double tol, double rt, int long_nnz, int smem, T* v,
                 double* bound, T* obj, T* rp, T* rd, T* mu, uint8_t* conv, double* reduced,
                 T* y, T* z, T* f, int* iters, T* trace, int trace_rows, cudaStream_t stream) {
  if (vstride > 0 && vstride < nnz) return (int)cudaErrorInvalidValue;
  Params<T> p = {};
  p.a_ptr = sp;
  p.a_col = p.a_ptr + m + 1;
  p.a_pos = p.a_col + nnz;
  p.t_ptr = p.a_pos + nnz;
  p.t_row = p.t_ptr + n + 1;
  p.plan = plan;
  p.vals = vals;
  p.vstride = vstride;
  p.b = b;
  p.c = c;
  p.l = l;
  p.u = u;
  p.wv = wv;
  p.wy = wy;
  p.wok = wok;
  p.skip = skip;
  p.m = m;
  p.n = n;
  p.C = C;
  p.chunk = chunk;
  p.n_chunks = n_chunks;
  p.long_nnz = long_nnz;
  p.tol = (T)tol;
  p.rt = (T)rt;
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
  p.trace = trace;
  p.trace_rows = trace_rows;
  return launch<T>(p, B, smem, stream);
}

}  // namespace

extern "C" {

// The largest schedulable cluster size for the float32 (is_f64 = 0) or
// float64 kernel on the current device; 0 when none.
int dtk_pdhgc_max_cluster(int is_f64) {
  return is_f64 ? max_cluster<double>() : max_cluster<float>();
}

// Prepares the float32 (is_f64 = 0) or float64 kernel on the current device
// for launches of up to a full block of shared memory; call it once a device
// before the first launch (ops/pdhg.py does, with the cluster size query).
int dtk_pdhgc_prepare(int is_f64) { return is_f64 ? prepare<double>() : prepare<float>(); }

// Shared-memory bytes of one CTA owning nr rows (zr nonzeros) and nc columns
// (zc nonzeros) of an (m, n) element.
size_t dtk_pdhgc_smem_bytes(int m, int n, int nr, int nc, int zr, int zc, int is_f64) {
  return is_f64 ? smem_bytes<double>(m, n, nr, nc, zr, zc)
                : smem_bytes<float>(m, n, nr, nc, zr, zc);
}

// sp: the structure's int32 buffer as ops/ipm.py::ipm_sparsity lays it out;
// plan: the ownership plan of ops/pdhg.py::cluster_plan for C CTAs.
int dtk_pdhgc_f32(const int* sp, const int* plan, int C, int nnz, const float* vals,
                  long vstride, const float* b, const float* c, const float* l,
                  const float* u, const float* wv, const float* wy, const uint8_t* wok,
                  const uint8_t* skip, int B, int m, int n, int chunk, int n_chunks,
                  double tol, double rt, int long_nnz, int smem, float* v, double* bound,
                  float* obj, float* rp, float* rd, float* mu, uint8_t* conv,
                  double* reduced, float* y, float* z, float* f, int* iters, float* trace,
                  int trace_rows, void* stream) {
  return launch_entry<float>(sp, plan, C, nnz, vals, vstride, b, c, l, u, wv, wy, wok, skip, B,
                             m, n, chunk, n_chunks, tol, rt, long_nnz, smem, v, bound, obj, rp,
                             rd, mu, conv, reduced, y, z, f, iters, trace, trace_rows,
                             (cudaStream_t)stream);
}

int dtk_pdhgc_f64(const int* sp, const int* plan, int C, int nnz, const double* vals,
                  long vstride, const double* b, const double* c, const double* l,
                  const double* u, const double* wv, const double* wy, const uint8_t* wok,
                  const uint8_t* skip, int B, int m, int n, int chunk, int n_chunks,
                  double tol, double rt, int long_nnz, int smem, double* v, double* bound,
                  double* obj, double* rp, double* rd, double* mu, uint8_t* conv,
                  double* reduced, double* y, double* z, double* f, int* iters,
                  double* trace, int trace_rows, void* stream) {
  return launch_entry<double>(sp, plan, C, nnz, vals, vstride, b, c, l, u, wv, wy, wok, skip,
                              B, m, n, chunk, n_chunks, tol, rt, long_nnz, smem, v, bound, obj,
                              rp, rd, mu, conv, reduced, y, z, f, iters, trace, trace_rows,
                              (cudaStream_t)stream);
}

}  // extern "C"
