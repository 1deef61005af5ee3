// K6b: the row-sharded restarted Halpern PDHG: K5's solve (pdhg_kernel.cu) of
// up to BMAX boxed LPs sharing one A, with A's rows split over the S shards of
// a mesh. Each shard holds a block of ms rows (A_blk, and its transpose At_blk),
// the matching slices of b and of every row vector (the row scale, b_s, sigma,
// the dual iterate, its anchor), and a full copy of the column data, the primal
// iterate and every restart scalar; so every shard takes the same decisions.
//
// Replaces distilp_tpu/ops/meshlp.py:96 sharded_pdhg: _pdhg_single
// (ops/pdhg.py:139) with axis_name set, under shard_map. The collectives of
// that program close at the same places here: the psum of the column partials
// A_blk' (row_s y_blk) (the opAT of every step and of the convergence test,
// and |A|' row_s for the column 1-norms), the psum of the dual half of the
// weighted residual and of the non-finite flags, the pmax of max|b_s| and of
// the primal residual, the psum of b_s'y, and the float64 psums of the
// certificate's A'y and b'y.
//
// The solve is one fixed sequence of phases cut at those collectives:
// SETUP_A, SETUP_B, (warm: RES, RESW), RES, INIT; per chunk `chunk` x (STEP
// -> psum of the step scalars -> COMMIT -> psum of the column partial), then
// STATS -> pmax / psum -> DECIDE (convergence, trace row); then STATS, EPI1
// -> float64 psums -> EPI2. Two routes run it.
//
// The fused route (pdhgs_fused_kernel; dtk_pdhgs_fused_*, _elem_fused_*) runs
// when every shard lies on one card: one cooperative launch per slice for all
// of them. A collective inside a launch deadlocks only when it waits on a
// launch that is not co-resident; here the card's G blocks (one per SM) are
// split into S groups of Gs = G / S, shard s runs on group s with its own
// Params, workspace and outputs (block index and group size in place of
// blockIdx.x and gridDim.x), and the cooperative launch makes every group
// co-resident, so the shards meet at grid syncs of one launch. The phases
// follow the sequence above with a grid sync between two phases, where the
// sequenced route has a launch boundary. Each psum / pmax is the next phase's
// own read of the S shards' parts in shard order (r = part_0, then r = op(r,
// part_s), the NaN-propagating max of common.cuh): collective_kernel.cu's
// order, so every shard gets the same bits with no pass and no barrier of its
// own. One barrier is added, in SETUP_B, which reads the parts and rewrites
// its own in one phase. The host's read of the done flags after each chunk
// becomes an in-kernel test, as in K5. Removed per step: the launches of
// STEP and COMMIT on every shard and the two collectives' launches per
// receiving shard (4 + 2S launches); per chunk: STATS's and DECIDE's
// launches, three collectives and the host's device-to-host read.
// The loop's graph (solver/device_loop.py) captures the same launch as a
// node of every row-mesh round, on buffers its plan owns and reuses each
// round: within one launch every buffer the kernel reads (the shards'
// parts, step scalars and maxima, the done flags, the workspace's state
// and partials) is written first, by SETUP_A, INIT, each STEP and STATS and
// EPI1, and the collectives' receive slots are never read on this route;
// so no value carries from one round into the next and nothing is zeroed.
//
// The rule that keeps one launch from hanging the card: a grid sync that only
// some groups reach never completes, so no branch around a barrier depends on
// the shard. Every such branch tests the phase, its argument, `warm` (a
// launch argument), the chunk index, the peers (set for every group), or shard
// 0's done flags, which every block reads after the same sync; inside a
// phase the barriers sit outside every element- and block-dependent branch
// (DECIDE's block-0 work no longer returns early).
//
// The sequenced route (pdhgs_kernel; dtk_pdhgs_*, _elem_*) runs when the
// shards span cards: each phase one cooperative launch on one shard (its grid
// barriers are its own), sequenced by the host (ops/meshlp.py) with
// collective_kernel.cu between them, the parts moved by peer copies until the
// cross-card transport exists. No kernel waits on another shard. Run at the
// fused route's group size it is the same code on the same grid, so the two
// agree bit for bit. That needs the file built without FMA contraction
// (kernels/build.py): the two kernels inline the phases into different
// code, and nvcc's contraction of a * b + c differs between them.
//
// Replicated decisions must be bit-identical on every shard: the restart test
// is a discrete branch. Every replicated quantity (the primal update, its half
// of the residual) is computed by the same code on the same inputs with the
// same grid (one group size for the whole mesh), and the cross-shard sums
// arrive in one fixed order.
//
// Padded rows (all zero) get row scale 1e12, sigma 0 and dual 0 (the step
// guards of K5), and add nothing to any product or to the certificate.
//
// The per-element entry (B6c: the reference's 3-D a_spec P(None, axis, None),
// MoE nodes with one A each). Shard s holds its rows' part of the union
// structure as a structure of its own (ms x n: row pointers, columns, each
// nonzero's place in the block's column order, then column pointers and rows:
// the first parts of ops/ipm.py's IPMSparsity), and each element's values on
// those nonzeros, vals + e * nnz_s: K5's per-element form (pdhg_kernel.cu),
// per shard. The phases that read A (setup's row maxima and |A|' row_s, the
// step's A_blk z, the column partials, the statistics, the float64
// certificate) walk the structure with element e's values on lane e, in
// ascending order, as K5's route does; everything else, the collectives and
// their order included, is the shared entry's code. No dense (B, ms, n) block
// and no transpose exist. Padded rows are empty rows of the block's structure,
// inert as above.
//
// What bounds it on an H100. Per step a shard streams its block of A twice
// (At_blk for the column partial, A_blk for the dual update), and the mesh
// together the whole A, as K5 does; at 128 devices both copies of a 769 / S
// row block fit L2, so bytes do not bound a step. On the sequenced route a
// step is 4 + 2S launches: launch-bound. On the fused route a step is five
// grid syncs of one launch (two in STEP, one between STEP and COMMIT, one in
// COMMIT, whose state writes wait for it, one after the column partial), ~1.1
// us each, and latency-bound dot products: a warp walks a row or column 128
// values an iteration, and all of an iteration's loads go out before its
// products (issued element by element they cost a memory round trip per
// element). At S shards a group has G / S blocks for all n columns, so the
// column partial's short columns (ms = m / S rows) take S times the warps'
// turns. chip_k6b_profile.py prints the cycles of each part of a step. The
// next cut: every block reduces the shards' step partials itself (no block-0
// pass and no sync between STEP and COMMIT), four syncs a step against K5's
// three.

#include <cooperative_groups.h>

#include <memory>

#include "common.cuh"

#ifndef DTK_PDHGS_THREADS
#define DTK_PDHGS_THREADS 512
#endif

namespace cg = cooperative_groups;

namespace {

using namespace dtk;

constexpr int THREADS = DTK_PDHGS_THREADS;
constexpr int NWARP = THREADS / 32;
constexpr int BMAX = 16;  // elements per launch (ops/meshlp.py BMAX)

// (B, n) column vectors of the workspace (replicated)
enum { V_CSA, V_CM, V_TAU, V_X, V_XA, V_ZX, V_TX, V_XH, V_ZB, V_XW, N_COLV };
// (B, ms) row vectors (the shard's rows)
enum { R_ROWS, R_BS, R_SIG, R_Y, R_YA, R_YS, R_TY, R_YH, R_YW, R_YSW, N_ROWV };
// per-(block, element) partials in the iteration dtype
enum { C_QX, C_QY, C_RP, C_OBJ, C_BY, C_LAG, C_RD, C_CMAX, C_BMAX, C_OBJV, N_C };
// ... in float64
enum { D_BY, D_LAG, D_SHIFT, N_D };
// per-(block, element) non-finite flags: candidates T(z) and Halpern
enum { F_1, F_2, N_F };
// per-element state in the iteration dtype, int and float64
enum { S_RESA, S_BSC, S_CSC, S_RESW, S_QX, S_OBJ, S_LAG, S_RD, S_OBJV, N_ST };
enum { I_T, I_IT, I_DONE, I_T0, I_NRE, I_USEW, N_STI };
enum { SD_SHIFT, SD_LAG, N_STD };
// the step scalars a shard sends to the psum, (B, N_SQ)
enum { Q_QY, Q_F1, Q_F2, N_SQ };

enum {
  P_SETUP_A = 0,  // scalings, cold/warm starts; column partial of |A|' row_s
  P_SETUP_B,      // tau, b_scale; column partial of the start's dual
  P_RES,          // T(x, y) without Halpern: the residual's partials (arg: warm point)
  P_RESW,         // the warm point's residual; column partial of the cold dual
  P_INIT,         // best-of-two start, per-element state; column partial
  P_STEP,         // T(x, y) with Halpern: candidates, residual partials, flags
  P_COMMIT,       // restart, rollback, Halpern counter; column partial
  P_STATS,        // convergence statistics (arg: every element, else the live)
  P_DECIDE,       // convergence, trace row (arg: chunk index)
  P_EPI1,         // v, y in original units; float64 column partial and b'y
  P_EPI2,         // the float64 certificate, reduced costs, box duals, scalars
  N_PHASES
};

struct Or {
  __device__ __forceinline__ int operator()(int a, int b) const { return a | b; }
};

template <typename T>
struct Params {
  const T* A;   // (ms, n) the shard's rows of A
  const T* At;  // (n, ms)
  // The per-element entry: the block's structure (rows of A_blk with their
  // columns and each nonzero's place in column order; rows of A_blk' with
  // their rows) and each element's values at vals + e * vstride.
  const int *a_ptr, *a_col, *a_pos, *t_ptr, *t_row;
  const T* vals;
  long vstride;
  const T* b;   // (B, ms)
  const T* c;   // (B, n)
  const T* l;
  const T* u;
  const T* wv;           // warm v (B, n) or null
  const T* wy;           // warm y (B, ms), the shard's rows
  const uint8_t* wok;    // warm usable (ok and every component finite)
  const uint8_t* skip;   // or null
  int B, ms, n, chunk, n_chunks, trace_rows, arg;
  T tol, rt;
  T* colv;
  T* rowv;
  T* pc;       // (G, B, N_C)
  double* pd;  // (G, B, N_D)
  int* pf;     // (G, B, N_F)
  T* st;       // (N_ST, B)
  int* sti;    // (N_STI, B)
  double* sd;  // (N_STD, B)
  T* part;           // (B, n) this shard's column partial (to the psum)
  const T* g;        // (B, n) the psum'd column product
  double* part64;    // (B, n) float64 column partial of the certificate
  const double* g64;
  T* sq;             // (B, N_SQ) step scalars (to the psum)
  const T* sqg;
  T* srp;            // (B,) max |b_s| at setup, the primal residual at STATS (to the pmax)
  const T* srpg;
  T* sby;            // (B,) b_s'y (to the psum)
  const T* sbyg;
  double* s64;       // (B,) the certificate's b'y (to the psum)
  const double* s64g;
  int* done_out;     // (B,) done flags the host reads once per chunk
  T* v_out;
  double* bound_out;
  T* obj_out;
  T* rp_out;
  T* rd_out;
  T* mu_out;
  uint8_t* conv_out;
  double* reduced_out;
  T* y_out;  // (B, ms) the shard's rows of the dual in original units
  T* z_out;
  T* f_out;
  int* iters_out;
  T* trace;  // (B, trace_rows, 6) or null
};

// The fused route's shards: every shard's Params (in the launch's parameter
// space) and their count; none on the sequenced route, which reads the
// collectives' results.
template <typename T>
struct Peers {
  const Params<T>* p;
  int S;
};

// A block's place in its shard's group: its index and the group's size
// (the sequenced route's group is the whole grid).
struct Grp {
  int bid, nb;
};

// Per-block scratch and the per-element decisions of a phase; every block
// computes the same values.
template <typename T>
struct Blk {
  T sw[NWARP * BMAX];
  T rv[N_C][BMAX];
  T w[BMAX];
  double swd[NWARP * BMAX];
  double rvd[N_D][BMAX];
  int swi[NWARP * BMAX];
  int rvi[N_F][BMAX];
  int restart[BMAX], fin[BMAX], usew[BMAX];
};

template <typename T>
__device__ __forceinline__ T* colv(const Params<T>& p, int v) {
  return p.colv + (size_t)v * p.B * p.n;
}
template <typename T>
__device__ __forceinline__ T* rowv(const Params<T>& p, int v) {
  return p.rowv + (size_t)v * p.B * p.ms;
}

__device__ __forceinline__ bool on(unsigned mask, int e) { return (mask >> e) & 1u; }

// The collectives' results. The sequenced route reads what
// collective_kernel.cu wrote; the fused route reduces the shards' parts
// itself, in shard order (r = part_0, then r = op(r, part_s)), as
// collective_kernel.cu's reduce_parts does: the same bits on every shard.
// psum of the column partials at idx = (e, j)
template <typename T>
__device__ __forceinline__ T g_at(const Params<T>& p, Peers<T> pr, size_t idx) {
  if (pr.p == nullptr) return p.g[idx];
  T r = pr.p[0].part[idx];
  for (int s = 1; s < pr.S; ++s) r = r + pr.p[s].part[idx];
  return r;
}
// psum of the step scalars: element e's slot k
template <typename T>
__device__ __forceinline__ T sq_at(const Params<T>& p, Peers<T> pr, int e, int k) {
  const int i = e * N_SQ + k;
  if (pr.p == nullptr) return p.sqg[i];
  T r = pr.p[0].sq[i];
  for (int s = 1; s < pr.S; ++s) r = r + pr.p[s].sq[i];
  return r;
}
// pmax of max|b_s| (setup) or of the primal residual (statistics)
template <typename T>
__device__ __forceinline__ T rp_at(const Params<T>& p, Peers<T> pr, int e) {
  if (pr.p == nullptr) return p.srpg[e];
  T r = pr.p[0].srp[e];
  for (int s = 1; s < pr.S; ++s) r = nan_max(r, pr.p[s].srp[e]);
  return r;
}
// psum of b_s'y
template <typename T>
__device__ __forceinline__ T by_at(const Params<T>& p, Peers<T> pr, int e) {
  if (pr.p == nullptr) return p.sbyg[e];
  T r = pr.p[0].sby[e];
  for (int s = 1; s < pr.S; ++s) r = r + pr.p[s].sby[e];
  return r;
}
// float64 psums of the certificate: A'y at idx, b'y of element e
template <typename T>
__device__ __forceinline__ double g64_at(const Params<T>& p, Peers<T> pr, size_t idx) {
  if (pr.p == nullptr) return p.g64[idx];
  double r = pr.p[0].part64[idx];
  for (int s = 1; s < pr.S; ++s) r = r + pr.p[s].part64[idx];
  return r;
}
template <typename T>
__device__ __forceinline__ double s64_at(const Params<T>& p, Peers<T> pr, int e) {
  if (pr.p == nullptr) return p.s64g[e];
  double r = pr.p[0].s64[e];
  for (int s = 1; s < pr.S; ++s) r = r + pr.p[s].s64[e];
  return r;
}

// acc[e] = sum_k S(row[k]) * S(vec[e*stride + k]) over k < len, for the
// elements of ``mask``; one warp, every lane ends with every element's sum.
template <typename S, typename TA, typename TV>
__device__ __forceinline__ void warp_dots(const TA* __restrict__ row, const TV* vec,
                                          long stride, int len, unsigned mask,
                                          int B, S (&acc)[BMAX], bool absa) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < BMAX; ++e) acc[e] = S(0);
  int k = lane;
  for (; k + 96 < len; k += 128) {
    S a0 = S(row[k]), a1 = S(row[k + 32]), a2 = S(row[k + 64]), a3 = S(row[k + 96]);
    if (absa) {
      a0 = fabs(a0);
      a1 = fabs(a1);
      a2 = fabs(a2);
      a3 = fabs(a3);
    }
    // Four elements at a time: every load first, then the products, so the
    // loads of an iteration share one memory round trip (each element's
    // sum keeps its order).
#pragma unroll
    for (int e0 = 0; e0 < BMAX; e0 += 4) {
      if (e0 < B) {
        S v[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u;
          if (e < B && on(mask, e)) {
            const TV* vp = vec + e * stride + k;
            v[u][0] = S(vp[0]);
            v[u][1] = S(vp[32]);
            v[u][2] = S(vp[64]);
            v[u][3] = S(vp[96]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u;
          if (e < B && on(mask, e)) {
            acc[e] += a0 * v[u][0];
            acc[e] += a1 * v[u][1];
            acc[e] += a2 * v[u][2];
            acc[e] += a3 * v[u][3];
          }
        }
      }
    }
  }
  // The rest, at most three strides: loads first here too, then the
  // products in the same order.
  const int nt = k < len ? (len - k + 31) / 32 : 0;
  S at[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    at[q] = q < nt ? S(row[k + 32 * q]) : S(0);
    if (absa) at[q] = fabs(at[q]);
  }
#pragma unroll
  for (int e0 = 0; e0 < BMAX; e0 += 4) {
    if (e0 < B) {
      S v[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          if (e < B && on(mask, e) && q < nt) v[u][q] = S(vec[e * stride + k + 32 * q]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          if (e < B && on(mask, e) && q < nt) acc[e] += at[q] * v[u][q];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < BMAX; ++e)
    if (e < B && on(mask, e)) acc[e] = warp_reduce(acc[e], Sum());
}

template <typename S>
__device__ __forceinline__ S pick(const S (&acc)[BMAX], int lane) {
  S r = S(0);
#pragma unroll
  for (int e = 0; e < BMAX; ++e)
    if (e == lane) r = acc[e];
  return r;
}

// Row i of A_blk against each element's (B, n) vector; lane e < B returns
// element e's sum. The per-element entry has lane e walk the row's nonzeros
// in ascending column order with element e's values.
template <bool kElem, typename S, typename T, typename V>
__device__ __forceinline__ S row_dot(const Params<T>& p, int i, const V* vec, unsigned mask) {
  const int lane = threadIdx.x & 31;
  if constexpr (kElem) {
    S acc = S(0);
    if (lane < p.B && on(mask, lane)) {
      const T* va = p.vals + (size_t)lane * p.vstride;
      const V* x = vec + (size_t)lane * p.n;
      for (int q = p.a_ptr[i]; q < p.a_ptr[i + 1]; ++q)
        acc += S(va[p.a_pos[q]]) * S(x[p.a_col[q]]);
    }
    return acc;
  } else {
    S acc[BMAX];
    warp_dots(p.A + (size_t)i * p.n, vec, p.n, p.n, mask, p.B, acc, false);
    return pick(acc, lane);
  }
}

// Column j of A_blk (row j of At_blk) against each element's (B, ms) vector
// (the per-element entry in ascending row order, as row_dot).
template <bool kElem, typename S, typename T, typename V>
__device__ __forceinline__ S col_dot(const Params<T>& p, int j, const V* vec, unsigned mask,
                                     bool absa = false) {
  const int lane = threadIdx.x & 31;
  if constexpr (kElem) {
    S acc = S(0);
    if (lane < p.B && on(mask, lane)) {
      const T* va = p.vals + (size_t)lane * p.vstride;
      const V* y = vec + (size_t)lane * p.ms;
      for (int q = p.t_ptr[j]; q < p.t_ptr[j + 1]; ++q) {
        const S a = S(va[q]);
        acc += (absa ? S(fabs(a)) : a) * S(y[p.t_row[q]]);
      }
    }
    return acc;
  } else {
    S acc[BMAX];
    warp_dots(p.At + (size_t)j * p.ms, vec, p.ms, p.ms, mask, p.B, acc, absa);
    return pick(acc, lane);
  }
}

// Per-lane values (lane e holds element e) of every warp -> one partial per
// (block, element), combined over the warps in a fixed order.
template <typename T, typename Op>
__device__ void block_partial(T v, Op op, T init, T* sw, T* dst, int nslot, int slot, int B,
                              bool accumulate, Grp grp) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  // Every warp is done reading sw: the statistics' block_reduce calls use
  // the same scratch just before, and a warp with no rows would otherwise
  // overwrite a slot another warp has yet to read.
  __syncthreads();
  if (lane < BMAX) sw[wid * BMAX + lane] = lane < B ? v : init;
  __syncthreads();
  if ((int)threadIdx.x < B) {
    const int e = threadIdx.x;
    T r = init;
    for (int q = 0; q < NWARP; ++q) r = op(r, sw[q * BMAX + e]);
    const size_t i = ((size_t)grp.bid * B + e) * nslot + slot;
    dst[i] = accumulate ? op(dst[i], r) : r;
  }
  __syncthreads();
}

// Every element's block_reduce at once: element e's value v[e] (per thread)
// reduced over the warp (the butterfly of warp_reduce), then over the
// block's warps in order, as common.cuh's block_reduce does, into
// dst[(bid, e), slot] by thread e. Two barriers for all B elements.
template <typename T, typename Op>
__device__ __forceinline__ void block_partials(const T (&v)[BMAX], Op op, T* sw, T* dst,
                                               int nslot, int slot, int B, Grp grp) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // every warp is done reading sw
#pragma unroll
  for (int e = 0; e < BMAX; ++e) {
    if (e < B) {
      const T r = warp_reduce(v[e], op);
      if (lane == 0) sw[wid * BMAX + e] = r;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < B) {
    const int e = threadIdx.x;
    T r = sw[e];
    for (int q = 1; q < NWARP; ++q) r = op(r, sw[q * BMAX + e]);
    dst[((size_t)grp.bid * B + e) * nslot + slot] = r;
  }
}

// Warps of task k of ``tasks`` reductions run side by side: a share of the
// block's warps each, or every warp (one task after another) when the block
// has fewer warps than tasks.
__host__ __device__ constexpr int task_w0(int k, int tasks) {
  return NWARP >= tasks ? k * (NWARP / tasks) : 0;
}
__host__ __device__ constexpr int task_nw(int tasks) {
  return NWARP >= tasks ? NWARP / tasks : NWARP;
}

// out[e] = op over the group's nb block partials (fixed order), on warps
// [w0, w0 + nw) of the block (several reductions run side by side on
// disjoint warps; which warp reduces changes no bit). Call after a grid
// sync; follow by __syncthreads.
template <typename T, typename Op>
__device__ void grid_reduce(const T* part, int nslot, int slot, int B, Op op, T init, T* out,
                            int nb, int w0 = 0, int nw = NWARP) {
  const int lane = threadIdx.x & 31, wid = (threadIdx.x >> 5) - w0;
  if (wid < 0 || wid >= nw) return;
  for (int e = wid; e < B; e += nw) {
    T v = init;
    for (int g = lane; g < nb; g += 32)
      v = op(v, part[((size_t)g * B + e) * nslot + slot]);
    v = warp_reduce(v, op);
    if (lane == 0) out[e] = v;
  }
}

// part[e, j] = sum_i |A_blk|^(absa) [i, j] vec[e, i] for every column j
// (this shard's column partial), for the elements of ``mask``.
template <bool kElem, typename S, typename T, typename V>
__device__ __forceinline__ void colpart(const Params<T>& p, Grp grp, const V* vec, S* out, unsigned mask,
                        bool absa) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int gw = grp.bid * NWARP + wid, tw = grp.nb * NWARP;
  for (int j = gw; j < p.n; j += tw) {
    const S s = col_dot<kElem, S>(p, j, vec, mask, absa);
    if (lane < p.B && on(mask, lane)) out[(size_t)lane * p.n + j] = s;
  }
}

// Column half of T(x, y) from the psum'd column product g: Tx, zb and the
// residual's column part (replicated on every shard); with ``halpern`` also
// the Halpern candidate and its flags.
template <typename T>
__device__ __forceinline__ void t_cols(const Params<T>& p, Blk<T>& s, Grp grp, Peers<T> pr,
                                       const T* x, unsigned mask, bool halpern) {
  const long gtid = (long)grp.bid * THREADS + threadIdx.x;
  const long gthreads = (long)grp.nb * THREADS;
  const int B = p.B, n = p.n;
  const T* csa = colv(p, V_CSA);
  const T* cm = colv(p, V_CM);
  const T* tau = colv(p, V_TAU);
  const T* xa = colv(p, V_XA);
  T* tx_o = colv(p, V_TX);
  T* xh_o = colv(p, V_XH);
  T* zb = colv(p, V_ZB);
  T q[BMAX];
  int fl[BMAX];
#pragma unroll
  for (int e = 0; e < BMAX; ++e) {
    q[e] = T(0);
    fl[e] = 0;
  }
  // Elementwise over (B, n): thread-local partials per element, then block
  // partials; the order is fixed by the grid, the same on every shard.
  for (long idx = gtid; idx < (long)B * n; idx += gthreads) {
    const int e = (int)(idx / n);
    if (!on(mask, e)) continue;
    const T ca = csa[idx], tk = tau[idx], xj = x[idx];
    const T tx = clip(xj - tk * (cm[idx] - ca * g_at(p, pr, (size_t)idx)), T(0), T(1));
    tx_o[idx] = tx;
    zb[idx] = ca * (T(2) * tx - xj);
    const T dx = tx - xj;
    const T qv = (tk > T(0) ? dx * dx : T(0)) / nan_max(tk, T(1e-30));
    int f = 0;
    if (halpern) {
      const T w = s.w[e];
      const T xh = w * tx + (T(1) - w) * xa[idx];
      xh_o[idx] = xh;
      f = (is_finite(tx) ? 0 : 1) | (is_finite(xh) ? 0 : 2);
    }
#pragma unroll
    for (int k = 0; k < BMAX; ++k)
      if (k == e) {
        q[k] += qv;
        fl[k] |= f;
      }
  }
  block_partials(q, Sum(), s.sw, p.pc, N_C, C_QX, B, grp);
  if (halpern) {
    // the flags OR-ed as block_reduce would, then split into their slots
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    __syncthreads();
#pragma unroll
    for (int e = 0; e < BMAX; ++e) {
      if (e < B) {
        const int r = warp_reduce(fl[e], Or());
        if (lane == 0) s.swi[wid * BMAX + e] = r;
      }
    }
    __syncthreads();
    if ((int)threadIdx.x < B) {
      const int e = threadIdx.x;
      int f = s.swi[e];
      for (int w = 1; w < NWARP; ++w) f |= s.swi[w * BMAX + e];
      p.pf[((size_t)grp.bid * B + e) * N_F + F_1] = f & 1;
      p.pf[((size_t)grp.bid * B + e) * N_F + F_2] = (f >> 1) & 1;
    }
  }
}

// Row half of T(x, y) on the shard's rows: Ty = y + sigma (b_s - row_s
// (A_blk zb)), the residual's row part; with ``halpern`` the candidate and
// its flags, OR-ed into the column half's.
template <bool kElem, typename T>
__device__ __forceinline__ void t_rows(const Params<T>& p, Blk<T>& s, Grp grp, const T* y, unsigned mask,
                       bool halpern) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int gw = grp.bid * NWARP + wid, tw = grp.nb * NWARP;
  const int B = p.B, ms = p.ms;
  const T* rows = rowv(p, R_ROWS);
  const T* bs = rowv(p, R_BS);
  const T* sig = rowv(p, R_SIG);
  const T* ya = rowv(p, R_YA);
  T* ty_o = rowv(p, R_TY);
  T* yh_o = rowv(p, R_YH);
  const T* zb = colv(p, V_ZB);
  T q = T(0);
  int fl = 0;
  for (int i = gw; i < ms; i += tw) {
    const T az = row_dot<kElem, T>(p, i, zb, mask);
    if (lane < B && on(mask, lane)) {
      const size_t k = (size_t)lane * ms + i;
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
  block_partial(q, Sum(), T(0), s.sw, p.pc, N_C, C_QY, B, false, grp);
  if (halpern) {
    block_partial(fl & 1, Or(), 0, s.swi, p.pf, N_F, F_1, B, true, grp);
    block_partial((fl >> 1) & 1, Or(), 0, s.swi, p.pf, N_F, F_2, B, true, grp);
  }
}

// T(x, y) and the partials of its residual (and flags), reduced by block 0
// into the replicated column part (state S_QX) and the shard's step scalars.
template <bool kElem, typename T>
__device__ __forceinline__ void t_step(const Params<T>& p, Blk<T>& s, cg::grid_group& grid,
                                       Grp grp, Peers<T> pr, const T* x, const T* y,
                                       unsigned mask, bool halpern) {
  const int B = p.B, tid = threadIdx.x;
  t_cols(p, s, grp, pr, x, mask, halpern);
  grid.sync();
  t_rows<kElem>(p, s, grp, y, mask, halpern);
  grid.sync();
  if (grp.bid == 0) {
    constexpr int Q = task_nw(4);
    grid_reduce(p.pc, N_C, C_QX, B, Sum(), T(0), s.rv[C_QX], grp.nb, task_w0(0, 4), Q);
    grid_reduce(p.pc, N_C, C_QY, B, Sum(), T(0), s.rv[C_QY], grp.nb, task_w0(1, 4), Q);
    if (halpern) {
      grid_reduce(p.pf, N_F, F_1, B, Or(), 0, s.rvi[F_1], grp.nb, task_w0(2, 4), Q);
      grid_reduce(p.pf, N_F, F_2, B, Or(), 0, s.rvi[F_2], grp.nb, task_w0(3, 4), Q);
    }
    __syncthreads();
    if (tid < B) {
      const bool live = on(mask, tid);
      p.st[S_QX * B + tid] = live ? s.rv[C_QX][tid] : T(0);
      p.sq[tid * N_SQ + Q_QY] = live ? s.rv[C_QY][tid] : T(0);
      p.sq[tid * N_SQ + Q_F1] = (live && halpern) ? T(s.rvi[F_1][tid]) : T(0);
      p.sq[tid * N_SQ + Q_F2] = (live && halpern) ? T(s.rvi[F_2][tid]) : T(0);
    }
  }
}

template <typename T>
__device__ unsigned live_mask(const Params<T>& p) {
  unsigned live = 0;
  for (int e = 0; e < p.B; ++e)
    if (!p.sti[I_DONE * p.B + e]) live |= 1u << e;
  return live;
}

// One phase (PHASE) of one shard on its group of blocks (``grp``), inlined
// where it is called. Every grid sync in here is reached by every block of
// the launch: no branch around one depends on the shard (only on the
// phase, its argument, or pr).
template <typename T, bool kElem, int PHASE>
__device__ __forceinline__ void run_phase(const Params<T>& p, Blk<T>& s, cg::grid_group& grid,
                                          const Grp grp, const Peers<T> pr, const int arg) {
  const int B = p.B, ms = p.ms, n = p.n;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int gw = grp.bid * NWARP + wid, tw = grp.nb * NWARP;
  const long gtid = (long)grp.bid * THREADS + tid;
  const long gthreads = (long)grp.nb * THREADS;
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

  if constexpr (PHASE == P_SETUP_A) {
    // columns, elementwise (replicated): scalings, cold x, warm projection
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
      if (tid == 0) p.pc[((size_t)grp.bid * B + e) * N_C + C_CMAX] = cmax;
    }
    grid.sync();
    // the shard's rows: row_s, b_s, sigma, cold and warm duals
    T bmax = T(0);
    for (int i = gw; i < ms; i += tw) {
      // Row i's max |a| cs_a, sum a l and sum |a| cs_a, per element.
      T rmax = T(0), alv = T(0), acv = T(0);
      if constexpr (kElem) {
        if (lane < B) {
          const T* va = p.vals + (size_t)lane * p.vstride;
          for (int q = p.a_ptr[i]; q < p.a_ptr[i + 1]; ++q) {
            const int j = p.a_col[q];
            const T a = va[p.a_pos[q]], aa = fabs(a);
            const T ca = csa[(size_t)lane * n + j];
            rmax = nan_max(rmax, aa * ca);
            alv += a * p.l[(size_t)lane * n + j];
            acv += aa * ca;
          }
        }
      } else {
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
        rmax = pick(mx, lane);
        alv = pick(al, lane);
        acv = pick(acs, lane);
      }
      if (lane < B) {
        const size_t k = (size_t)lane * ms + i;
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
    block_partial(bmax, Max(), T(0), s.sw, p.pc, N_C, C_BMAX, B, false, grp);
    grid.sync();
    // this shard's part of the column 1-norms: |A_blk|' row_s
    colpart<kElem, T>(p, grp, rows, p.part, all, true);
    if (grp.bid == 0) {
      grid_reduce(p.pc, N_C, C_CMAX, B, Max(), T(0), s.rv[C_CMAX], grp.nb);
      grid_reduce(p.pc, N_C, C_BMAX, B, Max(), T(0), s.rv[C_BMAX], grp.nb);
      __syncthreads();
      if (tid < B) {
        p.st[S_CSC * B + tid] = T(1) + s.rv[C_CMAX][tid];
        p.srp[tid] = s.rv[C_BMAX][tid];
      }
    }
  } else if constexpr (PHASE == P_SETUP_B) {
    // tau from the psum'd column 1-norms; b_scale from the pmax'd max|b_s|
    for (long idx = gtid; idx < (long)B * n; idx += gthreads) {
      const T ca = csa[idx];
      const T c1 = ca * g_at(p, pr, (size_t)idx);
      const T tk = c1 > T(1e-12) ? T(0.9) / nan_max(c1, T(1e-12)) : T(0);
      tau[idx] = ca > T(0) ? tk : T(0);
    }
    if (grp.bid == 0 && tid < B) p.st[S_BSC * B + tid] = T(1) + rp_at(p, pr, tid);
    // The fused route reads the column parts in place: every block is done
    // with them before this shard's part is overwritten.
    if (pr.p != nullptr) grid.sync();
    colpart<kElem, T>(p, grp, warm ? ysw : ys, p.part, all, false);
  } else if constexpr (PHASE == P_RES) {
    const bool wpt = arg != 0;
    t_step<kElem>(p, s, grid, grp, pr, wpt ? xw : x, wpt ? yw : y, all, false);
  } else if constexpr (PHASE == P_RESW) {
    if (grp.bid == 0 && tid < B)
      p.st[S_RESW * B + tid] = sqrt(p.st[S_QX * B + tid] + sq_at(p, pr, tid, Q_QY));
    colpart<kElem, T>(p, grp, ys, p.part, all, false);
  } else if constexpr (PHASE == P_INIT) {
    if (tid < B) {
      const T res_c = sqrt(p.st[S_QX * B + tid] + sq_at(p, pr, tid, Q_QY));
      T res0 = res_c;
      bool use_w = false;
      if (warm) {
        const T rw = p.st[S_RESW * B + tid];
        const T rwf = is_finite(rw) ? rw : T(INFINITY);
        use_w = p.wok[tid] != 0 && rwf <= res_c;
        if (use_w) res0 = rw;
      }
      s.usew[tid] = use_w ? 1 : 0;
      if (grp.bid == 0) {
        const int done = (p.skip != nullptr && p.skip[tid] != 0) ? 1 : 0;
        p.st[S_RESA * B + tid] = nan_max(res0, T(1e-30));
        p.sti[I_T * B + tid] = 0;
        p.sti[I_IT * B + tid] = 0;
        p.sti[I_T0 * B + tid] = 0;
        p.sti[I_NRE * B + tid] = 0;
        p.sti[I_USEW * B + tid] = use_w ? 1 : 0;
        p.sti[I_DONE * B + tid] = done;
        p.done_out[tid] = done;
      }
    }
    __syncthreads();
    for (long idx = gtid; idx < (long)B * n; idx += gthreads) {
      const int e = (int)(idx / n);
      if (s.usew[e]) x[idx] = xw[idx];
      xa[idx] = x[idx];
      zx[idx] = csa[idx] * x[idx];
    }
    for (long idx = gtid; idx < (long)B * ms; idx += gthreads) {
      const int e = (int)(idx / ms);
      if (s.usew[e]) {
        y[idx] = yw[idx];
        ys[idx] = ysw[idx];
      }
      ya[idx] = y[idx];
    }
    grid.sync();
    colpart<kElem, T>(p, grp, ys, p.part, all, false);
  } else if constexpr (PHASE == P_STEP) {
    const unsigned live = live_mask(p);
    if (tid < B) {
      const T tf = T(p.sti[I_T * B + tid]);
      s.w[tid] = (tf + T(1)) / (tf + T(2));
    }
    __syncthreads();
    t_step<kElem>(p, s, grid, grp, pr, x, y, live, true);
  } else if constexpr (PHASE == P_COMMIT) {
    const unsigned live = live_mask(p);
    T ra = T(0), res = T(0);
    bool rs = false;
    if (tid < B && on(live, tid)) {
      res = sqrt(p.st[S_QX * B + tid] + sq_at(p, pr, tid, Q_QY));
      ra = p.st[S_RESA * B + tid];
      rs = (res <= p.rt * ra) || (res > ra);
      const bool f1 = sq_at(p, pr, tid, Q_F1) > T(0.5);
      const bool f2 = sq_at(p, pr, tid, Q_F2) > T(0.5);
      s.restart[tid] = rs ? 1 : 0;
      s.fin[tid] = rs ? !f1 : !f2;
    }
    __syncthreads();
    const T* tx = colv(p, V_TX);
    const T* xh = colv(p, V_XH);
    const T* ty = rowv(p, R_TY);
    const T* yh = rowv(p, R_YH);
    for (long idx = gtid; idx < (long)B * n; idx += gthreads) {
      const int e = (int)(idx / n);
      if (!on(live, e)) continue;
      const bool r = s.restart[e];
      const T xn = r ? tx[idx] : xh[idx];
      if (r) xa[idx] = tx[idx];
      if (s.fin[e]) {
        x[idx] = xn;
        zx[idx] = csa[idx] * xn;
      }
    }
    for (long idx = gtid; idx < (long)B * ms; idx += gthreads) {
      const int e = (int)(idx / ms);
      if (!on(live, e)) continue;
      const bool r = s.restart[e];
      const T yn = r ? ty[idx] : yh[idx];
      if (r) ya[idx] = ty[idx];
      if (s.fin[e]) {
        y[idx] = yn;
        ys[idx] = rows[idx] * yn;
      }
    }
    grid.sync();
    // Every block has read the state it decided from: block 0 commits it.
    if (grp.bid == 0 && tid < B && on(live, tid)) {
      p.st[S_RESA * B + tid] = rs ? res : ra;
      p.sti[I_T * B + tid] = rs ? 0 : p.sti[I_T * B + tid] + 1;
      p.sti[I_IT * B + tid] += 1;
    }
    colpart<kElem, T>(p, grp, ys, p.part, live, false);
  } else if constexpr (PHASE == P_STATS) {
    // conv_stats at the committed (x, y): the column half (replicated) from
    // the psum'd column product, the row half on the shard's rows.
    const unsigned mask = arg ? all : live_mask(p);
    T obj[BMAX], lag[BMAX], rd[BMAX];
#pragma unroll
    for (int e = 0; e < BMAX; ++e) obj[e] = lag[e] = rd[e] = T(0);
    for (long idx = gtid; idx < (long)B * n; idx += gthreads) {
      const int e = (int)(idx / n);
      if (!on(mask, e)) continue;
      const T red = cm[idx] - csa[idx] * g_at(p, pr, (size_t)idx);
      const T act = csa[idx] > T(0) ? T(1) : T(0);
      const T neg = nan_min(T(0), red);
#pragma unroll
      for (int k = 0; k < BMAX; ++k)
        if (k == e) {
          obj[k] += cm[idx] * x[idx];
          lag[k] += act * neg;
          rd[k] = nan_max(rd[k], fabs(red - neg * act));
        }
    }
    block_partials(obj, Sum(), s.sw, p.pc, N_C, C_OBJ, B, grp);
    block_partials(lag, Sum(), s.sw, p.pc, N_C, C_LAG, B, grp);
    block_partials(rd, Max(), s.sw, p.pc, N_C, C_RD, B, grp);
    T rp = T(0), by = T(0);
    for (int i = gw; i < ms; i += tw) {
      const T az = row_dot<kElem, T>(p, i, zx, mask);
      if (lane < B && on(mask, lane)) {
        const size_t k = (size_t)lane * ms + i;
        rp = nan_max(rp, fabs(bs[k] - rows[k] * az));
        by += bs[k] * y[k];
      }
    }
    block_partial(rp, Max(), T(0), s.sw, p.pc, N_C, C_RP, B, false, grp);
    block_partial(by, Sum(), T(0), s.sw, p.pc, N_C, C_BY, B, false, grp);
    grid.sync();
    if (grp.bid == 0) {
      constexpr int Q = task_nw(5);
      grid_reduce(p.pc, N_C, C_OBJ, B, Sum(), T(0), s.rv[C_OBJ], grp.nb, task_w0(0, 5), Q);
      grid_reduce(p.pc, N_C, C_LAG, B, Sum(), T(0), s.rv[C_LAG], grp.nb, task_w0(1, 5), Q);
      grid_reduce(p.pc, N_C, C_RD, B, Max(), T(0), s.rv[C_RD], grp.nb, task_w0(2, 5), Q);
      grid_reduce(p.pc, N_C, C_RP, B, Max(), T(0), s.rv[C_RP], grp.nb, task_w0(3, 5), Q);
      grid_reduce(p.pc, N_C, C_BY, B, Sum(), T(0), s.rv[C_BY], grp.nb, task_w0(4, 5), Q);
      __syncthreads();
      if (tid < B && on(mask, tid)) {
        p.st[S_OBJ * B + tid] = s.rv[C_OBJ][tid];
        p.st[S_LAG * B + tid] = s.rv[C_LAG][tid];
        p.st[S_RD * B + tid] = s.rv[C_RD][tid];
        p.srp[tid] = s.rv[C_RP][tid];
        p.sby[tid] = s.rv[C_BY][tid];
      }
    }
  } else if constexpr (PHASE == P_DECIDE) {
    if (grp.bid == 0 && tid < B && !p.sti[I_DONE * B + tid]) {
      const int e = tid, ci = arg;
      const T bsc = p.st[S_BSC * B + e], csc = p.st[S_CSC * B + e];
      const T obj = p.st[S_OBJ * B + e];
      const T gap = fabs(obj - (by_at(p, pr, e) + p.st[S_LAG * B + e]));
      const T rp = rp_at(p, pr, e);
      const bool conv = (rp < p.tol * bsc) && (gap < p.tol * (bsc + csc + fabs(obj)));
      // A live chunk without a restart advances t by exactly chunk: a
      // shortfall counts one restart chunk.
      const int t = p.sti[I_T * B + e];
      if (t != p.sti[I_T0 * B + e] + p.chunk) p.sti[I_NRE * B + e] += 1;
      if (p.trace != nullptr && ci < p.trace_rows) {
        T* row = p.trace + ((size_t)e * p.trace_rows + ci) * 6;
        row[0] = T(p.sti[I_IT * B + e]);
        row[1] = rp;
        row[2] = p.st[S_RD * B + e];
        row[3] = gap / (bsc + csc);
        row[4] = T(p.sti[I_NRE * B + e]);
        row[5] = T(1);
      }
      if (conv) p.sti[I_DONE * B + e] = 1;
      p.sti[I_T0 * B + e] = t;
      p.done_out[e] = p.sti[I_DONE * B + e];
    }
  } else if constexpr (PHASE == P_EPI1) {
    // v (replicated) and the shard's rows of y in original units
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
    for (int i = gw; i < ms; i += tw)
      if (lane < B) {
        const size_t k = (size_t)lane * ms + i;
        p.y_out[k] = y[k] * rows[k];
      }
    block_partial(objv, Sum(), T(0), s.sw, p.pc, N_C, C_OBJV, B, false, grp);
    block_partial(shift, Sum(), 0.0, s.swd, p.pd, N_D, D_SHIFT, B, false, grp);
    grid.sync();
    // the certificate's shard parts in float64: (b - A l)'y on the rows,
    // A_blk' y per column
    double by64 = 0.0;
    for (int i = gw; i < ms; i += tw) {
      const double al = row_dot<kElem, double>(p, i, p.l, all);
      if (lane < B) {
        const size_t k = (size_t)lane * ms + i;
        by64 += ((double)p.b[k] - al) * (double)p.y_out[k];
      }
    }
    block_partial(by64, Sum(), 0.0, s.swd, p.pd, N_D, D_BY, B, false, grp);
    colpart<kElem, double>(p, grp, p.y_out, p.part64, all, false);
    grid.sync();
    if (grp.bid == 0) {
      grid_reduce(p.pc, N_C, C_OBJV, B, Sum(), T(0), s.rv[C_OBJV], grp.nb);
      grid_reduce(p.pd, N_D, D_SHIFT, B, Sum(), 0.0, s.rvd[D_SHIFT], grp.nb);
      grid_reduce(p.pd, N_D, D_BY, B, Sum(), 0.0, s.rvd[D_BY], grp.nb);
      __syncthreads();
      if (tid < B) {
        p.st[S_OBJV * B + tid] = s.rv[C_OBJV][tid];
        p.sd[SD_SHIFT * B + tid] = s.rvd[D_SHIFT][tid];
        p.s64[tid] = s.rvd[D_BY][tid];
      }
    }
  } else if constexpr (PHASE == P_EPI2) {
    // reduced costs from the psum'd float64 A'y (replicated), box duals,
    // the bound's column half; then every scalar output
    double lag64 = 0.0;
    for (int j = gw; j < n; j += tw) {
      if (lane < B) {
        const size_t k = (size_t)lane * n + j;
        const double red = (double)p.c[k] - g64_at(p, pr, k);
        p.reduced_out[k] = red;
        const bool active = csa[k] > T(0);
        const double r64 = (double)((p.u[k] - p.l[k]) * (active ? T(1) : T(0)));
        lag64 += r64 * nan_min(0.0, red);
        const T ro = (T)red;
        p.z_out[k] = active ? nan_max(ro, T(0)) : T(0);
        p.f_out[k] = active ? nan_max(-ro, T(0)) : T(0);
      }
    }
    block_partial(lag64, Sum(), 0.0, s.swd, p.pd, N_D, D_LAG, B, false, grp);
    grid.sync();
    if (grp.bid == 0) {
      grid_reduce(p.pd, N_D, D_LAG, B, Sum(), 0.0, s.rvd[D_LAG], grp.nb);
      __syncthreads();
      if (tid < B) {
        const int e = tid;
        double bound = s64_at(p, pr, e) + s.rvd[D_LAG][e];
        if (!is_finite(bound)) bound = -INFINITY;
        const T bsc = p.st[S_BSC * B + e], csc = p.st[S_CSC * B + e];
        p.bound_out[e] = bound + p.sd[SD_SHIFT * B + e];
        p.obj_out[e] = p.st[S_OBJV * B + e];
        p.rp_out[e] = rp_at(p, pr, e);
        p.rd_out[e] = p.st[S_RD * B + e];
        p.mu_out[e] = fabs(p.st[S_OBJ * B + e] - (by_at(p, pr, e) + p.st[S_LAG * B + e])) /
                      (bsc + csc);
        p.conv_out[e] = p.sti[I_DONE * B + e] ? 1 : 0;
        p.iters_out[e] = p.sti[I_IT * B + e];
      }
    }
  }
}

// The sequenced route: one phase of one shard, the whole grid its group.
template <typename T, bool kElem>
__global__ void __launch_bounds__(THREADS, 1) pdhgs_kernel(Params<T> p, int phase) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Blk<T>& s = *reinterpret_cast<Blk<T>*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const Grp grp{(int)blockIdx.x, (int)gridDim.x};
  switch (phase) {
    case P_SETUP_A: run_phase<T, kElem, P_SETUP_A>(p, s, grid, grp, Peers<T>{nullptr, 1}, p.arg); break;
    case P_SETUP_B: run_phase<T, kElem, P_SETUP_B>(p, s, grid, grp, Peers<T>{nullptr, 1}, p.arg); break;
    case P_RES: run_phase<T, kElem, P_RES>(p, s, grid, grp, Peers<T>{nullptr, 1}, p.arg); break;
    case P_RESW: run_phase<T, kElem, P_RESW>(p, s, grid, grp, Peers<T>{nullptr, 1}, p.arg); break;
    case P_INIT: run_phase<T, kElem, P_INIT>(p, s, grid, grp, Peers<T>{nullptr, 1}, p.arg); break;
    case P_STEP: run_phase<T, kElem, P_STEP>(p, s, grid, grp, Peers<T>{nullptr, 1}, p.arg); break;
    case P_COMMIT: run_phase<T, kElem, P_COMMIT>(p, s, grid, grp, Peers<T>{nullptr, 1}, p.arg); break;
    case P_STATS: run_phase<T, kElem, P_STATS>(p, s, grid, grp, Peers<T>{nullptr, 1}, p.arg); break;
    case P_DECIDE: run_phase<T, kElem, P_DECIDE>(p, s, grid, grp, Peers<T>{nullptr, 1}, p.arg); break;
    case P_EPI1: run_phase<T, kElem, P_EPI1>(p, s, grid, grp, Peers<T>{nullptr, 1}, p.arg); break;
    case P_EPI2: run_phase<T, kElem, P_EPI2>(p, s, grid, grp, Peers<T>{nullptr, 1}, p.arg); break;
  }
}

// The fused launch's argument: every shard's Params in the kernel's
// parameter space (__grid_constant__: read in place, never copied), so the
// compiler knows every pointer in them is global memory and the products
// read A with global loads, as the sequenced kernel does (a Params copy in
// shared memory made them generic loads). 64 shards of one card at most:
// 64 Params fill ~30 KB of the 32 KB a launch's parameters may hold.
constexpr int MAX_FUSED = 64;
template <typename T>
struct FusedArgs {
  Params<T> p[MAX_FUSED];
};

// True when every element of shard 0 is done (the fused loop's one test,
// read by every block after a grid sync; __ldcg reads it past L1).
__device__ __forceinline__ bool all_done(const int* done, int B) {
  for (int e = 0; e < B; ++e)
    if (!__ldcg(done + e)) return false;
  return true;
}

// The fused route: every shard of the card in one cooperative launch, shard
// s on blocks [s * Gs, (s + 1) * Gs). The phases run in the host sequence's
// order with a grid sync between two phases (where the sequenced route has
// a launch boundary); a collective is the next phase's read of the shards'
// parts in shard order (g_at, sq_at, ...). Every branch around a sync tests
// a value that is the same in every block: the phase, ``warm`` (an
// argument), the chunk index, and shard 0's done flags.
template <typename T, bool kElem>
__global__ void __launch_bounds__(THREADS, 1)
    pdhgs_fused_kernel(const __grid_constant__ FusedArgs<T> f, int S, int Gs, int warm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Blk<T>& s = *reinterpret_cast<Blk<T>*>(smem_raw);
  const Params<T>& p = f.p[blockIdx.x / Gs];
  cg::grid_group grid = cg::this_grid();
  const Grp grp{(int)(blockIdx.x % Gs), Gs};
  const Peers<T> pr{f.p, S};
  const int* done0 = f.p[0].sti + I_DONE * p.B;
  run_phase<T, kElem, P_SETUP_A>(p, s, grid, grp, pr, 0);
  grid.sync();
  run_phase<T, kElem, P_SETUP_B>(p, s, grid, grp, pr, 0);
  grid.sync();
  if (warm) {
    run_phase<T, kElem, P_RES>(p, s, grid, grp, pr, 1);
    grid.sync();
    run_phase<T, kElem, P_RESW>(p, s, grid, grp, pr, 0);
    grid.sync();
  }
  run_phase<T, kElem, P_RES>(p, s, grid, grp, pr, 0);
  grid.sync();
  run_phase<T, kElem, P_INIT>(p, s, grid, grp, pr, 0);
  grid.sync();
  if (!all_done(done0, p.B)) {
    for (int ci = 0; ci < p.n_chunks; ++ci) {
      for (int st = 0; st < p.chunk; ++st) {
        run_phase<T, kElem, P_STEP>(p, s, grid, grp, pr, 0);
        grid.sync();
        run_phase<T, kElem, P_COMMIT>(p, s, grid, grp, pr, 0);
        grid.sync();
      }
      run_phase<T, kElem, P_STATS>(p, s, grid, grp, pr, 0);
      grid.sync();
      run_phase<T, kElem, P_DECIDE>(p, s, grid, grp, pr, ci);
      grid.sync();
      if (all_done(done0, p.B)) break;
    }
  }
  run_phase<T, kElem, P_STATS>(p, s, grid, grp, pr, 1);
  grid.sync();
  run_phase<T, kElem, P_EPI1>(p, s, grid, grp, pr, 0);
  grid.sync();
  run_phase<T, kElem, P_EPI2>(p, s, grid, grp, pr, 0);
}

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

template <typename T>
size_t ws_bytes(int B, int ms, int n, int G) {
  return align_up(sizeof(double) * (size_t)G * B * N_D) +
         align_up(sizeof(T) * (size_t)G * B * N_C) +
         align_up(sizeof(int) * (size_t)G * B * N_F) +
         align_up(sizeof(T) * (size_t)N_ST * B) + align_up(sizeof(int) * (size_t)N_STI * B) +
         align_up(sizeof(double) * (size_t)N_STD * B) +
         align_up(sizeof(T) * (size_t)N_COLV * B * n) +
         align_up(sizeof(T) * (size_t)N_ROWV * B * ms);
}

// Blocks the card holds co-resident for ``kernel`` (one per SM: every block
// re-reduces the partials), or a cudaError_t.
int grid_size(const void* kernel, size_t smem, int* G) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *G = sms;
  return 0;
}

template <typename T, bool kElem>
int phase_grid(int* G) {
  return grid_size((const void*)pdhgs_kernel<T, kElem>, sizeof(Blk<T>), G);
}

// The fused route's grid, asked of the card once a device and entry (the
// first dtk_pdhgs_fused_grid query, made before any launch) and kept: a
// launch, a graph capture's included, reads it and queries nothing.
constexpr int MAX_DEVICES = 64;
int g_fused_grid[MAX_DEVICES][4];

template <typename T, bool kElem>
int fused_grid(int* G) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int& slot = g_fused_grid[dev][(sizeof(T) == 8 ? 2 : 0) + (kElem ? 1 : 0)];
  if (slot == 0) {
    const int gerr = grid_size((const void*)pdhgs_fused_kernel<T, kElem>, sizeof(Blk<T>), &slot);
    if (gerr != 0) {
      slot = 0;
      return gerr;
    }
  }
  *G = slot;
  return 0;
}

// Pointer slots of a shard (ops/meshlp.py builds the array in this order).
enum {
  A_A, A_AT, A_B, A_C, A_L, A_U, A_WV, A_WY, A_WOK, A_SKIP, A_WS,
  A_PART, A_G, A_PART64, A_G64, A_SQ, A_SQG, A_SRP, A_SRPG, A_SBY, A_SBYG, A_S64, A_S64G,
  A_DONE, A_V, A_BOUND, A_OBJ, A_RP, A_RD, A_MU, A_CONV, A_REDUCED, A_Y, A_Z, A_F,
  A_ITERS, A_TRACE, N_PTR
};
// Int slots (J_NNZ: the per-element entry's nonzeros of the block)
enum { J_B, J_MS, J_N, J_CHUNK, J_NCHUNKS, J_TROWS, J_G, J_ARG, J_NNZ, N_INT };

// One shard's Params from its slots (checked against its workspace at grid
// G). The shared entry reads A_blk and At_blk at P[A_A] and P[A_AT]; the
// per-element entry reads each element's values (B, nnz) at P[A_A] and the
// block's structure (int32, ops/ipm.py's IPMSparsity.index) at P[A_AT].
template <typename T, bool kElem>
int make_params(void* const* P, const int* I, const double* D, long ws_len, int G,
                Params<T>* out) {
  Params<T> p = {};
  p.B = I[J_B];
  p.ms = I[J_MS];
  p.n = I[J_N];
  p.chunk = I[J_CHUNK];
  p.n_chunks = I[J_NCHUNKS];
  p.trace_rows = I[J_TROWS];
  p.arg = I[J_ARG];
  if (p.B < 1 || p.B > BMAX || p.ms < 1 || p.n < 1) return (int)cudaErrorInvalidValue;
  if ((size_t)ws_len < ws_bytes<T>(p.B, p.ms, p.n, G)) return (int)cudaErrorInvalidValue;
  p.tol = (T)D[0];
  p.rt = (T)D[1];
  if constexpr (kElem) {
    const int nnz = I[J_NNZ];
    const int* idx = static_cast<const int*>(P[A_AT]);
    if (nnz < 0 || idx == nullptr || (nnz > 0 && P[A_A] == nullptr))
      return (int)cudaErrorInvalidValue;
    p.vals = static_cast<const T*>(P[A_A]);
    p.vstride = nnz;
    p.a_ptr = idx;
    p.a_col = p.a_ptr + p.ms + 1;
    p.a_pos = p.a_col + nnz;
    p.t_ptr = p.a_pos + nnz;
    p.t_row = p.t_ptr + p.n + 1;
  } else {
    p.A = static_cast<const T*>(P[A_A]);
    p.At = static_cast<const T*>(P[A_AT]);
  }
  p.b = static_cast<const T*>(P[A_B]);
  p.c = static_cast<const T*>(P[A_C]);
  p.l = static_cast<const T*>(P[A_L]);
  p.u = static_cast<const T*>(P[A_U]);
  p.wv = static_cast<const T*>(P[A_WV]);
  p.wy = static_cast<const T*>(P[A_WY]);
  p.wok = static_cast<const uint8_t*>(P[A_WOK]);
  p.skip = static_cast<const uint8_t*>(P[A_SKIP]);
  p.part = static_cast<T*>(P[A_PART]);
  p.g = static_cast<const T*>(P[A_G]);
  p.part64 = static_cast<double*>(P[A_PART64]);
  p.g64 = static_cast<const double*>(P[A_G64]);
  p.sq = static_cast<T*>(P[A_SQ]);
  p.sqg = static_cast<const T*>(P[A_SQG]);
  p.srp = static_cast<T*>(P[A_SRP]);
  p.srpg = static_cast<const T*>(P[A_SRPG]);
  p.sby = static_cast<T*>(P[A_SBY]);
  p.sbyg = static_cast<const T*>(P[A_SBYG]);
  p.s64 = static_cast<double*>(P[A_S64]);
  p.s64g = static_cast<const double*>(P[A_S64G]);
  p.done_out = static_cast<int*>(P[A_DONE]);
  p.v_out = static_cast<T*>(P[A_V]);
  p.bound_out = static_cast<double*>(P[A_BOUND]);
  p.obj_out = static_cast<T*>(P[A_OBJ]);
  p.rp_out = static_cast<T*>(P[A_RP]);
  p.rd_out = static_cast<T*>(P[A_RD]);
  p.mu_out = static_cast<T*>(P[A_MU]);
  p.conv_out = static_cast<uint8_t*>(P[A_CONV]);
  p.reduced_out = static_cast<double*>(P[A_REDUCED]);
  p.y_out = static_cast<T*>(P[A_Y]);
  p.z_out = static_cast<T*>(P[A_Z]);
  p.f_out = static_cast<T*>(P[A_F]);
  p.iters_out = static_cast<int*>(P[A_ITERS]);
  p.trace = static_cast<T*>(P[A_TRACE]);
  if (p.trace == nullptr) p.trace_rows = 0;
  unsigned char* w = static_cast<unsigned char*>(P[A_WS]);
  const int B = p.B;
  p.pd = reinterpret_cast<double*>(w);
  w += align_up(sizeof(double) * (size_t)G * B * N_D);
  p.pc = reinterpret_cast<T*>(w);
  w += align_up(sizeof(T) * (size_t)G * B * N_C);
  p.pf = reinterpret_cast<int*>(w);
  w += align_up(sizeof(int) * (size_t)G * B * N_F);
  p.st = reinterpret_cast<T*>(w);
  w += align_up(sizeof(T) * (size_t)N_ST * B);
  p.sti = reinterpret_cast<int*>(w);
  w += align_up(sizeof(int) * (size_t)N_STI * B);
  p.sd = reinterpret_cast<double*>(w);
  w += align_up(sizeof(double) * (size_t)N_STD * B);
  p.colv = reinterpret_cast<T*>(w);
  w += align_up(sizeof(T) * (size_t)N_COLV * B * p.n);
  p.rowv = reinterpret_cast<T*>(w);
  *out = p;
  return 0;
}

template <typename T, bool kElem>
int launch(int phase, void* const* P, const int* I, const double* D, long ws_len,
           cudaStream_t stream) {
  if (phase < 0 || phase >= N_PHASES) return (int)cudaErrorInvalidValue;
  const int G = I[J_G];
  int Gmax = 0;
  const int gerr = phase_grid<T, kElem>(&Gmax);
  if (gerr != 0) return gerr;
  if (G < 1 || G > Gmax) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params<T> p;
  const int perr = make_params<T, kElem>(P, I, D, ws_len, G, &p);
  if (perr != 0) return perr;
  void* args[] = {&p, &phase};
  cudaError_t err = cudaLaunchCooperativeKernel(pdhgs_kernel<T, kElem>, dim3(G), dim3(THREADS),
                                                args, sizeof(Blk<T>), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The fused route: S shards' slots (P: S x N_PTR, I: S x N_INT, ws_len: S),
// each shard on a group of I[J_G] blocks.
template <typename T, bool kElem>
int launch_fused(int S, void* const* P, const int* I, const double* D, const long* ws_len,
                 int warm, cudaStream_t stream) {
  if (S < 1 || S > MAX_FUSED) return (int)cudaErrorInvalidValue;
  const int Gs = I[J_G];
  int Gmax = 0;
  const int gerr = fused_grid<T, kElem>(&Gmax);
  if (gerr != 0) return gerr;
  if (Gs < 1 || (long)S * Gs > Gmax) return (int)cudaErrorCooperativeLaunchTooLarge;
  std::unique_ptr<FusedArgs<T>> args(new FusedArgs<T>());
  Params<T>* host = args->p;
  for (int s = 0; s < S; ++s) {
    const int* Is = I + (size_t)s * N_INT;
    // every group runs the same loop and grid: one B, chunking and G
    for (int j : {J_B, J_N, J_CHUNK, J_NCHUNKS, J_TROWS, J_G})
      if (Is[j] != I[j]) return (int)cudaErrorInvalidValue;
    const int perr =
        make_params<T, kElem>(P + (size_t)s * N_PTR, Is, D, ws_len[s], Gs, &host[s]);
    if (perr != 0) return perr;
    if ((host[s].wv != nullptr) != (warm != 0)) return (int)cudaErrorInvalidValue;
  }
  int ns = S, gs = Gs, wm = warm ? 1 : 0;
  void* kargs[] = {args.get(), &ns, &gs, &wm};
  cudaError_t err = cudaLaunchCooperativeKernel(pdhgs_fused_kernel<T, kElem>, dim3(S * Gs), dim3(THREADS),
                                    kargs, sizeof(Blk<T>), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of one launch on the current device (one per SM), or minus a
// cudaError_t. The sequenced route passes one grid size for every shard of
// a mesh.
int dtk_pdhgs_grid(int is_f64) {
  int G = 0;
  const int err = is_f64 ? phase_grid<double, false>(&G) : phase_grid<float, false>(&G);
  return err != 0 ? -err : G;
}

// The same for the per-element entry.
int dtk_pdhgs_elem_grid(int is_f64) {
  int G = 0;
  const int err = is_f64 ? phase_grid<double, true>(&G) : phase_grid<float, true>(&G);
  return err != 0 ? -err : G;
}

// The same for the fused route (either entry; asked of the card once, then
// kept): the caller splits the G blocks into S groups of G / S (S <=
// dtk_pdhgs_fused_max_shards()).
int dtk_pdhgs_fused_grid(int is_f64, int elem) {
  int G = 0;
  int err;
  if (elem)
    err = is_f64 ? fused_grid<double, true>(&G) : fused_grid<float, true>(&G);
  else
    err = is_f64 ? fused_grid<double, false>(&G) : fused_grid<float, false>(&G);
  return err != 0 ? -err : G;
}

// Shards one fused launch holds at most.
int dtk_pdhgs_fused_max_shards() { return MAX_FUSED; }

// Workspace bytes of one shard (B elements, ms rows, n columns, grid G).
size_t dtk_pdhgs_ws_bytes(int B, int ms, int n, int G, int is_f64) {
  return is_f64 ? ws_bytes<double>(B, ms, n, G) : ws_bytes<float>(B, ms, n, G);
}

// One phase of one shard: P holds N_PTR pointers (unused ones null), I the
// N_INT ints, D {tol, restart_tol}.
int dtk_pdhgs_f32(int phase, void* const* P, const int* I, const double* D, long ws_len,
                  void* stream) {
  return launch<float, false>(phase, P, I, D, ws_len, (cudaStream_t)stream);
}

int dtk_pdhgs_f64(int phase, void* const* P, const int* I, const double* D, long ws_len,
                  void* stream) {
  return launch<double, false>(phase, P, I, D, ws_len, (cudaStream_t)stream);
}

// One phase of one shard with a per-element A: P[0] each element's values
// on the block's structure, P[1] the structure, I[8] its nonzeros.
int dtk_pdhgs_elem_f32(int phase, void* const* P, const int* I, const double* D, long ws_len,
                       void* stream) {
  return launch<float, true>(phase, P, I, D, ws_len, (cudaStream_t)stream);
}

int dtk_pdhgs_elem_f64(int phase, void* const* P, const int* I, const double* D, long ws_len,
                       void* stream) {
  return launch<double, true>(phase, P, I, D, ws_len, (cudaStream_t)stream);
}

// The whole solve of S shards on one card in one cooperative launch: P the
// S shards' N_PTR pointers one after another, I their N_INT ints, ws_len
// their workspaces' bytes; warm 1 when every shard has a warm state.
int dtk_pdhgs_fused_f32(int S, void* const* P, const int* I, const double* D,
                        const long* ws_len, int warm, void* stream) {
  return launch_fused<float, false>(S, P, I, D, ws_len, warm, (cudaStream_t)stream);
}

int dtk_pdhgs_fused_f64(int S, void* const* P, const int* I, const double* D,
                        const long* ws_len, int warm, void* stream) {
  return launch_fused<double, false>(S, P, I, D, ws_len, warm, (cudaStream_t)stream);
}

// The same with a per-element A (each shard's slots as dtk_pdhgs_elem_*).
int dtk_pdhgs_elem_fused_f32(int S, void* const* P, const int* I, const double* D,
                             const long* ws_len, int warm, void* stream) {
  return launch_fused<float, true>(S, P, I, D, ws_len, warm, (cudaStream_t)stream);
}

int dtk_pdhgs_elem_fused_f64(int S, void* const* P, const int* I, const double* D,
                             const long* ws_len, int warm, void* stream) {
  return launch_fused<double, true>(S, P, I, D, ws_len, warm, (cudaStream_t)stream);
}

}  // extern "C"
