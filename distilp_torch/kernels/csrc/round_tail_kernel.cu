// R8: the tail of a branch-and-bound round, everything after the LP solve of
// a non-per-k round, in one cooperative launch on one card.
//
// Replaces the part of distilp_tpu/solver/backend_jax.py::_bnb_round after
// its LP call (:1577-1800) and its loop's condition ::_certified (:2704),
// which the TPU runs as one device program, and which the port ran as K2,
// some seventy torch operations (the incumbent argmin, the per-k
// scatter-min and the threshold, the children's concatenation, a stable
// argsort, the compaction's gathers, the spill minimum, the counters, the
// frozen lanes' selection), K3 and the loop's go test. For each lane:
//   1. rounding: K2's per-row rounding of each active beam row's LP point
//      (round_row.cuh), or, pre-rounded, the rows' (obj, w, n[, y]) as K2's
//      MoE mode or the node-sharded sweep's shards computed them;
//   2. the incumbent: obj_full = obj_lin + obj_const on active rows (+inf
//      elsewhere), its first-index argmin (a NaN wins, as torch.argmin's),
//      the improvement and the incumbent's w, n, y and k index;
//   3. each k's best (a NaN-propagating scatter-min) and the prune
//      threshold incumbent - mip_gap |incumbent| (+inf with no incumbent);
//   4. K3's per-row epilogue (epilogue_row.cuh, a warp a row);
//   5. the children (A rows, B rows, pass-through rows pruned against the
//      threshold) in the stable order of where(active, bound, inf), as
//      torch.argsort(stable=True) orders it: the key canonicalised (-0.0 as
//      0.0, every NaN one key above +inf) and ranked by counting over
//      (key, index) pairs in shared memory; the first cap rows kept, the
//      spilled live bounds' minimum folded into dropped_bound;
//   6. the go flag: any node active and no certificate, on the new state;
//   7. a frozen lane's state written through unchanged.
// Then, after one grid sync, every block copies the kept rows' boxes and
// warm iterates (lo, hi, v, y, z, f) into the new state, recomputing a beam
// child's box column by column from the row's epilogue scalars.
//
// The outputs are fresh memory: the loop keeps views of earlier states.
// Everything is a comparison, a selection, a copy or a float64 add, the
// threshold's and the certificate's products and differences rounded one
// by one (__dmul_rn, __dsub_rn; the file is built with --fmad=false for K2's
// and K3's arithmetic): bit for bit the plain version
// (solver/search.py::round_tail_reference).
//
// What bounds it on an H100: the copies. A lane's kept rows are cap x
// (5 nf + m) float32 read and written (the fleet's 128-device root: 64 x
// (5 x 1665 + 769) x 4 B = 2.3 MB each way); the decisions are small (B <= a
// few dozen beam rows, cap + B keys a lane, K2's O(M^2) scan a row). So the
// decisions run first, one block a lane (the rounding and the epilogue a
// warp a row), and the copies are spread over every block of the card, four
// independent loads in flight a thread. A cooperative launch with one grid
// sync (~1.1 us) was chosen over a thread-block cluster a lane: a cluster of
// at most 16 SMs could not spread one lane's copy over the card, and lanes
// (L up to 140) would not fit one cluster each at once.

#include <cooperative_groups.h>

#include <mutex>

#include "epilogue_row.cuh"
#include "round_row.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dtk;

#ifndef DTK_TAIL_THREADS
#define DTK_TAIL_THREADS 512
#endif
constexpr int TAIL_THREADS = DTK_TAIL_THREADS;
constexpr size_t SMEM_LIMIT = 232448;  // an H100 block's dynamic shared memory

struct TailParams {
  int L, B, cap, nf, m, M, n_k;
  int prerounded;   // 1: the rows arrive rounded (obj_lin, w_in, n_in, y_in)
  int has_y;        // MoE rows: y_in given, the incumbent's y follows it
  int iters_f32;    // iters_run is float32 (1) or int32 (0)
  int rd_lanes;     // rounding blocks in rd: one a lane (L) or one for all (1)
  int rd_stride;    // doubles from one lane's rounding block to the next
  int round_warps;  // warps of a block that round, 2M doubles of scratch each
  double mip_gap;
  // The LP result of the L*B beam rows, lane-major.
  const float* v;
  const double* reduced;
  const float* y_dual;
  const float* z_dual;
  const float* f_dual;
  const double* res_bound;
  const void* iters;
  // Dense rounding: (L, n_k) layers-per-segment and segments, packed blocks.
  const double* Ws;
  const double* ks;
  const double* rd;
  // Pre-rounded rows.
  const double* obj_lin;
  const double* w_in;
  const double* n_in;
  const double* y_in;
  // Per lane.
  const uint8_t* int_mask;
  const double* obj_const;
  const uint8_t* frozen;
  // The state (L, cap, ...).
  const float* lo;
  const float* hi;
  const int* kidx;
  const double* nbound;
  const uint8_t* active;
  const double* incumbent;
  const double* inc_w;
  const double* inc_n;
  const double* inc_y;
  const int* inc_kidx;
  const double* dropped;
  const double* pkb;
  const float* nv;
  const float* ny;
  const float* nz;
  const float* nfd;
  const uint8_t* nwarm;
  const double* st_iters;
  const double* st_rounds;
  // The new state and the go flags.
  float* o_lo;
  float* o_hi;
  int* o_kidx;
  double* o_bound;
  uint8_t* o_active;
  double* o_inc;
  double* o_inc_w;
  double* o_inc_n;
  double* o_inc_y;
  int* o_inc_kidx;
  double* o_dropped;
  double* o_pkb;
  float* o_v;
  float* o_y;
  float* o_z;
  float* o_f;
  uint8_t* o_warm;
  double* o_st_iters;
  double* o_st_rounds;
  uint8_t* o_go;
  // Workspace: the dense rounding's rows, each beam row's epilogue scalars,
  // each kept slot's source (< cap: that state row; cap + c: beam child c,
  // child A of row c for c < B, child B of row c - B after).
  double* ws_obj;
  double* ws_w;
  double* ws_n;
  double* ws_budget;
  float* ws_dn;
  int* ws_js;
  uint8_t* ws_act;
  int* ws_src;
};

// The pointers the host passes (dtk_round_tail): TailParams' 56 from v to
// o_go, then the workspace.
constexpr int N_PTRS = 57;

// torch.minimum: NaN-propagating; on ties the first operand.
__device__ __forceinline__ double t_min(double a, double b) {
  return (is_nan(a) || a <= b) ? a : b;
}

// The stable sort's key: ordered as torch.argsort orders doubles (-0.0 and
// 0.0 one key, every NaN one key above +inf).
__device__ __forceinline__ unsigned long long sort_key(double x) {
  if (x != x) return 0xffffffffffffffffull;
  if (x == 0.0) x = 0.0;
  const unsigned long long b = (unsigned long long)__double_as_longlong(x);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

// threshold = incumbent - mip_gap |incumbent|, +inf with no incumbent.
__device__ __forceinline__ double prune_threshold(double inc, double mip_gap) {
  return isfinite(inc) ? __dsub_rn(inc, __dmul_rn(mip_gap, fabs(inc))) : (double)INFINITY;
}

__device__ __forceinline__ double iters_at(const TailParams& p, size_t g) {
  return p.iters_f32 ? (double)((const float*)p.iters)[g] : (double)((const int*)p.iters)[g];
}

// One lane's decisions (block-wide): everything but the row copies.
__device__ void lane_phase(const TailParams& p, int l, unsigned char* smem) {
  __shared__ double s_red[32];
  __shared__ int s_best;
  const double inf = INFINITY;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const int B = p.B, cap = p.cap, nf = p.nf, M = p.M, n_k = p.n_k;
  const int total = cap + B;
  const size_t lc = (size_t)l * cap;  // the lane's first state row
  const size_t lb = (size_t)l * B;    // the lane's first beam (LP) row
  double* s_obj = (double*)smem;                                       // B
  double* s_cbnd = s_obj + B;                                          // total
  unsigned long long* s_key = (unsigned long long*)(s_cbnd + total);  // total
  double* s_scr = (double*)(s_key + total);                            // round scratch
  uint8_t* s_cact = (uint8_t*)(s_scr + (p.prerounded ? 0 : (size_t)p.round_warps * 2 * M));

  const bool frz = p.frozen != nullptr && p.frozen[l] != 0;
  const double inc_old = p.incumbent[l];
  const double oc = p.obj_const[l];
  bool better = false;
  int best_i = 0;
  double inc_new = inc_old;

  if (!frz) {
    // 1. The dense rounding of the active beam rows (a warp a row).
    if (!p.prerounded) {
      const double* rd = p.rd + (p.rd_lanes > 1 ? (size_t)l * p.rd_stride : 0);
      if (wid < p.round_warps) {
        double* w = s_scr + (size_t)wid * 2 * M;
        for (int r = wid; r < B; r += p.round_warps) {
          if (p.active[lc + r] == 0) continue;
          const size_t g = lb + r;
          const int k = p.kidx[lc + r];
          round_row(p.v + g * nf, p.Ws[(size_t)l * n_k + k], p.ks[(size_t)l * n_k + k], rd,
                    M, w, w + M, p.ws_obj + g, p.ws_w + g * M, p.ws_n + g * M);
        }
      }
      __syncthreads();
    }
    // 2. obj_full, and 3. the incumbent's row (warp 0).
    for (int r = tid; r < B; r += nt) {
      const size_t g = lb + r;
      s_obj[r] = p.active[lc + r] != 0
                     ? (p.prerounded ? p.obj_lin[g] : p.ws_obj[g]) + oc
                     : inf;
    }
    __syncthreads();
    if (wid == 0) {
      double bv = inf;
      int bi = INT_MAX;
      for (int r = lane; r < B; r += 32) argmin_combine(bv, bi, s_obj[r], r);
      for (int o = 16; o > 0; o >>= 1) {
        const double v2 = __shfl_xor_sync(FULL, bv, o);
        const int i2 = __shfl_xor_sync(FULL, bi, o);
        argmin_combine(bv, bi, v2, i2);
      }
      if (lane == 0) s_best = bi == INT_MAX ? 0 : bi;
    }
    __syncthreads();
    best_i = s_best;
    const double best_obj = s_obj[best_i];
    better = best_obj < inc_old;
    inc_new = better ? best_obj : inc_old;
  }
  const double thr = prune_threshold(inc_new, p.mip_gap);

  // The incumbent's vectors and each k's best (a frozen lane's copied).
  for (int j = tid; j < M; j += nt) {
    const size_t o = (size_t)l * M + j;
    const size_t src = (lb + best_i) * M + j;
    p.o_inc_w[o] = better ? (p.prerounded ? p.w_in[src] : p.ws_w[src]) : p.inc_w[o];
    p.o_inc_n[o] = better ? (p.prerounded ? p.n_in[src] : p.ws_n[src]) : p.inc_n[o];
    p.o_inc_y[o] = (better && p.has_y) ? p.y_in[src] : p.inc_y[o];
  }
  for (int k = tid; k < n_k; k += nt) {
    double rb = inf;
    if (!frz) {
      for (int r = 0; r < B; ++r) {
        if (p.kidx[lc + r] == k) rb = nan_min(rb, s_obj[r]);
      }
    }
    const size_t o = (size_t)l * n_k + k;
    p.o_pkb[o] = frz ? p.pkb[o] : t_min(p.pkb[o], rb);
  }

  double live = inf, spill = inf;
  bool any = false;
  if (!frz) {
    // 4. K3's epilogue, a warp a row; its scalars for the copy phase.
    for (int r = wid; r < B; r += nw) {
      const size_t g = lb + r;
      const size_t sr = lc + r;
      const bool act = p.active[sr] != 0;
      const EpiRow e = epi_row(WarpGroup{}, nf, p.lo + sr * nf, p.hi + sr * nf, p.v + g * nf,
                               p.reduced + g * nf, p.int_mask + (size_t)l * nf,
                               p.res_bound[g], oc, act, p.nbound[sr], thr, s_obj[r]);
      if (lane == 0) {
        p.ws_budget[g] = e.budget;
        p.ws_dn[g] = e.dn;
        p.ws_js[g] = e.js;
        p.ws_act[g] = act ? 1 : 0;
        s_cbnd[r] = s_cbnd[B + r] = e.bound;
        s_cact[r] = s_cact[B + r] = e.survive ? 1 : 0;
      }
    }
    // 5. The pass-through rows, pruned against the new threshold.
    for (int i = tid; i < cap - B; i += nt) {
      const size_t sr = lc + B + i;
      const double bnd = p.nbound[sr];
      s_cbnd[2 * B + i] = bnd;
      s_cact[2 * B + i] = (p.active[sr] != 0 && bnd < thr) ? 1 : 0;
    }
    __syncthreads();
    for (int c = tid; c < total; c += nt) s_key[c] = sort_key(s_cact[c] ? s_cbnd[c] : inf);
    __syncthreads();
    // The stable best-bound-first order: child c's place is the number of
    // children before it in (key, index) order.
    for (int c = tid; c < total; c += nt) {
      const unsigned long long kc = s_key[c];
      int rank = 0;
      for (int d = 0; d < total; ++d) {
        const unsigned long long kd = s_key[d];
        rank += (kd < kc || (kd == kc && d < c)) ? 1 : 0;
      }
      const double val = s_cact[c] ? s_cbnd[c] : inf;
      if (rank >= cap) {
        spill = nan_min(spill, val);
        continue;
      }
      const size_t o = lc + rank;
      int src, kx;
      bool warm;
      if (c < 2 * B) {
        const int r = c < B ? c : c - B;
        src = cap + c;
        kx = p.kidx[lc + r];
        warm = p.active[lc + r] != 0 || p.nwarm[lc + r] != 0;
      } else {
        const int i = B + (c - 2 * B);
        src = i;
        kx = p.kidx[lc + i];
        warm = p.nwarm[lc + i] != 0;
      }
      p.ws_src[o] = src;
      p.o_kidx[o] = kx;
      p.o_bound[o] = s_cbnd[c];
      p.o_active[o] = s_cact[c];
      p.o_warm[o] = warm ? 1 : 0;
      live = nan_min(live, val);
      any = any || s_cact[c] != 0;
    }
  } else {
    // 7. A frozen lane: every row where it was.
    for (int c = tid; c < cap; c += nt) {
      const size_t o = lc + c;
      const bool act = p.active[o] != 0;
      p.ws_src[o] = c;
      p.o_kidx[o] = p.kidx[o];
      p.o_bound[o] = p.nbound[o];
      p.o_active[o] = act ? 1 : 0;
      p.o_warm[o] = p.nwarm[o];
      live = nan_min(live, act ? p.nbound[o] : inf);
      any = any || act;
    }
  }
  any = __syncthreads_or(any) != 0;
  live = block_reduce(live, Min(), s_red);
  spill = block_reduce(spill, Min(), s_red);

  // 6. The lane's scalars and its go flag on the new state.
  if (tid == 0) {
    const double dropped = frz ? p.dropped[l] : t_min(p.dropped[l], spill);
    const double bb = t_min(live, dropped);
    const bool cert = isfinite(inc_new) &&
                      __dsub_rn(inc_new, bb) <= __dmul_rn(p.mip_gap, fabs(inc_new));
    double iters = 0.0;
    if (!frz) {
      for (int r = 0; r < B; ++r) iters += iters_at(p, lb + r);
    }
    p.o_inc[l] = inc_new;
    p.o_inc_kidx[l] = better ? p.kidx[lc + best_i] : p.inc_kidx[l];
    p.o_dropped[l] = dropped;
    p.o_st_iters[l] = frz ? p.st_iters[l] : p.st_iters[l] + iters;
    p.o_st_rounds[l] = frz ? p.st_rounds[l] : p.st_rounds[l] + 1.0;
    p.o_go[l] = (any && !cert) ? 1 : 0;
  }
  __syncthreads();
}

// A kept row's (lo, hi) at column j from its source.
__device__ __forceinline__ void box_at(const TailParams& p, unsigned l, int src, unsigned j,
                                       float& lo, float& hi) {
  const unsigned cap = p.cap, nf = p.nf, B = p.B;
  if (src < (int)cap) {
    const size_t o = ((size_t)l * cap + src) * nf + j;
    lo = p.lo[o];
    hi = p.hi[o];
    return;
  }
  const unsigned c = src - cap;
  const unsigned r = c < B ? c : c - B;
  const size_t g = (size_t)l * B + r;
  const size_t so = ((size_t)l * cap + r) * nf + j;
  EpiRow e;
  e.budget = p.ws_budget[g];
  e.dn = p.ws_dn[g];
  e.js = p.ws_js[g];
  float lo2, hi2, ha, lb;
  epi_tighten(p.lo[so], p.hi[so], p.reduced[g * nf + j], p.int_mask[(size_t)l * nf + j] != 0,
              e.budget, lo2, hi2);
  epi_split(e, (int)j, lo2, hi2, ha, lb);
  lo = c < B ? lo2 : lb;
  hi = c < B ? ha : hi2;
}

// A kept row's warm iterate at column j: the LP's for a solved beam row,
// else what its source carried.
__device__ __forceinline__ float carry_at(const TailParams& p, unsigned l, int src, unsigned j,
                                          unsigned W, const float* res, const float* old) {
  const unsigned cap = p.cap, B = p.B;
  if (src < (int)cap) return old[((size_t)l * cap + src) * W + j];
  const unsigned c = src - cap;
  const unsigned r = c < B ? c : c - B;
  const size_t g = (size_t)l * B + r;
  return p.ws_act[g] ? res[g * W + j] : old[((size_t)l * cap + r) * W + j];
}

constexpr int ILP = 4;

// Every block: the kept rows' (lo, hi) and warm iterates, element by
// element over the whole card, ILP elements in flight a thread.
__device__ void copy_phase(const TailParams& p) {
  const unsigned gt = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned gs = gridDim.x * blockDim.x;
  const unsigned cap = p.cap, nf = p.nf;
  {
    const unsigned total = (unsigned)p.L * cap * nf;
    for (unsigned base = gt; base < total; base += ILP * gs) {
      float lo[ILP], hi[ILP];
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const unsigned e = base + u * gs;
        if (e < total) {
          const unsigned slot = e / nf, j = e - slot * nf;
          box_at(p, slot / cap, p.ws_src[slot], j, lo[u], hi[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const unsigned e = base + u * gs;
        if (e < total) {
          p.o_lo[e] = lo[u];
          p.o_hi[e] = hi[u];
        }
      }
    }
  }
  const float* res[4] = {p.v, p.z_dual, p.f_dual, p.y_dual};
  const float* old[4] = {p.nv, p.nz, p.nfd, p.ny};
  float* out[4] = {p.o_v, p.o_z, p.o_f, p.o_y};
#pragma unroll 1
  for (int f = 0; f < 4; ++f) {
    const unsigned W = f == 3 ? (unsigned)p.m : nf;
    const unsigned total = (unsigned)p.L * cap * W;
    for (unsigned base = gt; base < total; base += ILP * gs) {
      float x[ILP];
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const unsigned e = base + u * gs;
        if (e < total) {
          const unsigned slot = e / W, j = e - slot * W;
          x[u] = carry_at(p, slot / cap, p.ws_src[slot], j, W, res[f], old[f]);
        }
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const unsigned e = base + u * gs;
        if (e < total) out[f][e] = x[u];
      }
    }
  }
}

__global__ void __launch_bounds__(TAIL_THREADS, 1)
    round_tail_kernel(const __grid_constant__ TailParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int l = blockIdx.x; l < p.L; l += gridDim.x) lane_phase(p, l, smem);
  cg::this_grid().sync();
  copy_phase(p);
}

// Dynamic shared memory of a block with `round_warps` rounding warps.
size_t smem_bytes(int B, int cap, int M, int prerounded, int round_warps) {
  const size_t total = (size_t)cap + B;
  size_t bytes = sizeof(double) * (size_t)B + (sizeof(double) + 8) * total + total;
  if (!prerounded) bytes += sizeof(double) * 2 * (size_t)M * round_warps;
  return bytes;
}

}  // namespace

extern "C" {

// The least dynamic shared memory a block needs (one rounding warp): the
// wrapper refuses a shape past the card's limit before it launches.
long dtk_round_tail_smem_bytes(int B, int cap, int M, int prerounded) {
  return (long)smem_bytes(B, cap, M, prerounded, 1);
}

// Bytes of the workspace (the wrapper allocates it after the new state).
long dtk_round_tail_ws_bytes(int L, int B, int cap, int M) {
  const size_t rows = (size_t)L * B;
  return (long)(rows * (sizeof(double) * (2 + 2 * (size_t)M) + sizeof(float) + sizeof(int) + 1) +
                (size_t)L * cap * sizeof(int) + 64);
}

// dims: L, B, cap, nf, m, M, n_k, prerounded, has_y, iters_f32, rd_lanes,
// rd_stride;
// ptrs: N_PTRS pointers in TailParams' order (ws_* carved here from the last).
int dtk_round_tail(const long long* ptrs, const int* dims, double mip_gap, void* stream) {
  TailParams p;
  p.L = dims[0];
  p.B = dims[1];
  p.cap = dims[2];
  p.nf = dims[3];
  p.m = dims[4];
  p.M = dims[5];
  p.n_k = dims[6];
  p.prerounded = dims[7];
  p.has_y = dims[8];
  p.iters_f32 = dims[9];
  p.rd_lanes = dims[10];
  p.rd_stride = dims[11];
  p.mip_gap = mip_gap;
  if (p.L <= 0 || p.B <= 0 || p.B > p.cap || p.M <= 0) return (int)cudaErrorInvalidValue;
  const void** slots[] = {
      (const void**)&p.v, (const void**)&p.reduced, (const void**)&p.y_dual,
      (const void**)&p.z_dual, (const void**)&p.f_dual, (const void**)&p.res_bound,
      (const void**)&p.iters, (const void**)&p.Ws, (const void**)&p.ks, (const void**)&p.rd,
      (const void**)&p.obj_lin, (const void**)&p.w_in, (const void**)&p.n_in,
      (const void**)&p.y_in, (const void**)&p.int_mask, (const void**)&p.obj_const,
      (const void**)&p.frozen, (const void**)&p.lo, (const void**)&p.hi,
      (const void**)&p.kidx, (const void**)&p.nbound, (const void**)&p.active,
      (const void**)&p.incumbent, (const void**)&p.inc_w, (const void**)&p.inc_n,
      (const void**)&p.inc_y, (const void**)&p.inc_kidx, (const void**)&p.dropped,
      (const void**)&p.pkb, (const void**)&p.nv, (const void**)&p.ny, (const void**)&p.nz,
      (const void**)&p.nfd, (const void**)&p.nwarm, (const void**)&p.st_iters,
      (const void**)&p.st_rounds, (const void**)&p.o_lo, (const void**)&p.o_hi,
      (const void**)&p.o_kidx, (const void**)&p.o_bound, (const void**)&p.o_active,
      (const void**)&p.o_inc, (const void**)&p.o_inc_w, (const void**)&p.o_inc_n,
      (const void**)&p.o_inc_y, (const void**)&p.o_inc_kidx, (const void**)&p.o_dropped,
      (const void**)&p.o_pkb, (const void**)&p.o_v, (const void**)&p.o_y, (const void**)&p.o_z,
      (const void**)&p.o_f, (const void**)&p.o_warm, (const void**)&p.o_st_iters,
      (const void**)&p.o_st_rounds, (const void**)&p.o_go};
  constexpr int n_slots = sizeof(slots) / sizeof(slots[0]);
  static_assert(n_slots + 1 == N_PTRS, "pointer table out of step");
  for (int i = 0; i < n_slots; ++i) *slots[i] = (const void*)ptrs[i];
  // The workspace, carved in dtk_round_tail_ws_bytes' order.
  unsigned char* ws = (unsigned char*)ptrs[n_slots];
  const size_t rows = (size_t)p.L * p.B;
  p.ws_obj = (double*)ws;
  p.ws_w = p.ws_obj + rows;
  p.ws_n = p.ws_w + rows * p.M;
  p.ws_budget = p.ws_n + rows * p.M;
  p.ws_dn = (float*)(p.ws_budget + rows);
  p.ws_js = (int*)(p.ws_dn + rows);
  p.ws_src = p.ws_js + rows;
  p.ws_act = (uint8_t*)(p.ws_src + (size_t)p.L * p.cap);

  // The card's SM count and the grid each shared-memory size allows, asked
  // once a device and size (the runtime's queries cost microseconds a call).
  static std::mutex mu;
  static int cached_dev = -1, sms = 0, set_smem = -1, occ_smem = -1, per_sm = 0;
  std::lock_guard<std::mutex> hold(mu);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != cached_dev) {
    int coop = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    cached_dev = dev;
    set_smem = occ_smem = -1;
  }
  // As many rounding warps as the block's shared memory holds, up to its
  // warps and the beam.
  const int nw = TAIL_THREADS / 32;
  int rw = p.prerounded ? 0 : (p.B < nw ? p.B : nw);
  while (rw > 1 && smem_bytes(p.B, p.cap, p.M, p.prerounded, rw) > SMEM_LIMIT) --rw;
  p.round_warps = rw;
  const size_t sm = smem_bytes(p.B, p.cap, p.M, p.prerounded, rw);
  if (sm > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if ((int)sm > set_smem) {
    err = cudaFuncSetAttribute(round_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sm);
    if (err != cudaSuccess) return (int)err;
    set_smem = (int)sm;
  }
  if ((int)sm != occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, round_tail_kernel,
                                                        TAIL_THREADS, sm);
    if (err != cudaSuccess) return (int)err;
    occ_smem = (int)sm;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = per_sm * sms;
  void* args[] = {(void*)&p};
  err = cudaLaunchCooperativeKernel((const void*)round_tail_kernel, dim3(grid),
                                    dim3(TAIL_THREADS), args, sm, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
