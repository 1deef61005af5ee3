// R8: the tail of a branch-and-bound round, everything after its LP solve,
// in one cooperative launch on one card; a per-k round (dims' per_k) as well
// as a round that prunes against one incumbent.
//
// Replaces the part of distilp_tpu/solver/backend_jax.py::_bnb_round after
// its LP call (:1577-1800; with per_k=True also :1597-1627, :1699-1702,
// :1728-1774) and its loop's condition ::_certified (:2704), or in per-k
// mode ::_certified_per_k (:2721) with ::_per_k_bound (:2709), which the TPU
// runs as one device program, and which the port ran as K2, some seventy
// torch operations (the incumbent argmin, the per-k scatter-min and the
// threshold, the children's concatenation, a stable argsort, the
// compaction's gathers, the spill minimum, the counters, the frozen lanes'
// selection), K3 and the loop's go test; a per-k round besides B15's two
// launches, a second argsort and the per-k certificate. For each lane:
//   1. rounding: K2's per-row rounding of each active beam row's LP point
//      (round_row.cuh), or, pre-rounded, the rows' (obj, w, n[, y]) as K2's
//      MoE mode or the node-sharded sweep's shards computed them;
//   2. the incumbent: obj_full = obj_lin + obj_const on active rows (+inf
//      elsewhere), its first-index argmin (a NaN wins, as torch.argmin's),
//      the improvement and the incumbent's w, n, y and k index;
//   3. each k's best (a NaN-propagating scatter-min) and the prune
//      threshold incumbent - mip_gap |incumbent| (+inf with no incumbent);
//      per-k mode: each k's threshold from its own best, and each improved
//      k's w, n, y from its best row (B15's incumbent body, per_k_row.cuh);
//   4. K3's per-row epilogue (epilogue_row.cuh, a warp a row), each row
//      against the threshold (per-k mode: its own k's);
//   5. the children (A rows, B rows, pass-through rows pruned against the
//      threshold) in the stable order of where(active, bound, inf), as
//      torch.argsort(stable=True) orders it: the key canonicalised (-0.0 as
//      0.0, every NaN one key above +inf) and ranked by counting over
//      (key, index) pairs in shared memory. Per-k mode re-ranks that order
//      k-fairly (B15's rank): each active row's rank g among its k's active
//      rows in it (pk_ranks), then its place in the order of the fair key
//      g (total + 1) + position, which is sum_k min(cnt_k, g) plus the
//      rank-g rows of other k's placed before it in the first order (a
//      table of each k's rows by rank); an inactive row's place is after
//      every active row, by position. The first cap rows are kept, the
//      spilled live bounds' minimum folded into dropped_bound (per-k mode:
//      and per k into per_k_dropped);
//   6. the go flag: any node active and no certificate, on the new state
//      (per-k mode: some k not settled, each k's bound the minimum of its
//      live bounds and its overflow floor);
//   7. a frozen lane's state written through unchanged.
// Then, after one grid sync, every block copies the kept rows' boxes and
// warm iterates (lo, hi, v, y, z, f) into the new state, recomputing a beam
// child's box column by column from the row's epilogue scalars.
//
// The outputs are fresh memory: the loop keeps views of earlier states (the
// per-k fields too in per-k mode; the other mode passes them through).
// Everything is a comparison, a selection, a copy, a count or a float64
// add, the thresholds' and the certificates' products and differences
// rounded one by one (__dmul_rn, __dsub_rn; the file is built with
// --fmad=false for K2's and K3's arithmetic): bit for bit the plain version
// (solver/search.py::round_tail_reference).
//
// What bounds it on an H100: the copies. A lane's kept rows are cap x
// (5 nf + m) float32 read and written (the fleet's 128-device root: 64 x
// (5 x 1665 + 769) x 4 B = 2.3 MB each way); the decisions are small on
// the paths (B <= 36 beam rows, cap + B <= 324 keys a lane, K2's O(M^2) scan
// a row). So the decisions run first, one block a lane (the rounding and the
// epilogue a warp a row, per-k folds a warp a k; the order an O(keys^2)
// count, cheaper than a sorting network's barriers at these sizes, though
// not at ~1000 keys a lane), and the copies are spread over every block of
// the card, four independent loads in flight a thread. A
// cooperative launch with one grid sync (~1.1 us) was chosen over a
// thread-block cluster a lane: a cluster of at most 16 SMs could not spread
// one lane's copy over the card, and lanes (L up to 140) would not fit one
// cluster each at once.

#include <cooperative_groups.h>

#include <mutex>

#include "epilogue_row.cuh"
#include "per_k_row.cuh"
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
  int per_k;        // 1: every node prunes against its own k's incumbent
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
  // Per-k mode: the per-k assignments and overflow floors (L, n_k[, M]) and
  // their new values (not read or written in the other mode).
  const double* pkw;
  const double* pkn;
  const double* pky;
  const double* pkd;
  double* o_pkw;
  double* o_pkn;
  double* o_pky;
  double* o_pkd;
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

// The pointers the host passes (dtk_round_tail): TailParams' 36 inputs from
// v to st_rounds, the per-k mode's 4 (pkw to pkd), the 20 outputs from o_lo
// to o_go and its 4 (o_pkw to o_pkd), then the workspace.
constexpr int N_PTRS = 65;

// The stable sort's key: ordered as torch.argsort orders doubles (-0.0 and
// 0.0 one key, every NaN one key above +inf).
__device__ __forceinline__ unsigned long long sort_key(double x) {
  if (x != x) return 0xffffffffffffffffull;
  if (x == 0.0) x = 0.0;
  const unsigned long long b = (unsigned long long)__double_as_longlong(x);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double iters_at(const TailParams& p, size_t g) {
  return p.iters_f32 ? (double)((const float*)p.iters)[g] : (double)((const int*)p.iters)[g];
}

// A lane's shared memory (dynamic), carved in the order below; the per-k
// arrays take no room in the other mode.
struct LaneSmem {
  double* obj;              // B: the beam rows' obj_full
  double* cbnd;             // total: the children's bounds
  unsigned long long* key;  // total: their sort keys
  double* scr;              // round_warps x 2M: the dense rounding's scratch
  double* thr;              // n_k (per-k): each k's prune threshold
  double* best;             // n_k (per-k): each k's new best
  int* ck;                  // total: the children's k
  int* pos;                 // total: their places in the new order (>= cap: spilled)
  int* r1;                  // total (per-k): their places in the first order
  int* ord;                 // total (per-k): the first order
  int* g;                   // total (per-k): each child's rank in its group
  int* tab;                 // total (per-k): each k's active rows' first places by rank
  int* run;                 // n_k + 1 (per-k): each group's count (inactive rows last)
  int* off;                 // n_k + 1 (per-k): each k's first entry of tab
  int* wc;                  // warps x (n_k + 1) (per-k): pk_ranks' tile counts
  uint8_t* cact;            // total: the children's active flags
  uint8_t* imp;             // n_k (per-k): the round improved the k's incumbent
};

__host__ __device__ inline size_t bump(size_t& at, size_t bytes) {
  const size_t o = at;
  at += bytes;
  return o;
}

// The bytes of a lane's shared memory; with `base`, its arrays in `s`.
__host__ __device__ inline size_t lane_smem(int B, int cap, int M, int prerounded,
                                            int round_warps, int n_k, int per_k, int warps,
                                            unsigned char* base = nullptr,
                                            LaneSmem* s = nullptr) {
  const size_t total = (size_t)cap + B;
  const size_t nk = per_k ? (size_t)n_k : 0;
  const size_t tk = per_k ? total : 0;
  const size_t gk = per_k ? (size_t)n_k + 1 : 0;
  size_t at = 0;
  const size_t o_obj = bump(at, 8 * (size_t)B), o_cbnd = bump(at, 8 * total),
               o_key = bump(at, 8 * total),
               o_scr = bump(at, prerounded ? 0 : 16 * (size_t)M * round_warps),
               o_thr = bump(at, 8 * nk), o_best = bump(at, 8 * nk), o_ck = bump(at, 4 * total),
               o_pos = bump(at, 4 * total), o_r1 = bump(at, 4 * tk), o_ord = bump(at, 4 * tk),
               o_g = bump(at, 4 * tk), o_tab = bump(at, 4 * tk), o_run = bump(at, 4 * gk),
               o_off = bump(at, 4 * gk), o_wc = bump(at, 4 * gk * warps),
               o_cact = bump(at, total), o_imp = bump(at, nk);
  if (s != nullptr) {
    s->obj = (double*)(base + o_obj);
    s->cbnd = (double*)(base + o_cbnd);
    s->key = (unsigned long long*)(base + o_key);
    s->scr = (double*)(base + o_scr);
    s->thr = (double*)(base + o_thr);
    s->best = (double*)(base + o_best);
    s->ck = (int*)(base + o_ck);
    s->pos = (int*)(base + o_pos);
    s->r1 = (int*)(base + o_r1);
    s->ord = (int*)(base + o_ord);
    s->g = (int*)(base + o_g);
    s->tab = (int*)(base + o_tab);
    s->run = (int*)(base + o_run);
    s->off = (int*)(base + o_off);
    s->wc = (int*)(base + o_wc);
    s->cact = base + o_cact;
    s->imp = base + o_imp;
  }
  return at;
}

// Per-k mode: the k-fair order of the children (B15's rank; block-wide,
// every thread calls). From each child's place in the first order (s.r1):
// its rank g among its k's active children in that order (pk_ranks over
// n_k + 1 groups, the inactive children the last), then its place in the
// order of the fair key (active ? g : total) (total + 1) + first place: an
// active child follows every active child of a lower rank (sum_q
// min(cnt_q, g)) and the rank-g children of other k's before it in the
// first order (tab lists each k's children by rank); an inactive child
// follows every active one, in first order.
__device__ void fair_places(const LaneSmem& s, int total, int n_k) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const auto group = [&](int c) {
    const int k = s.ck[c];
    return (s.cact[c] != 0 && k >= 0 && k < n_k) ? k : n_k;
  };
  for (int c = tid; c < total; c += nt) s.ord[s.r1[c]] = c;
  __syncthreads();
  pk_ranks(
      total, n_k + 1, s.run, s.wc, [&](int q) { return group(s.ord[q]); },
      [&](int q, int, int rank) { s.g[s.ord[q]] = rank; });
  if (tid == 0) {
    int off = 0;
    for (int k = 0; k < n_k; ++k) {
      s.off[k] = off;
      off += s.run[k];
    }
    s.off[n_k] = off;
  }
  __syncthreads();
  for (int c = tid; c < total; c += nt) {
    const int k = group(c);
    if (k < n_k) s.tab[s.off[k] + s.g[c]] = s.r1[c];
  }
  __syncthreads();
  const int n_active = s.off[n_k];
  for (int c = tid; c < total; c += nt) {
    const int g = s.g[c];
    int place = n_active + g;
    if (group(c) < n_k) {
      const int r1 = s.r1[c];
      place = 0;
      for (int q = 0; q < n_k; ++q) {
        const int cnt = s.run[q];
        place += min(cnt, g) + ((cnt > g && s.tab[s.off[q] + g] < r1) ? 1 : 0);
      }
    }
    s.pos[c] = place;
  }
  __syncthreads();
}

// One lane's decisions (block-wide): everything but the row copies.
__device__ void lane_phase(const TailParams& p, int l, unsigned char* smem) {
  __shared__ double s_red[32];
  __shared__ int s_best;
  __shared__ int s_open;
  const double inf = INFINITY;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const int B = p.B, cap = p.cap, nf = p.nf, M = p.M, n_k = p.n_k;
  const int total = cap + B;
  const bool per_k = p.per_k != 0;
  const size_t lc = (size_t)l * cap;  // the lane's first state row
  const size_t lb = (size_t)l * B;    // the lane's first beam (LP) row
  const size_t lk = (size_t)l * n_k;  // the lane's first k
  LaneSmem s;
  lane_smem(B, cap, M, p.prerounded, p.round_warps, n_k, p.per_k, nw, smem, &s);

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
        double* w = s.scr + (size_t)wid * 2 * M;
        for (int r = wid; r < B; r += p.round_warps) {
          if (p.active[lc + r] == 0) continue;
          const size_t g = lb + r;
          const int k = p.kidx[lc + r];
          round_row(p.v + g * nf, p.Ws[lk + k], p.ks[lk + k], rd, M, w, w + M, p.ws_obj + g,
                    p.ws_w + g * M, p.ws_n + g * M);
        }
      }
      __syncthreads();
    }
    // 2. obj_full, and 3. the incumbent's row (warp 0).
    for (int r = tid; r < B; r += nt) {
      const size_t g = lb + r;
      s.obj[r] = p.active[lc + r] != 0
                     ? (p.prerounded ? p.obj_lin[g] : p.ws_obj[g]) + oc
                     : inf;
    }
    __syncthreads();
    if (wid == 0) {
      double bv = inf;
      int bi = INT_MAX;
      for (int r = lane; r < B; r += 32) argmin_combine(bv, bi, s.obj[r], r);
      for (int o = 16; o > 0; o >>= 1) {
        const double v2 = __shfl_xor_sync(FULL, bv, o);
        const int i2 = __shfl_xor_sync(FULL, bi, o);
        argmin_combine(bv, bi, v2, i2);
      }
      if (lane == 0) s_best = bi == INT_MAX ? 0 : bi;
    }
    __syncthreads();
    best_i = s_best;
    const double best_obj = s.obj[best_i];
    better = best_obj < inc_old;
    inc_new = better ? best_obj : inc_old;
  }
  const double thr = prune_threshold(inc_new, p.mip_gap);
  const double* w_rows = p.prerounded ? p.w_in : p.ws_w;
  const double* n_rows = p.prerounded ? p.n_in : p.ws_n;

  // The incumbent's vectors and each k's best (a frozen lane's copied).
  for (int j = tid; j < M; j += nt) {
    const size_t o = (size_t)l * M + j;
    const size_t src = (lb + best_i) * M + j;
    p.o_inc_w[o] = better ? w_rows[src] : p.inc_w[o];
    p.o_inc_n[o] = better ? n_rows[src] : p.inc_n[o];
    p.o_inc_y[o] = (better && p.has_y) ? p.y_in[src] : p.inc_y[o];
  }
  for (int k = tid; k < n_k; k += nt) {
    double rb = inf;
    if (!frz) {
      for (int r = 0; r < B; ++r) {
        if (p.kidx[lc + r] == k) rb = nan_min(rb, s.obj[r]);
      }
    }
    const size_t o = lk + k;
    const double best = frz ? p.pkb[o] : t_min(p.pkb[o], rb);
    p.o_pkb[o] = best;
    if (per_k) {
      s.best[k] = best;
      s.thr[k] = prune_threshold(best, p.mip_gap);
      s.imp[k] = (!frz && rb < p.pkb[o]) ? 1 : 0;
    }
  }
  if (per_k) {
    // Each improved k's assignment from its best row (a warp a k).
    __syncthreads();
    for (int k = wid; k < n_k; k += nw) {
      const bool imp = s.imp[k] != 0;
      double v;
      int rs = INT_MAX;
      if (imp) pk_best_row(B, k, p.kidx + lc, s.obj, v, rs);
      const size_t src = (lb + (rs == INT_MAX ? 0 : rs)) * M;
      const size_t o = (lk + k) * M;
      pk_take_row(M, imp, w_rows + src, n_rows + src, p.has_y ? p.y_in + src : nullptr,
                  p.pkw + o, p.pkn + o, p.pky + o, p.o_pkw + o, p.o_pkn + o, p.o_pky + o);
    }
  }

  double live = inf, spill = inf;
  bool any = false;
  if (!frz) {
    // 4. K3's epilogue, a warp a row; its scalars for the copy phase.
    for (int r = wid; r < B; r += nw) {
      const size_t g = lb + r;
      const size_t sr = lc + r;
      const bool act = p.active[sr] != 0;
      const int kx = p.kidx[sr];
      const EpiRow e = epi_row(WarpGroup{}, nf, p.lo + sr * nf, p.hi + sr * nf, p.v + g * nf,
                               p.reduced + g * nf, p.int_mask + (size_t)l * nf,
                               p.res_bound[g], oc, act, p.nbound[sr], per_k ? s.thr[kx] : thr,
                               s.obj[r]);
      if (lane == 0) {
        p.ws_budget[g] = e.budget;
        p.ws_dn[g] = e.dn;
        p.ws_js[g] = e.js;
        p.ws_act[g] = act ? 1 : 0;
        s.cbnd[r] = s.cbnd[B + r] = e.bound;
        s.cact[r] = s.cact[B + r] = e.survive ? 1 : 0;
        s.ck[r] = s.ck[B + r] = kx;
      }
    }
    // 5. The pass-through rows, pruned against the new threshold.
    for (int i = tid; i < cap - B; i += nt) {
      const size_t sr = lc + B + i;
      const double bnd = p.nbound[sr];
      const int kx = p.kidx[sr];
      s.cbnd[2 * B + i] = bnd;
      s.cact[2 * B + i] = (p.active[sr] != 0 && bnd < (per_k ? s.thr[kx] : thr)) ? 1 : 0;
      s.ck[2 * B + i] = kx;
    }
    __syncthreads();
    for (int c = tid; c < total; c += nt) s.key[c] = sort_key(s.cact[c] ? s.cbnd[c] : inf);
    __syncthreads();
    // The stable best-bound-first order: child c's place is the number of
    // children before it in (key, index) order; per-k mode re-ranks it.
    int* first = per_k ? s.r1 : s.pos;
    for (int c = tid; c < total; c += nt) {
      const unsigned long long kc = s.key[c];
      int rank = 0;
      for (int d = 0; d < total; ++d) {
        const unsigned long long kd = s.key[d];
        rank += (kd < kc || (kd == kc && d < c)) ? 1 : 0;
      }
      first[c] = rank;
    }
    __syncthreads();
    if (per_k) fair_places(s, total, n_k);
    for (int c = tid; c < total; c += nt) {
      const int rank = s.pos[c];
      const double val = s.cact[c] ? s.cbnd[c] : inf;
      if (rank >= cap) {
        spill = nan_min(spill, val);
        continue;
      }
      const size_t o = lc + rank;
      int src;
      bool warm;
      if (c < 2 * B) {
        const int r = c < B ? c : c - B;
        src = cap + c;
        warm = p.active[lc + r] != 0 || p.nwarm[lc + r] != 0;
      } else {
        const int i = B + (c - 2 * B);
        src = i;
        warm = p.nwarm[lc + i] != 0;
      }
      p.ws_src[o] = src;
      p.o_kidx[o] = s.ck[c];
      p.o_bound[o] = s.cbnd[c];
      p.o_active[o] = s.cact[c];
      p.o_warm[o] = warm ? 1 : 0;
      live = nan_min(live, val);
      any = any || s.cact[c] != 0;
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

  if (per_k) {
    // 6, per k (a warp a k): the overflow floor of its spilled live bounds,
    // its bound (its live bounds' minimum and the floor) and whether it is
    // settled: its gap closed, or its bound +inf.
    if (tid == 0) s_open = 0;
    __syncthreads();
    for (int k = wid; k < n_k; k += nw) {
      double lv = inf, sp = inf;
      if (!frz) {
        for (int c = lane; c < total; c += 32) {
          if (s.ck[c] != k) continue;
          const double val = s.cact[c] ? s.cbnd[c] : inf;
          if (s.pos[c] < cap) {
            lv = nan_min(lv, val);
          } else {
            sp = nan_min(sp, val);
          }
        }
      } else {
        for (int c = lane; c < cap; c += 32) {
          if (p.kidx[lc + c] == k) lv = nan_min(lv, p.active[lc + c] ? p.nbound[lc + c] : inf);
        }
      }
      lv = warp_reduce(lv, Min());
      sp = warp_reduce(sp, Min());
      if (lane == 0) {
        const size_t o = lk + k;
        const double floor_k = frz ? p.pkd[o] : t_min(p.pkd[o], sp);
        const double bound_k = t_min(lv, floor_k);
        const double inc_k = s.best[k];
        const bool done = isfinite(inc_k) &&
                          __dsub_rn(inc_k, bound_k) <= __dmul_rn(p.mip_gap, fabs(inc_k));
        p.o_pkd[o] = floor_k;
        if (!(done || bound_k == inf)) s_open = 1;
      }
    }
    __syncthreads();
  }

  // 6. The lane's scalars and its go flag on the new state.
  if (tid == 0) {
    const double dropped = frz ? p.dropped[l] : t_min(p.dropped[l], spill);
    const double bb = t_min(live, dropped);
    const bool cert = per_k ? s_open == 0
                            : isfinite(inc_new) && __dsub_rn(inc_new, bb) <=
                                                       __dmul_rn(p.mip_gap, fabs(inc_new));
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
size_t smem_bytes(int B, int cap, int M, int prerounded, int round_warps, int n_k, int per_k) {
  return lane_smem(B, cap, M, prerounded, round_warps, n_k, per_k, TAIL_THREADS / 32);
}

}  // namespace

extern "C" {

// The least dynamic shared memory a block needs (one rounding warp): the
// wrapper refuses a shape past the card's limit before it launches.
long dtk_round_tail_smem_bytes(int B, int cap, int M, int prerounded, int n_k, int per_k) {
  return (long)smem_bytes(B, cap, M, prerounded, 1, n_k, per_k);
}

// Bytes of the workspace (the wrapper allocates it after the new state).
long dtk_round_tail_ws_bytes(int L, int B, int cap, int M) {
  const size_t rows = (size_t)L * B;
  return (long)(rows * (sizeof(double) * (2 + 2 * (size_t)M) + sizeof(float) + sizeof(int) + 1) +
                (size_t)L * cap * sizeof(int) + 64);
}

// dims: L, B, cap, nf, m, M, n_k, prerounded, has_y, iters_f32, rd_lanes,
// rd_stride, per_k;
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
  p.per_k = dims[12];
  p.mip_gap = mip_gap;
  if (p.L <= 0 || p.B <= 0 || p.B > p.cap || p.M <= 0 || p.n_k <= 0) {
    return (int)cudaErrorInvalidValue;
  }
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
      (const void**)&p.st_rounds, (const void**)&p.pkw, (const void**)&p.pkn,
      (const void**)&p.pky, (const void**)&p.pkd, (const void**)&p.o_lo, (const void**)&p.o_hi,
      (const void**)&p.o_kidx, (const void**)&p.o_bound, (const void**)&p.o_active,
      (const void**)&p.o_inc, (const void**)&p.o_inc_w, (const void**)&p.o_inc_n,
      (const void**)&p.o_inc_y, (const void**)&p.o_inc_kidx, (const void**)&p.o_dropped,
      (const void**)&p.o_pkb, (const void**)&p.o_v, (const void**)&p.o_y, (const void**)&p.o_z,
      (const void**)&p.o_f, (const void**)&p.o_warm, (const void**)&p.o_st_iters,
      (const void**)&p.o_st_rounds, (const void**)&p.o_go, (const void**)&p.o_pkw,
      (const void**)&p.o_pkn, (const void**)&p.o_pky, (const void**)&p.o_pkd};
  constexpr int n_slots = sizeof(slots) / sizeof(slots[0]);
  static_assert(n_slots + 1 == N_PTRS, "pointer table out of step");
  for (int i = 0; i < n_slots; ++i) *slots[i] = (const void*)ptrs[i];
  if (p.per_k && (!p.pkw || !p.pkn || !p.pky || !p.pkd || !p.o_pkw || !p.o_pkn || !p.o_pky ||
                  !p.o_pkd)) {
    return (int)cudaErrorInvalidValue;
  }
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
  while (rw > 1 && smem_bytes(p.B, p.cap, p.M, p.prerounded, rw, p.n_k, p.per_k) > SMEM_LIMIT) {
    --rw;
  }
  p.round_warps = rw;
  const size_t sm = smem_bytes(p.B, p.cap, p.M, p.prerounded, rw, p.n_k, p.per_k);
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
