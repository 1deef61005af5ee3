// The branch-and-bound loop of a sweep (dense or MoE, on the IPM or the PDHG
// engine) on the card: the seeded root state, every round's LP inputs, the
// loop's control and the answer, and the CUDA graph that runs them with the
// LP engine (K1, ipm_kernel.cu, or K5 on its route, pdhg_cluster_kernel.cu or
// pdhg_kernel.cu), for a MoE sweep K7 (decomp_kernel.cu) and K2's MoE mode
// (round_moe_kernel.cu), and the round tail (round_tail_kernel.cu) between,
// the loop as a conditional WHILE node.
//
// Replaces distilp_tpu/solver/backend_jax.py::_solve_packed_impl (:2100:
// the root state, the warm incumbent's re-pricing, the answer as one float64
// vector) and ::_run_bnb_loop (:2732: the root round, then a lax.while_loop
// whose condition, the gap test, runs on the device, :2891, :2913), which
// the TPU runs as one device program. The port ran them as a host loop: ~17
// torch launches a round to gather the LP's inputs, a read of the go flags a
// round, ~15 fills and ~7 reads around it. Here a solve is one graph launch:
//   bnb_seed_kernel     the root frontier (one node a k, boxes from the
//                       uploaded lo_k/hi_k, a previous solve's root iterates)
//                       and, given a warm hint, its exact re-pricing (K2's
//                       per-row body, round_row.cuh, a warp a lane) seeding
//                       the incumbent and that k's best;
//   bnb_control_kernel  (init) each lane's go flag on the seeded state: a node
//                       active and no certificate (per-k mode: some k not
//                       settled), as run_bnb_loop tests it;
//   a round, B rows a lane (the root round n_k rows at the full budget, a
//   warm round `beam` rows at the warm budget):
//     bnb_head_kernel   each row's b and c (by its k), box, warm iterate, ok
//                       and skip (frozen lanes' rows skip) straight from the
//                       state, a block a row;
//     the LP engine     dtk_ipm_f32 (K1) on the plan's buffers, or K5 on
//                       the route the plan fixed: one cluster launch, or one
//                       cooperative grid launch a slice of up to 16 rows, as
//                       the K5 wrapper slices them (ops/pdhg.py);
//     bnb_cast_kernel   (PDHG in float64) the result rounded to the search's
//                       float32, as search.cast_lp_result does;
//     the round tail    dtk_round_tail, reading one state buffer and writing
//                       the other (ping-pong), and each lane's go flag;
//     bnb_control_kernel (step) the next frozen mask and whether the loop
//                       goes on (a lane that stopped stays frozen; the
//                       round count against max_rounds), set on the WHILE
//                       node from the device (cudaGraphSetConditional);
//   bnb_answer_kernel   the answer of each lane as one float64 row: the head
//                       (incumbent, best bound, its k, LP steps, rounds), the
//                       incumbent's w, n, y, each k's best, in per-k mode each
//                       k's assignment and bound, then the root round's
//                       iterates (a lane that skipped it: the carried-in
//                       ones).
// The diagnostics configuration (_run_bnb_loop(collect_rounds=True) inside
// _solve_packed_impl(diag=True), :2777-2783, :2811-2893, :3272-3278): the
// same program with a log threaded through it. The root round's LP runs with
// its convergence trace on (B13: its other outputs are the untraced
// launch's bit for bit, so the search is the untraced one);
//   bnb_control_kernel  (init) zeroes the log and the trace; (step) writes the
//                       round's row, _round_row (:171-185), from the states
//                       that bracket it: [expanded, live_after, incumbent,
//                       best_bound, lp_iters, executed];
//   bnb_answer_kernel   appends the log (max_rounds rows) and the first n_k
//                       roots' trace, masked by the lanes that ran the root
//                       round and rounded to float32, to each lane's row.
// MoE sweeps (_solve_packed_impl's MoE parts, :2239-2350, :2437-2445; the
// MoE branch of _round_to_incumbent, :721-783):
//   bnb_seed_kernel     also gathers K7's problem of every lane from the
//                       upload (float32 rounded to nearest, as numpy casts),
//                       the ascent's start (the stored duals or zeros), b'
//                       and E, and zeroes the float64 evaluation's counters;
//   K7, its folds       cold: the fused ascent, then theta, the float64
//                       evaluation with the hint and the bound; warm: the
//                       three at the stored duals; margin: none;
//   bnb_seed_moe_kernel phase 0: the root bounds, the answer's duals block,
//                       the hint cells' LP points (n* rebuilt from the
//                       candidate) and the warm hint's; phase 1, after K2
//                       MoE's hint rows: the best repaired hint and each k's;
//                       phase 2, after its warm row: the warm hint's;
//   bnb_head_kernel     also writes each row's k's 2M expert-busy entries
//                       into its dense A and its values on the structure
//                       (K1's per-node route), and its W and k (K2 MoE);
//   K2 MoE's LP rows    between the LP and the round tail (pre-rounded rows);
// The PDHG engine (the reference's PDHG branch of _bnb_round, :1520-1558):
//   bnb_head_kernel     in its PDHG mode also tests a row's warm iterate for
//                       non-finite components as the K5 wrapper does, writes
//                       no dense A, and for pdhg_dtype 'f64' writes the LP's
//                       inputs and the MoE values in float64;
//   bnb_answer_kernel   also writes the duals block and, asked, the y-profile.
// The graph: seed, init, the root round (state A -> B), then WHILE { round
// B -> A, round A -> B }, then the answer. A lane settled in the body's first
// round is frozen in its second, so its state passes through unchanged;
// once the loop stops (every lane settled, or max_rounds reached), every lane
// is frozen and a round is an exact copy. The final state is always in B.
//
// What bounds it on an H100: nothing of its own. Its kernels move the state
// once (the seed writes it, the head reads a round's rows, the answer reads
// the incumbent and the root iterates: tens of KB) and do a few hundred
// float64 operations; each is one short launch whose latency (a few us)
// is the cost. What the design removes is the host: one graph launch
// replaces ~20 enqueues and a device-to-host read a round.
//
// Every output is a copy, a selection, a comparison or K2's rounding: the
// file is built with --fmad=false like round_kernel.cu, and the gap tests'
// products and differences are rounded one by one (__dmul_rn, __dsub_rn):
// bit for bit the plain versions in solver/device_loop.py.

#include <cuda_runtime.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12040
#error "bnb_loop_kernel.cu needs CUDA 12.4 or newer: the loop is a conditional WHILE graph node"
#endif

#include "per_k_row.cuh"
#include "round_row.cuh"

namespace {

using namespace dtk;

constexpr int SEED_THREADS = 256;
constexpr int HEAD_THREADS = 128;
constexpr int CONTROL_THREADS = 256;
constexpr int ANSWER_THREADS = 256;
constexpr int MOE_SEED_THREADS = 128;
constexpr int CAST_THREADS = 256;
// The round log's and the LP trace's columns (search.RL_COLS,
// ops/ipm.py::TRACE_COLS).
constexpr int RL_COLS = 6;
constexpr int TRACE_COLS = 6;
// K7's per-device rows (ops/decomp.py::RD_DEV_FIELDS), at most.
constexpr int DEV_ROWS = 16;

// The state of L lanes, in search.SearchState's order.
struct State {
  float* lo;        // (L, cap, nf)
  float* hi;        // (L, cap, nf)
  int* kidx;        // (L, cap)
  double* bound;    // (L, cap)
  uint8_t* active;  // (L, cap)
  double* inc;      // (L,)
  double* inc_w;    // (L, M)
  double* inc_n;
  double* inc_y;
  int* inc_kidx;    // (L,)
  double* dropped;  // (L,)
  double* pkb;      // (L, n_k)
  double* pkw;      // (L, n_k, M)
  double* pkn;
  double* pky;
  double* pkd;      // (L, n_k)
  float* nv;        // (L, cap, nf)
  float* ny;        // (L, cap, m)
  float* nz;        // (L, cap, nf)
  float* nfd;       // (L, cap, nf)
  uint8_t* nwarm;   // (L, cap)
  double* st_iters; // (L,)
  double* st_rounds;
};
constexpr int STATE_PTRS = 23;

// ------------------------------------------------------------------ seed

struct SeedParams {
  int L, cap, nf, m, M, n_k, has_root_warm, has_warm;
  // The uploaded sweep (lane-major).
  const float* lo_k;         // (L, n_k, nf)
  const float* hi_k;
  const uint8_t* rw_ok;      // (L, n_k) root iterates of a previous solve
  const float* rw_v;         // (L, n_k, nf)
  const float* rw_y;         // (L, n_k, m)
  const float* rw_z;
  const float* rw_f;
  const long long* warm_kidx;  // (L,) the hint's k index
  const double* warm_w;      // (L, M)
  const double* warm_n;
  const double* Ws;          // (L, n_k)
  const double* ks;
  const double* rd;          // (L, RD_BLOCK, M) packed rounding data
  long rd_stride;
  const double* obj_const;   // (L,)
  State s;
  // MoE mode (moe != 0; the dense re-pricing above is then off): K7's
  // problem of every lane gathered from the upload, in both dtypes (the
  // float32 copy rounded to nearest, as numpy casts), the ascent's starting
  // multipliers, contiguous copies of b' and E, and the float64
  // evaluation's row counters zeroed.
  int moe, n_dev_rows;
  int dev_rows[DEV_ROWS];    // the packed row of each of K7's rows
  long count_len;
  const double* rd_scalars;  // (L, 2) b', E
  const double* duals;       // (L, n_k (2 + M)) lam, mu, tau, or null (zeros)
  float* rdv32;              // (L, n_dev_rows, M)
  double* rdv64;
  float* bp32;               // (L,)
  float* E32;
  double* bp64;
  double* E64;
  float* ks32;               // (L, n_k)
  float* Ws32;
  float* P0;                 // (L, n_k (2 + M))
  int* count;                // (count_len,)
};

// search.root_state, then search.seed_warm's dense re-pricing. The node
// arrays are filled by every block (grid-stride); block l < L writes lane
// l's scalars, incumbent and per-k fields, warp 0 rounding the hint.
__global__ void __launch_bounds__(SEED_THREADS) bnb_seed_kernel(const __grid_constant__ SeedParams p) {
  extern __shared__ double seed_sm[];
  const State& s = p.s;
  const size_t L = p.L, cap = p.cap, nf = p.nf, m = p.m, n_k = p.n_k;
  const size_t gt = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t gs = (size_t)gridDim.x * blockDim.x;
  for (size_t e = gt; e < L * cap * nf; e += gs) {
    const size_t l = e / (cap * nf), r = (e / nf) % cap, j = e % nf;
    const bool root = r < n_k;
    const size_t src = (l * n_k + r) * nf + j;
    s.lo[e] = root ? p.lo_k[src] : 0.0f;
    s.hi[e] = root ? p.hi_k[src] : 0.0f;
    const bool w = root && p.has_root_warm;
    s.nv[e] = w ? p.rw_v[src] : 0.0f;
    s.nz[e] = w ? p.rw_z[src] : 0.0f;
    s.nfd[e] = w ? p.rw_f[src] : 0.0f;
  }
  for (size_t e = gt; e < L * cap * m; e += gs) {
    const size_t l = e / (cap * m), r = (e / m) % cap, i = e % m;
    s.ny[e] = (r < n_k && p.has_root_warm) ? p.rw_y[(l * n_k + r) * m + i] : 0.0f;
  }
  for (size_t e = gt; e < L * cap; e += gs) {
    const size_t l = e / cap, r = e % cap;
    const bool root = r < n_k;
    s.kidx[e] = root ? (int)r : 0;
    s.bound[e] = -INFINITY;
    s.active[e] = root ? 1 : 0;
    s.nwarm[e] = (root && p.has_root_warm) ? (p.rw_ok[l * n_k + r] ? 1 : 0) : 0;
  }
  if (p.moe) {
    const size_t M = p.M, R = p.n_dev_rows;
    for (size_t e = gt; e < L * R * M; e += gs) {
      const size_t l = e / (R * M), r = (e / M) % R, i = e % M;
      const double x = p.rd[l * p.rd_stride + (size_t)p.dev_rows[r] * M + i];
      p.rdv64[e] = x;
      p.rdv32[e] = __double2float_rn(x);
    }
    for (size_t e = gt; e < L; e += gs) {
      p.bp64[e] = p.rd_scalars[2 * e];
      p.E64[e] = p.rd_scalars[2 * e + 1];
      p.bp32[e] = __double2float_rn(p.rd_scalars[2 * e]);
      p.E32[e] = __double2float_rn(p.rd_scalars[2 * e + 1]);
    }
    for (size_t e = gt; e < L * n_k; e += gs) {
      p.ks32[e] = __double2float_rn(p.ks[e]);
      p.Ws32[e] = __double2float_rn(p.Ws[e]);
    }
    for (size_t e = gt; e < L * n_k * (2 + M); e += gs)
      p.P0[e] = p.duals != nullptr ? __double2float_rn(p.duals[e]) : 0.0f;
    for (size_t e = gt; e < (size_t)p.count_len; e += gs) p.count[e] = 0;
  }
  if (blockIdx.x >= L) return;
  const int l = blockIdx.x, M = p.M, tid = threadIdx.x;
  const size_t lm = (size_t)l * M, lk = (size_t)l * n_k;
  for (int i = tid; i < M; i += blockDim.x) {
    s.inc_w[lm + i] = 0.0;
    s.inc_n[lm + i] = 0.0;
    s.inc_y[lm + i] = 0.0;
  }
  for (size_t i = tid; i < n_k * M; i += blockDim.x) {
    s.pkw[lk * M + i] = 0.0;
    s.pkn[lk * M + i] = 0.0;
    s.pky[lk * M + i] = 0.0;
  }
  for (size_t k = tid; k < n_k; k += blockDim.x) {
    s.pkb[lk + k] = INFINITY;
    s.pkd[lk + k] = INFINITY;
  }
  if (tid == 0) {
    s.inc[l] = INFINITY;
    s.inc_kidx[l] = 0;
    s.dropped[l] = INFINITY;
    s.st_iters[l] = 0.0;
    s.st_rounds[l] = 0.0;
  }
  if (!p.has_warm) return;
  __syncthreads();
  if (tid >= 32) return;
  // The hint as an LP point (w, then n), re-priced exactly at its k: K2's
  // per-row body, as round_kernel.cu runs it on the float64 hint.
  double* v = seed_sm;             // nf doubles
  double* scratch = seed_sm + nf;  // 2M doubles
  long long kq = p.warm_kidx[l];
  const int kw = (int)(kq < 0 ? 0 : (kq > (long long)n_k - 1 ? (long long)n_k - 1 : kq));
  for (int j = tid; j < (int)nf; j += 32) {
    v[j] = j < M ? p.warm_w[lm + j] : (j < 2 * M ? p.warm_n[lm + j - M] : 0.0);
  }
  __syncwarp();
  double* obj = scratch + 2 * M;   // 1 double
  double* w_rep = obj + 1;         // M
  double* n_rep = w_rep + M;       // M
  round_row(v, p.Ws[lk + kw], p.ks[lk + kw], p.rd + (size_t)l * p.rd_stride, M, scratch,
            scratch + M, obj, w_rep, n_rep);
  __syncwarp();
  const double warm_obj = *obj + p.obj_const[l];
  // The state was just seeded: incumbent and every per_k_best are +inf.
  const bool finite = isfinite(warm_obj);
  const bool seeded = finite && warm_obj < (double)INFINITY;
  const double clean = finite ? warm_obj : INFINITY;
  const bool seeded_k = clean < (double)INFINITY;
  const size_t ko = (lk + kw) * M;
  for (int i = tid; i < M; i += 32) {
    if (seeded_k) {
      s.pkw[ko + i] = w_rep[i];
      s.pkn[ko + i] = n_rep[i];
    }
    if (seeded) {
      s.inc_w[lm + i] = w_rep[i];
      s.inc_n[lm + i] = n_rep[i];
    }
  }
  if (tid == 0) {
    s.pkb[lk + kw] = t_min(INFINITY, clean);
    if (seeded) {
      s.inc[l] = warm_obj;
      s.inc_kidx[l] = kw;
    }
  }
}

// -------------------------------------------------------------- MoE seed

// The MoE seed around K7 and K2's MoE mode (search.seed_root_bounds and
// seed_warm with moe), a block a lane, in three phases:
//   0  after K7 (or, on a margin tick, instead of it): the root bounds into
//      the roots' node bounds (+ obj_const); the duals block of the answer
//      (lam, mu, tau, raw bounds: the evaluation's, or on a margin tick the
//      stored duals and the uploaded margin bounds); on a cold solve each
//      k's Lagrangian-primal hint cell as an LP point (w*, n* rebuilt from
//      the candidate, y*: ops/decomp.py::primal_hint) for K2's hint mode;
//      given a warm hint, its point and k's (W, k) for K2's warm mode;
//   1  after K2's hint rows: the best repaired hint (first index on ties)
//      as the incumbent and each k's repaired hint as its best;
//   2  after K2's warm row: the re-priced warm hint, where it beats them.
struct MoeSeedParams {
  int L, cap, n_k, M, phase, cold, has_warm, Y;
  const double* obj_const;   // (L,)
  // phase 0
  const double* bound;       // (L, n_k) the evaluation's raw bounds
  const double* margin;      // (L, n_k) or null
  const double* lam;         // (L, n_k) the evaluation's multipliers
  const double* mu;
  const double* tau;         // (L, n_k, M)
  const double* duals_in;    // (L, n_k (2 + M)) the stored duals (margin)
  double* duals_out;         // (L, 3 n_k + n_k M)
  const double* hint_w;      // (L, n_k, M)
  const int* hint_flat;
  const double* rd;          // (L, RD_BLOCK, M) packed rounding data
  long rd_stride;
  int rd_has_gpu, rd_ram_minus_n, rd_cuda_rhs, rd_metal_rhs, rd_eb_ram, rd_eb_vram,
      rd_eb_metal, rd_ram_rhs;  // their packed rows
  const double* bp64;        // (L,)
  double* hint_v;            // (L n_k, 3M)
  const long long* warm_kidx;  // (L,)
  const double* warm_w;      // (L, M)
  const double* warm_n;
  const double* warm_y;
  const double* Ws;          // (L, n_k)
  const double* ks;
  double* warm_v;            // (L, 3M)
  double* warm_W;            // (L,)
  double* warm_k;
  // phase 1: K2's hint rows; phase 2: its warm rows
  const double* r_obj;       // (rows,)
  const double* r_w;         // (rows, M)
  const double* r_n;
  const double* r_y;
  State s;
};

__device__ __forceinline__ int clamp_k(long long kq, int n_k) {
  return (int)(kq < 0 ? 0 : (kq > (long long)n_k - 1 ? (long long)n_k - 1 : kq));
}

__global__ void __launch_bounds__(MOE_SEED_THREADS)
    bnb_seed_moe_kernel(const __grid_constant__ MoeSeedParams p) {
  extern __shared__ int moe_sm[];  // n_k flags (phase 1)
  __shared__ int s_best;
  const State& s = p.s;
  const int l = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n_k = p.n_k, M = p.M;
  const size_t lk = (size_t)l * n_k, lm = (size_t)l * M;
  const double inf = INFINITY;
  if (p.phase == 0) {
    const int dw = 3 * n_k + n_k * M;
    double* d = p.duals_out + (size_t)l * dw;
    const size_t pw = (size_t)n_k * (2 + M);
    for (int k = tid; k < n_k; k += nt) {
      const double raw = p.margin != nullptr ? p.margin[lk + k] : p.bound[lk + k];
      s.bound[(size_t)l * p.cap + k] = raw + p.obj_const[l];
      d[2 * n_k + n_k * M + k] = raw;
      if (p.margin != nullptr) {
        d[k] = p.duals_in[l * pw + k];
        d[n_k + k] = p.duals_in[l * pw + n_k + k];
      } else {
        d[k] = p.lam[lk + k];
        d[n_k + k] = p.mu[lk + k];
      }
    }
    for (int e = tid; e < n_k * M; e += nt) {
      d[2 * n_k + e] = p.margin != nullptr ? p.duals_in[l * pw + 2 * n_k + e]
                                           : p.tau[lk * M + e];
    }
    if (p.cold) {
      const double* rd = p.rd + (size_t)l * p.rd_stride;
      const double bp = p.bp64[l];
      const double zero = 0.0;
      for (int e = tid; e < n_k * M; e += nt) {
        const int k = e / M, i = e % M;
        const size_t o = lk * M + e;
        const double w = p.hint_w[o];
        const long long flat = p.hint_flat[o];
        const long long c = flat / p.Y;
        const double y = (double)(flat % p.Y);
        auto row = [&](int r) { return rd[(size_t)r * M + i]; };
        const double hg = row(p.rd_has_gpu), rm = row(p.rd_ram_minus_n);
        const double ebr = row(p.rd_eb_ram), rhs = row(p.rd_ram_rhs);
        const double vram = nan_min(__dsub_rn(row(p.rd_cuda_rhs), __dmul_rn(row(p.rd_eb_vram), y)),
                                    __dsub_rn(row(p.rd_metal_rhs), __dmul_rn(row(p.rd_eb_metal), y)));
        double nb = __dmul_rn(nan_min(nan_max(floor(__ddiv_rn(vram, bp)), zero), w), hg);
        if (!isfinite(nb)) nb = __dmul_rn(w, hg);
        const double kink_arg = __dsub_rn(
            __ddiv_rn(__dsub_rn(__dadd_rn(__dmul_rn(bp, w), __dmul_rn(ebr, y)), rhs), bp), 1e-9);
        double nk = __dmul_rn(__dmul_rn(nan_min(nan_max(ceil(kink_arg), zero), w), hg), rm);
        if (!isfinite(nk)) nk = zero;
        const double smin_arg =
            __dsub_rn(__ddiv_rn(__dsub_rn(__dmul_rn(ebr, y), rhs), bp), 1e-9);
        double ns = __dmul_rn(__dmul_rn(nan_min(nan_max(ceil(smin_arg), zero), w), hg), rm);
        if (!isfinite(ns)) ns = zero;
        const double n = c == 0 ? zero : (c == 1 ? __dmul_rn(w, hg) : (c == 2 ? nb : (c == 3 ? nk : ns)));
        double* v = p.hint_v + (lk + k) * 3 * M;
        v[i] = w;
        v[M + i] = n;
        v[2 * M + i] = y;
      }
    }
    if (p.has_warm) {
      const int kw = clamp_k(p.warm_kidx[l], n_k);
      double* v = p.warm_v + lm * 3;
      for (int i = tid; i < M; i += nt) {
        v[i] = p.warm_w[lm + i];
        v[M + i] = p.warm_n[lm + i];
        v[2 * M + i] = p.warm_y[lm + i];
      }
      if (tid == 0) {
        p.warm_W[l] = p.Ws[lk + kw];
        p.warm_k[l] = p.ks[lk + kw];
      }
    }
    return;
  }
  if (p.phase == 1) {
    // jnp/torch argmin: the first NaN, else the first minimum.
    if (tid == 0) {
      int jb = 0;
      double vb = p.r_obj[lk] + p.obj_const[l];
      for (int j = 1; j < n_k; ++j) {
        const double v = p.r_obj[lk + j] + p.obj_const[l];
        if (!is_nan(vb) && (is_nan(v) || v < vb)) {
          vb = v;
          jb = j;
        }
      }
      s_best = (vb < s.inc[l]) ? jb : -1;
    }
    for (int j = tid; j < n_k; j += nt) {
      const double v = p.r_obj[lk + j] + p.obj_const[l];
      const double clean = isfinite(v) ? v : inf;
      moe_sm[j] = clean < s.pkb[lk + j] ? 1 : 0;
    }
    __syncthreads();
    const int jb = s_best;
    for (int e = tid; e < n_k * M; e += nt) {
      const int j = e / M;
      if (moe_sm[j]) {
        const size_t src = (lk + j) * M + e % M;
        s.pkw[lk * M + e] = p.r_w[src];
        s.pkn[lk * M + e] = p.r_n[src];
        s.pky[lk * M + e] = p.r_y[src];
      }
    }
    if (jb >= 0) {
      for (int i = tid; i < M; i += nt) {
        const size_t src = (lk + jb) * M + i;
        s.inc_w[lm + i] = p.r_w[src];
        s.inc_n[lm + i] = p.r_n[src];
        s.inc_y[lm + i] = p.r_y[src];
      }
    }
    __syncthreads();
    for (int j = tid; j < n_k; j += nt) {
      const double v = p.r_obj[lk + j] + p.obj_const[l];
      s.pkb[lk + j] = nan_min(s.pkb[lk + j], isfinite(v) ? v : inf);
    }
    if (tid == 0 && jb >= 0) {
      s.inc[l] = p.r_obj[lk + jb] + p.obj_const[l];
      s.inc_kidx[l] = jb;
    }
    return;
  }
  // phase 2: the warm hint re-priced (a row a lane).
  const int kw = clamp_k(p.warm_kidx[l], n_k);
  const double warm_obj = p.r_obj[l] + p.obj_const[l];
  const bool finite = isfinite(warm_obj);
  const bool seeded = finite && warm_obj < s.inc[l];
  const double clean = finite ? warm_obj : inf;
  const bool seeded_k = clean < s.pkb[lk + kw];
  const size_t ko = (lk + kw) * M;
  for (int i = tid; i < M; i += nt) {
    if (seeded_k) {
      s.pkw[ko + i] = p.r_w[lm + i];
      s.pkn[ko + i] = p.r_n[lm + i];
      s.pky[ko + i] = p.r_y[lm + i];
    }
    if (seeded) {
      s.inc_w[lm + i] = p.r_w[lm + i];
      s.inc_n[lm + i] = p.r_n[lm + i];
      s.inc_y[lm + i] = p.r_y[lm + i];
    }
  }
  __syncthreads();
  if (tid == 0) {
    s.pkb[lk + kw] = nan_min(s.pkb[lk + kw], clean);
    if (seeded) {
      s.inc[l] = warm_obj;
      s.inc_kidx[l] = kw;
    }
  }
}

// ------------------------------------------------------------------ head

struct HeadParams {
  int L, B, cap, nf, m, n_k;
  const float* lo;
  const float* hi;
  const int* kidx;
  const uint8_t* active;
  const float* nv;
  const float* ny;
  const float* nz;
  const float* nfd;
  const uint8_t* nwarm;
  const uint8_t* frozen;  // (L,)
  const float* b_k;       // (L, n_k, m)
  const float* c_k;       // (L, n_k, nf)
  float* b;               // (L*B, m) lane-major rows
  float* c;               // (L*B, nf)
  float* l;
  float* u;
  float* wv;
  float* wy;              // (L*B, m)
  float* wz;
  float* wf;
  uint8_t* wok;           // (L*B,)
  uint8_t* skip;
  // MoE mode (moe != 0): each row's per-node A, the sweep's base (written
  // once when the plan loads it) with the row's k's 2M expert-busy entries
  // written here, as a dense (m, nf) matrix (K1's certificate) and as values
  // on the sweep's structure (K1's products), and the row's W and k (K2).
  int moe, M, nnz;
  const float* gky;       // (L, n_k, 2, M)
  const int* gky_pos;     // (2, M) places in a row's values
  float* A_rows;          // (L*B, m, nf)
  float* vals;            // (L*B, nnz)
  const double* Ws;       // (L, n_k)
  const double* ks;
  double* Wr;             // (L*B,)
  double* kr;
  // PDHG mode (pdhg != 0; K5 reads the rows): a row's warm iterate is used
  // only when every component of its v, y, z and f is finite (as the K5
  // wrapper tests it, ops/pdhg.py::_pdhg_kernel), and no dense A is written
  // (A_rows is null: K5 reads only the values). With lp_f64 (pdhg_dtype
  // 'f64') the LP's b, c, l, u, warm v and y and the values are written in
  // float64 (the exact casts the wrapper makes on entry) instead.
  int pdhg, lp_f64;
  double* b64;            // (L*B, m)
  double* c64;            // (L*B, nf)
  double* l64;
  double* u64;
  double* wv64;
  double* wy64;           // (L*B, m)
  double* vals64;         // (L*B, nnz)
  // Row mesh (mesh_S > 0; K6b reads the rows): a row's b and warm y go to
  // the S row blocks of ms rows each (block s at b + s * blk_rows * ms, row
  // r of it at + r * ms), the padded rows of the last blocks zero, as
  // ops/meshlp.py::shard_rows pads them; the warm verdict is still judged
  // on the row's m values. A MoE row's 2M expert-busy entries go to their
  // blocks' values (RowBlocks.take): entry j at vals + gky_mesh[j] + row *
  // gky_mesh[2M + j] (its place in the blocks' concatenated values, and its
  // block's nonzeros a row).
  int mesh_S, ms;
  long blk_rows;
  const long long* gky_mesh;  // (2, 2M)
  // Write each row's W and k without the MoE mode (the node mesh's dense
  // rows, which K2's dense entry rounds a shard at a time).
  int wk;
};

template <typename T>
__device__ __forceinline__ void put(bool f64, float* o32, double* o64, size_t i, T x) {
  if (f64) {
    o64[i] = (double)x;
  } else {
    o32[i] = (float)x;
  }
}

// search._bnb_round's gathers of a round's LP inputs, a block a row.
__global__ void __launch_bounds__(HEAD_THREADS) bnb_head_kernel(const __grid_constant__ HeadParams p) {
  const size_t row = blockIdx.x;
  const size_t lane = row / p.B, r = row % p.B;
  const size_t slot = lane * p.cap + r;
  const size_t nf = p.nf, m = p.m;
  const size_t k = (size_t)p.kidx[slot];
  const size_t kb = lane * p.n_k + k;
  const bool f64 = p.lp_f64 != 0;
  bool fin = true;
  for (size_t j = threadIdx.x; j < nf; j += blockDim.x) {
    const size_t o = row * nf + j, so = slot * nf + j;
    const float v = p.nv[so], z = p.nz[so], f = p.nfd[so];
    put(f64, p.c, p.c64, o, p.c_k[kb * nf + j]);
    put(f64, p.l, p.l64, o, p.lo[so]);
    put(f64, p.u, p.u64, o, p.hi[so]);
    put(f64, p.wv, p.wv64, o, v);
    p.wz[o] = z;
    p.wf[o] = f;
    fin = fin && isfinite(v) && isfinite(z) && isfinite(f);
  }
  const bool mesh = p.mesh_S > 0;
  const size_t ms = mesh ? (size_t)p.ms : m;
  const size_t bstride = mesh ? (size_t)p.blk_rows * ms : 0;
  for (size_t i = threadIdx.x; i < m; i += blockDim.x) {
    const float y = p.ny[slot * m + i];
    const size_t o = mesh ? (i / ms) * bstride + row * ms + i % ms : row * m + i;
    put(f64, p.b, p.b64, o, p.b_k[kb * m + i]);
    put(f64, p.wy, p.wy64, o, y);
    fin = fin && isfinite(y);
  }
  if (mesh) {
    for (size_t i = m + threadIdx.x; i < (size_t)p.mesh_S * ms; i += blockDim.x) {
      const size_t o = (i / ms) * bstride + row * ms + i % ms;
      put(f64, p.b, p.b64, o, 0.0f);
      put(f64, p.wy, p.wy64, o, 0.0f);
    }
  }
  // p.pdhg is the same in every thread: the whole block reaches the barrier.
  const bool warm_finite = p.pdhg ? __syncthreads_and(fin) != 0 : true;
  if (threadIdx.x == 0) {
    p.wok[row] = p.nwarm[slot] && warm_finite ? 1 : 0;
    const bool live = p.active[slot] && !(p.frozen != nullptr && p.frozen[lane]);
    p.skip[row] = live ? 0 : 1;
  }
  if ((p.moe || p.wk) && threadIdx.x == 0) {
    p.Wr[row] = p.Ws[kb];
    p.kr[row] = p.ks[kb];
  }
  if (!p.moe) return;
  // search.node_A / node_values: rows 4M + i and 5M + i of column 2M + i.
  const size_t M = p.M;
  const float* g = p.gky + kb * 2 * M;
  if (p.gky_mesh != nullptr) {
    for (size_t j = threadIdx.x; j < 2 * M; j += blockDim.x) {
      const size_t o = (size_t)p.gky_mesh[j] + row * (size_t)p.gky_mesh[2 * M + j];
      put(f64, p.vals, p.vals64, o, g[j]);
    }
    return;
  }
  float* A = p.A_rows == nullptr ? nullptr : p.A_rows + row * m * nf;
  float* v = p.vals == nullptr ? nullptr : p.vals + row * (size_t)p.nnz;
  double* v64 = p.vals64 == nullptr ? nullptr : p.vals64 + row * (size_t)p.nnz;
  for (size_t i = threadIdx.x; i < M; i += blockDim.x) {
    if (A != nullptr) {
      A[(4 * M + i) * nf + 2 * M + i] = g[i];
      A[(5 * M + i) * nf + 2 * M + i] = g[M + i];
    }
    put(f64, v, v64, p.gky_pos[i], g[i]);
    put(f64, v, v64, p.gky_pos[M + i], g[M + i]);
  }
}

// ---------------------------------------------------------------- gather

// The row mesh's dual blocks back in full coordinates (ops/meshlp.py: the
// reference's tiled all_gather of the shards' y in mesh order, then the
// padding dropped): y[r, i] = block i / ms's row r, entry i % ms, for the
// m real rows of A. One pass, in the iteration dtype; the float64 cast (if
// any) reads the result.
struct GatherParams {
  long R, m, ms, blk_rows;
  int f64;
  const void* src;  // (S, blk_rows, ms)
  void* dst;        // (R, m)
};

__global__ void __launch_bounds__(CAST_THREADS) bnb_gather_kernel(const __grid_constant__ GatherParams p) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t n = (size_t)p.R * p.m, ms = p.ms, bstride = (size_t)p.blk_rows * ms;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += stride) {
    const size_t r = idx / p.m, i = idx % p.m;
    const size_t o = (i / ms) * bstride + r * ms + i % ms;
    if (p.f64) {
      static_cast<double*>(p.dst)[idx] = static_cast<const double*>(p.src)[o];
    } else {
      static_cast<float*>(p.dst)[idx] = static_cast<const float*>(p.src)[o];
    }
  }
}

// ------------------------------------------------------------------ cast

// A float64 PDHG round's result in the search's float32 (search.
// cast_lp_result, the reference's _cast_lp_result, backend_jax.py:1414,
// applied at :1558): v, y, z, f, obj and the residuals rounded to nearest
// into the float32 result the round tail and the answer read, and reduced
// rounded to float32 and held in float64, in place. K5 writes bound,
// converged and iters_run straight into the float32 result.
struct CastParams {
  long R, nf, m;
  const double* v64;  // (R, nf)
  const double* y64;  // (R, m)
  const double* z64;
  const double* f64;
  const double* obj64;  // (R,)
  const double* rp64;
  const double* rd64;
  const double* mu64;
  float* v;
  float* y;
  float* z;
  float* f;
  float* obj;
  float* rp;
  float* rd;
  float* mu;
  double* reduced;  // (R, nf), in place
};
constexpr int CAST_PTRS = 17;

__global__ void __launch_bounds__(CAST_THREADS) bnb_cast_kernel(const __grid_constant__ CastParams p) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t t0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_cols = (size_t)p.R * p.nf, n_rows = (size_t)p.R * p.m;
  for (size_t i = t0; i < n_cols; i += stride) {
    p.v[i] = __double2float_rn(p.v64[i]);
    p.z[i] = __double2float_rn(p.z64[i]);
    p.f[i] = __double2float_rn(p.f64[i]);
    p.reduced[i] = (double)__double2float_rn(p.reduced[i]);
  }
  for (size_t i = t0; i < n_rows; i += stride) p.y[i] = __double2float_rn(p.y64[i]);
  for (size_t i = t0; i < (size_t)p.R; i += stride) {
    p.obj[i] = __double2float_rn(p.obj64[i]);
    p.rp[i] = __double2float_rn(p.rp64[i]);
    p.rd[i] = __double2float_rn(p.rd64[i]);
    p.mu[i] = __double2float_rn(p.mu64[i]);
  }
}

// --------------------------------------------------------------- control

// ctl[0]: the index of the next round (0 the root); ctl[1]: 1 once the loop
// stopped.
struct ControlParams {
  int L, cap, n_k, per_k, max_rounds, init;
  double mip_gap;
  cudaGraphConditionalHandle handle;  // 0: none (set nothing)
  const uint8_t* go;  // (L,) the round tail's flags (step)
  // The seeded state (init).
  const uint8_t* active;
  const double* bound;
  const int* kidx;
  const double* inc;
  const double* dropped;
  const double* pkb;
  const double* pkd;
  uint8_t* frozen;  // (L,)
  uint8_t* ran;     // (L,) init: the lanes that run the root round
  int* ctl;
  // The round log (null: none): (L, max_rounds, RL_COLS), a row a round
  // that ran; the root round's rows a lane (B0) and a warm round's (Bw);
  // the round's source state (before it) and the state it wrote (after);
  // the root LP's trace buffer, trace_words 4-byte words, zeroed at init.
  double* log;
  int B0, Bw;
  const uint8_t* b_active;
  const double* b_iters;
  const uint8_t* a_active;
  const double* a_bound;
  const double* a_inc;
  const double* a_dropped;
  const double* a_iters;
  uint32_t* trace;
  long trace_words;
};

// search.certified / certified_per_k on one lane of the seeded state, its
// go flag (a node active and not settled).
__device__ bool lane_go(const ControlParams& p, int l) {
  const size_t lc = (size_t)l * p.cap;
  const double inf = INFINITY;
  bool any = false;
  double live = inf;
  for (int c = 0; c < p.cap; ++c) {
    any = any || p.active[lc + c];
    live = nan_min(live, p.active[lc + c] ? p.bound[lc + c] : inf);
  }
  if (!any) return false;
  if (!p.per_k) {
    const double bb = t_min(live, p.dropped[l]);
    const double v = p.inc[l];
    const bool cert = isfinite(v) && __dsub_rn(v, bb) <= __dmul_rn(p.mip_gap, fabs(v));
    return !cert;
  }
  for (int k = 0; k < p.n_k; ++k) {
    double lv = inf;
    for (int c = 0; c < p.cap; ++c) {
      if (p.kidx[lc + c] == k) lv = nan_min(lv, p.active[lc + c] ? p.bound[lc + c] : inf);
    }
    const size_t o = (size_t)l * p.n_k + k;
    const double bound_k = t_min(lv, p.pkd[o]);
    const double inc_k = p.pkb[o];
    const bool done =
        isfinite(inc_k) && __dsub_rn(inc_k, bound_k) <= __dmul_rn(p.mip_gap, fabs(inc_k));
    if (!(done || bound_k == inf)) return true;
  }
  return false;
}

// search.round_row of lane l for round r (the reference's _round_row): the
// beam's active rows before the round, the live nodes, the incumbent and the
// proven bound after it (search.best_bound), the LP steps it spent, and
// whether the lane ran it (not frozen in it). A frozen lane's state passed
// through the round unchanged, so its row comes from that state.
__device__ void log_row(const ControlParams& p, int l, int r) {
  const size_t lc = (size_t)l * p.cap;
  const int nbeam = r == 0 ? p.B0 : p.Bw;
  const double inf = INFINITY;
  int expanded = 0, live = 0;
  double lb = inf;
  for (int c = 0; c < p.cap; ++c) {
    if (c < nbeam && p.b_active[lc + c]) ++expanded;
    if (p.a_active[lc + c]) ++live;
    lb = nan_min(lb, p.a_active[lc + c] ? p.a_bound[lc + c] : inf);
  }
  double* row = p.log + ((size_t)l * p.max_rounds + r) * RL_COLS;
  row[0] = (double)expanded;
  row[1] = (double)live;
  row[2] = p.a_inc[l];
  row[3] = t_min(lb, p.a_dropped[l]);
  row[4] = __dsub_rn(p.a_iters[l], p.b_iters[l]);
  row[5] = p.frozen[l] ? 0.0 : 1.0;
}

__global__ void __launch_bounds__(CONTROL_THREADS) bnb_control_kernel(const __grid_constant__ ControlParams p) {
  __shared__ int s_any;
  __shared__ int s_run;
  const int tid = threadIdx.x;
  if (tid == 0) s_any = 0;
  __syncthreads();
  if (p.init) {
    // A launch's log and trace start empty: a plan serves every solve of
    // its signature, and a shorter solve must not show a longer one's rows.
    if (p.log != nullptr) {
      const size_t n = (size_t)p.L * p.max_rounds * RL_COLS;
      for (size_t i = tid; i < n; i += blockDim.x) p.log[i] = 0.0;
      for (size_t i = tid; i < (size_t)p.trace_words; i += blockDim.x) p.trace[i] = 0u;
    }
    // Before the root round: each lane's go on the seeded state.
    const bool run0 = p.max_rounds >= 1;
    for (int l = tid; l < p.L; l += blockDim.x) {
      const bool g = run0 && lane_go(p, l);
      p.ran[l] = g ? 1 : 0;
      if (g) atomicOr(&s_any, 1);
    }
    __syncthreads();
    const bool run = s_any != 0;
    for (int l = tid; l < p.L; l += blockDim.x) p.frozen[l] = (run && p.ran[l]) ? 0 : 1;
    if (tid == 0) {
      p.ctl[0] = 0;
      p.ctl[1] = run ? 0 : 1;
    }
    return;
  }
  // After a round: the tail's flags decide the next one. A round that ran
  // after the loop stopped (the WHILE body runs two a pass) is an exact copy
  // and writes no log row.
  const bool stopped = p.ctl[1] != 0;
  if (!stopped) {
    const int r = p.ctl[0];
    for (int l = tid; l < p.L; l += blockDim.x) {
      if (p.go[l]) atomicOr(&s_any, 1);
      if (p.log != nullptr && r < p.max_rounds) log_row(p, l, r);
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int next = p.ctl[0] + 1;
    const bool run = !stopped && s_any != 0 && next < p.max_rounds;
    if (!stopped) p.ctl[0] = next;
    if (!run) p.ctl[1] = 1;
    s_run = run ? 1 : 0;
    if (p.handle != 0) cudaGraphSetConditional(p.handle, run ? 1u : 0u);
  }
  __syncthreads();
  for (int l = tid; l < p.L; l += blockDim.x) p.frozen[l] = (s_run && p.go[l]) ? 0 : 1;
}

// ---------------------------------------------------------------- answer

struct AnswerParams {
  int L, cap, nf, m, M, n_k, per_k, B0, width, has_root_warm;
  State s;             // the final state
  const uint8_t* ran;  // (L,)
  // The root round's LP result, (L*B0, ...) lane-major.
  const float* rv;
  const float* ry;
  const float* rz;
  const float* rf;
  // The carried-in root iterates (the upload), when a lane skipped it.
  const uint8_t* rw_ok;
  const float* rw_v;
  const float* rw_y;
  const float* rw_z;
  const float* rw_f;
  double* out;  // (L, width)
  // MoE: the seed's duals block (L, dual_w) after each k's best, and the
  // evaluation's y-profile (L, my_size) after the root iterates, where asked.
  int dual_w;
  long my_size;
  const double* duals;
  const double* my;
  // Diagnostics: the round log (L, log_rows, RL_COLS) and the root round's
  // LP trace (L*B0, trace_rows, TRACE_COLS) in float32, or float64 when
  // trace_f64 (log_rows and trace_rows 0: none).
  int log_rows, trace_rows, trace_f64;
  const double* log;
  const void* trace;
};

// backend_torch._search's answer of one lane, a block a lane.
__global__ void __launch_bounds__(ANSWER_THREADS) bnb_answer_kernel(const __grid_constant__ AnswerParams p) {
  __shared__ double red[32];
  const int l = blockIdx.x, tid = threadIdx.x;
  const State& s = p.s;
  const size_t M = p.M, n_k = p.n_k, nf = p.nf, m = p.m, cap = p.cap;
  const size_t lc = (size_t)l * cap;
  double* o = p.out + (size_t)l * p.width;
  const double inf = INFINITY;
  double live = inf;
  for (size_t c = tid; c < cap; c += blockDim.x) live = nan_min(live, s.active[lc + c] ? s.bound[lc + c] : inf);
  live = block_reduce(live, Min(), red);
  if (tid == 0) {
    o[0] = s.inc[l];
    o[1] = t_min(live, s.dropped[l]);
    o[2] = (double)s.inc_kidx[l];
    o[3] = s.st_iters[l];
    o[4] = s.st_rounds[l];
  }
  size_t q = 5;
  for (size_t i = tid; i < M; i += blockDim.x) {
    o[q + i] = s.inc_w[l * M + i];
    o[q + M + i] = s.inc_n[l * M + i];
    o[q + 2 * M + i] = s.inc_y[l * M + i];
  }
  q += 3 * M;
  for (size_t k = tid; k < n_k; k += blockDim.x) o[q + k] = s.pkb[l * n_k + k];
  q += n_k;
  if (p.dual_w > 0) {
    for (size_t i = tid; i < (size_t)p.dual_w; i += blockDim.x)
      o[q + i] = p.duals[(size_t)l * p.dual_w + i];
    q += p.dual_w;
  }
  if (p.per_k) {
    const size_t blk = n_k * M;
    for (size_t i = tid; i < blk; i += blockDim.x) {
      o[q + i] = s.pkw[l * blk + i];
      o[q + blk + i] = s.pkn[l * blk + i];
      o[q + 2 * blk + i] = s.pky[l * blk + i];
    }
    q += 3 * blk;
    // search.per_k_bound: each k's least live bound and its floor.
    for (size_t k = tid; k < n_k; k += blockDim.x) {
      double lv = inf;
      for (size_t c = 0; c < cap; ++c) {
        if ((size_t)s.kidx[lc + c] == k) lv = nan_min(lv, s.active[lc + c] ? s.bound[lc + c] : inf);
      }
      o[q + k] = t_min(lv, s.pkd[l * n_k + k]);
    }
    q += n_k;
  }
  // The root round's iterates: the LP's for a lane that ran it (every root
  // row was active: the seed makes the n_k roots active), else the
  // carried-in ones.
  const bool ran = p.ran[l] != 0;
  const bool rw = p.has_root_warm != 0;
  for (size_t k = tid; k < n_k; k += blockDim.x) {
    o[q + k] = ran ? 1.0 : ((rw && p.rw_ok[l * n_k + k]) ? 1.0 : 0.0);
  }
  q += n_k;
  const float* res[4] = {p.rv, p.ry, p.rz, p.rf};
  const float* old[4] = {p.rw_v, p.rw_y, p.rw_z, p.rw_f};
  for (int f = 0; f < 4; ++f) {
    const size_t W = f == 1 ? m : nf;
    for (size_t e = tid; e < n_k * W; e += blockDim.x) {
      const size_t k = e / W, j = e % W;
      float x = 0.0f;
      if (ran) {
        x = res[f][((size_t)l * p.B0 + k) * W + j];
      } else if (rw) {
        x = old[f][((size_t)l * n_k + k) * W + j];
      }
      o[q + e] = (double)x;
    }
    q += n_k * W;
  }
  for (size_t i = tid; i < (size_t)p.my_size; i += blockDim.x) o[q + i] = p.my[l * p.my_size + i];
  q += p.my_size;
  // The diagnostics tail (packed.AnswerLayout: the log's rows, then the
  // trace of the first n_k roots, zeros for a lane that skipped the root
  // round, rounded to float32 as search.cast_lp_result rounds the host
  // loop's).
  const size_t nlog = (size_t)p.log_rows * RL_COLS;
  for (size_t i = tid; i < nlog; i += blockDim.x) o[q + i] = p.log[l * nlog + i];
  q += nlog;
  const size_t per = (size_t)p.trace_rows * TRACE_COLS;
  for (size_t e = tid; e < n_k * per; e += blockDim.x) {
    const size_t src = ((size_t)l * p.B0 + e / per) * per + e % per;
    float x = 0.0f;
    if (ran) {
      x = p.trace_f64 ? __double2float_rn(static_cast<const double*>(p.trace)[src])
                      : static_cast<const float*>(p.trace)[src];
    }
    o[q + e] = (double)x;
  }
}

// ------------------------------------------------------------- the graph

struct Graph {
  cudaGraph_t g = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphConditionalHandle handle = 0;
};

}  // namespace

extern "C" {

// The seed's dynamic shared memory: the hint (nf doubles), K2's scratch
// (2M), its objective and repaired w, n (1 + 2M).
long dtk_bnb_seed_smem(int nf, int M) { return (long)sizeof(double) * (nf + 4 * (long)M + 1); }

// dims: L, cap, nf, m, M, n_k, has_root_warm, has_warm, rd_stride, moe,
// n_dev_rows, count_len, then DEV_ROWS packed rows; ptrs: lo_k, hi_k,
// rw_ok, rw_v, rw_y, rw_z, rw_f, warm_kidx, warm_w, warm_n, Ws, ks, rd,
// obj_const, then the state's 23, then (MoE) rd_scalars, duals, rdv32,
// rdv64, bp32, E32, bp64, E64, ks32, Ws32, P0, count.
int dtk_bnb_seed(const long long* ptrs, const int* dims, void* stream) {
  SeedParams p;
  p.L = dims[0];
  p.cap = dims[1];
  p.nf = dims[2];
  p.m = dims[3];
  p.M = dims[4];
  p.n_k = dims[5];
  p.has_root_warm = dims[6];
  p.has_warm = dims[7];
  p.rd_stride = dims[8];
  if (p.L <= 0 || p.n_k <= 0 || p.n_k > p.cap || 2 * p.M > p.nf) return (int)cudaErrorInvalidValue;
  const void** in[] = {(const void**)&p.lo_k, (const void**)&p.hi_k, (const void**)&p.rw_ok,
                       (const void**)&p.rw_v, (const void**)&p.rw_y, (const void**)&p.rw_z,
                       (const void**)&p.rw_f, (const void**)&p.warm_kidx,
                       (const void**)&p.warm_w, (const void**)&p.warm_n, (const void**)&p.Ws,
                       (const void**)&p.ks, (const void**)&p.rd, (const void**)&p.obj_const};
  constexpr int n_in = sizeof(in) / sizeof(in[0]);
  for (int i = 0; i < n_in; ++i) *in[i] = (const void*)ptrs[i];
  void** st = reinterpret_cast<void**>(&p.s);
  for (int i = 0; i < STATE_PTRS; ++i) st[i] = (void*)ptrs[n_in + i];
  p.moe = dims[9];
  p.n_dev_rows = dims[10];
  p.count_len = dims[11];
  if (p.moe && (p.has_warm || p.n_dev_rows < 1 || p.n_dev_rows > DEV_ROWS))
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < DEV_ROWS; ++r) p.dev_rows[r] = dims[12 + r];
  const void** moe_in[] = {(const void**)&p.rd_scalars, (const void**)&p.duals,
                           (const void**)&p.rdv32, (const void**)&p.rdv64,
                           (const void**)&p.bp32, (const void**)&p.E32,
                           (const void**)&p.bp64, (const void**)&p.E64,
                           (const void**)&p.ks32, (const void**)&p.Ws32, (const void**)&p.P0,
                           (const void**)&p.count};
  constexpr int n_moe = sizeof(moe_in) / sizeof(moe_in[0]);
  for (int i = 0; i < n_moe; ++i) *moe_in[i] = (const void*)ptrs[n_in + STATE_PTRS + i];
  const size_t sm = (size_t)dtk_bnb_seed_smem(p.nf, p.M);
  if (sm > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(bnb_seed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t elems = (size_t)p.L * p.cap * (p.nf > p.m ? p.nf : p.m);
  size_t grid = (elems + SEED_THREADS * 4 - 1) / (SEED_THREADS * 4);
  if (grid > 1024) grid = 1024;
  if (grid < (size_t)p.L) grid = p.L;  // a block a lane for the lane's scalars
  bnb_seed_kernel<<<(unsigned)grid, SEED_THREADS, sm, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The MoE seed's dynamic shared memory: a flag a k.
long dtk_bnb_seed_moe_smem(int n_k) { return (long)sizeof(int) * (n_k > 0 ? n_k : 1); }

// dims: L, cap, n_k, M, phase, cold, has_warm, Y, rd_stride, then the
// packed rows of has_gpu, ram_minus_n, cuda_rhs, metal_rhs, eb_ram,
// eb_vram, eb_metal, ram_rhs; ptrs: obj_const, bound, margin, lam, mu, tau,
// duals_in, duals_out, hint_w, hint_flat, rd, bp64, hint_v, warm_kidx,
// warm_w, warm_n, warm_y, Ws, ks, warm_v, warm_W, warm_k, r_obj, r_w, r_n,
// r_y, then the state's 23.
int dtk_bnb_seed_moe(const long long* ptrs, const int* dims, void* stream) {
  MoeSeedParams p;
  p.L = dims[0];
  p.cap = dims[1];
  p.n_k = dims[2];
  p.M = dims[3];
  p.phase = dims[4];
  p.cold = dims[5];
  p.has_warm = dims[6];
  p.Y = dims[7];
  p.rd_stride = dims[8];
  p.rd_has_gpu = dims[9];
  p.rd_ram_minus_n = dims[10];
  p.rd_cuda_rhs = dims[11];
  p.rd_metal_rhs = dims[12];
  p.rd_eb_ram = dims[13];
  p.rd_eb_vram = dims[14];
  p.rd_eb_metal = dims[15];
  p.rd_ram_rhs = dims[16];
  if (p.L <= 0 || p.n_k <= 0 || p.n_k > p.cap || p.M <= 0 || p.Y <= 0 || p.phase < 0 ||
      p.phase > 2)
    return (int)cudaErrorInvalidValue;
  const void** slots[] = {
      (const void**)&p.obj_const, (const void**)&p.bound, (const void**)&p.margin,
      (const void**)&p.lam, (const void**)&p.mu, (const void**)&p.tau, (const void**)&p.duals_in,
      (const void**)&p.duals_out, (const void**)&p.hint_w, (const void**)&p.hint_flat,
      (const void**)&p.rd, (const void**)&p.bp64, (const void**)&p.hint_v,
      (const void**)&p.warm_kidx, (const void**)&p.warm_w, (const void**)&p.warm_n,
      (const void**)&p.warm_y, (const void**)&p.Ws, (const void**)&p.ks,
      (const void**)&p.warm_v, (const void**)&p.warm_W, (const void**)&p.warm_k,
      (const void**)&p.r_obj, (const void**)&p.r_w, (const void**)&p.r_n, (const void**)&p.r_y};
  constexpr int n = sizeof(slots) / sizeof(slots[0]);
  for (int i = 0; i < n; ++i) *slots[i] = (const void*)ptrs[i];
  void** st = reinterpret_cast<void**>(&p.s);
  for (int i = 0; i < STATE_PTRS; ++i) st[i] = (void*)ptrs[n + i];
  const size_t sm = (size_t)dtk_bnb_seed_moe_smem(p.n_k);
  if (sm > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bnb_seed_moe_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
    if (err != cudaSuccess) return (int)err;
  }
  bnb_seed_moe_kernel<<<p.L, MOE_SEED_THREADS, sm, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dims: L, B, cap, nf, m, n_k, moe, M, nnz, pdhg, lp_f64, mesh_S, ms,
// blk_rows, wk; ptrs: lo, hi, kidx, active, nv, ny, nz, nf, nwarm, frozen,
// b_k, c_k, then the 10 outputs, then (MoE) gky, gky_pos, A_rows, vals, Ws,
// ks, Wr, kr, then (lp_f64) b64, c64, l64, u64, wv64, wy64, vals64, then
// (row mesh, MoE) gky_mesh.
int dtk_bnb_head(const long long* ptrs, const int* dims, void* stream) {
  HeadParams p;
  p.L = dims[0];
  p.B = dims[1];
  p.cap = dims[2];
  p.nf = dims[3];
  p.m = dims[4];
  p.n_k = dims[5];
  if (p.L <= 0 || p.B <= 0 || p.B > p.cap) return (int)cudaErrorInvalidValue;
  const void** slots[] = {
      (const void**)&p.lo, (const void**)&p.hi, (const void**)&p.kidx, (const void**)&p.active,
      (const void**)&p.nv, (const void**)&p.ny, (const void**)&p.nz, (const void**)&p.nfd,
      (const void**)&p.nwarm, (const void**)&p.frozen, (const void**)&p.b_k,
      (const void**)&p.c_k, (const void**)&p.b, (const void**)&p.c, (const void**)&p.l,
      (const void**)&p.u, (const void**)&p.wv, (const void**)&p.wy, (const void**)&p.wz,
      (const void**)&p.wf, (const void**)&p.wok, (const void**)&p.skip,
      (const void**)&p.gky, (const void**)&p.gky_pos, (const void**)&p.A_rows,
      (const void**)&p.vals, (const void**)&p.Ws, (const void**)&p.ks, (const void**)&p.Wr,
      (const void**)&p.kr, (const void**)&p.b64, (const void**)&p.c64, (const void**)&p.l64,
      (const void**)&p.u64, (const void**)&p.wv64, (const void**)&p.wy64,
      (const void**)&p.vals64, (const void**)&p.gky_mesh};
  constexpr int n = sizeof(slots) / sizeof(slots[0]);
  for (int i = 0; i < n; ++i) *slots[i] = (const void*)ptrs[i];
  p.moe = dims[6];
  p.M = dims[7];
  p.nnz = dims[8];
  p.pdhg = dims[9];
  p.lp_f64 = dims[10];
  p.mesh_S = dims[11];
  p.ms = dims[12];
  p.blk_rows = dims[13];
  p.wk = dims[14];
  if (p.mesh_S < 0 || (p.mesh_S > 0 && (!p.pdhg || p.ms <= 0 || (long)p.mesh_S * p.ms < p.m ||
                                          p.blk_rows < (long)p.L * p.B)))
    return (int)cudaErrorInvalidValue;
  if (p.mesh_S > 0 && p.moe && p.gky_mesh == nullptr) return (int)cudaErrorInvalidValue;
  if (p.wk && (p.Wr == nullptr || p.kr == nullptr || p.Ws == nullptr || p.ks == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p.moe && (p.M <= 0 || 6 * p.M > p.m || 3 * p.M > p.nf)) return (int)cudaErrorInvalidValue;
  if (p.moe && (p.lp_f64 ? p.vals64 == nullptr : p.vals == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p.moe && !p.pdhg && p.A_rows == nullptr) return (int)cudaErrorInvalidValue;
  if (p.lp_f64 && (!p.pdhg || p.b64 == nullptr || p.c64 == nullptr || p.l64 == nullptr ||
                   p.u64 == nullptr || p.wv64 == nullptr || p.wy64 == nullptr))
    return (int)cudaErrorInvalidValue;
  bnb_head_kernel<<<p.L * p.B, HEAD_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dims: R, nf, m; ptrs: v64, y64, z64, f64, obj64, rp64, rd64, mu64, then
// the float32 v, y, z, f, obj, rp, rd, mu, then reduced (in place).
int dtk_bnb_cast(const long long* ptrs, const int* dims, void* stream) {
  CastParams p;
  p.R = dims[0];
  p.nf = dims[1];
  p.m = dims[2];
  if (p.R <= 0 || p.nf <= 0 || p.m <= 0) return (int)cudaErrorInvalidValue;
  const void** slots[] = {
      (const void**)&p.v64, (const void**)&p.y64, (const void**)&p.z64, (const void**)&p.f64,
      (const void**)&p.obj64, (const void**)&p.rp64, (const void**)&p.rd64,
      (const void**)&p.mu64, (const void**)&p.v, (const void**)&p.y, (const void**)&p.z,
      (const void**)&p.f, (const void**)&p.obj, (const void**)&p.rp, (const void**)&p.rd,
      (const void**)&p.mu, (const void**)&p.reduced};
  static_assert(sizeof(slots) / sizeof(slots[0]) == CAST_PTRS, "cast pointer table");
  for (int i = 0; i < CAST_PTRS; ++i) {
    *slots[i] = (const void*)ptrs[i];
    if (*slots[i] == nullptr) return (int)cudaErrorInvalidValue;
  }
  const size_t elems = (size_t)p.R * (p.nf > p.m ? p.nf : p.m);
  size_t grid = (elems + CAST_THREADS * 4 - 1) / (CAST_THREADS * 4);
  if (grid > 1024) grid = 1024;
  if (grid < 1) grid = 1;
  bnb_cast_kernel<<<(unsigned)grid, CAST_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dims: R, m, S, ms, blk_rows, f64; ptrs: src (the S dual blocks), dst
// (R, m).
int dtk_bnb_gather(const long long* ptrs, const int* dims, void* stream) {
  GatherParams p;
  p.R = dims[0];
  p.m = dims[1];
  const int S = dims[2];
  p.ms = dims[3];
  p.blk_rows = dims[4];
  p.f64 = dims[5];
  p.src = (const void*)ptrs[0];
  p.dst = (void*)ptrs[1];
  if (p.R <= 0 || p.m <= 0 || S <= 0 || p.ms <= 0 || (long)S * p.ms < p.m ||
      p.blk_rows < p.R || p.src == nullptr || p.dst == nullptr)
    return (int)cudaErrorInvalidValue;
  size_t grid = ((size_t)p.R * p.m + CAST_THREADS * 4 - 1) / (CAST_THREADS * 4);
  if (grid > 1024) grid = 1024;
  if (grid < 1) grid = 1;
  bnb_gather_kernel<<<(unsigned)grid, CAST_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dims: L, cap, n_k, per_k, max_rounds, init, B0, Bw, trace_words; ptrs:
// go, active, bound, kidx, inc, dropped, pkb, pkd, frozen, ran, ctl, then
// (the round log; null: none) log, b_active, b_iters, a_active, a_bound,
// a_inc, a_dropped, a_iters, trace.
int dtk_bnb_control(const long long* ptrs, const int* dims, double mip_gap,
                    unsigned long long handle, void* stream) {
  ControlParams p;
  p.L = dims[0];
  p.cap = dims[1];
  p.n_k = dims[2];
  p.per_k = dims[3];
  p.max_rounds = dims[4];
  p.init = dims[5];
  p.B0 = dims[6];
  p.Bw = dims[7];
  p.trace_words = dims[8];
  p.mip_gap = mip_gap;
  p.handle = (cudaGraphConditionalHandle)handle;
  if (p.L <= 0 || p.trace_words < 0) return (int)cudaErrorInvalidValue;
  const void** slots[] = {(const void**)&p.go,  (const void**)&p.active, (const void**)&p.bound,
                          (const void**)&p.kidx, (const void**)&p.inc, (const void**)&p.dropped,
                          (const void**)&p.pkb, (const void**)&p.pkd, (const void**)&p.frozen,
                          (const void**)&p.ran, (const void**)&p.ctl, (const void**)&p.log,
                          (const void**)&p.b_active, (const void**)&p.b_iters,
                          (const void**)&p.a_active, (const void**)&p.a_bound,
                          (const void**)&p.a_inc, (const void**)&p.a_dropped,
                          (const void**)&p.a_iters, (const void**)&p.trace};
  constexpr int n = sizeof(slots) / sizeof(slots[0]);
  for (int i = 0; i < n; ++i) *slots[i] = (const void*)ptrs[i];
  if (p.log != nullptr) {
    if (p.B0 <= 0 || p.B0 > p.cap || p.Bw <= 0 || p.Bw > p.cap ||
        (p.trace_words > 0 && p.trace == nullptr))
      return (int)cudaErrorInvalidValue;
    if (!p.init && (p.b_active == nullptr || p.b_iters == nullptr || p.a_active == nullptr ||
                    p.a_bound == nullptr || p.a_inc == nullptr || p.a_dropped == nullptr ||
                    p.a_iters == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  bnb_control_kernel<<<1, CONTROL_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dims: L, cap, nf, m, M, n_k, per_k, B0, width, has_root_warm, dual_w,
// my_size, log_rows, trace_rows, trace_f64; ptrs: the state's 23, ran, rv,
// ry, rz, rf, rw_ok, rw_v, rw_y, rw_z, rw_f, out, duals, my, log, trace.
int dtk_bnb_answer(const long long* ptrs, const int* dims, void* stream) {
  AnswerParams p;
  p.L = dims[0];
  p.cap = dims[1];
  p.nf = dims[2];
  p.m = dims[3];
  p.M = dims[4];
  p.n_k = dims[5];
  p.per_k = dims[6];
  p.B0 = dims[7];
  p.width = dims[8];
  p.has_root_warm = dims[9];
  if (p.L <= 0 || p.B0 < p.n_k) return (int)cudaErrorInvalidValue;
  void** st = reinterpret_cast<void**>(&p.s);
  for (int i = 0; i < STATE_PTRS; ++i) st[i] = (void*)ptrs[i];
  const void** slots[] = {(const void**)&p.ran, (const void**)&p.rv, (const void**)&p.ry,
                          (const void**)&p.rz, (const void**)&p.rf, (const void**)&p.rw_ok,
                          (const void**)&p.rw_v, (const void**)&p.rw_y, (const void**)&p.rw_z,
                          (const void**)&p.rw_f, (const void**)&p.out,
                          (const void**)&p.duals, (const void**)&p.my, (const void**)&p.log,
                          (const void**)&p.trace};
  constexpr int n = sizeof(slots) / sizeof(slots[0]);
  for (int i = 0; i < n; ++i) *slots[i] = (const void*)ptrs[STATE_PTRS + i];
  p.dual_w = dims[10];
  p.my_size = dims[11];
  p.log_rows = dims[12];
  p.trace_rows = dims[13];
  p.trace_f64 = dims[14];
  if ((p.dual_w > 0 && p.duals == nullptr) || (p.my_size > 0 && p.my == nullptr) ||
      p.log_rows < 0 || p.trace_rows < 0 || (p.log_rows > 0 && p.log == nullptr) ||
      (p.trace_rows > 0 && p.trace == nullptr))
    return (int)cudaErrorInvalidValue;
  bnb_answer_kernel<<<p.L, ANSWER_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// A new graph and the handle of its WHILE node (0 at every launch until a
// control kernel sets it).
int dtk_bnb_graph_new(void** graph, unsigned long long* handle) {
  Graph* g = new Graph();
  cudaError_t err = cudaGraphCreate(&g->g, 0);
  if (err == cudaSuccess) {
    err = cudaGraphConditionalHandleCreate(&g->handle, g->g, 0, cudaGraphCondAssignDefault);
  }
  if (err != cudaSuccess) {
    if (g->g) cudaGraphDestroy(g->g);
    delete g;
    return (int)err;
  }
  *graph = g;
  *handle = (unsigned long long)g->handle;
  return 0;
}

// Capture of one part (prologue, body, epilogue) on `stream`: this thread's
// own capture, so another thread's CUDA calls go on meanwhile.
int dtk_bnb_capture_begin(void* stream) {
  return (int)cudaStreamBeginCapture((cudaStream_t)stream, cudaStreamCaptureModeThreadLocal);
}

int dtk_bnb_capture_end(void* stream, void** part) {
  cudaGraph_t g = nullptr;
  cudaError_t err = cudaStreamEndCapture((cudaStream_t)stream, &g);
  if (err != cudaSuccess) {
    if (g) cudaGraphDestroy(g);
    return (int)err;
  }
  *part = g;
  return 0;
}

// prologue -> WHILE { body } -> epilogue, instantiated. The parts are
// cloned into the graph and destroyed here.
int dtk_bnb_graph_finish(void* graph, void* prologue, void* body, void* epilogue) {
  Graph* g = (Graph*)graph;
  cudaGraph_t parts[3] = {(cudaGraph_t)prologue, (cudaGraph_t)body, (cudaGraph_t)epilogue};
  cudaGraphNode_t pro, cond, inner, epi;
  cudaError_t err = cudaGraphAddChildGraphNode(&pro, g->g, nullptr, 0, parts[0]);
  cudaGraphNodeParams cp = {};
  if (err == cudaSuccess) {
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = g->handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    err = cudaGraphAddNode(&cond, g->g, &pro, 1, &cp);
  }
  if (err == cudaSuccess) {
    err = cudaGraphAddChildGraphNode(&inner, cp.conditional.phGraph_out[0], nullptr, 0, parts[1]);
  }
  if (err == cudaSuccess) err = cudaGraphAddChildGraphNode(&epi, g->g, &cond, 1, parts[2]);
  if (err == cudaSuccess) err = cudaGraphInstantiate(&g->exec, g->g, 0);
  for (cudaGraph_t part : parts) {
    if (part) cudaGraphDestroy(part);
  }
  return (int)err;
}

int dtk_bnb_graph_launch(void* graph, void* stream) {
  Graph* g = (Graph*)graph;
  if (g->exec == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGraphLaunch(g->exec, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

void dtk_bnb_graph_free(void* graph) {
  Graph* g = (Graph*)graph;
  if (g == nullptr) return;
  if (g->exec) cudaGraphExecDestroy(g->exec);
  if (g->g) cudaGraphDestroy(g->g);
  delete g;
}

void dtk_bnb_graph_discard(void* part) {
  if (part) cudaGraphDestroy((cudaGraph_t)part);
}

}  // extern "C"
