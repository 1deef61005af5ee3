// The branch-and-bound loop of a dense IPM sweep on the card: the seeded
// root state, every round's LP inputs, the loop's control and the answer,
// and the CUDA graph that runs them with K1 (ipm_kernel.cu) and the round
// tail (round_tail_kernel.cu) between, the loop as a conditional WHILE node.
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
//     K1                dtk_ipm_f32 on the plan's buffers;
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
};

// search._bnb_round's gathers of a round's LP inputs, a block a row.
__global__ void __launch_bounds__(HEAD_THREADS) bnb_head_kernel(const __grid_constant__ HeadParams p) {
  const size_t row = blockIdx.x;
  const size_t lane = row / p.B, r = row % p.B;
  const size_t slot = lane * p.cap + r;
  const size_t nf = p.nf, m = p.m;
  const size_t k = (size_t)p.kidx[slot];
  const size_t kb = lane * p.n_k + k;
  for (size_t j = threadIdx.x; j < nf; j += blockDim.x) {
    const size_t o = row * nf + j, so = slot * nf + j;
    p.c[o] = p.c_k[kb * nf + j];
    p.l[o] = p.lo[so];
    p.u[o] = p.hi[so];
    p.wv[o] = p.nv[so];
    p.wz[o] = p.nz[so];
    p.wf[o] = p.nfd[so];
  }
  for (size_t i = threadIdx.x; i < m; i += blockDim.x) {
    p.b[row * m + i] = p.b_k[kb * m + i];
    p.wy[row * m + i] = p.ny[slot * m + i];
  }
  if (threadIdx.x == 0) {
    p.wok[row] = p.nwarm[slot] ? 1 : 0;
    const bool live = p.active[slot] && !(p.frozen != nullptr && p.frozen[lane]);
    p.skip[row] = live ? 0 : 1;
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

__global__ void __launch_bounds__(CONTROL_THREADS) bnb_control_kernel(const __grid_constant__ ControlParams p) {
  __shared__ int s_any;
  __shared__ int s_run;
  const int tid = threadIdx.x;
  if (tid == 0) s_any = 0;
  __syncthreads();
  if (p.init) {
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
  // After a round: the tail's flags decide the next one.
  const bool stopped = p.ctl[1] != 0;
  if (!stopped) {
    for (int l = tid; l < p.L; l += blockDim.x) {
      if (p.go[l]) atomicOr(&s_any, 1);
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

// dims: L, cap, nf, m, M, n_k, has_root_warm, has_warm, rd_stride;
// ptrs: lo_k, hi_k, rw_ok, rw_v, rw_y, rw_z, rw_f, warm_kidx, warm_w,
// warm_n, Ws, ks, rd, obj_const, then the state's 23.
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

// dims: L, B, cap, nf, m, n_k; ptrs: lo, hi, kidx, active, nv, ny, nz, nf,
// nwarm, frozen, b_k, c_k, then the 10 outputs.
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
      (const void**)&p.wf, (const void**)&p.wok, (const void**)&p.skip};
  constexpr int n = sizeof(slots) / sizeof(slots[0]);
  for (int i = 0; i < n; ++i) *slots[i] = (const void*)ptrs[i];
  bnb_head_kernel<<<p.L * p.B, HEAD_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dims: L, cap, n_k, per_k, max_rounds, init; ptrs: go, active, bound,
// kidx, inc, dropped, pkb, pkd, frozen, ran, ctl.
int dtk_bnb_control(const long long* ptrs, const int* dims, double mip_gap,
                    unsigned long long handle, void* stream) {
  ControlParams p;
  p.L = dims[0];
  p.cap = dims[1];
  p.n_k = dims[2];
  p.per_k = dims[3];
  p.max_rounds = dims[4];
  p.init = dims[5];
  p.mip_gap = mip_gap;
  p.handle = (cudaGraphConditionalHandle)handle;
  if (p.L <= 0) return (int)cudaErrorInvalidValue;
  const void** slots[] = {(const void**)&p.go,  (const void**)&p.active, (const void**)&p.bound,
                          (const void**)&p.kidx, (const void**)&p.inc, (const void**)&p.dropped,
                          (const void**)&p.pkb, (const void**)&p.pkd, (const void**)&p.frozen,
                          (const void**)&p.ran, (const void**)&p.ctl};
  constexpr int n = sizeof(slots) / sizeof(slots[0]);
  for (int i = 0; i < n; ++i) *slots[i] = (const void*)ptrs[i];
  bnb_control_kernel<<<1, CONTROL_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dims: L, cap, nf, m, M, n_k, per_k, B0, width, has_root_warm; ptrs: the
// state's 23, ran, rv, ry, rz, rf, rw_ok, rw_v, rw_y, rw_z, rw_f, out.
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
                          (const void**)&p.rw_f, (const void**)&p.out};
  constexpr int n = sizeof(slots) / sizeof(slots[0]);
  for (int i = 0; i < n; ++i) *slots[i] = (const void*)ptrs[STATE_PTRS + i];
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
