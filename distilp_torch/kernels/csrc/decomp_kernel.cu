// K7: the Lagrangian decomposition bound of the MoE MILP, evaluated per
// (k-candidate, device) over the device's whole integer lattice, and the
// multiplier ascent that tightens it.
//
// Replaces distilp_tpu/solver/backend_jax.py::_decomp_terms,
// ::_decomp_terms_for_w and ::_decomp_bound_roots: the float32 bound and its
// gradient that the Adam ascent evaluates once per step (the lax.scan at
// :1050-1085), and the float64 evaluation at the chosen multipliers. Each
// cell (candidate c of the five n candidates {0, w, the VRAM boundary, the
// RAM-slack kink, the s <= w endpoint}, layers w in [1, w_max], experts y in
// [0, e_max]) is priced exactly as the MILP prices it (integer ceil slacks,
// penalties, busy constant): the 5-D tensor the reference builds is never
// materialized.
//
//   term = lin + theta cyc - lambda w - mu y     (ok cells; else +inf/3.4e37)
//
// Five entries:
// - dtk_decomp_ascent_f32, the whole ascent in one cooperative launch: the
//   lattice is cut into work units (instance s, k, device i, a chunk of w),
//   one block each, spread over every SM; for each of the steps + 1
//   evaluations every unit writes its partial accumulator (minimum, tie
//   count, tie sums of w, y and cyc) into its fixed slot; after one grid
//   sync every block folds the slots of its units' (s, k) in chunk order,
//   forms the bound, keeps the best multipliers (strict >), and takes the
//   Adam step with the gradient of the plain version (ops/decomp.py::
//   bound_grads: softmax over the devices, sums in device order) and the
//   host's per-step (lr, 1 - b1^t, 1 - b2^t). Each block keeps its own copy
//   of those multipliers, one per unit it holds, in shared memory (in global
//   memory, one copy a unit, where shared memory cannot hold a block's
//   copies at the grid's size): the copies take the same steps on the same
//   slots, so they stay equal and nothing is published between steps (the
//   slots alternate between two rounds). The cells' (lin, cyc),
//   which do not depend on the multipliers, are priced once per launch into
//   global memory (lin NaN where the cell is not ok) and re-read every step
//   from L2: twice as fast as pricing them again every step on every
//   instance timed (20 MB for the flagship).
// - dtk_decomp_eval_f32: one float32 evaluation per launch (bound and tie
//   means per (k, i)), one block per (k, i, s); what DecompBound32 and the
//   card's step-by-step yardstick of the ascent launch.
// - dtk_decomp_eval_f64 (the final evaluation): per (k, i, y) the minimum
//   over candidates and w (m_y), whether any cell is ok, and, when asked,
//   the Lagrangian-primal hint: the smallest w attaining the minimum and
//   within it the first (candidate, y) in candidate-major order. Work units
//   as the ascent's, one block each; the last unit of a (k, i, s) to finish
//   folds the row's partials in chunk order.
// - dtk_decomp_theta_f64 and dtk_decomp_bound_f64, the float64 folds around
//   that evaluation (theta = (k - 1) softmax(tau) before it, the per-k bound
//   from m_y after it), devices summed in order:
//   the host route and the loop's CUDA graph both run them, so the two
//   routes' root bounds agree bit for bit.
//
// A unit prices its cells with the per-step entry's functions (y_terms,
// n_cand, cell) and forms the term with the same expression (a cell that is
// not ok has a NaN lin, so a NaN term, which no comparison takes, as the
// per-step entry skips it), so each evaluation inside the ascent is the
// per-step entry's at the same multipliers: the minimum, the count and the
// integer tie sums are order-free, only the tie sum of cyc is added in
// another order.
//
// Instance axis: every entry evaluates S instances in one launch (a MoE
// scenario batch, whose S ascents run in lockstep as the reference's vmap
// runs them): every input carries a leading instance axis (the packed
// vectors, b', E, the k grid, the multipliers).
//
// Every rd vector arrives already cast to the evaluation's dtype, and every
// expression keeps the reference's order of operations; the library is built
// with --fmad=false, because the ceil(x / b' - 1e-9) staircases flip on one
// ulp.
//
// What bounds it on an H100: operations. One evaluation prices
// 5 n_k M w_max (e_max + 1) cells (DeepSeek-V3 on 32 devices: 2.5 M cells,
// ~60 operations each) from a few kilobytes of input; the ascent does that
// steps + 1 times. The design keeps every SM busy (the flagship's 32
// (k, i) rows cut into 8 w-chunks each), reads the cells' 8 bytes from L2
// instead of pricing them again, keeps the 300 steps on the card (one grid
// sync a step, no launch and no host step), and reduces in a fixed order
// without atomics on values (a run repeats bit for bit).

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using namespace dtk;
namespace cg = cooperative_groups;

// Rows of the packed per-device matrix (DR_ROWS, M), in the dtype of the
// evaluation.
enum {
  DR_A = 0,
  DR_B_GPU,
  DR_PEN_SET,
  DR_PEN_VRAM,
  DR_BUSY_CONST,
  DR_S_DISK,
  DR_RAM_RHS,
  DR_RAM_MINUS_N,
  DR_CUDA_RHS,
  DR_METAL_RHS,
  DR_HAS_GPU,
  DR_EB_RAM,
  DR_EB_VRAM,
  DR_EB_METAL,
  DR_G_RAW,
  DR_ROWS
};

template <typename T>
struct Dev {
  T a, b_gpu, pen_set, pen_vram, busy_const, s_disk, ram_rhs, rm, cuda, metal, hg,
      ebr, ebv, ebm, g_k, bp, Wj, E, half_bs;
};

template <typename T>
__device__ Dev<T> load_dev(const T* rdv, int M, int i, T bp, T kj, T Wj, T E) {
  auto g = [&](int row) { return rdv[(size_t)row * M + i]; };
  Dev<T> d;
  d.a = g(DR_A);
  d.b_gpu = g(DR_B_GPU);
  d.pen_set = g(DR_PEN_SET);
  d.pen_vram = g(DR_PEN_VRAM);
  d.busy_const = g(DR_BUSY_CONST);
  d.s_disk = g(DR_S_DISK);
  d.ram_rhs = g(DR_RAM_RHS);
  d.rm = g(DR_RAM_MINUS_N);
  d.cuda = g(DR_CUDA_RHS);
  d.metal = g(DR_METAL_RHS);
  d.hg = g(DR_HAS_GPU);
  d.ebr = g(DR_EB_RAM);
  d.ebv = g(DR_EB_VRAM);
  d.ebm = g(DR_EB_METAL);
  d.g_k = g(DR_G_RAW) / kj;
  d.bp = bp;
  d.Wj = Wj;
  d.E = E;
  d.half_bs = T(0.5) * (bp / d.s_disk);
  return d;
}

// The y-only parts of a cell row.
template <typename T>
struct YTerms {
  T Y, vram_rhs, smin_arg, ebrY, ebvY, ebmY, gY;
};

template <typename T>
__device__ __forceinline__ YTerms<T> y_terms(const Dev<T>& d, int y) {
  YTerms<T> t;
  t.Y = T(y);
  t.ebrY = d.ebr * t.Y;
  t.ebvY = d.ebv * t.Y;
  t.ebmY = d.ebm * t.Y;
  t.gY = d.g_k * t.Y;
  t.vram_rhs = nan_min(d.cuda - t.ebvY, d.metal - t.ebmY);
  t.smin_arg = (t.ebrY - d.ram_rhs) / d.bp - T(1e-9);
  return t;
}

// n of candidate c at (w, y).
template <typename T>
__device__ __forceinline__ T n_cand(const Dev<T>& d, const YTerms<T>& yt, T Wg, int c) {
  switch (c) {
    case 0:
      return T(0);
    case 1:
      return Wg * d.hg;
    case 2: {
      T nb = clip(floor(yt.vram_rhs / d.bp), T(0), Wg) * d.hg;
      return isfinite(nb) ? nb : Wg * d.hg;
    }
    case 3: {
      T rk = clip(ceil(((d.bp * Wg + yt.ebrY) - d.ram_rhs) / d.bp - T(1e-9)), T(0), Wg)
             * d.hg * d.rm;
      return isfinite(rk) ? rk : T(0);
    }
    default: {
      T ns = clip(ceil(yt.smin_arg), T(0), Wg) * d.hg * d.rm;
      return isfinite(ns) ? ns : T(0);
    }
  }
}

// (ok, lin, cyc) of one cell.
template <typename T>
__device__ __forceinline__ bool cell(const Dev<T>& d, const YTerms<T>& yt, T Wg, T n,
                                     T& lin, T& cyc) {
  const T bp = d.bp;
  const T resident = ((bp * Wg) - (bp * n) * d.rm) + yt.ebrY;
  const T s_ram = ceil(nan_max(resident - d.ram_rhs, T(0)) / bp - T(1e-9));
  bool ok = s_ram <= nan_min(Wg, d.Wj);
  const T bn = bp * n;
  T viol_v = nan_max(nan_max((bn + yt.ebvY) - d.cuda, (bn + yt.ebmY) - d.metal), T(0));
  if (!isfinite(viol_v)) viol_v = T(0);
  const T t = ceil(viol_v / bp - T(1e-9));
  ok = ok && (t <= n + T(1e-9));
  ok = ok && (Wg <= d.Wj) && (yt.Y <= d.E);
  lin = (((d.a * Wg + d.b_gpu * n) + d.pen_set * s_ram) + d.pen_vram * t) + yt.gY;
  cyc = (lin + d.busy_const) + d.half_bs * Wg;
  return ok;
}

constexpr float BIG32 = 3.4e37f;

// Minimum, tie count and tie sums of the ok cells.
struct Acc {
  float mn;
  int cnt;
  double sw, sy, sc;
};

__device__ __forceinline__ void acc_add(Acc& a, float v, double w, double y, double c) {
  if (v < a.mn) {
    a.mn = v;
    a.cnt = 1;
    a.sw = w;
    a.sy = y;
    a.sc = c;
  } else if (v == a.mn) {
    a.cnt += 1;
    a.sw += w;
    a.sy += y;
    a.sc += c;
  }
}

__device__ __forceinline__ void acc_merge(Acc& a, const Acc& b) {
  if (b.cnt == 0) return;
  if (a.cnt == 0 || b.mn < a.mn) {
    a = b;
  } else if (b.mn == a.mn) {
    a.cnt += b.cnt;
    a.sw += b.sw;
    a.sy += b.sy;
    a.sc += b.sc;
  }
}

// Fixed-order block reduction of an Acc: lanes by butterfly, warps in index
// order. The result is thread 0's. ``part`` holds 32 slots of shared memory;
// contains __syncthreads (every thread of the block calls it).
__device__ Acc block_acc(Acc acc, Acc* part) {
  for (int o = 16; o > 0; o >>= 1) {
    Acc b;
    b.mn = __shfl_xor_sync(FULL, acc.mn, o);
    b.cnt = __shfl_xor_sync(FULL, acc.cnt, o);
    b.sw = __shfl_xor_sync(FULL, acc.sw, o);
    b.sy = __shfl_xor_sync(FULL, acc.sy, o);
    b.sc = __shfl_xor_sync(FULL, acc.sc, o);
    // Merge in lane order so both lanes of a pair get the same sums.
    if ((threadIdx.x & o) == 0) {
      acc_merge(acc, b);
    } else {
      acc_merge(b, acc);
      acc = b;
    }
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // the previous call's reader is done with part
  if (lane == 0) part[wid] = acc;
  __syncthreads();
  Acc r = part[0];
  if (threadIdx.x == 0)
    for (int q = 1; q < (int)((blockDim.x + 31) >> 5); ++q) acc_merge(r, part[q]);
  return r;
}

// The per-(k, i) outputs of a folded Acc: a (k, i) with no ok cell reports
// 3.4e37 and zero means.
struct Stat {
  float mn, wbar, ybar, cycbar;
};

__device__ __forceinline__ Stat acc_stat(const Acc& r) {
  if (r.cnt == 0) return {BIG32, 0.0f, 0.0f, 0.0f};
  return {r.mn, (float)(r.sw / r.cnt), (float)(r.sy / r.cnt), (float)(r.sc / r.cnt)};
}

__global__ void decomp_f32_kernel(const float* __restrict__ rdv,
                                  const float* __restrict__ bp_s,
                                  const float* __restrict__ E_s,
                                  const float* __restrict__ ks,
                                  const float* __restrict__ Ws, int M, int w_max,
                                  int e_max, const float* __restrict__ lam,
                                  const float* __restrict__ mu,
                                  const float* __restrict__ theta,
                                  float* __restrict__ bmin, float* __restrict__ wbar,
                                  float* __restrict__ ybar,
                                  float* __restrict__ cycbar) {
  __shared__ Acc part[32];
  const int n_k = gridDim.y;
  const int s = blockIdx.z;
  const int kidx = s * n_k + blockIdx.y;  // (instance, k) row of the k axis
  const int i = blockIdx.x;
  const Dev<float> d = load_dev<float>(rdv + (size_t)s * DR_ROWS * M, M, i, bp_s[s],
                                       ks[kidx], Ws[kidx], E_s[s]);
  const float th = theta[(size_t)kidx * M + i];
  const float lm = lam[kidx];
  const float mm = mu[kidx];
  Acc acc{INFINITY, 0, 0.0, 0.0, 0.0};
  for (int y = threadIdx.x; y <= e_max; y += blockDim.x) {
    const YTerms<float> yt = y_terms(d, y);
    for (int w = 1; w <= w_max; ++w) {
      const float Wg = (float)w;
      for (int c = 0; c < 5; ++c) {
        const float n = n_cand(d, yt, Wg, c);
        float lin, cyc;
        if (!cell(d, yt, Wg, n, lin, cyc)) continue;
        const float term = ((lin + th * cyc) - lm * Wg) - mm * yt.Y;
        acc_add(acc, term, (double)w, (double)y, (double)cyc);
      }
    }
  }
  const Acc r = block_acc(acc, part);
  if (threadIdx.x == 0) {
    const Stat st = acc_stat(r);
    const size_t o = (size_t)kidx * M + i;
    bmin[o] = st.mn;
    wbar[o] = st.wbar;
    ybar[o] = st.ybar;
    cycbar[o] = st.cycbar;
  }
}

// ---------------------------------------------------------------- work units

// Unit u of a launch: row = u / n_chunks is the (instance, k, device) triple
// (row = (s n_k + k) M + i, the index of the (S, n_k, M) outputs), and
// chunk u % n_chunks the layers w in [w0, w0 + nw). Its (w, y) pairs are
// flattened as idx = (w - w0) (e_max + 1) + y.
struct Unit {
  int row, s, k, kidx, i, w0, nw, npairs;
};

__device__ __forceinline__ Unit unit_of(int u, int n_chunks, int chunk_w, int w_max, int M,
                                        int n_k, int Y) {
  Unit t;
  t.row = u / n_chunks;
  const int c = u % n_chunks;
  t.i = t.row % M;
  t.kidx = t.row / M;
  t.k = t.kidx % n_k;
  t.s = t.kidx / n_k;
  t.w0 = 1 + c * chunk_w;
  t.nw = min(chunk_w, w_max - t.w0 + 1);
  t.npairs = t.nw * Y;
  return t;
}

// ---------------------------------------------------------------- the ascent

constexpr int ASC_THREADS = 256;
constexpr int ASC_MAX_BLOCKS_PER_SM = 4;

struct AscParams {
  const float* rdv;   // (S, DR_ROWS, M)
  const float* bp;    // (S,)
  const float* E;     // (S,)
  const float* ks;    // (S, n_k)
  const float* Ws;    // (S, n_k)
  const float* adam;  // (steps, 3): lr, 1 - b1^t, 1 - b2^t of step t
  const float* P0;    // (S, NP): lam (n_k), mu (n_k), tau (n_k M) per instance
  float* best;        // (S, NP) out: the best multipliers seen
  int S, n_k, M, w_max, e_max, steps, chunk_w, n_chunks, units;
  // Owner states a block keeps in shared memory (units u = blockIdx.x + j G,
  // j < per_block); 0: one state a unit in ``owners``.
  int per_block;
  float b1, one_b1, b2, one_b2, eps;  // Adam's constants as float32
  // Workspace (ascent_ws_bytes): two rounds of one Acc slot per unit (an
  // evaluation writes one while the last one's is still being read), the
  // cells' cache, and (per_block == 0) the units' owner states.
  Acc* slots;
  float2* cache;  // (units' cells): (lin or NaN, cyc), [c][idx] per unit
  float* owners;  // (units, owner_floats(M)) or null
};

__device__ __forceinline__ int np_of(const AscParams& a) { return a.n_k * (2 + a.M); }

__device__ __forceinline__ size_t cache_off(const AscParams& a, const Unit& t) {
  return ((size_t)t.row * a.w_max + (t.w0 - 1)) * (size_t)(a.e_max + 1) * 5;
}

__device__ __forceinline__ Dev<float> unit_dev(const AscParams& a, const Unit& t) {
  return load_dev<float>(a.rdv + (size_t)t.s * DR_ROWS * a.M, a.M, t.i, a.bp[t.s],
                         a.ks[t.kidx], a.Ws[t.kidx], a.E[t.s]);
}

// Price the unit's cells once: (lin, cyc), lin NaN where the cell is not ok
// (a NaN term is neither below nor equal to any minimum, as a skipped cell).
// Each thread later reads back the entries it wrote.
__device__ void fill_cache(const AscParams& a, const Unit& t) {
  const Dev<float> d = unit_dev(a, t);
  const int Y = a.e_max + 1;
  float2* cc = a.cache + cache_off(a, t);
  for (int idx = threadIdx.x; idx < t.npairs; idx += blockDim.x) {
    const int w = t.w0 + idx / Y, y = idx % Y;
    const YTerms<float> yt = y_terms(d, y);
    const float Wg = (float)w;
    for (int c = 0; c < 5; ++c) {
      const float n = n_cand(d, yt, Wg, c);
      float lin, cyc;
      const bool ok = cell(d, yt, Wg, n, lin, cyc);
      cc[(size_t)c * t.npairs + idx] = make_float2(ok ? lin : NAN, cyc);
    }
  }
}

// One unit's share of an evaluation at multipliers (theta of its device,
// lambda, mu), from its cells' cache. Thread 0 returns the unit's Acc.
__device__ Acc eval_unit(const AscParams& a, const Unit& t, float th, float lm, float mm,
                         Acc* part) {
  const int Y = a.e_max + 1;
  Acc acc{INFINITY, 0, 0.0, 0.0, 0.0};
  const float2* cc = a.cache + cache_off(a, t);
  for (int idx = threadIdx.x; idx < t.npairs; idx += blockDim.x) {
    const int w = t.w0 + idx / Y, y = idx % Y;
    const float Wg = (float)w, Yf = (float)y;
    for (int c = 0; c < 5; ++c) {
      const float2 lc = cc[(size_t)c * t.npairs + idx];
      const float term = ((lc.x + th * lc.y) - lm * Wg) - mm * Yf;
      acc_add(acc, term, (double)w, (double)y, (double)lc.y);
    }
  }
  return block_acc(acc, part);
}

__device__ __forceinline__ Acc ldcg_acc(const Acc* p) {
  Acc r;
  r.mn = __ldcg(&p->mn);
  r.cnt = __ldcg(&p->cnt);
  r.sw = __ldcg(&p->sw);
  r.sy = __ldcg(&p->sy);
  r.sc = __ldcg(&p->sc);
  return r;
}

// The ascent state of one owner (s, k) as a block keeps it (in shared
// memory, or in global memory where shared memory cannot hold them): its
// M + 2 multipliers (lam, mu, tau) and Adam's moments, the softmax and
// theta of tau, the best bound. Every block that holds a unit of (s, k)
// keeps a copy and takes the same steps on the same slots, so the copies
// stay equal without any exchange.
struct Owner {
  float *pv, *mv, *vv, *soft, *theta, *best_b;
};

__host__ __device__ __forceinline__ size_t owner_floats(int M) { return 5 * (size_t)M + 8; }

// Shared scratch of the update (after the owners' states): the folded
// statistics (mn, w, y, cyc), exp scratch, then the owner's M n_chunks
// slots.
struct Scratch {
  float *mn, *w, *y, *c, *e;
  Acc* acc;
};

__host__ __device__ __forceinline__ size_t scratch_floats(int M) {
  return ((5 * (size_t)M) + 1) & ~(size_t)1;
}

// Copy j of the states starting at ``base``.
__device__ __forceinline__ Owner owner_at(float* base, int M, int j) {
  float* b = base + (size_t)j * owner_floats(M);
  const int J = M + 2;
  return {b, b + J, b + 2 * J, b + 3 * J, b + 3 * J + M, b + 3 * J + 2 * M};
}

__device__ __forceinline__ Scratch scratch_at(float* sh, int M, int per_block) {
  float* b = sh + (size_t)per_block * owner_floats(M);
  Scratch sc;
  sc.mn = b;
  sc.w = b + M;
  sc.y = b + 2 * M;
  sc.c = b + 3 * M;
  sc.e = b + 4 * M;
  sc.acc = reinterpret_cast<Acc*>(b + scratch_floats(M));
  return sc;
}

// Index in P of multiplier j of owner (s, k): lam, mu, tau_i.
__device__ __forceinline__ size_t param_of(const AscParams& a, int s, int k, int j) {
  const size_t base = (size_t)s * np_of(a);
  return base + (j == 0 ? k : j == 1 ? a.n_k + k : 2 * a.n_k + (size_t)k * a.M + j - 2);
}

// softmax(tau) over the devices as ops/decomp.py::softmax computes it (the
// maximum, exp of the differences, their sum in device order, the
// quotients) and theta = (k - 1) softmax, into the owner's state. Contains
// __syncthreads.
__device__ void set_theta(const AscParams& a, int o, const Owner& w, float* e, float* red) {
  const int M = a.M;
  const float* tau = w.pv + 2;
  if (threadIdx.x == 0) {
    float mx = tau[0];
    for (int i = 1; i < M; ++i) mx = nan_max(mx, tau[i]);
    red[0] = mx;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) e[i] = expf(tau[i] - red[0]);
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int i = 0; i < M; ++i) sum = sum + e[i];
    red[1] = sum;
  }
  __syncthreads();
  const float km1 = a.ks[o] - 1.0f;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const float sm = e[i] / red[1];
    w.soft[i] = sm;
    w.theta[i] = km1 * sm;
  }
  __syncthreads();
}

// Owner o's start: its multipliers from P0, zero moments, theta of P0.
__device__ void owner_init(const AscParams& a, int o, const Owner& w, const Scratch& sc,
                           float* red) {
  const int s = o / a.n_k, k = o % a.n_k;
  for (int j = threadIdx.x; j < a.M + 2; j += blockDim.x) {
    w.pv[j] = a.P0[param_of(a, s, k, j)];
    w.mv[j] = 0.0f;
    w.vv[j] = 0.0f;
  }
  __syncthreads();
  set_theta(a, o, w, sc.e, red);
}

// Owner o = (s, k) after evaluation t, from the slots of its M devices: the
// bound, the best-of (``publish``: this block writes the best multipliers
// out), and (t < steps) the gradient and Adam step t as ops/decomp.py::
// ascend takes it with torch's CUDA operations (m / bc as m * (1 / bc),
// each product and sum rounded on its own: the library contracts nothing),
// then theta of the new multipliers.
__device__ void owner_step(const AscParams& a, int o, int t, const Acc* slots, bool publish,
                           const Owner& w, const Scratch& sc, float* red) {
  const int M = a.M, nc = a.n_chunks, J = M + 2;
  const int s = o / a.n_k, k = o % a.n_k;
  const Acc* sl = slots + (size_t)o * M * nc;  // rows o M + i, nc slots each
  for (int q = threadIdx.x; q < M * nc; q += blockDim.x) sc.acc[q] = ldcg_acc(sl + q);
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    Acc r = sc.acc[i * nc];
    for (int c = 1; c < nc; ++c) acc_merge(r, sc.acc[i * nc + c]);
    const Stat st = acc_stat(r);
    sc.mn[i] = st.mn;
    sc.w[i] = st.wbar;
    sc.y[i] = st.ybar;
    sc.c[i] = st.cycbar;
  }
  __syncthreads();
  const float Ws = a.Ws[o], E = a.E[s], km1 = a.ks[o] - 1.0f;
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int i = 0; i < M; ++i) sum = sum + sc.mn[i];
    const float b = (sum + w.pv[0] * Ws) + w.pv[1] * E;
    float better = 1.0f;
    if (t > 0) {
      better = b > w.best_b[0] ? 1.0f : 0.0f;
      w.best_b[0] = nan_max(w.best_b[0], b);
    } else {
      w.best_b[0] = b;
    }
    red[0] = better;
    if (t < a.steps) {
      // bound_grads at grad_b = -1: sums over the devices in device order.
      float sw = 0.0f, sy = 0.0f, dot = 0.0f;
      for (int i = 0; i < M; ++i) sw = sw + sc.w[i];
      for (int i = 0; i < M; ++i) sy = sy + sc.y[i];
      for (int i = 0; i < M; ++i) dot = dot + w.soft[i] * (km1 * (-1.0f * sc.c[i]));
      red[1] = dot;
      red[2] = -1.0f * (Ws - sw);
      red[3] = -1.0f * (E - sy);
    }
  }
  __syncthreads();
  if (publish && red[0] != 0.0f) {
    for (int j = threadIdx.x; j < J; j += blockDim.x) a.best[param_of(a, s, k, j)] = w.pv[j];
  }
  if (t >= a.steps) return;
  const float lr = a.adam[3 * t], inv1 = 1.0f / a.adam[3 * t + 1],
              inv2 = 1.0f / a.adam[3 * t + 2];
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    float g;
    if (j < 2) {
      g = red[2 + j];
    } else {
      const int i = j - 2;
      const float ct = km1 * (-1.0f * sc.c[i]);
      g = w.soft[i] * ct - w.soft[i] * red[1];
    }
    const float m = a.b1 * w.mv[j] + a.one_b1 * g;
    const float v = a.b2 * w.vv[j] + (a.one_b2 * g) * g;
    w.pv[j] = w.pv[j] - (lr * (m * inv1)) / (sqrtf(v * inv2) + a.eps);
    w.mv[j] = m;
    w.vv[j] = v;
  }
  __syncthreads();
  set_theta(a, o, w, sc.e, red + 4);
}

// The ascent: block b holds units u = b + j G and a copy of each one's
// owner state (kGlobal: unit u's state in the workspace, else copy j in
// shared memory). A step: every unit evaluates at its owner's multipliers
// and writes its slot (round t % 2); one grid sync (reached by every block:
// the loop bounds are launch arguments); every block folds its owners'
// slots and steps their multipliers. The block of an owner's first unit
// writes the best multipliers out.
template <bool kGlobal>
__global__ void __launch_bounds__(ASC_THREADS)
    decomp_ascent_kernel(const __grid_constant__ AscParams a) {
  extern __shared__ float sh[];
  __shared__ Acc part[32];
  __shared__ float red[8];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, M = a.M, Y = a.e_max + 1, per_row = a.n_chunks * M;
  const Scratch sc = scratch_at(sh, M, kGlobal ? 0 : a.per_block);
  auto owner = [&](int j, int u) {
    return kGlobal ? owner_at(a.owners, M, u) : owner_at(sh, M, j);
  };
  for (int j = 0, u = blockIdx.x; u < a.units; ++j, u += G) {
    const Unit t = unit_of(u, a.n_chunks, a.chunk_w, a.w_max, M, a.n_k, Y);
    owner_init(a, t.kidx, owner(j, u), sc, red);
    fill_cache(a, t);
  }
  for (int t = 0; t <= a.steps; ++t) {
    Acc* slots = a.slots + (size_t)(t & 1) * a.units;
    for (int j = 0, u = blockIdx.x; u < a.units; ++j, u += G) {
      const Unit ut = unit_of(u, a.n_chunks, a.chunk_w, a.w_max, M, a.n_k, Y);
      const Owner w = owner(j, u);
      const Acc r = eval_unit(a, ut, w.theta[ut.i], w.pv[0], w.pv[1], part);
      if (threadIdx.x == 0) slots[u] = r;
    }
    grid.sync();
    for (int j = 0, u = blockIdx.x; u < a.units; ++j, u += G) {
      const int o = u / per_row;
      owner_step(a, o, t, slots, u % per_row == 0, owner(j, u), sc, red);
    }
  }
}

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

// Workspace of the ascent: two rounds of slots, the cache, then (per_block
// == 0) one owner state a unit.
size_t ascent_ws_bytes(int units, long cells, int M, int per_block) {
  const size_t owners = per_block > 0 ? 0 : sizeof(float) * (size_t)units * owner_floats(M);
  return align_up(sizeof(Acc) * 2 * (size_t)units) + align_up(sizeof(float2) * (size_t)cells) +
         owners;
}

// Most slots an owner folds: M n_chunks <= max(M, the grid), and the grid
// is at most ASC_MAX_BLOCKS_PER_SM blocks an SM.
size_t owner_slots(int M, int sms) {
  const size_t g = (size_t)ASC_MAX_BLOCKS_PER_SM * sms;
  return (size_t)M > g ? (size_t)M : g;
}

// Shared memory of a block holding ``per_block`` owner states (0: none).
size_t ascent_smem(int M, int sms, int per_block) {
  return sizeof(float) * ((size_t)per_block * owner_floats(M) + scratch_floats(M)) +
         sizeof(Acc) * owner_slots(M, sms);
}

const void* ascent_fn(int per_block) {
  return per_block > 0 ? (const void*)decomp_ascent_kernel<false>
                       : (const void*)decomp_ascent_kernel<true>;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// ---------------------------------------------------------------- float64

struct F64Params {
  const double *rdv, *bp, *E, *ks, *Ws, *lam, *mu, *theta;
  int S, n_k, M, w_max, e_max, track_hint, chunk_w, n_chunks;
  double* part_my;   // (units, e_max + 1)
  double* part_best; // (units,)
  int* part_key;     // (units,)
  int* part_ok;      // (units,)
  int* count;        // (S n_k M,) zeroed by the caller
  double* m_y;
  unsigned char* any_ok;
  double* hint_w;
  int* hint_flat;
};

size_t f64_ws_bytes(int units, int Y) {
  return align_up(sizeof(double) * (size_t)units * Y) + align_up(sizeof(double) * units) +
         2 * align_up(sizeof(int) * (size_t)units);
}

// (term, key) before (best, best_key): the reference's first w (ascending,
// strict <) and within it its flat (c, y) argmin; a NaN term never wins.
__device__ __forceinline__ bool hint_before(double v, int key, double best, int best_key) {
  return v < best || (v == best && key < best_key);
}

__global__ void decomp_f64_kernel(const __grid_constant__ F64Params a) {
  __shared__ double red_v[32];
  __shared__ int red_i[32];
  __shared__ int last;
  const int Y = a.e_max + 1;
  const int u = blockIdx.x;
  const Unit t = unit_of(u, a.n_chunks, a.chunk_w, a.w_max, a.M, a.n_k, Y);
  const Dev<double> d = load_dev<double>(a.rdv + (size_t)t.s * DR_ROWS * a.M, a.M, t.i,
                                         a.bp[t.s], a.ks[t.kidx], a.Ws[t.kidx], a.E[t.s]);
  const double th = a.theta[t.row];
  const double lm = a.lam[t.kidx];
  const double mm = a.mu[t.kidx];
  int ok_any = 0;
  // Best cell by (term, then key = ((w - 1) 5 + c) Y + y).
  double best = INFINITY;
  int best_key = INT_MAX;
  for (int y = threadIdx.x; y <= a.e_max; y += blockDim.x) {
    const YTerms<double> yt = y_terms(d, y);
    double my = INFINITY;
    for (int w = t.w0; w < t.w0 + t.nw; ++w) {
      const double Wg = (double)w;
      for (int c = 0; c < 5; ++c) {
        const double n = n_cand(d, yt, Wg, c);
        double lin, cyc;
        if (!cell(d, yt, Wg, n, lin, cyc)) continue;
        ok_any = 1;
        const double term = ((lin + th * cyc) - lm * Wg) - mm * yt.Y;
        my = nan_min(my, term);
        const int key = ((w - 1) * 5 + c) * Y + y;
        if (hint_before(term, key, best, best_key)) {
          best = term;
          best_key = key;
        }
      }
    }
    a.part_my[(size_t)u * Y + y] = my;
  }
  ok_any = __syncthreads_or(ok_any);
  if (a.track_hint) {
    // Block argmin over (best, best_key); a thread with no finite cell holds
    // (+inf, INT_MAX) and never wins against a finite one.
    for (int o = 16; o > 0; o >>= 1) {
      const double v2 = __shfl_xor_sync(FULL, best, o);
      const int k2 = __shfl_xor_sync(FULL, best_key, o);
      if (hint_before(v2, k2, best, best_key)) {
        best = v2;
        best_key = k2;
      }
    }
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (lane == 0) {
      red_v[wid] = best;
      red_i[wid] = best_key;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int q = 1; q < (int)((blockDim.x + 31) >> 5); ++q) {
        if (hint_before(red_v[q], red_i[q], best, best_key)) {
          best = red_v[q];
          best_key = red_i[q];
        }
      }
    }
  }
  if (threadIdx.x == 0) {
    a.part_ok[u] = ok_any;
    a.part_best[u] = best;
    a.part_key[u] = best_key;
  }
  // The last unit of the row to finish folds the row (threadFenceReduction).
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.count + t.row, 1) == a.n_chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int u0 = t.row * a.n_chunks;
  for (int y = threadIdx.x; y <= a.e_max; y += blockDim.x) {
    double my = __ldcg(a.part_my + (size_t)u0 * Y + y);
    for (int c = 1; c < a.n_chunks; ++c)
      my = nan_min(my, __ldcg(a.part_my + (size_t)(u0 + c) * Y + y));
    a.m_y[(size_t)t.row * Y + y] = my;
  }
  if (threadIdx.x == 0) {
    int ok = 0;
    double b = INFINITY;
    int bk = INT_MAX;
    for (int c = 0; c < a.n_chunks; ++c) {
      ok |= __ldcg(a.part_ok + u0 + c);
      const double v2 = __ldcg(a.part_best + u0 + c);
      const int k2 = __ldcg(a.part_key + u0 + c);
      if (hint_before(v2, k2, b, bk)) {
        b = v2;
        bk = k2;
      }
    }
    a.any_ok[t.row] = (unsigned char)ok;
    if (a.track_hint) {
      if (b < INFINITY) {
        a.hint_w[t.row] = (double)(bk / (5 * Y) + 1);
        a.hint_flat[t.row] = bk % (5 * Y);
      } else {
        a.hint_w[t.row] = 1.0;  // the reference's initial carry: nothing beat +inf
        a.hint_flat[t.row] = 0;
      }
    }
  }
}

int threads_for(int e_max) {
  int t = ((e_max + 1 + 31) / 32) * 32;
  return t > 1024 ? 1024 : t;
}

// ------------------------------------------------------------ the folds

// The float64 glue around the evaluation, the devices summed in order
// 0..M-1 (the plain versions are torch reductions, which sum in another
// order; the two agree to the last bits). What bounds both on an H100:
// latency (a few KB read and written; the flagship's bound fold reads its
// 66 KB y-profile once). theta = (k - 1) softmax(tau), the evaluation's
// input, one thread an (instance, k) row, from float64 tau or from the
// ascent's float32 multipliers P (S, n_k (2 + M)), whose float64 (lam, mu,
// tau) it then also writes.
constexpr int FOLD_THREADS = 128;

__global__ void decomp_theta_kernel(const float* __restrict__ P32,
                                    const double* __restrict__ tau_in,
                                    const double* __restrict__ ks, int rows, int n_k, int M,
                                    double* __restrict__ lam_out, double* __restrict__ mu_out,
                                    double* __restrict__ tau_out, double* __restrict__ theta) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const size_t s = r / n_k, k = r % n_k, pw = (size_t)n_k * (2 + M);
  const float* P = P32 == nullptr ? nullptr : P32 + s * pw;
  const double* tau = tau_in + (size_t)r * M;
  auto tau_at = [&](int i) -> double {
    return P != nullptr ? (double)P[2 * n_k + k * M + i] : tau[i];
  };
  if (P != nullptr) {
    lam_out[r] = (double)P[k];
    mu_out[r] = (double)P[n_k + k];
    for (int i = 0; i < M; ++i) tau_out[(size_t)r * M + i] = tau_at(i);
  }
  double mx = -INFINITY;
  for (int i = 0; i < M; ++i) mx = nan_max(mx, tau_at(i));
  double sum = 0.0;
  for (int i = 0; i < M; ++i) sum = __dadd_rn(sum, exp(__dsub_rn(tau_at(i), mx)));
  const double km1 = __dsub_rn(ks[r], 1.0);
  for (int i = 0; i < M; ++i)
    theta[(size_t)r * M + i] = __dmul_rn(km1, __ddiv_rn(exp(__dsub_rn(tau_at(i), mx)), sum));
}

// The per-k bound from the evaluation's y-profile: the sum over devices of
// each device's minimum over y, plus lam W, plus mu E; -inf where NaN, +inf
// where some device has no ok cell (ops/decomp.py::bound_of). A block a
// row: a warp a device takes its minimum over y (a tree of NaN-propagating
// minima), then one thread sums the devices in order.
constexpr int BOUND_THREADS = 256;

__global__ void __launch_bounds__(BOUND_THREADS)
    decomp_bound_kernel(const double* __restrict__ m_y, const unsigned char* __restrict__ any_ok,
                        const double* __restrict__ lam, const double* __restrict__ mu,
                        const double* __restrict__ Ws, const double* __restrict__ E, int n_k,
                        int M, int Y, double* __restrict__ out) {
  extern __shared__ double bound_mn[];  // M
  const int r = blockIdx.x, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < M; i += nw) {
    const double* row = m_y + ((size_t)r * M + i) * Y;
    double v = INFINITY;
    for (int y = lane; y < Y; y += 32) v = nan_min(v, row[y]);
    v = warp_reduce(v, Min());
    if (lane == 0) bound_mn[i] = v;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  double sum = 0.0;
  bool all_ok = true;
  for (int i = 0; i < M; ++i) {
    sum = __dadd_rn(sum, bound_mn[i]);
    all_ok = all_ok && any_ok[(size_t)r * M + i] != 0;
  }
  double b = __dadd_rn(__dadd_rn(sum, __dmul_rn(lam[r], Ws[r])), __dmul_rn(mu[r], E[r / n_k]));
  if (b != b) b = -INFINITY;
  out[r] = all_ok ? b : INFINITY;
}

}  // namespace

extern "C" {

// Shapes: rdv (S, DR_ROWS, M); bp, E (S,); ks, Ws, lam, mu (S, n_k); theta
// and the (S, n_k, M) outputs; m_y (S, n_k, M, e_max + 1).
int dtk_decomp_eval_f32(const float* rdv, const float* bp, const float* E,
                        const float* ks, const float* Ws, int S, int n_k, int M,
                        int w_max, int e_max, const float* lam, const float* mu,
                        const float* theta, float* bmin, float* wbar, float* ybar,
                        float* cycbar, void* stream) {
  if (S <= 0 || n_k <= 0 || M <= 0) return 0;
  dim3 grid(M, n_k, S);
  decomp_f32_kernel<<<grid, threads_for(e_max), 0, (cudaStream_t)stream>>>(
      rdv, bp, E, ks, Ws, M, w_max, e_max, lam, mu, theta, bmin, wbar, ybar, cycbar);
  return (int)cudaGetLastError();
}

// Blocks of the ascent the card holds co-resident at M devices when each
// block keeps ``per_block`` owner states in shared memory (0: in global
// memory), at most ASC_MAX_BLOCKS_PER_SM an SM; or minus a cudaError_t.
int dtk_decomp_ascent_grid(int M, int per_block) {
  int sms = 0, occ = 0;
  int err = per_block < 0 ? (int)cudaErrorInvalidValue : sm_count(&sms);
  if (err == 0) {
    const size_t smem = ascent_smem(M, sms, per_block);
    const void* fn = ascent_fn(per_block);
    int optin = 0, dev = 0;
    cudaFuncAttributes fa;
    err = (int)cudaGetDevice(&dev);
    if (err == 0)
      err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == 0) err = (int)cudaFuncGetAttributes(&fa, fn);
    // Past what a block may hold: no grid (and no attribute call that
    // would leave an error for the next launch's check).
    if (err == 0 && smem + fa.sharedSizeBytes > (size_t)optin)
      return -(int)cudaErrorCooperativeLaunchTooLarge;
    if (err == 0 && smem > 48 * 1024)
      err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
    if (err == 0)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, ASC_THREADS, smem);
  }
  if (err != 0) return -err;
  if (occ < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  return sms * (occ < ASC_MAX_BLOCKS_PER_SM ? occ : ASC_MAX_BLOCKS_PER_SM);
}

size_t dtk_decomp_ascent_ws_bytes(int units, long cells, int M, int per_block) {
  return ascent_ws_bytes(units, cells, M, per_block);
}

// The whole ascent in one cooperative launch of G blocks (G <=
// dtk_decomp_ascent_grid(M, per_block)): ``steps`` Adam steps from P0
// (S, n_k (2 + M)), the best multipliers seen (the initial point included)
// into ``best``. Each block keeps the owner states of its units in shared
// memory (per_block >= its units) or, per_block == 0, each unit's in the
// workspace. Adam's constants as float32 (b1, 1 - b1, b2, 1 - b2, eps).
int dtk_decomp_ascent_f32(const float* rdv, const float* bp, const float* E,
                          const float* ks, const float* Ws, int S, int n_k, int M,
                          int w_max, int e_max, const float* adam, int steps, float b1,
                          float one_b1, float b2, float one_b2, float eps,
                          const float* P0, int chunk_w, int n_chunks,
                          int G, int per_block, void* ws, long ws_len, float* best,
                          void* stream) {
  if (S <= 0 || n_k <= 0 || M <= 0) return 0;
  if (steps < 0 || chunk_w < 1 || n_chunks < 1 || (n_chunks - 1) * chunk_w >= w_max ||
      n_chunks * chunk_w < w_max || G < 1 || per_block < 0)
    return (int)cudaErrorInvalidValue;
  const long units_l = (long)S * n_k * M * n_chunks;
  if (units_l > INT_MAX) return (int)cudaErrorInvalidValue;
  const int units = (int)units_l;
  const long cells = (long)S * n_k * M * w_max * (e_max + 1) * 5;
  if ((size_t)ws_len < ascent_ws_bytes(units, cells, M, per_block))
    return (int)cudaErrorInvalidValue;
  const int G_max = dtk_decomp_ascent_grid(M, per_block);
  if (G_max < 0) return -G_max;
  if (G > G_max) return (int)cudaErrorCooperativeLaunchTooLarge;
  int sms = 0;
  const int err_sm = sm_count(&sms);
  if (err_sm != 0) return err_sm;
  if ((size_t)M * n_chunks > owner_slots(M, sms) ||
      (per_block > 0 && units > (long)per_block * G))
    return (int)cudaErrorInvalidValue;
  AscParams a;
  a.rdv = rdv;
  a.bp = bp;
  a.E = E;
  a.ks = ks;
  a.Ws = Ws;
  a.adam = adam;
  a.P0 = P0;
  a.best = best;
  a.S = S;
  a.n_k = n_k;
  a.M = M;
  a.w_max = w_max;
  a.e_max = e_max;
  a.steps = steps;
  a.chunk_w = chunk_w;
  a.n_chunks = n_chunks;
  a.units = units;
  a.per_block = per_block;
  a.b1 = b1;
  a.one_b1 = one_b1;
  a.b2 = b2;
  a.one_b2 = one_b2;
  a.eps = eps;
  a.slots = static_cast<Acc*>(ws);
  char* p = static_cast<char*>(ws) + align_up(sizeof(Acc) * 2 * (size_t)units);
  a.cache = reinterpret_cast<float2*>(p);
  a.owners = per_block > 0 ? nullptr
                           : reinterpret_cast<float*>(p + align_up(sizeof(float2) * (size_t)cells));
  // The size the grid was sized with.
  const size_t smem = ascent_smem(M, sms, per_block);
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(ascent_fn(per_block), dim3(G),
                                                dim3(ASC_THREADS), args, smem,
                                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

size_t dtk_decomp_f64_ws_bytes(int units, int Y) { return f64_ws_bytes(units, Y); }

// The float64 evaluation over units of ``chunk_w`` layers (n_chunks a row),
// one block each; ``count`` (S n_k M,) int32 zeros.
int dtk_decomp_eval_f64(const double* rdv, const double* bp, const double* E,
                        const double* ks, const double* Ws, int S, int n_k, int M,
                        int w_max, int e_max, const double* lam, const double* mu,
                        const double* theta, int track_hint, int chunk_w, int n_chunks,
                        void* ws, long ws_len, int* count, double* m_y,
                        unsigned char* any_ok, double* hint_w, int* hint_flat,
                        void* stream) {
  if (S <= 0 || n_k <= 0 || M <= 0) return 0;
  if (chunk_w < 1 || n_chunks < 1 || (n_chunks - 1) * chunk_w >= w_max ||
      n_chunks * chunk_w < w_max)
    return (int)cudaErrorInvalidValue;
  const int units = S * n_k * M * n_chunks, Y = e_max + 1;
  if ((size_t)ws_len < f64_ws_bytes(units, Y)) return (int)cudaErrorInvalidValue;
  F64Params a;
  a.rdv = rdv;
  a.bp = bp;
  a.E = E;
  a.ks = ks;
  a.Ws = Ws;
  a.lam = lam;
  a.mu = mu;
  a.theta = theta;
  a.S = S;
  a.n_k = n_k;
  a.M = M;
  a.w_max = w_max;
  a.e_max = e_max;
  a.track_hint = track_hint;
  a.chunk_w = chunk_w;
  a.n_chunks = n_chunks;
  char* p = static_cast<char*>(ws);
  a.part_my = reinterpret_cast<double*>(p);
  p += align_up(sizeof(double) * (size_t)units * Y);
  a.part_best = reinterpret_cast<double*>(p);
  p += align_up(sizeof(double) * units);
  a.part_key = reinterpret_cast<int*>(p);
  p += align_up(sizeof(int) * (size_t)units);
  a.part_ok = reinterpret_cast<int*>(p);
  a.count = count;
  a.m_y = m_y;
  a.any_ok = any_ok;
  a.hint_w = hint_w;
  a.hint_flat = hint_flat;
  decomp_f64_kernel<<<units, threads_for(e_max), 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// theta (S, n_k, M) = (k - 1) softmax(tau): tau from ``tau`` (S, n_k, M)
// float64, or, with P32 (S, n_k (2 + M)) float32 given, from P32, whose
// float64 lam, mu (S, n_k) and tau then go to the three outputs.
int dtk_decomp_theta_f64(const float* P32, const double* tau, const double* ks, int S, int n_k,
                         int M, double* lam, double* mu, double* tau_out, double* theta,
                         void* stream) {
  if (S <= 0 || n_k <= 0 || M <= 0) return 0;
  if (P32 == nullptr ? tau == nullptr : (lam == nullptr || mu == nullptr || tau_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int rows = S * n_k;
  decomp_theta_kernel<<<(rows + FOLD_THREADS - 1) / FOLD_THREADS, FOLD_THREADS, 0,
                        (cudaStream_t)stream>>>(P32, tau, ks, rows, n_k, M, lam, mu, tau_out,
                                                theta);
  return (int)cudaGetLastError();
}

// bound (S, n_k) from m_y (S, n_k, M, Y), any_ok (S, n_k, M), lam, mu, Ws
// (S, n_k) and E (S,).
int dtk_decomp_bound_f64(const double* m_y, const unsigned char* any_ok, const double* lam,
                         const double* mu, const double* Ws, const double* E, int S, int n_k,
                         int M, int Y, double* bound, void* stream) {
  if (S <= 0 || n_k <= 0 || M <= 0) return 0;
  if (Y <= 0) return (int)cudaErrorInvalidValue;
  const size_t sm = sizeof(double) * (size_t)M;
  if (sm > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(decomp_bound_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
    if (err != cudaSuccess) return (int)err;
  }
  decomp_bound_kernel<<<S * n_k, BOUND_THREADS, sm, (cudaStream_t)stream>>>(
      m_y, any_ok, lam, mu, Ws, E, n_k, M, Y, bound);
  return (int)cudaGetLastError();
}

}  // extern "C"
