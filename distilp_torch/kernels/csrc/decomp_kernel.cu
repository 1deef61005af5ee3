// K7: the Lagrangian decomposition bound of the MoE MILP, evaluated per
// (k-candidate, device) over the device's whole integer lattice.
//
// Replaces distilp_tpu/solver/backend_jax.py::_decomp_terms,
// ::_decomp_terms_for_w and the two evaluations of ::_decomp_bound_roots
// (the float32 bound and its gradient that the multiplier ascent calls once
// per step, and the float64 evaluation at the chosen multipliers). Each cell
// (candidate c of the five n candidates {0, w, the VRAM boundary, the
// RAM-slack kink, the s <= w endpoint}, layers w in [1, w_max], experts y in
// [0, e_max]) is priced exactly as the MILP prices it (integer ceil slacks,
// penalties, busy constant), on the fly: the 5-D tensor the reference builds
// is never materialized.
//
//   term = lin + theta cyc - lambda w - mu y     (ok cells; else +inf/3.4e37)
//
// dtk_decomp_eval_f32 (the ascent): per (k, i) the minimum of term over
// all cells, and, for the gradient, the count and the mean w, y and cyc of
// the cells that attain it (jnp.min's gradient splits the cotangent equally
// over tied cells). A (k, i) with no ok cell reports 3.4e37 and count 0.
// dtk_decomp_eval_f64 (the final evaluation): per (k, i, y) the minimum
// over candidates and w (m_y), whether any cell is ok, and, when asked, the
// Lagrangian-primal hint: the smallest w attaining the minimum and within it
// the first (candidate, y) in candidate-major order.
//
// Instance axis: both entries evaluate S instances in one launch (a MoE
// scenario batch, whose S ascents run in lockstep as the reference's vmap
// runs them): every input carries a leading instance axis (the packed
// vectors, b', E, the k grid, the multipliers) and block (i, k, s) reads
// instance s's. S = 1 is one sweep.
//
// Every rd vector arrives already cast to the evaluation's dtype, and every
// expression keeps the reference's order of operations; the library is built
// with --fmad=false, because the ceil(x / b' - 1e-9) staircases flip on one
// ulp.
//
// What bounds it on an H100: operations. One evaluation prices
// 5 n_k M w_max (e_max + 1) cells (DeepSeek-V3 on 32 devices: 2.5 M cells,
// ~60 operations each) from a few kilobytes of input. One block per (k, i, s),
// one thread per y (looping over w and the five candidates, which share the
// y-only terms), and a fixed-order block reduction: no atomics, so a run
// repeats bit for bit.

#include "common.cuh"

namespace {

using namespace dtk;

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
  // Fixed-order block reduction: lanes by butterfly, warps in index order.
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
  if (lane == 0) part[wid] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc r = part[0];
    for (int q = 1; q < (int)((blockDim.x + 31) >> 5); ++q) acc_merge(r, part[q]);
    const size_t o = (size_t)kidx * M + i;
    if (r.cnt == 0) {
      bmin[o] = BIG32;
      wbar[o] = ybar[o] = cycbar[o] = 0.0f;
    } else {
      bmin[o] = r.mn;
      wbar[o] = (float)(r.sw / r.cnt);
      ybar[o] = (float)(r.sy / r.cnt);
      cycbar[o] = (float)(r.sc / r.cnt);
    }
  }
}

__global__ void decomp_f64_kernel(const double* __restrict__ rdv,
                                  const double* __restrict__ bp_s,
                                  const double* __restrict__ E_s,
                                  const double* __restrict__ ks,
                                  const double* __restrict__ Ws, int M, int w_max,
                                  int e_max, const double* __restrict__ lam,
                                  const double* __restrict__ mu,
                                  const double* __restrict__ theta, int track_hint,
                                  double* __restrict__ m_y,
                                  unsigned char* __restrict__ any_ok,
                                  double* __restrict__ hint_w,
                                  int* __restrict__ hint_flat) {
  __shared__ double red_v[32];
  __shared__ int red_i[32];
  const int n_k = gridDim.y;
  const int s = blockIdx.z;
  const int kidx = s * n_k + blockIdx.y;  // (instance, k) row of the k axis
  const int i = blockIdx.x;
  const int Y = e_max + 1;
  const Dev<double> d = load_dev<double>(rdv + (size_t)s * DR_ROWS * M, M, i, bp_s[s],
                                         ks[kidx], Ws[kidx], E_s[s]);
  const double th = theta[(size_t)kidx * M + i];
  const double lm = lam[kidx];
  const double mm = mu[kidx];
  int ok_any = 0;
  // Best cell by (term, then key = ((w - 1) 5 + c) Y + y): the reference's
  // first w (ascending, strict <) and within it its flat (c, y) argmin.
  double best = INFINITY;
  int best_key = INT_MAX;
  for (int y = threadIdx.x; y <= e_max; y += blockDim.x) {
    const YTerms<double> yt = y_terms(d, y);
    double my = INFINITY;
    for (int w = 1; w <= w_max; ++w) {
      const double Wg = (double)w;
      for (int c = 0; c < 5; ++c) {
        const double n = n_cand(d, yt, Wg, c);
        double lin, cyc;
        if (!cell(d, yt, Wg, n, lin, cyc)) continue;
        ok_any = 1;
        const double term = ((lin + th * cyc) - lm * Wg) - mm * yt.Y;
        my = nan_min(my, term);
        const int key = ((w - 1) * 5 + c) * Y + y;
        if (term < best || (term == best && key < best_key)) {
          best = term;
          best_key = key;
        }
      }
    }
    m_y[((size_t)kidx * M + i) * Y + y] = my;
  }
  ok_any = __syncthreads_or(ok_any);
  if (!track_hint) {
    if (threadIdx.x == 0) any_ok[(size_t)kidx * M + i] = (unsigned char)ok_any;
    return;
  }
  // Block argmin over (best, best_key); a thread with no finite cell holds
  // (+inf, INT_MAX) and never wins against a finite one.
  for (int o = 16; o > 0; o >>= 1) {
    const double v2 = __shfl_xor_sync(FULL, best, o);
    const int k2 = __shfl_xor_sync(FULL, best_key, o);
    if (v2 < best || (v2 == best && k2 < best_key)) {
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
      if (red_v[q] < best || (red_v[q] == best && red_i[q] < best_key)) {
        best = red_v[q];
        best_key = red_i[q];
      }
    }
    const size_t o = (size_t)kidx * M + i;
    any_ok[o] = (unsigned char)ok_any;
    if (best < INFINITY) {
      hint_w[o] = (double)(best_key / (5 * Y) + 1);
      hint_flat[o] = best_key % (5 * Y);
    } else {
      hint_w[o] = 1.0;  // the reference's initial carry: nothing beat +inf
      hint_flat[o] = 0;
    }
  }
}

int threads_for(int e_max) {
  int t = ((e_max + 1 + 31) / 32) * 32;
  return t > 1024 ? 1024 : t;
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

int dtk_decomp_eval_f64(const double* rdv, const double* bp, const double* E,
                        const double* ks, const double* Ws, int S, int n_k, int M,
                        int w_max, int e_max, const double* lam, const double* mu,
                        const double* theta, int track_hint, double* m_y,
                        unsigned char* any_ok, double* hint_w, int* hint_flat,
                        void* stream) {
  if (S <= 0 || n_k <= 0 || M <= 0) return 0;
  dim3 grid(M, n_k, S);
  decomp_f64_kernel<<<grid, threads_for(e_max), 0, (cudaStream_t)stream>>>(
      rdv, bp, E, ks, Ws, M, w_max, e_max, lam, mu, theta, track_hint, m_y, any_ok,
      hint_w, hint_flat);
  return (int)cudaGetLastError();
}

}  // extern "C"
