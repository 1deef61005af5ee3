// K3's per-row arithmetic: the branch-and-bound epilogue of one beam row
// after its LP solve and its rounding. Shared by bnb_epilogue_kernel.cu
// (K3's entry, a block a row) and round_tail_kernel.cu (the round's tail, a
// warp a row), so the arithmetic exists once; the two differ only in the
// group of threads that reduces over the row's columns.
//
// Replaces the per-row part of distilp_tpu/solver/backend_jax.py::_bnb_round
// (after its LP call): fold the LP bound (-inf guard, parent max; +inf for
// rows not processed), prune against the threshold, tighten integer boxes by
// reduced costs (sound for any dual), close fully fixed or achieved nodes,
// pick the branch variable (most fractional, else the widest box;
// jnp.argmax's first-index rule) and split it into the two child boxes.
#pragma once

#include "common.cuh"

namespace dtk {

constexpr float EPI_FRAC_TOL = 1e-4f;

// A thread block as the group that reduces over a row (every thread of the
// block must call; sf/si hold 32 slots each).
struct BlockGroup {
  float* sf;
  int* si;
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ bool all(bool x) const { return __syncthreads_and(x); }
  __device__ float max(float x) const { return block_reduce(x, Max(), sf); }
  __device__ void argmax(float& v, int& i) const { block_argmax(v, i, sf, si); }
};

// One warp as the group (every lane of the warp must call).
struct WarpGroup {
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ bool all(bool x) const { return __all_sync(FULL, x); }
  __device__ float max(float x) const { return warp_reduce(x, Max()); }
  __device__ void argmax(float& v, int& i) const { warp_argmax(v, i); }
};

// What a row's epilogue decides; the child boxes follow column by column
// from these (epi_tighten, epi_split).
struct EpiRow {
  double bound;   // folded bound (+inf for a row not processed)
  double budget;  // the reduced-cost tightening's budget
  float dn;       // the split: child A's hi and child B's lo - 1 at js
  int js;         // the branch variable
  bool survive;
};

// Reduced-cost tightening of one column: the box (lo2, hi2) both children
// start from (the budget from the raw, unfolded bound).
__device__ __forceinline__ void epi_tighten(float lo, float hi, double red, bool im,
                                            double budget, float& lo2, float& hi2) {
  const double lo64 = (double)lo, hi64 = (double)hi;
  const double th = (im && red > 1e-12) ? floor(lo64 + budget / nan_max(red, 1e-12) + 1e-9) : hi64;
  const double tl = (im && red < -1e-12) ? ceil(hi64 - budget / nan_max(-red, 1e-12) - 1e-9) : lo64;
  hi2 = nan_min(hi, (float)th);
  lo2 = nan_max(lo, (float)tl);
}

// The split at column j: child A's hi and child B's lo (child A's lo is lo2,
// child B's hi is hi2).
__device__ __forceinline__ void epi_split(const EpiRow& e, int j, float lo2, float hi2,
                                          float& hi_a, float& lo_b) {
  hi_a = j == e.js ? e.dn : hi2;
  lo_b = j == e.js ? e.dn + 1.0f : lo2;
}

// One row's epilogue over its nf columns (lo, hi, v, red the row's arrays,
// int_mask its instance's). Every thread of the group gets the result.
template <class G>
__device__ EpiRow epi_row(const G& g, int nf, const float* __restrict__ lo,
                          const float* __restrict__ hi, const float* __restrict__ v,
                          const double* __restrict__ red,
                          const uint8_t* __restrict__ int_mask, double res_bound,
                          double obj_const, bool act, double parent_bound, double thr,
                          double obj_full) {
  const double inf = INFINITY;
  const float finf = INFINITY;
  EpiRow e;

  // Bound fold.
  const double bound_raw = res_bound + obj_const;
  double bound = isfinite(bound_raw) ? bound_raw : -inf;
  bound = act ? nan_max(bound, parent_bound) : inf;
  bool survive = act && bound < thr;

  // Reduced-cost box tightening.
  double budget = thr - bound_raw;
  budget = (isfinite(budget) && budget >= 0.0) ? budget : inf;
  bool boxes_ok = true;
  float wmax = -finf;
  for (int j = g.rank(); j < nf; j += g.size()) {
    const bool im = int_mask[j] != 0;
    float lo2, hi2;
    epi_tighten(lo[j], hi[j], red[j], im, budget, lo2, hi2);
    boxes_ok = boxes_ok && (lo2 <= hi2);
    wmax = nan_max(wmax, im ? hi2 - lo2 : 0.0f);
  }
  boxes_ok = g.all(boxes_ok);
  wmax = g.max(wmax);
  survive = survive && boxes_ok;
  const bool fully_fixed = wmax < 0.5f;
  const bool achieved = obj_full <= bound + 1e-6 * nan_max(1.0, fabs(bound));
  survive = survive && !(fully_fixed || achieved);

  // Branch variable: most fractional branchable column, else the widest.
  float fbest = -finf, wbest = -finf;
  int fi = INT_MAX, wi = INT_MAX;
  for (int j = g.rank(); j < nf; j += g.size()) {
    const bool im = int_mask[j] != 0;
    float lo2, hi2;
    epi_tighten(lo[j], hi[j], red[j], im, budget, lo2, hi2);
    const float width = im ? hi2 - lo2 : 0.0f;
    const float vj = v[j];
    const float frac = fabsf(vj - rintf(vj));
    const float fm = (im && width > 0.5f) ? frac : -1.0f;
    argmax_combine(fbest, fi, fm, j);
    argmax_combine(wbest, wi, width, j);
  }
  g.argmax(fbest, fi);
  g.argmax(wbest, wi);
  const bool has_frac = fbest > EPI_FRAC_TOL;
  const int js = has_frac ? fi : wi;
  float loj, hij;
  epi_tighten(lo[js], hi[js], red[js], int_mask[js] != 0, budget, loj, hij);
  const float split = has_frac ? v[js] : 0.5f * (loj + hij);
  e.dn = clip(floorf(split), loj, nan_max(hij - 1.0f, loj));
  e.js = js;
  e.bound = bound;
  e.budget = budget;
  e.survive = survive;
  return e;
}

}  // namespace dtk
