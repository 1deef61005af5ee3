// K3: the per-row part of one branch-and-bound round after the LP solve and
// the rounding, one thread block per beam row.
//
// Replaces the elementwise and row-reduction part of
// distilp_tpu/solver/backend_jax.py::_bnb_round (after its LP call): fold the
// LP bound (-inf guard, parent max; +inf for rows not processed), prune
// against the threshold, tighten integer boxes by reduced costs (sound for any
// dual), close fully fixed or achieved nodes, pick the branch variable (most
// fractional, else the widest box; jnp.argmax's first-index rule), split it
// into the two child boxes, and carry the solved iterate to both children.
// The scalar reductions over the beam (incumbent argmin, per-k scatter-min,
// threshold) and the best-bound-first stable compaction stay outside, as
// plain tensor operations over at most `cap` rows.
//
// What bounds it on an H100: a few elementwise passes over B rows of nf
// columns (B <= 16, nf = 209 at M=16: about 80 KB in and out), so bytes and
// launch latency; the design reads every input once and writes every output
// once from one block per row, with the row's reductions in shared memory.

#include "common.cuh"

namespace {

using namespace dtk;

constexpr float FRAC_TOL = 1e-4f;

__global__ void bnb_epilogue_kernel(
    const float* __restrict__ lo_in, const float* __restrict__ hi_in,
    const float* __restrict__ v, const double* __restrict__ reduced,
    const float* __restrict__ y_dual, const float* __restrict__ z_dual,
    const float* __restrict__ f_dual, const double* __restrict__ res_bound,
    const double* __restrict__ parent_bound, const uint8_t* __restrict__ active,
    const double* __restrict__ obj_full, const double* __restrict__ threshold,
    const uint8_t* __restrict__ int_mask, double obj_const,
    const float* __restrict__ node_v, const float* __restrict__ node_y,
    const float* __restrict__ node_z, const float* __restrict__ node_f,
    const uint8_t* __restrict__ node_warm, int nf, int m,
    double* __restrict__ bound_out, uint8_t* __restrict__ survive_out,
    float* __restrict__ lo_a, float* __restrict__ hi_a, float* __restrict__ lo_b,
    float* __restrict__ hi_b, float* __restrict__ v_new, float* __restrict__ y_new,
    float* __restrict__ z_new, float* __restrict__ f_new,
    uint8_t* __restrict__ warm_new) {
  __shared__ float s_f[32];
  __shared__ int s_i[32];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int bs = blockDim.x;
  const size_t ro = (size_t)r * nf;
  const bool act = active[r] != 0;
  const double inf = INFINITY;
  const float finf = INFINITY;

  // Bound fold.
  const double bound_raw = res_bound[r] + obj_const;
  double bound = isfinite(bound_raw) ? bound_raw : -inf;
  bound = act ? nan_max(bound, parent_bound[r]) : inf;
  const double thr = threshold[r];
  bool survive = act && bound < thr;

  // Reduced-cost box tightening (budget from the raw, unfolded bound).
  double budget = thr - bound_raw;
  budget = (isfinite(budget) && budget >= 0.0) ? budget : inf;
  bool boxes_ok = true;
  float wmax = -finf;
  for (int j = tid; j < nf; j += bs) {
    const bool im = int_mask[j] != 0;
    const float lo = lo_in[ro + j];
    const float hi = hi_in[ro + j];
    const double lo64 = (double)lo, hi64 = (double)hi, red = reduced[ro + j];
    const double th = (im && red > 1e-12) ? floor(lo64 + budget / nan_max(red, 1e-12) + 1e-9) : hi64;
    const double tl = (im && red < -1e-12) ? ceil(hi64 - budget / nan_max(-red, 1e-12) - 1e-9) : lo64;
    const float hi2 = nan_min(hi, (float)th);
    const float lo2 = nan_max(lo, (float)tl);
    lo_a[ro + j] = lo2;
    hi_b[ro + j] = hi2;
    boxes_ok = boxes_ok && (lo2 <= hi2);
    wmax = nan_max(wmax, im ? hi2 - lo2 : 0.0f);
  }
  boxes_ok = __syncthreads_and(boxes_ok);
  wmax = block_reduce(wmax, Max(), s_f);
  survive = survive && boxes_ok;
  const bool fully_fixed = wmax < 0.5f;
  const bool achieved = obj_full[r] <= bound + 1e-6 * nan_max(1.0, fabs(bound));
  survive = survive && !(fully_fixed || achieved);

  // Branch variable: most fractional branchable column, else the widest.
  float fbest = -finf, wbest = -finf;
  int fi = INT_MAX, wi = INT_MAX;
  for (int j = tid; j < nf; j += bs) {
    const bool im = int_mask[j] != 0;
    const float width = im ? hi_b[ro + j] - lo_a[ro + j] : 0.0f;
    const float vj = v[ro + j];
    const float frac = fabsf(vj - rintf(vj));
    const float fm = (im && width > 0.5f) ? frac : -1.0f;
    argmax_combine(fbest, fi, fm, j);
    argmax_combine(wbest, wi, width, j);
  }
  block_argmax(fbest, fi, s_f, s_i);
  block_argmax(wbest, wi, s_f, s_i);
  const bool has_frac = fbest > FRAC_TOL;
  const int js = has_frac ? fi : wi;
  const float loj = lo_a[ro + js];
  const float hij = hi_b[ro + js];
  const float split = has_frac ? v[ro + js] : 0.5f * (loj + hij);
  const float dn = clip(floorf(split), loj, nan_max(hij - 1.0f, loj));

  for (int j = tid; j < nf; j += bs) {
    const float lo2 = lo_a[ro + j];
    const float hi2 = hi_b[ro + j];
    hi_a[ro + j] = j == js ? dn : hi2;
    lo_b[ro + j] = j == js ? dn + 1.0f : lo2;
    v_new[ro + j] = act ? v[ro + j] : node_v[ro + j];
    z_new[ro + j] = act ? z_dual[ro + j] : node_z[ro + j];
    f_new[ro + j] = act ? f_dual[ro + j] : node_f[ro + j];
  }
  for (int i = tid; i < m; i += bs) {
    const size_t o = (size_t)r * m + i;
    y_new[o] = act ? y_dual[o] : node_y[o];
  }
  if (tid == 0) {
    bound_out[r] = bound;
    survive_out[r] = survive ? 1 : 0;
    warm_new[r] = (act || node_warm[r] != 0) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int dtk_bnb_epilogue(
    const float* lo, const float* hi, const float* v, const double* reduced,
    const float* y_dual, const float* z_dual, const float* f_dual,
    const double* res_bound, const double* parent_bound, const uint8_t* active,
    const double* obj_full, const double* threshold, const uint8_t* int_mask,
    double obj_const, const float* node_v, const float* node_y,
    const float* node_z, const float* node_f, const uint8_t* node_warm, int B,
    int nf, int m, double* bound, uint8_t* survive, float* lo_a, float* hi_a,
    float* lo_b, float* hi_b, float* v_new, float* y_new, float* z_new,
    float* f_new, uint8_t* warm_new, int threads, void* stream) {
  bnb_epilogue_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      lo, hi, v, reduced, y_dual, z_dual, f_dual, res_bound, parent_bound,
      active, obj_full, threshold, int_mask, obj_const, node_v, node_y, node_z,
      node_f, node_warm, nf, m, bound, survive, lo_a, hi_a, lo_b, hi_b, v_new,
      y_new, z_new, f_new, warm_new);
  return (int)cudaGetLastError();
}

}  // extern "C"
