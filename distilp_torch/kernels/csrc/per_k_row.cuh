// B15's per-k bodies: the parts of a per-k branch-and-bound round that every
// k does for itself. Shared by bnb_epilogue_kernel.cu (B15's two entries,
// dtk_bnb_per_k_incumbent and dtk_bnb_per_k_rank) and round_tail_kernel.cu
// (the round tail's per-k mode), so the arithmetic exists once.
//
// Replaces the per-k parts of distilp_tpu/solver/backend_jax.py::_bnb_round
// with per_k=True (:1597-1627, :1699-1702, :1728-1774): each k's best row of
// the round and the per-k incumbent it improves, each k's prune threshold,
// and each active child row's rank among its k's active rows in the
// best-bound-first order, from which the k-fair compaction order follows.
#pragma once

#include "common.cuh"

namespace dtk {

// torch.minimum: NaN-propagating; on ties the first operand.
__device__ __forceinline__ double t_min(double a, double b) {
  return (is_nan(a) || a <= b) ? a : b;
}

// threshold = best - mip_gap |best|, +inf with no incumbent; the product and
// the difference rounded one by one, as torch computes them.
__device__ __forceinline__ double prune_threshold(double best, double mip_gap) {
  return isfinite(best) ? __dsub_rn(best, __dmul_rn(mip_gap, fabs(best))) : (double)INFINITY;
}

// The round's best row of k (warp-wide: every lane of the warp calls): the
// argmin of where(kidx == k, obj, inf) over the B rows, torch.argmin's rule
// (the first NaN, else the first index of the minimum). Every lane gets
// (v, r_star); r_star is INT_MAX when no row takes part.
__device__ __forceinline__ void pk_best_row(int B, int k, const int* kidx, const double* obj,
                                            double& v, int& r_star) {
  v = INFINITY;
  r_star = INT_MAX;
  for (int r = threadIdx.x & 31; r < B; r += 32) {
    argmin_combine(v, r_star, kidx[r] == k ? obj[r] : (double)INFINITY, r);
  }
  for (int o = 16; o > 0; o >>= 1) {
    const double v2 = __shfl_xor_sync(FULL, v, o);
    const int i2 = __shfl_xor_sync(FULL, r_star, o);
    argmin_combine(v, r_star, v2, i2);
  }
}

// A k's new assignment (warp-wide, the lanes over the M devices): its best
// row's w, n, y where the round improved the k's incumbent (y zeros where
// the rows carry none, y_row null), its old one elsewhere.
__device__ __forceinline__ void pk_take_row(int M, bool improved, const double* w_row,
                                            const double* n_row, const double* y_row,
                                            const double* w_old, const double* n_old,
                                            const double* y_old, double* w_out, double* n_out,
                                            double* y_out) {
  for (int j = threadIdx.x & 31; j < M; j += 32) {
    w_out[j] = improved ? w_row[j] : w_old[j];
    n_out[j] = improved ? n_row[j] : n_old[j];
    y_out[j] = improved ? (y_row != nullptr ? y_row[j] : 0.0) : y_old[j];
  }
}

// Each row's rank among the rows of its group, in position order
// (block-wide: every thread of the block calls). The rows sit at positions
// 0..total-1; key_of(p) is the group of the row at p in [0, n), or -1 for a
// row in no group. Per tile of the block's threads: warp match groups, each
// warp's counts in s_wc (warps x n), earlier tiles' counts in s_run (n).
// sink(p, group, rank) is called for every p < total (rank -1 for no
// group). Zeroes s_run and s_wc itself and leaves s_run[g] the count of
// group g.
template <class KeyOf, class Sink>
__device__ void pk_ranks(int total, int n, int* s_run, int* s_wc, KeyOf key_of, Sink sink) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int i = tid; i < n; i += nt) s_run[i] = 0;
  for (int i = tid; i < nw * n; i += nt) s_wc[i] = 0;
  __syncthreads();
  for (int base = 0; base < total; base += nt) {
    const int p = base + tid;
    const int k = p < total ? key_of(p) : -1;
    const unsigned grp = __match_any_sync(FULL, k);
    if (k >= 0 && lane == __ffs(grp) - 1) s_wc[wid * n + k] = __popc(grp);
    __syncthreads();
    if (p < total) {
      int rank = -1;
      if (k >= 0) {
        rank = s_run[k] + __popc(grp & below);
        for (int q = 0; q < wid; ++q) rank += s_wc[q * n + k];
      }
      sink(p, k, rank);
    }
    __syncthreads();
    for (int i = tid; i < n; i += nt) {
      int sum = 0;
      for (int q = 0; q < nw; ++q) {
        sum += s_wc[q * n + i];
        s_wc[q * n + i] = 0;
      }
      s_run[i] += sum;
    }
    __syncthreads();
  }
}

}  // namespace dtk
