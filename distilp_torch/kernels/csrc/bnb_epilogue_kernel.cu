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
// The per-row arithmetic lives in epilogue_row.cuh, shared with the round
// tail (round_tail_kernel.cu), which runs every round's epilogue itself
// beside the incumbent, the thresholds and the compaction: this entry
// serves the tail's plain version (solver/search.py::tail_tensors).
//
// Per-row instance: `obj_const` holds one constant per instance and
// `int_mask` one (nf,) mask per instance; row r reads those of inst[r]
// (inst == nullptr: instance 0 for every row), so the beam rows of several
// sweeps (scenarios, batch lanes) fold in one launch, as the reference's
// vmap over sweeps does.
//
// What bounds it on an H100: a few elementwise passes over B rows of nf
// columns (B <= 16, nf = 209 at M=16: about 80 KB in and out), so bytes and
// launch latency; the design reads every input once and writes every output
// once from one block per row, with the row's reductions in shared memory.
//
// K3's per-k mode (B15): two more entries for _bnb_round(per_k=True), where
// every node prunes against its own k's incumbent (backend_jax.py:1597-1627,
// :1699-1702, :1728-1774). Their per-k bodies live in per_k_row.cuh, shared
// with the round tail (round_tail_kernel.cu), whose per-k mode runs a whole
// per-k round after its LP call in one launch; these entries serve the
// tail's plain version (solver/search.py::tail_tensors).
//   dtk_bnb_per_k_incumbent, before the per-row epilogue: per k, the round's
//     best row of that k (pk_best_row), the per-k incumbent it improves and a
//     copy of that row's w, n, y (pk_take_row); then the prune threshold of
//     every frontier row from its own k's incumbent. One block: a warp per k
//     reduces over the B rows, then the block writes the cap thresholds from
//     the n_k in shared memory.
//   dtk_bnb_per_k_rank, after the first stable (best-bound-first) argsort of
//     the child rows: each active row's rank among its k's active rows
//     (pk_ranks: warp match groups, per-warp counts in shared memory, tiles
//     in order), the int64 fair key rank * (total + 1) + position, and the
//     per-k floor of the bounds that the fair order puts past the capacity.
//     That order lists the rank-0 rows, then the rank-1 rows, ..., each group
//     by position; so a row is spilled iff its rank exceeds R*, the largest r
//     with sum_k min(cnt_k, r) < cap, or equals R* and its place in the
//     rank-R* group (a block-wide prefix count of one flag) lands at or past
//     cap. The second argsort, which the caller makes for the kept rows, is
//     not needed for it. The floor is a shared-memory atomicMin over the
//     bounds' order-preserving 64-bit keys.
// Both take a grid over lanes, one block per lane as for one sweep: every
// array carries a leading lane axis and block l reads and writes lane l's
// slices alone (a batch of per-k sweeps in one launch).
// Both are bound by launch latency: n_k <= ~40 k's, B <= 4 n_k rows of M
// devices, cap + B <= 36 n_k child rows, a few KB in and out, per lane.

#include "epilogue_row.cuh"
#include "per_k_row.cuh"

namespace {

using namespace dtk;

__global__ void bnb_epilogue_kernel(
    const float* __restrict__ lo_in, const float* __restrict__ hi_in,
    const float* __restrict__ v, const double* __restrict__ reduced,
    const float* __restrict__ y_dual, const float* __restrict__ z_dual,
    const float* __restrict__ f_dual, const double* __restrict__ res_bound,
    const double* __restrict__ parent_bound, const uint8_t* __restrict__ active,
    const double* __restrict__ obj_full, const double* __restrict__ threshold,
    const uint8_t* __restrict__ int_mask_all, const double* __restrict__ obj_const_all,
    const int* __restrict__ inst, const float* __restrict__ node_v,
    const float* __restrict__ node_y, const float* __restrict__ node_z,
    const float* __restrict__ node_f,
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
  const int q_inst = inst != nullptr ? inst[r] : 0;
  const uint8_t* int_mask = int_mask_all + (size_t)q_inst * nf;

  const EpiRow e = epi_row(BlockGroup{s_f, s_i}, nf, lo_in + ro, hi_in + ro, v + ro,
                           reduced + ro, int_mask, res_bound[r], obj_const_all[q_inst], act,
                           parent_bound[r], threshold[r], obj_full[r]);

  for (int j = tid; j < nf; j += bs) {
    float lo2, hi2, ha, lb;
    epi_tighten(lo_in[ro + j], hi_in[ro + j], reduced[ro + j], int_mask[j] != 0, e.budget,
                lo2, hi2);
    epi_split(e, j, lo2, hi2, ha, lb);
    lo_a[ro + j] = lo2;
    hi_a[ro + j] = ha;
    lo_b[ro + j] = lb;
    hi_b[ro + j] = hi2;
    v_new[ro + j] = act ? v[ro + j] : node_v[ro + j];
    z_new[ro + j] = act ? z_dual[ro + j] : node_z[ro + j];
    f_new[ro + j] = act ? f_dual[ro + j] : node_f[ro + j];
  }
  for (int i = tid; i < m; i += bs) {
    const size_t o = (size_t)r * m + i;
    y_new[o] = act ? y_dual[o] : node_y[o];
  }
  if (tid == 0) {
    bound_out[r] = e.bound;
    survive_out[r] = e.survive ? 1 : 0;
    warm_new[r] = (act || node_warm[r] != 0) ? 1 : 0;
  }
}

// Order-preserving 64-bit key of a double: a smaller double has a smaller
// key (-0.0 just below 0.0, a NaN of positive sign above +inf).
__device__ __forceinline__ unsigned long long order_key(double x) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(x);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double from_order_key(unsigned long long key) {
  const unsigned long long b = (key >> 63) ? (key & 0x7fffffffffffffffull) : ~key;
  return __longlong_as_double((long long)b);
}

__global__ void per_k_incumbent_kernel(
    const double* __restrict__ obj_full, const int* __restrict__ kidx_p, int B,
    const double* __restrict__ w_int, const double* __restrict__ n_int,
    const double* __restrict__ y_int, int M, const double* __restrict__ best_in,
    const double* __restrict__ w_in, const double* __restrict__ n_in,
    const double* __restrict__ y_in, int n_k, const int* __restrict__ node_kidx,
    int cap, double mip_gap, double* __restrict__ best_out,
    double* __restrict__ w_out, double* __restrict__ n_out,
    double* __restrict__ y_out, double* __restrict__ thr_rows) {
  extern __shared__ double s_thr[];  // n_k thresholds
  const size_t q = blockIdx.x;  // the lane
  obj_full += q * B;
  kidx_p += q * B;
  w_int += q * B * M;
  n_int += q * B * M;
  if (y_int != nullptr) y_int += q * B * M;
  best_in += q * n_k;
  best_out += q * n_k;
  w_in += q * n_k * M;
  n_in += q * n_k * M;
  y_in += q * n_k * M;
  w_out += q * n_k * M;
  n_out += q * n_k * M;
  y_out += q * n_k * M;
  node_kidx += q * cap;
  thr_rows += q * cap;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int k = wid; k < n_k; k += nw) {
    double v;
    int r_star;
    pk_best_row(B, k, kidx_p, obj_full, v, r_star);
    const double old = best_in[k];
    const bool improved = v < old;
    const double best = t_min(old, v);
    if (lane == 0) {
      best_out[k] = best;
      s_thr[k] = prune_threshold(best, mip_gap);
    }
    const size_t rs = (size_t)(r_star == INT_MAX ? 0 : r_star) * M;
    const size_t ko = (size_t)k * M;
    pk_take_row(M, improved, w_int + rs, n_int + rs, y_int != nullptr ? y_int + rs : nullptr,
                w_in + ko, n_in + ko, y_in + ko, w_out + ko, n_out + ko, y_out + ko);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < cap; r += blockDim.x) thr_rows[r] = s_thr[node_kidx[r]];
}

__global__ void per_k_rank_kernel(
    const long long* __restrict__ order, int total, const int* __restrict__ child_kidx,
    const uint8_t* __restrict__ child_active, const double* __restrict__ child_bound,
    int n_k, int cap, const double* __restrict__ dropped_in,
    long long* __restrict__ fair_key, double* __restrict__ dropped_out) {
  extern __shared__ unsigned long long s_min[];  // n_k floor keys
  int* s_run = (int*)(s_min + n_k);               // n_k counts of earlier tiles
  int* s_wc = s_run + n_k;                        // (warps, n_k) counts of this tile
  __shared__ int s_flag[32];
  __shared__ int s_R, s_AR;
  const size_t q = blockIdx.x;  // the lane
  order += q * total;
  child_kidx += q * total;
  child_active += q * total;
  child_bound += q * total;
  fair_key += q * total;
  dropped_in += q * n_k;
  dropped_out += q * n_k;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int nw = nt >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const long long stride = (long long)total + 1;
  for (int i = tid; i < n_k; i += nt) s_min[i] = order_key(INFINITY);

  // 1. Each active row's rank among its k's active rows, in position order.
  pk_ranks(
      total, n_k, s_run, s_wc,
      [&](int p) {
        const long long src = order[p];
        return child_active[src] != 0 ? child_kidx[src] : -1;
      },
      [&](int p, int k, int rank) {
        fair_key[p] = (k >= 0 ? (long long)rank : (long long)total) * stride + p;
      });

  // 2. R*: the largest rank r with A(r) = sum_k min(cnt_k, r) < cap (none
  // when every active row fits).
  if (tid == 0) {
    long long act = 0;
    int maxc = 0;
    for (int i = 0; i < n_k; ++i) {
      act += s_run[i];
      maxc = max(maxc, s_run[i]);
    }
    int R = INT_MAX, AR = 0;
    if (act > cap) {
      int lo = 0, hi = maxc;  // A(lo) < cap <= A(hi)
      while (hi - lo > 1) {
        const int mid = lo + (hi - lo) / 2;
        long long a = 0;
        for (int i = 0; i < n_k; ++i) a += min(s_run[i], mid);
        if (a < cap) lo = mid; else hi = mid;
      }
      long long a = 0;
      for (int i = 0; i < n_k; ++i) a += min(s_run[i], lo);
      R = lo;
      AR = (int)a;
    }
    s_R = R;
    s_AR = AR;
  }
  __syncthreads();

  // 3. The per-k floor of the spilled rows' bounds.
  const int R = s_R, AR = s_AR;
  if (R != INT_MAX) {
    int group = 0;  // rank-R* rows in earlier tiles
    for (int base = 0; base < total; base += nt) {
      const int p = base + tid;
      bool act = false;
      long long rank = -1;
      int k = 0;
      double bnd = 0.0;
      if (p < total) {
        const long long src = order[p];
        act = child_active[src] != 0;
        if (act) {
          rank = fair_key[p] / stride;
          k = child_kidx[src];
          bnd = child_bound[src];
        }
      }
      const bool in_group = act && rank == R;
      const unsigned bal = __ballot_sync(FULL, in_group);
      if (lane == 0) s_flag[wid] = __popc(bal);
      __syncthreads();
      int g = group + __popc(bal & lanes_below);
      for (int q = 0; q < wid; ++q) g += s_flag[q];
      if (act && (rank > R || (in_group && AR + g >= cap))) {
        atomicMin(&s_min[k], order_key(bnd));
      }
      for (int q = 0; q < nw; ++q) group += s_flag[q];
      __syncthreads();
    }
  }
  __syncthreads();
  for (int i = tid; i < n_k; i += nt) {
    dropped_out[i] = nan_min(dropped_in[i], from_order_key(s_min[i]));
  }
}

}  // namespace

extern "C" {

int dtk_bnb_epilogue(
    const float* lo, const float* hi, const float* v, const double* reduced,
    const float* y_dual, const float* z_dual, const float* f_dual,
    const double* res_bound, const double* parent_bound, const uint8_t* active,
    const double* obj_full, const double* threshold, const uint8_t* int_mask,
    const double* obj_const, const int* inst, const float* node_v, const float* node_y,
    const float* node_z, const float* node_f, const uint8_t* node_warm, int B,
    int nf, int m, double* bound, uint8_t* survive, float* lo_a, float* hi_a,
    float* lo_b, float* hi_b, float* v_new, float* y_new, float* z_new,
    float* f_new, uint8_t* warm_new, int threads, void* stream) {
  bnb_epilogue_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      lo, hi, v, reduced, y_dual, z_dual, f_dual, res_bound, parent_bound,
      active, obj_full, threshold, int_mask, obj_const, inst, node_v, node_y, node_z,
      node_f, node_warm, nf, m, bound, survive, lo_a, hi_a, lo_b, hi_b, v_new,
      y_new, z_new, f_new, warm_new);
  return (int)cudaGetLastError();
}

int dtk_bnb_per_k_incumbent(
    const double* obj_full, const int* kidx_p, int B, const double* w_int,
    const double* n_int, const double* y_int, int M, const double* best_in,
    const double* w_in, const double* n_in, const double* y_in, int n_k,
    const int* node_kidx, int cap, double mip_gap, double* best_out, double* w_out,
    double* n_out, double* y_out, double* thr_rows, int lanes, int threads,
    void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t sm = sizeof(double) * (size_t)n_k;
  if (sm > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return 0;
  per_k_incumbent_kernel<<<lanes, threads, sm, (cudaStream_t)stream>>>(
      obj_full, kidx_p, B, w_int, n_int, y_int, M, best_in, w_in, n_in, y_in, n_k,
      node_kidx, cap, mip_gap, best_out, w_out, n_out, y_out, thr_rows);
  return (int)cudaGetLastError();
}

int dtk_bnb_per_k_rank(const long long* order, int total, const int* child_kidx,
                       const uint8_t* child_active, const double* child_bound,
                       int n_k, int cap, const double* dropped_in,
                       long long* fair_key, double* dropped_out, int lanes,
                       int threads, void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t sm = (size_t)n_k * (sizeof(unsigned long long) + sizeof(int) * (1 + threads / 32));
  if (sm > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        per_k_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
    if (err != cudaSuccess) return (int)err;
  }
  if (lanes <= 0) return 0;
  per_k_rank_kernel<<<lanes, threads, sm, (cudaStream_t)stream>>>(
      order, total, child_kidx, child_active, child_bound, n_k, cap, dropped_in,
      fair_key, dropped_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
