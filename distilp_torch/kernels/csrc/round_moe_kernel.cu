// K2, MoE part: exact integer rounding of LP points (or Lagrangian-primal
// hints) to MoE MILP incumbents, one thread block per row, in float64.
//
// Replaces the MoE branch of distilp_tpu/solver/backend_jax.py::
// _round_to_incumbent (vmapped over the frontier rows of a branch-and-bound
// round, over the per-k Lagrangian-primal hints, and called once on a warm
// hint). Per row:
//   1. the layer counts w and GPU layers n as the dense rounding makes them
//      (floor, largest-remainder redistribution to sum W, n = round(n) in
//      [0, w]);
//   2. the expert counts y: from an LP point (y_steps < 0) floor and the
//      same redistribution to sum E; from a hint (y_steps >= 0) round, then
//      y_steps greedy steps that add the unit where the exact objective grows
//      least (sum(y) < E) or remove it where it shrinks most (sum(y) > E),
//      pricing the M unit-add or unit-remove candidates;
//   3. `moves` steps of a local search over the 5 M M transfers of
//      q in {1, 2, 4, 8, 16} experts from device i to device j (i != j): the
//      flat first argmin over (q, i, j), taken when it beats the current
//      price by more than 1e-12;
//   4. the exact objective (k-1) C + sum(lin), +inf when infeasible.
// A candidate's price is computed by one thread over the M devices in
// device order (the plain version sums in the same order), so equal-cost
// candidates tie, and the first-index argmin breaks the tie, the same way
// in both.
//
// What bounds it on an H100: latency. A move step prices 5 M^2 candidates
// of M devices each (M=32: 164k device evaluations, ~40 float64 operations
// each) and a repair step 2M; the batch is at most 16 rows. Bytes are a few
// kilobytes per row. The design keeps the row's state and every per-device
// constant in shared memory, gives each thread a slice of the candidates,
// and picks the winner with one block-wide first-index argmin per step.
// Built with --fmad=false: the ceil staircases must see the same products as
// the plain version.

#include "common.cuh"

namespace {

using namespace dtk;

// Row indices of the packed rounding-data matrix (RD_ROWS, M).
enum {
  RD_A = 0,
  RD_B_GPU,
  RD_PEN_SET,
  RD_PEN_VRAM,
  RD_BUSY_CONST,
  RD_S_DISK,
  RD_RAM_RHS,
  RD_RAM_MINUS_N,
  RD_CUDA_RHS,
  RD_METAL_RHS,
  RD_HAS_GPU,
  RD_W_ACTIVE,
  RD_BPRIME,  // b' broadcast over the row
  RD_G_RAW,
  RD_EB_RAM,
  RD_EB_VRAM,
  RD_EB_METAL,
  RD_ROWS
};

// Shared per-device arrays of one row.
enum {
  S_W = 0,
  S_N,
  S_Y,
  S_REM,
  S_BASE_RES,   // b' w - (b' n) ram_minus_n
  S_BN,         // b' n
  S_WCAP,       // min(w, W)
  S_NTOL,       // n + 1e-9
  S_AW_BN,      // a w + b_gpu n
  S_HALF_FETCH, // 0.5 (b' / s_disk) w
  S_GK,         // g_raw / k
  S_EBR,
  S_EBV,
  S_EBM,
  S_RAM_RHS,
  S_CUDA,
  S_METAL,
  S_PEN_SET,
  S_PEN_VRAM,
  S_BUSY,
  S_ARRAYS
};

struct Row {
  const double* s;  // shared arrays, S_ARRAYS x M
  int M;
  double bp, kf;
  __device__ __forceinline__ const double* a(int k) const { return s + (size_t)k * M; }
};

// Exact objective of the row's y with y[i1] += d1 and y[i2] += d2 (i1, i2
// may be -1). +inf when a slack cap is exceeded.
__device__ double price(const Row& r, int i1, double d1, int i2, double d2) {
  const double* y = r.a(S_Y);
  const double* base_res = r.a(S_BASE_RES);
  const double* bn = r.a(S_BN);
  const double* wcap = r.a(S_WCAP);
  const double* ntol = r.a(S_NTOL);
  const double* aw_bn = r.a(S_AW_BN);
  const double* half_fetch = r.a(S_HALF_FETCH);
  const double* gk = r.a(S_GK);
  const double* ebr = r.a(S_EBR);
  const double* ebv = r.a(S_EBV);
  const double* ebm = r.a(S_EBM);
  const double* ram_rhs = r.a(S_RAM_RHS);
  const double* cuda = r.a(S_CUDA);
  const double* metal = r.a(S_METAL);
  const double* pen_set = r.a(S_PEN_SET);
  const double* pen_vram = r.a(S_PEN_VRAM);
  const double* busy = r.a(S_BUSY);
  const double bp = r.bp;
  double cmax = -INFINITY, total = 0.0;
  for (int j = 0; j < r.M; ++j) {
    double yj = y[j];
    if (j == i1) yj = yj + d1;
    if (j == i2) yj = yj + d2;
    const double viol_ram = nan_max((base_res[j] + ebr[j] * yj) - ram_rhs[j], 0.0);
    const double s_ram = ceil(viol_ram / bp - 1e-9);
    if (!(s_ram <= wcap[j])) return INFINITY;
    double viol_vram = nan_max(nan_max((bn[j] + ebv[j] * yj) - cuda[j],
                                       (bn[j] + ebm[j] * yj) - metal[j]),
                               0.0);
    if (!isfinite(viol_vram)) viol_vram = 0.0;
    const double t = ceil(viol_vram / bp - 1e-9);
    if (!(t <= ntol[j])) return INFINITY;
    const double pen_cost = pen_set[j] * s_ram + pen_vram[j] * t;
    const double lin = (aw_bn[j] + pen_cost) + gk[j] * yj;
    cmax = nan_max(cmax, (lin + busy[j]) + half_fetch[j]);
    total = total + lin;
  }
  return (r.kf - 1.0) * cmax + total;
}

// _int_redistribute on warp 0: M + 4 unit moves of vals toward sum ==
// target, by largest remainder up and smallest down (jnp.argmax rules).
template <typename Lo, typename Hi>
__device__ void redistribute(double* vals, const double* rem, int M, double target,
                             Lo lo, Hi hi) {
  const int lane = threadIdx.x & 31;
  double sum = 0.0;
  for (int j = lane; j < M; j += 32) sum += vals[j];
  double d = target - warp_reduce(sum, Sum());
  for (int step = 0; step < M + 4; ++step) {
    if (!(d > 0.0) && !(d < 0.0)) break;  // d == 0 (or NaN) never moves
    double best = -INFINITY;
    int bi = INT_MAX;
    for (int j = lane; j < M; j += 32) {
      const double sc = d > 0.0 ? (vals[j] < hi(j) ? rem[j] : -INFINITY)
                                : (vals[j] > lo(j) ? -rem[j] : -INFINITY);
      argmax_combine(best, bi, sc, j);
    }
    warp_argmax(best, bi);
    if (bi == INT_MAX) bi = 0;
    __syncwarp();
    if (lane == 0) vals[bi] += d > 0.0 ? 1.0 : -1.0;
    __syncwarp();
    d += d > 0.0 ? -1.0 : 1.0;
  }
}

template <typename Tv>
__global__ void round_moe_kernel(const Tv* __restrict__ v, long v_stride,
                                 const double* __restrict__ Wr,
                                 const double* __restrict__ kr,
                                 const double* __restrict__ rd,
                                 const double* __restrict__ E_ptr, int M, int y_steps,
                                 int moves, double* __restrict__ obj_out,
                                 double* __restrict__ w_out,
                                 double* __restrict__ n_out,
                                 double* __restrict__ y_out) {
  extern __shared__ double sm[];
  __shared__ double red_v[32];
  __shared__ int red_i[32];
  __shared__ double cur_price;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const Tv* vr = v + (size_t)r * v_stride;
  const double* RD = rd;
  auto rdv = [&](int row, int j) { return RD[(size_t)row * M + j]; };
  double* w = sm + (size_t)S_W * M;
  double* n = sm + (size_t)S_N * M;
  double* y = sm + (size_t)S_Y * M;
  double* rem = sm + (size_t)S_REM * M;
  const double bp = rd[(size_t)RD_BPRIME * M];
  const double Wf = Wr[r];
  const double kf = kr[r];
  const double E = *E_ptr;

  // 1. Layers: floor + redistribution to sum W (as the dense kernel).
  for (int j = tid; j < M; j += nt) {
    const double wfr = (double)vr[j];
    const double fl = floor(wfr);
    rem[j] = wfr - fl;
    w[j] = clip(fl, rdv(RD_W_ACTIVE, j), Wf * rdv(RD_W_ACTIVE, j));
  }
  __syncthreads();
  if (tid < 32) {
    redistribute(w, rem, M, Wf, [&](int j) { return rdv(RD_W_ACTIVE, j); },
                 [&](int j) { return Wf * rdv(RD_W_ACTIVE, j); });
  }
  __syncthreads();
  for (int j = tid; j < M; j += nt) {
    n[j] = clip(rint((double)vr[M + j]), 0.0, w[j]) * rdv(RD_HAS_GPU, j);
  }
  __syncthreads();

  // Per-device constants of the pricer.
  for (int j = tid; j < M; j += nt) {
    const double wj = w[j], nj = n[j];
    sm[(size_t)S_BASE_RES * M + j] = bp * wj - (bp * nj) * rdv(RD_RAM_MINUS_N, j);
    sm[(size_t)S_BN * M + j] = bp * nj;
    sm[(size_t)S_WCAP * M + j] = nan_min(wj, Wf);
    sm[(size_t)S_NTOL * M + j] = nj + 1e-9;
    sm[(size_t)S_AW_BN * M + j] = rdv(RD_A, j) * wj + rdv(RD_B_GPU, j) * nj;
    sm[(size_t)S_HALF_FETCH * M + j] = 0.5 * ((bp / rdv(RD_S_DISK, j)) * wj);
    sm[(size_t)S_GK * M + j] = rdv(RD_G_RAW, j) / kf;
    sm[(size_t)S_EBR * M + j] = rdv(RD_EB_RAM, j);
    sm[(size_t)S_EBV * M + j] = rdv(RD_EB_VRAM, j);
    sm[(size_t)S_EBM * M + j] = rdv(RD_EB_METAL, j);
    sm[(size_t)S_RAM_RHS * M + j] = rdv(RD_RAM_RHS, j);
    sm[(size_t)S_CUDA * M + j] = rdv(RD_CUDA_RHS, j);
    sm[(size_t)S_METAL * M + j] = rdv(RD_METAL_RHS, j);
    sm[(size_t)S_PEN_SET * M + j] = rdv(RD_PEN_SET, j);
    sm[(size_t)S_PEN_VRAM * M + j] = rdv(RD_PEN_VRAM, j);
    sm[(size_t)S_BUSY * M + j] = rdv(RD_BUSY_CONST, j);
    const double yfr = (double)vr[2 * M + j];
    if (y_steps < 0) {
      const double fl = floor(yfr);
      rem[j] = yfr - fl;
      y[j] = clip(fl, 0.0, E);
    } else {
      y[j] = clip(rint(yfr), 0.0, E);
    }
  }
  __syncthreads();
  const Row row{sm, M, bp, kf};

  // 2. Expert counts.
  if (y_steps < 0) {
    if (tid < 32) {
      redistribute(y, rem, M, E, [](int) { return 0.0; }, [&](int) { return E; });
    }
    __syncthreads();
  } else {
    for (int step = 0; step < y_steps; ++step) {
      double sy = 0.0;
      for (int j = 0; j < M; ++j) sy += y[j];  // integers: exact in any order
      const double d = E - sy;
      if (!(d > 0.0) && !(d < 0.0)) break;  // y no longer changes
      double best = INFINITY;
      int bi = INT_MAX;
      for (int i = tid; i < M; i += nt) {
        double c;
        if (d > 0.0) {
          c = y[i] < E ? price(row, i, 1.0, -1, 0.0) : INFINITY;
        } else {
          c = y[i] > 0.0 ? price(row, i, -1.0, -1, 0.0) : INFINITY;
        }
        argmin_combine(best, bi, c, i);
      }
      block_argmin(best, bi, red_v, red_i);
      if (bi == INT_MAX) bi = 0;
      if (tid == 0) y[bi] += d > 0.0 ? 1.0 : -1.0;
      __syncthreads();
    }
  }

  // 3. Expert moves: q experts from i to j, the best of all 5 M M.
  const int MM = M * M;
  for (int step = 0; step < moves; ++step) {
    if (tid == 0) cur_price = price(row, -1, 0.0, -1, 0.0);
    double best = INFINITY;
    int bf = INT_MAX;
    for (int f = tid; f < 5 * MM; f += nt) {
      const int qi = f / MM;
      const int i = (f / M) % M;
      const int j = f % M;
      const double q = (double)(1 << qi);
      double c = INFINITY;
      if (i != j && y[i] >= q && y[j] + q <= E) c = price(row, i, -q, j, q);
      argmin_combine(best, bf, c, f);
    }
    block_argmin(best, bf, red_v, red_i);  // its barriers publish cur_price
    if (bf == INT_MAX) bf = 0;
    const bool better = best < cur_price - 1e-12;
    __syncthreads();
    if (better && tid == 0) {
      const double q = (double)(1 << (bf / MM));
      y[(bf / M) % M] -= q;
      y[bf % M] += q;
    }
    __syncthreads();
  }

  // 4. The exact objective.
  if (tid == 0) {
    double sw = 0.0, sy = 0.0;
    for (int j = 0; j < M; ++j) {
      sw += w[j];
      sy += y[j];
    }
    const bool valid = sw == Wf && sy == E;
    obj_out[r] = valid ? price(row, -1, 0.0, -1, 0.0) : INFINITY;
  }
  for (int j = tid; j < M; j += nt) {
    w_out[(size_t)r * M + j] = w[j];
    n_out[(size_t)r * M + j] = n[j];
    y_out[(size_t)r * M + j] = y[j];
  }
}

template <typename Tv>
int launch(const Tv* v, long v_stride, const double* Wr, const double* kr,
           const double* rd, const double* E, int M, int B, int y_steps, int moves,
           double* obj, double* w, double* n, double* y, int threads,
           cudaStream_t stream) {
  if (threads % 32 != 0 || threads < 32 || threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t sm = sizeof(double) * (size_t)S_ARRAYS * M;
  if (sm > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        round_moe_kernel<Tv>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
    if (err != cudaSuccess) return (int)err;
  }
  round_moe_kernel<Tv><<<B, threads, sm, stream>>>(v, v_stride, Wr, kr, rd, E, M,
                                                  y_steps, moves, obj, w, n, y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dtk_round_moe_f32(const float* v, long v_stride, const double* Wr,
                      const double* kr, const double* rd, const double* E, int M,
                      int B, int y_steps, int moves, double* obj, double* w,
                      double* n, double* y, int threads, void* stream) {
  return launch<float>(v, v_stride, Wr, kr, rd, E, M, B, y_steps, moves, obj, w, n,
                       y, threads, (cudaStream_t)stream);
}

int dtk_round_moe_f64(const double* v, long v_stride, const double* Wr,
                      const double* kr, const double* rd, const double* E, int M,
                      int B, int y_steps, int moves, double* obj, double* w,
                      double* n, double* y, int threads, void* stream) {
  return launch<double>(v, v_stride, Wr, kr, rd, E, M, B, y_steps, moves, obj, w, n,
                        y, threads, (cudaStream_t)stream);
}

}  // extern "C"
