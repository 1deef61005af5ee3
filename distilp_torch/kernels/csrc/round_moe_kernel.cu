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
// Per-row instance: `rd` is a stack of (RD_ROWS, M) blocks and `E` one
// expert count per block; row r prices against block inst[r] (inst ==
// nullptr: block 0 for every row), so the rows of several sweeps round in
// one launch, as the reference's vmap over sweeps does. The hint mode
// (y_steps >= 0) takes the same index.
// A candidate's price is computed by one thread over the M devices in
// device order (the plain version sums in the same order), so equal-cost
// candidates tie, and the first-index argmin breaks the tie, the same way
// in both.
//
// The delta table: a candidate changes y at two devices at most, by one of
// 0, +-1, +-2, +-4, +-8, +-16. The block keeps, for every device j and each
// of those 11 deltas, j's (ok, lin, cy) at y_j + delta in shared memory
// (in a global workspace, a table a row, where the row's arrays and its
// table do not fit a block's shared memory together: M > 668 on an H100),
// priced with price()'s expressions; a candidate's price is price()'s loop
// over the devices reading the table (delta 0 except at its one or two
// devices), so it is price() bit for bit, with no divide and no ceil. After
// a repair step or a move only the moved devices' entries are priced again.
//
// What bounds it on an H100: latency. A move step prices 5 M^2 candidates
// of M devices each (M=32: 164k device terms, each a few shared-memory
// reads and two float64 operations) and a repair step M; the batch is at
// most 16 rows. Bytes are a few kilobytes per row. The design keeps the
// row's state, every per-device constant and the delta table in shared
// memory, gives each thread a slice of the candidates, and picks the winner
// with one block-wide first-index argmin per step. Built with --fmad=false:
// the ceil staircases must see the same products as the plain version.
//
// B14, dtk_price_fixed_f64: price() alone over a batch of fixed assignments,
// one block each (distilp_tpu/solver/backend_jax.py:791
// price_fixed_assignment; load-aware routing compares its iterates with it at
// their realized expert loads). Latency-bound: a few float64 operations per
// device, one thread sums the devices in order as the plain version does.

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

// Device j's share of price() at y_j = yj: ok when neither slack passes its
// cap, its linear cost lin and its cycle term cy = (lin + busy) + half fetch.
__device__ __forceinline__ bool device_cost(const Row& r, int j, double yj, double& lin,
                                            double& cy) {
  const double bp = r.bp;
  const double viol_ram =
      nan_max((r.a(S_BASE_RES)[j] + r.a(S_EBR)[j] * yj) - r.a(S_RAM_RHS)[j], 0.0);
  const double s_ram = ceil(viol_ram / bp - 1e-9);
  double viol_vram = nan_max(nan_max((r.a(S_BN)[j] + r.a(S_EBV)[j] * yj) - r.a(S_CUDA)[j],
                                     (r.a(S_BN)[j] + r.a(S_EBM)[j] * yj) - r.a(S_METAL)[j]),
                             0.0);
  if (!isfinite(viol_vram)) viol_vram = 0.0;
  const double t = ceil(viol_vram / bp - 1e-9);
  const double pen_cost = r.a(S_PEN_SET)[j] * s_ram + r.a(S_PEN_VRAM)[j] * t;
  lin = (r.a(S_AW_BN)[j] + pen_cost) + r.a(S_GK)[j] * yj;
  cy = (lin + r.a(S_BUSY)[j]) + r.a(S_HALF_FETCH)[j];
  return (s_ram <= r.a(S_WCAP)[j]) && (t <= r.a(S_NTOL)[j]);
}

// Exact objective of the row's y with y[i1] += d1 and y[i2] += d2 (i1, i2
// may be -1). +inf when a slack cap is exceeded.
__device__ double price(const Row& r, int i1, double d1, int i2, double d2) {
  const double* y = r.a(S_Y);
  double cmax = -INFINITY, total = 0.0;
  for (int j = 0; j < r.M; ++j) {
    double yj = y[j];
    if (j == i1) yj = yj + d1;
    if (j == i2) yj = yj + d2;
    double lin, cy;
    if (!device_cost(r, j, yj, lin, cy)) return INFINITY;
    cmax = nan_max(cmax, cy);
    total = total + lin;
  }
  return (r.kf - 1.0) * cmax + total;
}

// The delta table of a row: device j's (ok, lin, cy) at y_j + delta for the
// N_DELTA deltas {0, +1, -1, +2, -2, ..., +16, -16} (entry e: +q at
// 1 + 2 log2 q, -q at 2 + 2 log2 q), in shared memory as [e][j]. Every
// candidate of the repair (one device +-1) and of the moves (q from i to j)
// changes y at two devices at most, so its price is the same loop as
// price() over the table's entries: no divide and no ceil per candidate.
constexpr int N_DELTA = 11;

struct Tab {
  double* lin;  // (N_DELTA, M)
  double* cy;
  unsigned char* ok;
};

// Bytes of one row's table: lin and cy, then ok.
__host__ __device__ __forceinline__ size_t tab_bytes(int M) {
  return (sizeof(double) * 2 * N_DELTA + N_DELTA) * (size_t)M;
}

// Bytes of one row's table in the global workspace (256-byte aligned rows).
__host__ __device__ __forceinline__ size_t tab_row_bytes(int M) {
  return (tab_bytes(M) + 255) & ~(size_t)255;
}

__device__ __forceinline__ double delta_of(int e) {
  const double q = (double)(1 << ((e - 1) >> 1));
  return (e & 1) ? q : -q;
}

// Entry e of device j from the row's current y (price()'s expressions).
__device__ __forceinline__ void tab_entry(const Row& r, const Tab& tb, int j, int e) {
  double yj = r.a(S_Y)[j];
  if (e != 0) yj = yj + delta_of(e);
  double lin, cy;
  const bool ok = device_cost(r, j, yj, lin, cy);
  const int o = e * r.M + j;
  tb.lin[o] = lin;
  tb.cy[o] = cy;
  tb.ok[o] = ok;
}

// price() of y with device i1 at entry e1 and i2 at entry e2 (i1, i2 may be
// -1): device order, the same nan_max and the same sequential sum.
__device__ __forceinline__ double price_tab(const Row& r, const Tab& tb, int i1, int e1,
                                            int i2, int e2) {
  double cmax = -INFINITY, total = 0.0;
  for (int j = 0; j < r.M; ++j) {
    const int o = (j == i1 ? e1 : j == i2 ? e2 : 0) * r.M + j;
    if (!tb.ok[o]) return INFINITY;
    cmax = nan_max(cmax, tb.cy[o]);
    total = total + tb.lin[o];
  }
  return (r.kf - 1.0) * cmax + total;
}

// The table's entries of devices i1 and i2 (i2 may be -1) after their y
// changed. Contains __syncthreads.
__device__ void tab_update(const Row& r, const Tab& tb, int i1, int i2) {
  const int tid = threadIdx.x;
  if (tid < N_DELTA) tab_entry(r, tb, i1, tid);
  if (i2 >= 0 && tid >= 32 && tid < 32 + N_DELTA) tab_entry(r, tb, i2, tid - 32);
  __syncthreads();
}

// Device j's constants of price() from its w and n (in shared memory), the
// packed rounding data, b', W and k.
__device__ void price_constants(double* sm, const double* rd, int M, int j, double bp,
                                double Wf, double kf) {
  auto rdv = [&](int row) { return rd[(size_t)row * M + j]; };
  const double wj = sm[(size_t)S_W * M + j], nj = sm[(size_t)S_N * M + j];
  sm[(size_t)S_BASE_RES * M + j] = bp * wj - (bp * nj) * rdv(RD_RAM_MINUS_N);
  sm[(size_t)S_BN * M + j] = bp * nj;
  sm[(size_t)S_WCAP * M + j] = nan_min(wj, Wf);
  sm[(size_t)S_NTOL * M + j] = nj + 1e-9;
  sm[(size_t)S_AW_BN * M + j] = rdv(RD_A) * wj + rdv(RD_B_GPU) * nj;
  sm[(size_t)S_HALF_FETCH * M + j] = 0.5 * ((bp / rdv(RD_S_DISK)) * wj);
  sm[(size_t)S_GK * M + j] = rdv(RD_G_RAW) / kf;
  sm[(size_t)S_EBR * M + j] = rdv(RD_EB_RAM);
  sm[(size_t)S_EBV * M + j] = rdv(RD_EB_VRAM);
  sm[(size_t)S_EBM * M + j] = rdv(RD_EB_METAL);
  sm[(size_t)S_RAM_RHS * M + j] = rdv(RD_RAM_RHS);
  sm[(size_t)S_CUDA * M + j] = rdv(RD_CUDA_RHS);
  sm[(size_t)S_METAL * M + j] = rdv(RD_METAL_RHS);
  sm[(size_t)S_PEN_SET * M + j] = rdv(RD_PEN_SET);
  sm[(size_t)S_PEN_VRAM * M + j] = rdv(RD_PEN_VRAM);
  sm[(size_t)S_BUSY * M + j] = rdv(RD_BUSY_CONST);
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

// kGlobalTab: the delta table in ``tab_ws`` (row r at r tab_row_bytes(M)),
// else in shared memory after the row's arrays.
template <typename Tv, bool kGlobalTab>
__global__ void round_moe_kernel(const Tv* __restrict__ v, long v_stride,
                                 const double* __restrict__ Wr,
                                 const double* __restrict__ kr,
                                 const double* __restrict__ rd_all,
                                 const double* __restrict__ E_all,
                                 const int* __restrict__ inst, int M, int y_steps,
                                 int moves, double* __restrict__ obj_out,
                                 double* __restrict__ w_out,
                                 double* __restrict__ n_out,
                                 double* __restrict__ y_out,
                                 unsigned char* __restrict__ tab_ws) {
  extern __shared__ double sm[];
  __shared__ double red_v[32];
  __shared__ int red_i[32];
  __shared__ double cur_price;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const Tv* vr = v + (size_t)r * v_stride;
  const int q_inst = inst != nullptr ? inst[r] : 0;
  const double* rd = rd_all + (size_t)q_inst * RD_ROWS * M;
  const double* E_ptr = E_all + q_inst;
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
    price_constants(sm, rd, M, j, bp, Wf, kf);
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
  double* tab_d = kGlobalTab
                      ? reinterpret_cast<double*>(tab_ws + (size_t)r * tab_row_bytes(M))
                      : sm + (size_t)S_ARRAYS * M;
  const Tab tb{tab_d, tab_d + (size_t)N_DELTA * M,
               reinterpret_cast<unsigned char*>(tab_d + (size_t)2 * N_DELTA * M)};

  // 2. Expert counts, then the delta table of the row's y.
  if (y_steps < 0) {
    if (tid < 32) {
      redistribute(y, rem, M, E, [](int) { return 0.0; }, [&](int) { return E; });
    }
    __syncthreads();
  }
  for (int o = tid; o < N_DELTA * M; o += nt) tab_entry(row, tb, o % M, o / M);
  __syncthreads();
  if (y_steps >= 0) {
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
          c = y[i] < E ? price_tab(row, tb, i, 1, -1, 0) : INFINITY;
        } else {
          c = y[i] > 0.0 ? price_tab(row, tb, i, 2, -1, 0) : INFINITY;
        }
        argmin_combine(best, bi, c, i);
      }
      block_argmin(best, bi, red_v, red_i);
      if (bi == INT_MAX) bi = 0;
      if (tid == 0) y[bi] += d > 0.0 ? 1.0 : -1.0;
      __syncthreads();
      tab_update(row, tb, bi, -1);
    }
  }

  // 3. Expert moves: q experts from i to j, the best of all 5 M M.
  const int MM = M * M;
  for (int step = 0; step < moves; ++step) {
    if (tid == 0) cur_price = price_tab(row, tb, -1, 0, -1, 0);
    double best = INFINITY;
    int bf = INT_MAX;
    for (int f = tid; f < 5 * MM; f += nt) {
      const int qi = f / MM;
      const int i = (f / M) % M;
      const int j = f % M;
      const double q = (double)(1 << qi);
      double c = INFINITY;
      if (i != j && y[i] >= q && y[j] + q <= E)
        c = price_tab(row, tb, i, 2 + 2 * qi, j, 1 + 2 * qi);
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
    if (better) tab_update(row, tb, (bf / M) % M, bf % M);
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

// B14: the exact objective of fixed integer assignments (w, n, y), one block
// each: price() of the assignment as it is, +inf when it is infeasible
// (sum w != W, some w < 1, sum y != E, or a slack past its cap). No
// rounding, no repair, no moves.
__global__ void price_fixed_kernel(const double* __restrict__ w_in,
                                   const double* __restrict__ n_in,
                                   const double* __restrict__ y_in,
                                   const double* __restrict__ Wr,
                                   const double* __restrict__ kr,
                                   const double* __restrict__ rd,
                                   const double* __restrict__ E_ptr, int M,
                                   double* __restrict__ obj_out) {
  extern __shared__ double sm[];
  __shared__ int s_ok;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  double* w = sm + (size_t)S_W * M;
  double* n = sm + (size_t)S_N * M;
  double* y = sm + (size_t)S_Y * M;
  const double bp = rd[(size_t)RD_BPRIME * M];
  const double Wf = Wr[r];
  const double kf = kr[r];
  if (tid == 0) s_ok = 1;
  __syncthreads();
  for (int j = tid; j < M; j += nt) {
    const size_t o = (size_t)r * M + j;
    w[j] = w_in[o];
    n[j] = n_in[o];
    y[j] = y_in[o];
    if (!(w[j] >= 1.0)) s_ok = 0;
    price_constants(sm, rd, M, j, bp, Wf, kf);
  }
  __syncthreads();
  if (tid == 0) {
    double sw = 0.0, sy = 0.0;
    for (int j = 0; j < M; ++j) {
      sw += w[j];
      sy += y[j];
    }
    const bool valid = s_ok != 0 && sw == Wf && sy == *E_ptr;
    obj_out[r] = valid ? price(Row{sm, M, bp, kf}, -1, 0.0, -1, 0.0) : INFINITY;
  }
}

// Shared memory of a block: the row's arrays, then (table in shared
// memory) the delta table.
size_t moe_smem(int M, bool table) {
  return sizeof(double) * (size_t)S_ARRAYS * M + (table ? tab_bytes(M) : 0);
}

int smem_optin(size_t* out) {
  int dev = 0, v = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *out = (size_t)v;
  return (int)err;
}

template <typename Tv, bool kGlobalTab>
int launch_as(const Tv* v, long v_stride, const double* Wr, const double* kr,
              const double* rd, const double* E, const int* inst, int M, int B,
              int y_steps, int moves, double* obj, double* w, double* n, double* y,
              unsigned char* tab_ws, int threads, cudaStream_t stream) {
  const size_t sm = moe_smem(M, !kGlobalTab);
  if (sm > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(round_moe_kernel<Tv, kGlobalTab>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
    if (err != cudaSuccess) return (int)err;
  }
  round_moe_kernel<Tv, kGlobalTab><<<B, threads, sm, stream>>>(
      v, v_stride, Wr, kr, rd, E, inst, M, y_steps, moves, obj, w, n, y, tab_ws);
  return (int)cudaGetLastError();
}

// tab_ws null: the delta table in shared memory; else B tables of
// tab_row_bytes(M) there (tab_len bytes).
template <typename Tv>
int launch(const Tv* v, long v_stride, const double* Wr, const double* kr,
           const double* rd, const double* E, const int* inst, int M, int B,
           int y_steps, int moves, double* obj, double* w, double* n, double* y,
           void* tab_ws, long tab_len, int threads, cudaStream_t stream) {
  if (threads % 32 != 0 || threads < 64 || threads > 1024) return (int)cudaErrorInvalidValue;
  if (tab_ws == nullptr)
    return launch_as<Tv, false>(v, v_stride, Wr, kr, rd, E, inst, M, B, y_steps, moves, obj,
                                w, n, y, nullptr, threads, stream);
  if (tab_len < 0 || (size_t)tab_len < (size_t)B * tab_row_bytes(M))
    return (int)cudaErrorInvalidValue;
  return launch_as<Tv, true>(v, v_stride, Wr, kr, rd, E, inst, M, B, y_steps, moves, obj, w,
                             n, y, static_cast<unsigned char*>(tab_ws), threads, stream);
}

}  // namespace

extern "C" {

// Bytes of the global workspace a launch of B rows at M devices needs for
// its delta tables: 0 where a block's shared memory holds the row's arrays
// and its table together (then the launch takes no workspace), or minus a
// cudaError_t.
long dtk_round_moe_tab_bytes(int M, int B) {
  size_t optin = 0;
  int err = smem_optin(&optin);
  cudaFuncAttributes fa;
  if (err == 0) err = (int)cudaFuncGetAttributes(&fa, round_moe_kernel<double, false>);
  if (err != 0) return -(long)err;
  return moe_smem(M, true) + fa.sharedSizeBytes <= optin
             ? 0
             : (long)((size_t)B * tab_row_bytes(M));
}

int dtk_round_moe_f32(const float* v, long v_stride, const double* Wr,
                      const double* kr, const double* rd, const double* E,
                      const int* inst, int M, int B, int y_steps, int moves,
                      double* obj, double* w, double* n, double* y, void* tab_ws,
                      long tab_len, int threads, void* stream) {
  return launch<float>(v, v_stride, Wr, kr, rd, E, inst, M, B, y_steps, moves, obj, w,
                       n, y, tab_ws, tab_len, threads, (cudaStream_t)stream);
}

int dtk_round_moe_f64(const double* v, long v_stride, const double* Wr,
                      const double* kr, const double* rd, const double* E,
                      const int* inst, int M, int B, int y_steps, int moves,
                      double* obj, double* w, double* n, double* y, void* tab_ws,
                      long tab_len, int threads, void* stream) {
  return launch<double>(v, v_stride, Wr, kr, rd, E, inst, M, B, y_steps, moves, obj, w,
                        n, y, tab_ws, tab_len, threads, (cudaStream_t)stream);
}

int dtk_price_fixed_f64(const double* w, const double* n, const double* y,
                        const double* Wr, const double* kr, const double* rd,
                        const double* E, int M, int P, double* obj, int threads,
                        void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t sm = sizeof(double) * (size_t)S_ARRAYS * M;
  if (sm > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        price_fixed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
    if (err != cudaSuccess) return (int)err;
  }
  price_fixed_kernel<<<P, threads, sm, (cudaStream_t)stream>>>(w, n, y, Wr, kr, rd, E,
                                                              M, obj);
  return (int)cudaGetLastError();
}

}  // extern "C"
