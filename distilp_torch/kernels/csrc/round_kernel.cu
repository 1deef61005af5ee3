// K2: exact integer rounding of dense LP points to MILP incumbents, one warp
// per row, in float64.
//
// Replaces distilp_tpu/solver/backend_jax.py::_int_redistribute and the dense
// branch of ::_round_to_incumbent (vmapped over the frontier rows of a
// branch-and-bound round, and called once on the warm hint). Per row: floor
// the LP layer counts w and redistribute them one unit at a time toward
// sum(w) == W by largest fractional remainder, in an (M+4)-step scan whose
// argmax follows jnp.argmax (first index of the maximum; index 0 when every
// score is -inf, so a blocked step still moves device 0); round n <= w; the
// closed-form RAM and VRAM slacks; the cycle C = max(busy + fetch/2); the
// exact objective (k-1) C + sum(lin), +inf when the point is infeasible.
//
// What bounds it on an H100: a row is O(M^2) scalar float64 work over a few
// hundred bytes of input (M=16: 16 devices, 20 scan steps of a 16-wide
// argmax); the batch is at most a few dozen rows. Latency of one warp per
// row, not bytes or FLOPs. The design keeps a row's w and remainders in
// shared memory and every reduction in warp shuffles: no block barrier.

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
  RD_ROWS
};

template <typename Tv>
__global__ void round_kernel(const Tv* __restrict__ v, long v_stride,
                             const double* __restrict__ Wr,
                             const double* __restrict__ kr,
                             const double* __restrict__ rd, int M,
                             int B, double* __restrict__ obj_out,
                             double* __restrict__ w_out,
                             double* __restrict__ n_out) {
  extern __shared__ double sm[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + wid;
  if (r >= B) return;  // the whole warp leaves together
  double* w = sm + (size_t)wid * 2 * M;
  double* rem = w + M;
  const Tv* vr = v + (size_t)r * v_stride;
  const double* w_active = rd + (size_t)RD_W_ACTIVE * M;
  const double bp = rd[(size_t)RD_BPRIME * M];
  const double Wf = Wr[r];
  const double kf = kr[r];
  const double inf = INFINITY;

  double sw = 0.0;
  for (int j = lane; j < M; j += 32) {
    const double wfr = (double)vr[j];
    const double fl = floor(wfr);
    rem[j] = wfr - fl;
    const double wj = clip(fl, w_active[j], Wf * w_active[j]);
    w[j] = wj;
    sw += wj;
  }
  double d = Wf - warp_reduce(sw, Sum());
  __syncwarp();

  // _int_redistribute: M + 4 unit moves toward sum(w) == W. A step with
  // d == 0 (or NaN) changes nothing, and d then stays put: stop there.
  for (int step = 0; step < M + 4; ++step) {
    if (!(d > 0.0) && !(d < 0.0)) break;
    double best = -inf;
    int bi = INT_MAX;
    for (int j = lane; j < M; j += 32) {
      const double lo = w_active[j];
      const double hi = Wf * w_active[j];
      const double sc = d > 0.0 ? (w[j] < hi ? rem[j] : -inf)
                                : (w[j] > lo ? -rem[j] : -inf);
      argmax_combine(best, bi, sc, j);
    }
    warp_argmax(best, bi);
    if (bi == INT_MAX) bi = 0;
    __syncwarp();
    if (lane == 0) w[bi] += d > 0.0 ? 1.0 : -1.0;
    __syncwarp();
    d += d > 0.0 ? -1.0 : 1.0;
  }

  // Dense pricing (y == 0): closed-form slacks and continuous block.
  const double* a = rd + (size_t)RD_A * M;
  const double* b_gpu = rd + (size_t)RD_B_GPU * M;
  const double* pen_set = rd + (size_t)RD_PEN_SET * M;
  const double* pen_vram = rd + (size_t)RD_PEN_VRAM * M;
  const double* busy_const = rd + (size_t)RD_BUSY_CONST * M;
  const double* s_disk = rd + (size_t)RD_S_DISK * M;
  const double* ram_rhs = rd + (size_t)RD_RAM_RHS * M;
  const double* ram_minus_n = rd + (size_t)RD_RAM_MINUS_N * M;
  const double* cuda_rhs = rd + (size_t)RD_CUDA_RHS * M;
  const double* metal_rhs = rd + (size_t)RD_METAL_RHS * M;
  const double* has_gpu = rd + (size_t)RD_HAS_GPU * M;

  double sum_w = 0.0, sum_lin = 0.0, cmax = -inf;
  bool ok = true;
  for (int j = lane; j < M; j += 32) {
    const double wj = w[j];
    const double nj = clip(rint((double)vr[M + j]), 0.0, wj) * has_gpu[j];
    w_out[(size_t)r * M + j] = wj;
    n_out[(size_t)r * M + j] = nj;
    sum_w += wj;
    const double resident = bp * wj - (bp * nj) * ram_minus_n[j];
    const double viol_ram = nan_max(resident - ram_rhs[j], 0.0);
    const double s_ram = ceil(viol_ram / bp - 1e-9);
    ok = ok && (s_ram <= nan_min(wj, Wf));
    double viol_vram = nan_max(nan_max(bp * nj - cuda_rhs[j], bp * nj - metal_rhs[j]), 0.0);
    if (!isfinite(viol_vram)) viol_vram = 0.0;
    const double t = ceil(viol_vram / bp - 1e-9);
    ok = ok && (t <= Wf * has_gpu[j] + 1e-9);
    const double pen_cost = pen_set[j] * s_ram + pen_vram[j] * t;
    const double lin = (a[j] * wj + b_gpu[j] * nj) + pen_cost;
    const double busy = lin + busy_const[j];
    const double fetch = (bp / s_disk[j]) * wj;
    cmax = nan_max(cmax, busy + 0.5 * fetch);
    sum_lin += lin;
  }
  sum_w = warp_reduce(sum_w, Sum());
  sum_lin = warp_reduce(sum_lin, Sum());
  cmax = warp_reduce(cmax, Max());
  ok = __all_sync(FULL, ok);
  if (lane == 0) {
    const bool valid = sum_w == Wf;
    obj_out[r] = (valid && ok) ? (kf - 1.0) * cmax + sum_lin : inf;
  }
}

template <typename Tv>
int launch(const Tv* v, long v_stride, const double* Wr, const double* kr,
           const double* rd, int M, int B, double* obj, double* w,
           double* n, cudaStream_t stream) {
  const int warps = 4;
  const int blocks = (B + warps - 1) / warps;
  const size_t sm = sizeof(double) * 2 * (size_t)M * warps;
  if (sm > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        round_kernel<Tv>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
    if (err != cudaSuccess) return (int)err;
  }
  round_kernel<Tv><<<blocks, 32 * warps, sm, stream>>>(v, v_stride, Wr, kr, rd, M,
                                                       B, obj, w, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dtk_round_f32(const float* v, long v_stride, const double* Wr,
                  const double* kr, const double* rd, int M, int B,
                  double* obj, double* w, double* n, void* stream) {
  return launch<float>(v, v_stride, Wr, kr, rd, M, B, obj, w, n,
                       (cudaStream_t)stream);
}

int dtk_round_f64(const double* v, long v_stride, const double* Wr,
                  const double* kr, const double* rd, int M, int B,
                  double* obj, double* w, double* n, void* stream) {
  return launch<double>(v, v_stride, Wr, kr, rd, M, B, obj, w, n,
                        (cudaStream_t)stream);
}

}  // extern "C"
