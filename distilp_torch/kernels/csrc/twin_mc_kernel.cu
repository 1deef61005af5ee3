// K8: the digital twin's Monte-Carlo engine, one warp per row, in float64.
//
// Replaces distilp_tpu/twin/engine.py::_build_kernel (``_mc`` vmapping
// ``_eval_one`` over [samples | M sensitivity rows | base row]). A row is one
// perturbed execution of a placement: per device the multipliers (drawn for
// a sample row, fixed for the others), the RAM/VRAM spill need against the
// drifted capacity, the violation test against the slack caps, the disk
// time, the busy time and the cycle term; per row the cycle max and the
// latency sum(comp + disk) + (k-1) C + sum(comm) + sum(off) + kappa.
//
// Random numbers: Philox4x32-10 keyed by the seed, counter (device, row,
// stream, 0), so a draw depends on (seed, row, device, stream) alone and the
// plain version (twin/engine.py::draw_multipliers) draws the same bits.
// Stream 0: Box-Muller normals for compute and link; stream 1: disk and
// memory; stream 2: the straggler uniform. Uniforms are 53-bit, in (0, 1].
//
// What bounds it on an H100: nothing the card is short of. A report is
// (samples + M + 1) x M cells of ~70 float64 operations and three Philox
// calls over a few KB of per-device vectors (M=16, 1024 samples: 1.7e4
// cells, ~1.2 MFLOP): launch latency. The design stages the 14 per-device
// vectors in shared memory once per block (read from global memory when
// they do not fit), puts lanes over devices in a strided loop (any M), and
// reduces each row in a fixed order (lane partials, then warp_reduce's
// shuffle tree; no atomics), so two launches with one seed agree bit for
// bit. Built with --fmad=false: the ceil staircase of the spill need must
// see the same products as the plain version.

#include "common.cuh"

namespace {

using namespace dtk;

// Rows of the packed (V_ROWS, M) vector matrix (twin/engine.py VEC_FIELDS).
enum {
  V_COMPUTE0 = 0,
  V_COMM0,
  V_OFF0,
  V_PREFETCH0,
  V_PEN_SET,
  V_PEN_VRAM,
  V_RAM_LHS0,
  V_RAM_RHS,
  V_CUDA_LHS0,
  V_CUDA_RHS,
  V_METAL_LHS0,
  V_METAL_RHS,
  V_S_CAP,
  V_T_CAP,
  V_ROWS
};

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;
constexpr double TWO_PI = 6.283185307179586;
constexpr int WARPS = 8;
constexpr size_t MAX_SMEM = 227 * 1024;

struct Words {
  uint32_t x0, x1, x2, x3;
};

__device__ __forceinline__ Words philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c0), lo0 = PHILOX_M0 * c0;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c2), lo1 = PHILOX_M1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return {c0, c1, c2, c3};
}

__device__ __forceinline__ double uniform53(uint32_t hi, uint32_t lo) {
  const uint64_t x = (((uint64_t)hi << 21) | (lo >> 11)) + 1ull;
  return (double)x * 0x1p-53;
}

// Box-Muller: the two normals of one Philox output.
__device__ __forceinline__ void normal_pair(Words w, double& z0, double& z1) {
  const double u1 = uniform53(w.x0, w.x1), u2 = uniform53(w.x2, w.x3);
  const double r = sqrt(-2.0 * log(u1));
  const double th = TWO_PI * u2;
  z0 = r * cos(th);
  z1 = r * sin(th);
}

__device__ __forceinline__ double jitter(double z, double s) {
  return exp(s * z - 0.5 * s * s);
}

__device__ __forceinline__ double drift(double rhs, double mem) {
  return rhs > 0.0 ? rhs * mem : rhs;
}

__global__ void twin_mc_kernel(const double* __restrict__ vecs_g, int M, int samples,
                               double bp, double kfac, double kappa, double s_comp,
                               double s_comm, double s_disk, double s_mem,
                               double dropout_p, double slowdown, double degrade,
                               uint32_t k0, uint32_t k1, int stage,
                               double* __restrict__ lat_out,
                               unsigned char* __restrict__ viol_out) {
  extern __shared__ double sv[];
  const double* v = vecs_g;
  if (stage) {
    for (int i = threadIdx.x; i < V_ROWS * M; i += blockDim.x) sv[i] = vecs_g[i];
    __syncthreads();
    v = sv;
  }
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int R = samples + M + 1;
  if (r >= R) return;  // the whole warp leaves together
  const bool drawn = r < samples;
  const int sens_dev = r - samples;  // in [0, M) on a sensitivity row

  double sum_cd = 0.0, sum_comm = 0.0, sum_off = 0.0;
  double cmax = -INFINITY;
  bool bad = false;
  for (int j = lane; j < M; j += 32) {
    double comp, comm, disk, mem;
    if (drawn) {
      double z_comp, z_comm, z_disk, z_mem;
      normal_pair(philox(j, r, 0, 0, k0, k1), z_comp, z_comm);
      normal_pair(philox(j, r, 1, 0, k0, k1), z_disk, z_mem);
      const Words d = philox(j, r, 2, 0, k0, k1);
      comp = jitter(z_comp, s_comp);
      if (uniform53(d.x0, d.x1) < dropout_p) comp = comp * slowdown;
      comm = jitter(z_comm, s_comm);
      disk = jitter(z_disk, s_disk);
      mem = jitter(z_mem, s_mem);
    } else {
      comp = comm = (j == sens_dev) ? 1.0 + (degrade - 1.0) : 1.0;
      disk = mem = 1.0;
    }
    const double comp_s = v[V_COMPUTE0 * M + j] * comp;
    const double comm_s = v[V_COMM0 * M + j] * comm;
    const double off_s = v[V_OFF0 * M + j] * comm;
    const double ram_rhs = drift(v[V_RAM_RHS * M + j], mem);
    const double cuda_rhs = drift(v[V_CUDA_RHS * M + j], mem);
    const double metal_rhs = drift(v[V_METAL_RHS * M + j], mem);
    const double s_need = nan_max(
        0.0, ceil(nan_max(0.0, v[V_RAM_LHS0 * M + j] - ram_rhs) / bp - 1e-12));
    const double vram_deficit =
        nan_max(nan_max(0.0, v[V_CUDA_LHS0 * M + j] - cuda_rhs),
                nan_max(0.0, v[V_METAL_LHS0 * M + j] - metal_rhs));
    const double t_need = nan_max(0.0, ceil(vram_deficit / bp - 1e-12));
    const double s_cap = v[V_S_CAP * M + j], t_cap = v[V_T_CAP * M + j];
    bad = bad || (s_need > s_cap + 1e-9) || (t_need > t_cap + 1e-9);
    const double s_used = nan_min(s_need, s_cap);
    const double t_used = nan_min(t_need, t_cap);
    const double disk_s =
        (v[V_PEN_SET * M + j] * s_used + v[V_PEN_VRAM * M + j] * t_used) * disk;
    const double busy = comp_s + disk_s + off_s + comm_s;
    cmax = nan_max(cmax, busy + 0.5 * v[V_PREFETCH0 * M + j] * disk);
    sum_cd += comp_s + disk_s;
    sum_comm += comm_s;
    sum_off += off_s;
  }
  sum_cd = warp_reduce(sum_cd, Sum());
  sum_comm = warp_reduce(sum_comm, Sum());
  sum_off = warp_reduce(sum_off, Sum());
  cmax = warp_reduce(cmax, Max());
  bad = __any_sync(FULL, bad);
  if (lane == 0) {
    lat_out[r] = sum_cd + kfac * cmax + sum_comm + sum_off + kappa;
    viol_out[r] = bad ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int dtk_twin_mc(const double* vecs, int M, int samples, double bp, double kfac,
                double kappa, double s_comp, double s_comm, double s_disk,
                double s_mem, double dropout_p, double slowdown, double degrade,
                unsigned int k0, unsigned int k1, double* lat, unsigned char* viol,
                void* stream) {
  const int R = samples + M + 1;
  const int blocks = (R + WARPS - 1) / WARPS;
  const size_t sm = sizeof(double) * V_ROWS * (size_t)M;
  const int stage = sm <= MAX_SMEM ? 1 : 0;
  const size_t dyn = stage ? sm : 0;
  if (dyn > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        twin_mc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  twin_mc_kernel<<<blocks, 32 * WARPS, dyn, (cudaStream_t)stream>>>(
      vecs, M, samples, bp, kfac, kappa, s_comp, s_comm, s_disk, s_mem, dropout_p,
      slowdown, degrade, k0, k1, stage, lat, viol);
  return (int)cudaGetLastError();
}

}  // extern "C"
