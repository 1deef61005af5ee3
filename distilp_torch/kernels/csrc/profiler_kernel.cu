// K9a and K9b: the device profiler's probe kernels.
//
// K9a, dtk_roll1: y[i] = x[(i - 1) mod n] over a resident float32 array.
// Replaces the chain body of distilp_tpu/profiler/device.py::
// accel_bench_mem_to_compute (``jnp.roll(x, 1)`` in a fori_loop, timed by
// ``_chained_rate``). The profiler launches it c times, ping-ponging between
// two buffers, at two chain lengths; the slope is the HBM streaming rate.
// Bound: each pass reads and writes n*4 bytes once (256 MB: 0.16 ms at
// 3.35 TB/s). Design: one aligned 16-byte load and store per thread for four
// outputs, plus the one element before them (a neighbour's, from L1/L2), so
// every element is read once from device memory, coalesced; a scalar loop
// covers the ragged tail. Each launch streams the whole array: nothing is
// kept in L2 across passes, so a small array would read the L2's rate, not
// the memory's (the profiler prints the array size beside the rate).
//
// K9b, dtk_gemm_absmax_* then dtk_absmax_rescale_*: one step of the GEMM
// chain, y = x @ b; y <- y / (max|y| + eps), in float32, float16 and
// bfloat16. Replaces the chain body of distilp_tpu/profiler/device.py:225
// _gemm_flops (``y = jnp.matmul(x, b); y / (jnp.max(jnp.abs(y)) + eps)``).
// x is (M, K) (the chain's (B, S, S) input, rows stacked), b is (K, N), both
// row-major; K and N are multiples of 16 bytes' worth of elements.
// Bound: 2 M N K operations at the dtype's peak (the tensor cores for the
// 16-bit types, the FP32 pipes for float32); the bytes, x and b read and y
// written once, are far below it at the profiler's sizes. Both products are
// one shape: a producer warp keeps TMA loads (128-byte swizzle) of x and b
// tiles in flight through a ring of stages in dynamic shared memory, with a
// full and an empty mbarrier per stage, and consumer warpgroups (under
// setmaxnreg) compute on the stages that have arrived. TMA zero-fills the
// ragged edges; the epilogue masks its stores. The tensor maps are encoded
// on the host through cudaGetDriverEntryPoint, so the library needs no
// -lcuda.
// - float16/bfloat16, gemm_wgmma_kernel: 128x256 output tiles, one block
//   each; a ring of four stages of 64 k; two consumers (64 rows each) issue
//   wgmma.mma_async m64n256k16, float32 accumulators in registers. x is
//   K-major for operand A; b is MN-major for operand B, read through the
//   descriptor's transpose bit (no transposing pass).
// - float32, gemm_f32_kernel: the FP32 pipes with explicit fmaf (the library
//   is built with --fmad=false; no TF32), every output's k summed in order in
//   one fmaf chain. Its bound is FFMA issue, one warp-wide FFMA a cycle on
//   each SM sub-partition: any other instruction a computing warp issues, and
//   any cycle all its warps wait on a shared load, is a cycle the pipes lose.
//   So the copies are the producer's alone and the consumers issue only
//   shared loads and FFMA (x read as four k of a row in one 16-byte load, as
//   TMA lays it: no transpose); consumer warpgroups of 8x8 outputs a thread,
//   three (128x192 tiles) or two (128x128), keep as many warps on each
//   sub-partition to cover the loads' latency; a persistent grid (one block
//   an SM) walks the tiles, so the producer loads the next tile while the
//   consumers store this one. The host takes the layout whose last round of
//   tiles idles least at the shape (f32_consumers): on an H100's 132 SMs,
//   of the profiler's sizes (S = 4096-8192, b_1-b_4) only S = 8192 at b_1
//   and b_2 take 128x192.
// Each product rounds its tile to the working dtype (round to nearest even,
// as torch does), stores it and writes the tile's abs-max (of the rounded
// values) to ``partial``: the scale's reduction is the product's epilogue.
// dtk_gemm_tile gives the output tile of each dtype and shape, so the
// wrapper sizes ``partial`` from the library's own layout.
// - The scale: every block reduces the partials (max is order-free) and
//   divides its stretch of y in place with 16-byte loads and stores. The
//   division follows PyTorch's rules for the plain expression
//   ``y / (y.abs().amax() + eps)``: max + eps is rounded to the working
//   dtype, then y / denom is an IEEE float32 division rounded to the
//   working dtype, so given the same product the scale agrees with its
//   plain version bit for bit (the library is built with --fmad=false and
//   the default IEEE division).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <string.h>

#include "common.cuh"

namespace {

using namespace dtk;

constexpr int THREADS = 256;

__global__ void roll1_kernel(const float* __restrict__ x, float* __restrict__ y,
                             long n) {
  const long n4 = n / 4;
  const long stride = (long)gridDim.x * blockDim.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (long t = (long)blockIdx.x * blockDim.x + threadIdx.x; t < n4; t += stride) {
    const float4 a = x4[t];
    const float prev = x[t == 0 ? n - 1 : 4 * t - 1];
    y4[t] = make_float4(prev, a.x, a.y, a.z);
  }
  for (long i = 4 * n4 + (long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    y[i] = x[i == 0 ? n - 1 : i - 1];
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elements in one 16-byte load or store (4 float32 or 8 16-bit values).
template <typename T>
constexpr int VEC = 16 / sizeof(T);

// One block per output tile, numbered in groups of GROUP_M tile-rows with the
// tile-rows fastest, so that the blocks in flight share their b tiles in L2.
constexpr int GROUP_M = 8;

__device__ __forceinline__ void tile_coords(int tile, int tiles_m, int tiles_n, int& tm,
                                            int& tn) {
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (tile / per_group) * GROUP_M;
  const int rows_in_group = min(tiles_m - first_m, GROUP_M);
  tm = first_m + (tile % per_group) % rows_in_group;
  tn = (tile % per_group) / rows_in_group;
}

// ---- TMA and mbarriers (both products) -------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// ---- float32: the FP32 pipes, fed by TMA ------------------------------------

// Two layouts of C consumer warpgroups (C = 3 or 2): 128 x 64C output tiles
// (128x192 or 128x128) in stages of 32 k: the x tile as 128 rows of 32 k
// (128 bytes a row, as x lies), the b tile as 2C boxes of 32 k-rows by 32
// columns. Consumer warp w owns rows 64 (w / 2C) + [0, 64) and box w % 2C of
// b; its lane (tr, tc) = (lane / 4, lane % 4) owns rows tr + 8 i (i < 8) and
// the 4-column chunks tc and tc + 4 of the box: 8x8 outputs. The 128-byte
// swizzle stores chunk c of 128-byte row r at c ^ (r % 8): the eight rows a
// warp's x load reads (r % 8 = tr) and the four chunks of its b load (one
// row) lie in distinct banks. Three warps (C = 3) or two (C = 2) on each SM
// sub-partition hide the shared loads' latency; 8x16 outputs a thread load
// fewer bytes an FFMA but ran slower. The host picks C from the shape
// (f32_consumers): whichever grid leaves less of its last round idle.
constexpr int F32_TM = 128, F32_TK = 32, F32_STAGES = 5;
constexpr int F32_X_BYTES = F32_TM * F32_TK * 4;  // 16 KB
constexpr int F32_B_BOX = F32_TK * 32 * 4;        // 4 KB
// setmaxnreg moves registers within the block: every thread starts with
// ENTRY_REGS (what one block an SM allows), the producer warpgroup gives
// back down to F32_PRODUCER_REGS, the consumers take up to CONSUMER_REGS.
// A consumer asking for more than was given back waits for ever.
constexpr int F32_PRODUCER_REGS = 24;

template <int C>
struct F32Layout {
  static constexpr int WARPS = 4 * C;    // consumer warps
  static constexpr int WARPS_N = 2 * C;  // warps (b boxes) along a row
  static constexpr int TN = 32 * WARPS_N;
  static constexpr int THREADS = 128 * (1 + C);  // + the producer warpgroup
  static constexpr int STAGE_BYTES = F32_X_BYTES + WARPS_N * F32_B_BOX;
  // The ring (1024-byte aligned for the swizzle), the mbarriers, and two
  // sets of the consumer warps' reduction slots (tiles alternate).
  static constexpr int SMEM = 1024 + F32_STAGES * STAGE_BYTES + 2 * F32_STAGES * 8 + 2 * WARPS * 4;
  static constexpr int ENTRY_REGS = (65536 / THREADS) & ~7;
  static constexpr int CONSUMER_REGS = C == 3 ? 160 : ENTRY_REGS;
  static_assert(C == 2 || C == 3, "two or three consumer warpgroups");
  static_assert(128 * (ENTRY_REGS - F32_PRODUCER_REGS) >= 128 * C * (CONSUMER_REGS - ENTRY_REGS),
                "the consumers' registers must come from the producer's");
  static_assert(SMEM <= 232448, "the ring must fit one block's shared memory");
};

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// One stage's 32 k into acc, in order. xs: this thread's first x row in the
// stage; bs: its warp's b box; tcx[m]: byte offset of chunk tc ^ m (m < 4)
// in a 128-byte row.
__device__ __forceinline__ void f32_stage(float (&acc)[8][8], const uint8_t* xs,
                                          const uint8_t* bs, int tr, const int (&tcx)[4]) {
#pragma unroll 2
  for (int kb = 0; kb < F32_TK / 8; ++kb) {  // 8 k: k % 8 is fixed below
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // x: four k (chunk 2 kb + h of the row) of each of the thread's 8 rows.
      const uint8_t* xa = xs + (((2 * kb + h) ^ tr) << 4);
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(xa + i * 1024);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kx = 4 * h + e;  // this k's row % 8 in the swizzle
        const uint8_t* br = bs + (8 * kb + kx) * 128 + tcx[kx & 3];
        float bv[8];
#pragma unroll
        for (int p = 0; p < 2; ++p) {  // chunk tc + 4 p lies at (tc ^ kx % 4) + 4 (p ^ kx / 4)
          const float4 v = *reinterpret_cast<const float4*>(br + ((p ^ (kx >> 2)) << 6));
          bv[4 * p] = v.x; bv[4 * p + 1] = v.y; bv[4 * p + 2] = v.z; bv[4 * p + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = lane_of(a[i], e);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(F32Layout<C>::THREADS, 1)
gemm_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap bmap, float* __restrict__ y, long M,
                long N, long K, int tiles_m, int tiles_n, float* __restrict__ partial) {
  using L = F32Layout<C>;
  extern __shared__ uint8_t f32_smem[];
  const uint32_t raw = smem_u32(f32_smem);
  uint8_t* ring = f32_smem + ((1024 - (raw & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + F32_STAGES * L::STAGE_BYTES);
  float* slots = reinterpret_cast<float*>(bars + 2 * F32_STAGES);
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t full_s = smem_u32(bars), empty_s = full_s + 8 * F32_STAGES;
  const int ntiles = tiles_m * tiles_n;
  const int nk = (int)((K + F32_TK - 1) / F32_TK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < F32_STAGES; ++s) {
      mbar_init(full_s + 8 * s, 1);
      mbar_init(empty_s + 8 * s, L::WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Both roles walk the same tiles (blockIdx.x, + gridDim.x, ...) and count
  // the same stages ``it`` across them: stage it % F32_STAGES, phase
  // (it / F32_STAGES) & 1.
  if (threadIdx.x < 128) {
    // Producer: one thread keeps F32_STAGES stages of TMA loads in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F32_PRODUCER_REGS) : "memory");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        int tm, tn;
        tile_coords(tile, tiles_m, tiles_n, tm, tn);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % F32_STAGES;
          mbar_wait(empty_s + 8 * s, ((it / F32_STAGES) & 1) ^ 1);
          const uint32_t bar = full_s + 8 * s;
          mbar_expect_tx(bar, L::STAGE_BYTES);
          const uint32_t dst = ring_s + s * L::STAGE_BYTES;
          tma_load_2d(dst, &xmap, kt * F32_TK, tm * F32_TM, bar);
#pragma unroll
          for (int g = 0; g < L::WARPS_N; ++g)
            tma_load_2d(dst + F32_X_BYTES + g * F32_B_BOX, &bmap, tn * L::TN + 32 * g,
                        kt * F32_TK, bar);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS) : "memory");
    const int ct = threadIdx.x - 128, cw = ct >> 5, lane = ct & 31;
    const int tr = lane >> 2, tc = lane & 3, wr = cw / L::WARPS_N, wc = cw % L::WARPS_N;
    // This thread's first x row and its warp's b box, in stage 0.
    const uint8_t* xrow = ring + (wr * 64 + tr) * 128;
    const uint8_t* bbox = ring + F32_X_BYTES + wc * F32_B_BOX;
    int tcx[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) tcx[m] = (tc ^ m) << 4;
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_s + 8 * (stage % F32_STAGES));
    };
    int it = 0, parity = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, parity ^= 1) {
      int tm, tn;
      tile_coords(tile, tiles_m, tiles_n, tm, tn);
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        // Hand the previous stage back. What makes that safe: every shared
        // load of it was issued, and its value consumed by an FFMA, before
        // this point in the warp's program order (an FFMA issues only once
        // its operands have arrived), so no load of it is in flight when
        // the lanes meet at __syncwarp and lane 0's arrive releases it to
        // the producer. The release after the last pass is the same.
        if (kt > 0) release(it - 1);
        const int s = it % F32_STAGES;
        mbar_wait(full_s + 8 * s, (it / F32_STAGES) & 1);
        f32_stage(acc, xrow + s * L::STAGE_BYTES, bbox + s * L::STAGE_BYTES, tr, tcx);
      }
      release(it - 1);

      // Epilogue; the producer is already loading the next tile. acc[i][4 p
      // + e] is row tr + 8 i of the warp's 64 and column 16 p + 4 tc + e of
      // its box.
      const long row0 = (long)tm * F32_TM + wr * 64 + tr;
      const long col0 = (long)tn * L::TN + 32 * wc + 4 * tc;
      float m = 0.0f;  // |y| >= 0; NaN propagates through nan_max
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long row = row0 + 8 * i;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const long col = col0 + 16 * q;
          if (row < M && col < N) {  // N % 4 == 0: the chunk is in
            const float4 v = make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                                         acc[i][4 * q + 3]);
            m = nan_max(nan_max(m, fabsf(v.x)),
                        nan_max(fabsf(v.y), nan_max(fabsf(v.z), fabsf(v.w))));
            *reinterpret_cast<float4*>(y + row * N + col) = v;
          }
        }
      }
      m = warp_reduce(m, Max());
      float* tile_slots = slots + parity * L::WARPS;
      if (lane == 0) tile_slots[cw] = m;
      // A warp reaches the next use of this set only after every consumer
      // passed the next tile's barrier, so after thread 0 read it here.
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * L::WARPS) : "memory");
      if (ct == 0) {
        float r = tile_slots[0];
        for (int q = 1; q < L::WARPS; ++q) r = nan_max(r, tile_slots[q]);
        partial[(long)tm * tiles_n + tn] = r;
      }
    }
  }
}

// ---- float16 / bfloat16: TMA and wgmma --------------------------------------

constexpr int WG_TM = 128, WG_TN = 256, WG_TK = 64, WG_STAGES = 4;
constexpr int WG_CONSUMERS = 2;                        // warpgroups of 64 rows
constexpr int WG_THREADS = 128 * (1 + WG_CONSUMERS);  // + the producer warpgroup
constexpr int WG_A_BYTES = WG_TM * WG_TK * 2;          // 16 KB: 128 rows of 128 B
constexpr int WG_B_CHUNK = WG_TK * 64 * 2;             // 8 KB: 64 k-rows of 64 columns
constexpr int WG_B_BYTES = (WG_TN / 64) * WG_B_CHUNK;  // 32 KB
constexpr int WG_STAGE_BYTES = WG_A_BYTES + WG_B_BYTES;
// The ring (1024-byte aligned for the 128-byte swizzle), then the mbarriers
// and the consumers' reduction slots.
constexpr int WG_SMEM = 1024 + WG_STAGES * WG_STAGE_BYTES + 2 * WG_STAGES * 8 + 32 * 4;

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1). Byte
// offsets: ``lbo`` between 64-element chunks along M/N (MN-major only),
// ``sbo`` between groups of 8 rows (K-major) or of 8 k (MN-major).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define DTK_WG_OUT(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64x256, float32) += A (64x16, K-major) @ B (16x256, MN-major, transposed).
template <typename T>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_m64n256k16<__half>(float (&d)[128], uint64_t da,
                                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : DTK_WG_OUT(d)
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_m64n256k16<__nv_bfloat16>(float (&d)[128], uint64_t da,
                                                                uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : DTK_WG_OUT(d)
      : "l"(da), "l"(db), "r"(1));
}
#undef DTK_WG_OUT

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b, float& m) {
  T v[2] = {from_f<T>(a), from_f<T>(b)};
  m = nan_max(m, nan_max(fabsf(to_f(v[0])), fabsf(to_f(v[1]))));
  uint32_t raw;
  memcpy(&raw, v, sizeof(raw));
  *reinterpret_cast<uint32_t*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap bmap, T* __restrict__ y, long M,
                  long N, long K, int tiles_m, int tiles_n, float* __restrict__ partial) {
  extern __shared__ uint8_t wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  uint8_t* ring = wg_smem + ((1024 - (raw & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + WG_STAGES * WG_STAGE_BYTES);
  float* slots = reinterpret_cast<float*>(bars + 2 * WG_STAGES);
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t full_s = smem_u32(bars), empty_s = full_s + 8 * WG_STAGES;

  int tm, tn;
  tile_coords(blockIdx.x, tiles_m, tiles_n, tm, tn);
  const int nk = (int)((K + WG_TK - 1) / WG_TK);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full_s + 8 * s, 1);
      mbar_init(empty_s + 8 * s, WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps WG_STAGES stages of TMA loads in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES;
        mbar_wait(empty_s + 8 * s, ((kt / WG_STAGES) & 1) ^ 1);
        const uint32_t bar = full_s + 8 * s;
        mbar_expect_tx(bar, WG_STAGE_BYTES);
        const uint32_t a_dst = ring_s + s * WG_STAGE_BYTES;
        tma_load_2d(a_dst, &xmap, kt * WG_TK, tm * WG_TM, bar);
#pragma unroll
        for (int c = 0; c < WG_TN / 64; ++c)
          tma_load_2d(a_dst + WG_A_BYTES + c * WG_B_CHUNK, &bmap, tn * WG_TN + c * 64,
                      kt * WG_TK, bar);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;  // this consumer's 64 rows of the tile
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % WG_STAGES;
      mbar_wait(full_s + 8 * s, (kt / WG_STAGES) & 1);
      const uint32_t a_s = ring_s + s * WG_STAGE_BYTES + cw * 64 * 128;
      const uint32_t b_s = ring_s + s * WG_STAGE_BYTES + WG_A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_TK / 16; ++kk)
        // A: 16 k are 32 bytes along the swizzled 128-byte row; B: 16 k are
        // two 1024-byte groups of 8 k-rows.
        wgmma_m64n256k16<T>(d, wg_desc(a_s + kk * 32, 16, 1024),
                            wg_desc(b_s + kk * 2048, WG_B_CHUNK, 1024));
      wgmma_commit();
      // Stage kt-1's products are done: hand its buffers back.
      wgmma_wait<1>();
      if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty_s + 8 * ((kt - 1) % WG_STAGES));
    }
    wgmma_wait<0>();

    // Epilogue. Accumulator d[4j + 2h + e] is row 16 w + lane/4 + 8 h, column
    // 8 j + 2 (lane % 4) + e of this warpgroup's 64x256 block (w its warp).
    const int lane = threadIdx.x & 31, w = (threadIdx.x / 32) & 3;
    const long row0 = (long)tm * WG_TM + cw * 64 + 16 * w + lane / 4;
    const long col0 = (long)tn * WG_TN + 2 * (lane & 3);
    float m = 0.0f;  // |y| >= 0; NaN propagates through nan_max
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const long col = col0 + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long row = row0 + 8 * h;
        if (row < M && col < N)  // N is even: both columns are in
          store_pair<T>(y + row * N + col, d[4 * j + 2 * h], d[4 * j + 2 * h + 1], m);
      }
    }
    m = warp_reduce(m, Max());
    const int cwarp = threadIdx.x / 32 - 4;  // 0..7 over the consumers
    if (lane == 0) slots[cwarp] = m;
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WG_CONSUMERS) : "memory");
    if (cwarp == 0 && lane == 0) {
      float r = slots[0];
      for (int q = 1; q < 4 * WG_CONSUMERS; ++q) r = nan_max(r, slots[q]);
      partial[(long)tm * tiles_n + tn] = r;
    }
  }
}

template <typename T>
__global__ void rescale_kernel(T* __restrict__ y, long n, const float* __restrict__ partial,
                               int nparts, float eps) {
  __shared__ float scratch[32];
  float m = 0.0f;
  for (int p = threadIdx.x; p < nparts; p += blockDim.x) m = nan_max(m, partial[p]);
  m = block_reduce(m, Max(), scratch);
  // amax (exact in the working dtype) + eps, rounded to the working dtype.
  const float denom = to_f(from_f<T>(m + eps));
  const long stride = (long)gridDim.x * blockDim.x;
  const long first = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long nv = n / VEC<T>;
  uint4* y16 = reinterpret_cast<uint4*>(y);
  for (long t = first; t < nv; t += stride) {
    uint4 raw = y16[t];
    T v[VEC<T>];
    memcpy(v, &raw, sizeof(raw));
#pragma unroll
    for (int k = 0; k < VEC<T>; ++k) v[k] = from_f<T>(to_f(v[k]) / denom);
    memcpy(&raw, v, sizeof(raw));
    y16[t] = raw;
  }
  for (long i = nv * VEC<T> + first; i < n; i += stride)
    y[i] = from_f<T>(to_f(y[i]) / denom);
}

int tiles(long n, int tile) { return (int)((n + tile - 1) / tile); }

// libcuda's cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 2-D row-major (rows, cols) array of ``elem_bytes``-byte values, loaded
// in (box_rows, box_cols) boxes with the 128-byte swizzle (box_cols *
// elem_bytes <= 128); out-of-bounds elements read 0.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType dt, int elem_bytes, const void* base,
               long rows, long cols, int box_rows, int box_cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, dt, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// The float32 layout (consumer warpgroups C) for an (M, N) product on
// ``sms`` SMs, one persistent block each: the one whose grid computes the
// fewer padded outputs, rounds of ``sms`` tiles times the tile's size, so
// the less of its last round idles; 128x192 on a tie (its blocks ran about
// 1% faster at full rounds). Both products of one shape pick the same.
int f32_consumers(long M, long N, int sms) {
  const long t3 = (long)tiles(M, F32_TM) * tiles(N, F32Layout<3>::TN);
  const long t2 = (long)tiles(M, F32_TM) * tiles(N, F32Layout<2>::TN);
  const long cost3 = (t3 + sms - 1) / sms * F32Layout<3>::TN;
  const long cost2 = (t2 + sms - 1) / sms * F32Layout<2>::TN;
  return cost2 < cost3 ? 2 : 3;
}

template <int C>
int gemm_f32(const void* x, const void* b, void* y, long M, long N, long K, float* partial,
             int sms, cudaStream_t s) {
  using L = F32Layout<C>;
  CUtensorMap xmap, bmap;
  if (!encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, M, K, F32_TM, F32_TK) ||
      !encode_2d(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b, K, N, F32_TK, 32))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return (int)e;
  // A persistent grid: one block an SM (its ring fills most of the SM's
  // shared memory), none without a tile.
  const int tm = tiles(M, F32_TM), tn = tiles(N, L::TN);
  const int grid = (long)tm * tn < sms ? tm * tn : sms;
  gemm_f32_kernel<C><<<grid, L::THREADS, L::SMEM, s>>>(xmap, bmap, (float*)y, M, N, K, tm, tn,
                                                       partial);
  return (int)cudaGetLastError();
}

template <typename T>
int gemm_16bit(CUtensorMapDataType dt, const void* x, const void* b, void* y, long M, long N,
               long K, float* partial, cudaStream_t s) {
  if (M <= 0 || N <= 0) return 0;
  CUtensorMap xmap, bmap;
  if (!encode_2d(&xmap, dt, 2, x, M, K, WG_TM, WG_TK) ||
      !encode_2d(&bmap, dt, 2, b, K, N, WG_TK, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(gemm_wgmma_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tm = tiles(M, WG_TM), tn = tiles(N, WG_TN);
  gemm_wgmma_kernel<T><<<tm * tn, WG_THREADS, WG_SMEM, s>>>(xmap, bmap, (T*)y, M, N, K, tm,
                                                             tn, partial);
  return (int)cudaGetLastError();
}

template <typename T>
int rescale(T* y, long n, const float* partial, int nparts, float eps, int blocks,
            cudaStream_t s) {
  if (n <= 0) return 0;
  rescale_kernel<T><<<blocks, THREADS, 0, s>>>(y, n, partial, nparts, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dtk_roll1(const float* x, float* y, long n, int blocks, void* stream) {
  if (n <= 0) return 0;
  roll1_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

// The output tile of dtk_gemm_absmax_<dtype> (0 float32, 1 float16, 2
// bfloat16) for an (M, N) product on the current device: partial holds one
// abs-max per tile.
int dtk_gemm_tile(int dtype, long M, long N, int* rows, int* cols) {
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  *rows = dtype == 0 ? F32_TM : WG_TM;
  *cols = WG_TN;
  if (dtype == 0) {
    int sms = 0;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return (int)e;
    *cols = f32_consumers(M, N, sms) == 3 ? F32Layout<3>::TN : F32Layout<2>::TN;
  }
  return 0;
}

// y (M, N) = x (M, K) @ b (K, N); partial gets one abs-max per output tile
// (ceil(M/rows) * ceil(N/cols) floats, tile (i, j) at i * ceil(N/cols) + j,
// with (rows, cols) from dtk_gemm_tile). M < 2^31 and fewer than 2^31 tiles.
int dtk_gemm_absmax_f32(const void* x, const void* b, void* y, long M, long N, long K,
                        float* partial, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  return f32_consumers(M, N, sms) == 3
             ? gemm_f32<3>(x, b, y, M, N, K, partial, sms, (cudaStream_t)stream)
             : gemm_f32<2>(x, b, y, M, N, K, partial, sms, (cudaStream_t)stream);
}

int dtk_gemm_absmax_f16(const void* x, const void* b, void* y, long M, long N, long K,
                        float* partial, void* stream) {
  return gemm_16bit<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, x, b, y, M, N, K, partial,
                            (cudaStream_t)stream);
}

int dtk_gemm_absmax_bf16(const void* x, const void* b, void* y, long M, long N, long K,
                         float* partial, void* stream) {
  return gemm_16bit<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, b, y, M, N, K,
                                   partial, (cudaStream_t)stream);
}

// y <- y / (max(partial) + eps), in place.
int dtk_absmax_rescale_f32(void* y, long n, const float* partial, int nparts, float eps,
                           int blocks, void* stream) {
  return rescale<float>((float*)y, n, partial, nparts, eps, blocks, (cudaStream_t)stream);
}

int dtk_absmax_rescale_f16(void* y, long n, const float* partial, int nparts, float eps,
                           int blocks, void* stream) {
  return rescale<__half>((__half*)y, n, partial, nparts, eps, blocks, (cudaStream_t)stream);
}

int dtk_absmax_rescale_bf16(void* y, long n, const float* partial, int nparts, float eps,
                            int blocks, void* stream) {
  return rescale<__nv_bfloat16>((__nv_bfloat16*)y, n, partial, nparts, eps, blocks,
                                (cudaStream_t)stream);
}

}  // extern "C"
