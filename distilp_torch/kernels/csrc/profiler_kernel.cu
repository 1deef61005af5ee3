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
// bfloat16. Replaces the chain body of distilp_tpu/profiler/device.py::
// _gemm_flops (``y = jnp.matmul(x, b); y / (jnp.max(jnp.abs(y)) + eps)``).
// x is (M, K) (the chain's (B, S, S) input, rows stacked), b is (K, N), both
// row-major; K and N are multiples of 16 bytes' worth of elements.
// - float16/bfloat16, gemm_wgmma_kernel: 128x256 output tiles, one block of
//   three warpgroups each. A producer warp issues TMA loads (128-byte
//   swizzle) of 128x64 tiles of x and 64x256 tiles of b into a ring of four
//   stages in dynamic shared memory, with a full and an empty mbarrier per
//   stage; two consumer warpgroups (64 rows each, under setmaxnreg) issue
//   wgmma.mma_async m64n256k16 on the stages that have arrived, float32
//   accumulators in registers. x is K-major for operand A; b is MN-major for
//   operand B, read through the descriptor's transpose bit (no transposing
//   pass). TMA zero-fills the ragged edges; the epilogue masks its stores.
// - float32, gemm_f32_kernel: the FP32 pipes (explicit fmaf, so no TF32 and
//   no dependence on --fmad; k summed in order for every output), 128x128
//   output tiles of 256 threads, 8x8 outputs a thread, operand tiles of 16
//   k streamed through a four-stage cp.async ring in shared memory (the x
//   tile transposed on its way in).
// Each block rounds its tile to the working dtype (round to nearest even,
// as torch does), stores it and writes the tile's abs-max (of the rounded
// values) to ``partial``: the scale's reduction is the product's epilogue.
// dtk_gemm_tile gives each dtype's output tile, so the wrapper sizes
// ``partial`` from the library's own layout.
// - The scale: every block reduces the partials (max is order-free) and
//   divides its stretch of y in place with 16-byte loads and stores. The
//   division follows PyTorch's rules for the plain expression
//   ``y / (y.abs().amax() + eps)``: max + eps is rounded to the working
//   dtype, then y / denom is an IEEE float32 division rounded to the
//   working dtype, so given the same product the scale agrees with its
//   plain version bit for bit (the library is built with --fmad=false and
//   the default IEEE division).
// Bound: 2 M N K operations at the dtype's peak (tensor cores for the
// 16-bit types, the FP32 pipes for float32); the bytes, x and b read and y
// written once, are far below it at the profiler's sizes. The tensor maps
// are encoded on the host through cudaGetDriverEntryPoint, so the library
// needs no -lcuda.

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

// ---- float32: the FP32 pipes, a cp.async ring -------------------------------

// 16x16 threads, each 8 rows (ty*4 + 0..3 and 64 + ty*4 + 0..3) by 8
// columns (likewise with tx), so the shared-memory reads of a k step are
// four float4 broadcasts. The x tile is stored transposed (k-major, rows of
// 132 floats against bank conflicts): its copies are 4 bytes each, the b
// tile's 16.
constexpr int F32_TM = 128, F32_TN = 128, F32_TK = 16, F32_STAGES = 4;
constexpr int F32_XP = F32_TM + 4;  // x tile row pitch (floats)
constexpr int F32_STAGE_FLOATS = F32_TK * F32_XP + F32_TK * F32_TN;
constexpr int F32_SMEM = F32_STAGES * F32_STAGE_FLOATS * (int)sizeof(float);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = smem_u32(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(valid ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(THREADS, 2)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ b,
                float* __restrict__ y, long M, long N, long K, int tiles_m, int tiles_n,
                float* __restrict__ partial) {
  extern __shared__ __align__(16) float f32_smem[];
  __shared__ float scratch[32];
  const int tid = threadIdx.x;
  int tm, tn;
  tile_coords(blockIdx.x, tiles_m, tiles_n, tm, tn);
  const long m0 = (long)tm * F32_TM, n0 = (long)tn * F32_TN;
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const long nk = (K + F32_TK - 1) / F32_TK;
  // Per thread and stage: 8 elements of the x tile, column xk of rows
  // xr + 16 q (a warp reads two rows of 16 k), and two 16-byte chunks of the
  // b tile, rows br + 8 q. A copy past the edge is zero-filled (source size
  // 0). The addresses are set up once; a stage adds its k offset.
  const int xk = tid & 15, xr = tid >> 4, br = tid >> 5, bc = (tid & 31) * 4;
  const float* xp = x + (m0 + xr) * K + xk;
  const float* bp = b + (long)br * N + n0 + bc;
  unsigned rows_in = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) rows_in |= (m0 + xr + 16 * q < M) ? 1u << q : 0u;
  const bool col_in = n0 + bc < N;
  auto load = [&](long kt) {
    float* xs = f32_smem + (kt % F32_STAGES) * F32_STAGE_FLOATS;
    float* bs = xs + F32_TK * F32_XP;
    const long k0 = kt * F32_TK;
    const bool k_in = k0 + xk < K;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bool in = k_in && ((rows_in >> q) & 1u);
      cp_async<4>(xs + xk * F32_XP + xr + 16 * q, in ? xp + k0 + 16 * q * K : x, in);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool in = col_in && k0 + br + 8 * q < K;
      cp_async<16>(bs + (br + 8 * q) * F32_TN + bc, in ? bp + (k0 + 8 * q) * N : b, in);
    }
  };

#pragma unroll
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (long kt = 0; kt < nk; ++kt) {
    cp_async_wait<F32_STAGES - 2>();  // this thread's copies of stage kt
    __syncthreads();  // everyone's copies landed; stage kt-1 is read
    if (kt + F32_STAGES - 1 < nk) load(kt + F32_STAGES - 1);
    cp_async_commit();
    const float* xs = f32_smem + (kt % F32_STAGES) * F32_STAGE_FLOATS;
    const float* bs = xs + F32_TK * F32_XP;
#pragma unroll
    for (int k = 0; k < F32_TK; ++k) {
      float a[8], c[8];
      const float4 a0 = *reinterpret_cast<const float4*>(xs + k * F32_XP + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + k * F32_XP + 64 + ty * 4);
      const float4 c0 = *reinterpret_cast<const float4*>(bs + k * F32_TN + tx * 4);
      const float4 c1 = *reinterpret_cast<const float4*>(bs + k * F32_TN + 64 + tx * 4);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      c[0] = c0.x; c[1] = c0.y; c[2] = c0.z; c[3] = c0.w;
      c[4] = c1.x; c[5] = c1.y; c[6] = c1.z; c[7] = c1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float m = 0.0f;  // |y| >= 0; NaN propagates through nan_max
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long col = n0 + h * 64 + tx * 4;
      if (row < M && col < N) {
        const float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                     acc[i][4 * h + 3]);
        m = nan_max(nan_max(m, fabsf(v.x)), nan_max(fabsf(v.y), nan_max(fabsf(v.z), fabsf(v.w))));
        *reinterpret_cast<float4*>(y + row * N + col) = v;
      }
    }
  }
  m = block_reduce(m, Max(), scratch);
  if (tid == 0) partial[(long)tm * tiles_n + tn] = m;
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

// A 2-D row-major (rows, cols) array of 16-bit values, loaded in (box_rows,
// box_cols) boxes with the 128-byte swizzle; out-of-bounds elements read 0.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType dt, const void* base, long rows,
               long cols, int box_rows, int box_cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, dt, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int gemm_16bit(CUtensorMapDataType dt, const void* x, const void* b, void* y, long M, long N,
               long K, float* partial, cudaStream_t s) {
  if (M <= 0 || N <= 0) return 0;
  CUtensorMap xmap, bmap;
  if (!encode_2d(&xmap, dt, x, M, K, WG_TM, WG_TK) || !encode_2d(&bmap, dt, b, K, N, WG_TK, 64))
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
// bfloat16): partial holds one abs-max per tile.
int dtk_gemm_tile(int dtype, int* rows, int* cols) {
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  *rows = dtype == 0 ? F32_TM : WG_TM;
  *cols = dtype == 0 ? F32_TN : WG_TN;
  return 0;
}

// y (M, N) = x (M, K) @ b (K, N); partial gets one abs-max per output tile
// (ceil(M/rows) * ceil(N/cols) floats, tile (i, j) at i * ceil(N/cols) + j,
// with (rows, cols) from dtk_gemm_tile). M < 2^31 and fewer than 2^31 tiles.
int dtk_gemm_absmax_f32(const void* x, const void* b, void* y, long M, long N, long K,
                        float* partial, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(gemm_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tm = tiles(M, F32_TM), tn = tiles(N, F32_TN);
  gemm_f32_kernel<<<tm * tn, THREADS, F32_SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)b, (float*)y, M, N, K, tm, tn, partial);
  return (int)cudaGetLastError();
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
