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
// - The product: 128x128 output tiles, one block of 256 threads each, the
//   operand tiles double-buffered in shared memory (the next tile's global
//   loads, 16 bytes a thread, are in flight while the current one is
//   multiplied). float16/bfloat16 on the tensor cores through WMMA
//   (16x16x16 fragments, float32 accumulators, 8 warps of 64x32 outputs,
//   k-tiles of 32); float32 on the FP32 pipes (explicit fmaf, so no TF32
//   and no dependence on --fmad; 8x8 outputs a thread, k-tiles of 8, k
//   summed in order). Each block rounds its tile to the working dtype,
//   stores it and writes the tile's abs-max (of the rounded values) to
//   ``partial``: the scale's reduction is the product's epilogue.
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
// written once, are far below it at the profiler's sizes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>

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

constexpr int TILE_M = 128;
constexpr int TILE_N = 128;

// float32: 16x16 threads, each 8 rows (ty*4 + 0..3 and 64 + ty*4 + 0..3) by
// 8 columns (likewise with tx), so the shared-memory reads of a k step are
// four float4 broadcasts. The x tile is stored transposed (k-major).
constexpr int F32_TK = 8;

__global__ void __launch_bounds__(THREADS, 2)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ b,
                float* __restrict__ y, long M, long N, long K,
                float* __restrict__ partial) {
  __shared__ __align__(16) float xs[2][F32_TK][TILE_M];
  __shared__ __align__(16) float bs[2][F32_TK][TILE_N];
  __shared__ float scratch[32];
  const int tid = threadIdx.x;
  const long m0 = (long)blockIdx.y * TILE_M, n0 = (long)blockIdx.x * TILE_N;
  // Loader coordinates: one float4 of x and one of b per thread and k-tile.
  const int xr = tid >> 1, xc = (tid & 1) * 4;
  const int br = tid >> 5, bc = (tid & 31) * 4;
  const int tx = tid & 15, ty = tid >> 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const long nk = (K + F32_TK - 1) / F32_TK;
  float4 rx, rb;
  auto load = [&](long kt) {
    const long k0 = kt * F32_TK;
    rx = (m0 + xr < M && k0 + xc < K)
             ? *reinterpret_cast<const float4*>(x + (m0 + xr) * K + k0 + xc) : zero;
    rb = (k0 + br < K && n0 + bc < N)
             ? *reinterpret_cast<const float4*>(b + (k0 + br) * N + n0 + bc) : zero;
  };
  auto store = [&](int buf) {
    xs[buf][xc + 0][xr] = rx.x;
    xs[buf][xc + 1][xr] = rx.y;
    xs[buf][xc + 2][xr] = rx.z;
    xs[buf][xc + 3][xr] = rx.w;
    *reinterpret_cast<float4*>(&bs[buf][br][bc]) = rb;
  };

  load(0);
  store(0);
  __syncthreads();
  for (long kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int k = 0; k < F32_TK; ++k) {
      float a[8], c[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[cur][k][64 + ty * 4]);
      const float4 c0 = *reinterpret_cast<const float4*>(&bs[cur][k][tx * 4]);
      const float4 c1 = *reinterpret_cast<const float4*>(&bs[cur][k][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      c[0] = c0.x; c[1] = c0.y; c[2] = c0.z; c[3] = c0.w;
      c[4] = c1.x; c[5] = c1.y; c[6] = c1.z; c[7] = c1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

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
  if (tid == 0) partial[(long)blockIdx.y * gridDim.x + blockIdx.x] = m;
}

// float16 / bfloat16: 8 warps in a 2x4 grid, each 64x32 outputs as 4x2
// WMMA fragments. Rows of the shared tiles are padded by 16 bytes against
// bank conflicts (fragment pointers stay 32-byte aligned). Both products
// are held to two blocks an SM (at most 128 registers a thread): left
// alone, ptxas gave the bfloat16 instance 136 and one block an SM, and it
// ran at two thirds of the float16 instance's rate.
constexpr int H_TK = 32;
constexpr int H_PAD = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
gemm_wmma_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ y,
                 long M, long N, long K, float* __restrict__ partial) {
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(128) T xs[2][TILE_M][H_TK + H_PAD];
  __shared__ __align__(128) T bs[2][H_TK][TILE_N + H_PAD];
  __shared__ float scratch[32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const long m0 = (long)blockIdx.y * TILE_M, n0 = (long)blockIdx.x * TILE_N;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // Two 16-byte chunks of each operand tile per thread and k-tile: the x
  // tile is 128 rows of 4 chunks, the b tile 32 rows of 16 chunks.
  const long nk = (K + H_TK - 1) / H_TK;
  uint4 rx[2], rb[2];
  auto load = [&](long kt) {
    const long k0 = kt * H_TK;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + q * THREADS;
      const int xr = c >> 2, xc = (c & 3) * 8;
      const int br = c >> 4, bc = (c & 15) * 8;
      rx[q] = (m0 + xr < M && k0 + xc < K)
                  ? *reinterpret_cast<const uint4*>(x + (m0 + xr) * K + k0 + xc) : zero;
      rb[q] = (k0 + br < K && n0 + bc < N)
                  ? *reinterpret_cast<const uint4*>(b + (k0 + br) * N + n0 + bc) : zero;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + q * THREADS;
      *reinterpret_cast<uint4*>(&xs[buf][c >> 2][(c & 3) * 8]) = rx[q];
      *reinterpret_cast<uint4*>(&bs[buf][c >> 4][(c & 15) * 8]) = rb[q];
    }
  };

  load(0);
  store(0);
  __syncthreads();
  for (long kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < H_TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &xs[cur][wm * 64 + i * 16][kk], H_TK + H_PAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &bs[cur][kk][wn * 32 + j * 16], TILE_N + H_PAD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  // Epilogue: each warp stages one 16x16 float fragment at a time in the
  // (now idle) x tile, then every lane rounds 8 consecutive values of one
  // row, stores them with one 16-byte store and folds them into the max.
  float* stage = reinterpret_cast<float*>(&xs[0][0][0]) + warp * 256;
  const int sr = lane >> 1, sc = (lane & 1) * 8;
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long row = m0 + wm * 64 + i * 16 + sr;
      const long col = n0 + wn * 32 + j * 16 + sc;
      if (row < M && col < N) {
        T v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = from_f<T>(stage[sr * 16 + sc + e]);
          m = nan_max(m, fabsf(to_f(v[e])));
        }
        uint4 raw;
        memcpy(&raw, v, sizeof(raw));
        *reinterpret_cast<uint4*>(y + row * N + col) = raw;
      }
      __syncwarp();
    }
  }
  m = block_reduce(m, Max(), scratch);
  if (tid == 0) partial[(long)blockIdx.y * gridDim.x + blockIdx.x] = m;
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

dim3 gemm_grid(long M, long N) {
  return dim3((unsigned)((N + TILE_N - 1) / TILE_N), (unsigned)((M + TILE_M - 1) / TILE_M));
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

// y (M, N) = x (M, K) @ b (K, N); partial gets one abs-max per 128x128
// output tile, (ceil(M/128) * ceil(N/128) floats, tile (i, j) at
// i * ceil(N/128) + j).
int dtk_gemm_absmax_f32(const void* x, const void* b, void* y, long M, long N, long K,
                        float* partial, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  gemm_f32_kernel<<<gemm_grid(M, N), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)b, (float*)y, M, N, K, partial);
  return (int)cudaGetLastError();
}

int dtk_gemm_absmax_f16(const void* x, const void* b, void* y, long M, long N, long K,
                        float* partial, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  gemm_wmma_kernel<__half><<<gemm_grid(M, N), THREADS, 0, (cudaStream_t)stream>>>(
      (const __half*)x, (const __half*)b, (__half*)y, M, N, K, partial);
  return (int)cudaGetLastError();
}

int dtk_gemm_absmax_bf16(const void* x, const void* b, void* y, long M, long N, long K,
                         float* partial, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  gemm_wmma_kernel<__nv_bfloat16><<<gemm_grid(M, N), THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)b, (__nv_bfloat16*)y, M, N, K,
      partial);
  return (int)cudaGetLastError();
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
