// Shared device helpers of the solver kernels: NaN-propagating min/max (the
// semantics of jnp.minimum / jnp.maximum, which CUDA's fminf/fmaxf do not
// have: those drop a NaN operand), warp and block reductions with a fixed
// summation order, and the first-index argmax rule of jnp.argmax.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

namespace dtk {

constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ bool is_nan(T a) { return a != a; }

template <typename T>
__device__ __forceinline__ bool is_finite(T a) { return isfinite(a); }

// max/min that return NaN when either operand is NaN.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (is_nan(a) || a > b) ? a : b; }

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (is_nan(a) || a < b) ? a : b; }

// jnp.clip(x, lo, hi) == minimum(maximum(x, lo), hi), NaN-propagating.
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) { return nan_min(nan_max(x, lo), hi); }

struct Sum {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct Max {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return nan_max(a, b); }
};
struct Min {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return nan_min(a, b); }
};

// Butterfly reduction: every lane ends with the same value (each level
// combines the same two partials on both lanes of a pair).
template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Block-wide reduction; every thread gets the result. ``scratch`` holds one
// slot per warp (32 suffice for any block). Contains __syncthreads: every
// thread of the block must call it.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* scratch) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_reduce(v, op);
  __syncthreads();  // the previous call's readers are done with scratch
  if (lane == 0) scratch[wid] = v;
  __syncthreads();
  T r = scratch[0];
  for (int i = 1; i < nw; ++i) r = op(r, scratch[i]);
  return r;
}

// (value, index) argmax with jnp.argmax's rules: the first NaN wins, else
// the first index of the maximum (so an all -inf vector gives index 0).
template <typename T>
__device__ __forceinline__ void argmax_combine(T& v, int& i, T v2, int i2) {
  const bool n1 = is_nan(v), n2 = is_nan(v2);
  bool take;
  if (n1 || n2) {
    take = n2 && (!n1 || i2 < i);
  } else {
    take = v2 > v || (v2 == v && i2 < i);
  }
  if (take) {
    v = v2;
    i = i2;
  }
}

template <typename T>
__device__ __forceinline__ void warp_argmax(T& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    T v2 = __shfl_xor_sync(FULL, v, o);
    int i2 = __shfl_xor_sync(FULL, i, o);
    argmax_combine(v, i, v2, i2);
  }
}

// Block-wide argmax (jnp.argmax rules); every thread gets (v, i). Threads
// holding no element pass (-inf, INT_MAX). Contains __syncthreads.
template <typename T>
__device__ void block_argmax(T& v, int& i, T* sv, int* si) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  warp_argmax(v, i);
  __syncthreads();
  if (lane == 0) {
    sv[wid] = v;
    si[wid] = i;
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  for (int q = 1; q < nw; ++q) argmax_combine(v, i, sv[q], si[q]);
}

// (value, index) argmin with jnp.argmin's rules: the first NaN wins, else
// the first index of the minimum (so an all +inf vector gives index 0 when
// index 0 takes part).
template <typename T>
__device__ __forceinline__ void argmin_combine(T& v, int& i, T v2, int i2) {
  const bool n1 = is_nan(v), n2 = is_nan(v2);
  bool take;
  if (n1 || n2) {
    take = n2 && (!n1 || i2 < i);
  } else {
    take = v2 < v || (v2 == v && i2 < i);
  }
  if (take) {
    v = v2;
    i = i2;
  }
}

// Block-wide argmin (jnp.argmin rules); every thread gets (v, i). Threads
// holding no element pass (+inf, INT_MAX). Contains __syncthreads.
template <typename T>
__device__ void block_argmin(T& v, int& i, T* sv, int* si) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    T v2 = __shfl_xor_sync(FULL, v, o);
    int i2 = __shfl_xor_sync(FULL, i, o);
    argmin_combine(v, i, v2, i2);
  }
  __syncthreads();
  if (lane == 0) {
    sv[wid] = v;
    si[wid] = i;
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  for (int q = 1; q < nw; ++q) argmin_combine(v, i, sv[q], si[q]);
}

}  // namespace dtk
