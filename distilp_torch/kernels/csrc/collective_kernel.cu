// The collectives of the port's single-controller mesh: psum and pmax over
// the S shards' parts of one buffer, each receiving shard getting the same
// fixed-order result (part 0, 1, ..., S-1), bit for bit on every shard.
//
// Replaces jax.lax.psum / jax.lax.pmax inside shard_map in the JAX package
// (distilp_tpu/ops/pdhg.py:164-175 under ops/meshlp.py:96 sharded_pdhg, and
// distilp_tpu/profiler/topology.py:96 _collective_times), which XLA lowers to
// all-reduces over the TPU's interconnect. Here the parts have already reached
// the receiving shard's device (a peer copy across GPUs, the identity on a
// virtual mesh whose shards share a device); one launch per receiving shard
// reads them in shard order and writes the result. No atomics: the order of
// the sum is fixed, so every shard sees the same bits and takes the same
// replicated decisions. pmax propagates NaN as jnp.maximum does (common.cuh).
//
// What bounds it on an H100: bytes. S parts read once and one result written,
// (S + 1) * len elements per receiving shard; the PDHG's per-step exchange is
// a (B, n) column product (B = 2, n = 1665 at 128 devices: 13 KB), so a call
// is a launch's latency, not its bandwidth.

#include "common.cuh"

namespace {

using namespace dtk;

constexpr int MAX_PARTS = 64;
constexpr int THREADS = 256;
constexpr long MAX_BLOCKS = 1024;

template <typename T>
struct Parts {
  const T* p[MAX_PARTS];
};

template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS) reduce_parts(Parts<T> parts, int S, long len,
                                                        T* __restrict__ out) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < len; i += stride) {
    T r = parts.p[0][i];
    for (int s = 1; s < S; ++s) r = Op()(r, parts.p[s][i]);
    out[i] = r;
  }
}

template <typename T>
int launch(const void* const* ptrs, int S, long len, int op, void* out, cudaStream_t stream) {
  if (S < 1 || S > MAX_PARTS || len < 0 || (op != 0 && op != 1)) return (int)cudaErrorInvalidValue;
  if (len == 0) return 0;
  Parts<T> parts = {};
  for (int s = 0; s < S; ++s) parts.p[s] = static_cast<const T*>(ptrs[s]);
  long blocks = (len + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  T* o = static_cast<T*>(out);
  if (op == 0)
    reduce_parts<T, Sum><<<(unsigned)blocks, THREADS, 0, stream>>>(parts, S, len, o);
  else
    reduce_parts<T, Max><<<(unsigned)blocks, THREADS, 0, stream>>>(parts, S, len, o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = op over parts[0..S-1] elementwise, in shard order; op 0 sum, 1 max.
// parts: S device pointers on out's device (a host array of pointers).
int dtk_allreduce_f32(const void* const* parts, int S, long len, int op, void* out,
                      void* stream) {
  return launch<float>(parts, S, len, op, out, (cudaStream_t)stream);
}

int dtk_allreduce_f64(const void* const* parts, int S, long len, int op, void* out,
                      void* stream) {
  return launch<double>(parts, S, len, op, out, (cudaStream_t)stream);
}

}  // extern "C"
