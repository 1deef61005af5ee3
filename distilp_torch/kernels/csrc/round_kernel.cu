// K2: exact integer rounding of dense LP points to MILP incumbents, one warp
// per row, in float64.
//
// Replaces distilp_tpu/solver/backend_jax.py::_int_redistribute and the dense
// branch of ::_round_to_incumbent (vmapped over the frontier rows of a
// branch-and-bound round, and called once on the warm hint). Per row
// (round_row.cuh, shared with the round tail, round_tail_kernel.cu): floor
// the LP layer counts w and redistribute them one unit at a time toward
// sum(w) == W by largest fractional remainder, in an (M+4)-step scan whose
// argmax follows jnp.argmax (first index of the maximum; index 0 when every
// score is -inf, so a blocked step still moves device 0); round n <= w; the
// closed-form RAM and VRAM slacks; the cycle C = max(busy + fetch/2); the
// exact objective (k-1) C + sum(lin), +inf when the point is infeasible.
//
// Per-row instance: `rd` is a stack of packed rounding blocks, one per
// instance, `rd_stride` doubles apart, and row r rounds against block
// inst[r] (its own w_active, a, busy constants and right-hand sides), so the
// rows of several sweeps (scenarios, batch lanes) round in one launch, as the
// reference's vmap over sweeps does. inst == nullptr reads block 0 for every
// row.
//
// What bounds it on an H100: a row is O(M^2) scalar float64 work over a few
// hundred bytes of input (M=16: 16 devices, 20 scan steps of a 16-wide
// argmax); the batch is at most a few dozen rows. Latency of one warp per
// row, not bytes or FLOPs. The design keeps a row's w and remainders in
// shared memory and every reduction in warp shuffles: no block barrier.
//
// Since the round tail (round_tail_kernel.cu) rounds every round's dense
// beam rows itself, this entry serves the warm hint, the node-sharded
// sweep's shards (a launch a shard inside the loop's graph) and the tail's
// plain version. Rows of more than 768 devices need more than 48 KB of
// shared memory a block: dtk_round_prepare sets that once a card.

#include "round_row.cuh"

namespace {

using namespace dtk;

template <typename Tv>
__global__ void round_kernel(const Tv* __restrict__ v, long v_stride,
                             const double* __restrict__ Wr,
                             const double* __restrict__ kr,
                             const double* __restrict__ rd_all,
                             const int* __restrict__ inst, long rd_stride, int M,
                             int B, double* __restrict__ obj_out,
                             double* __restrict__ w_out,
                             double* __restrict__ n_out) {
  extern __shared__ double sm[];
  const int wid = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + wid;
  if (r >= B) return;  // the whole warp leaves together
  double* w = sm + (size_t)wid * 2 * M;
  const double* rd = rd_all + (inst != nullptr ? (size_t)inst[r] * rd_stride : 0);
  round_row(v + (size_t)r * v_stride, Wr[r], kr[r], rd, M, w, w + M, obj_out + r,
            w_out + (size_t)r * M, n_out + (size_t)r * M);
}

constexpr int WARPS = 4;
constexpr int MAX_DEVICES = 64;
// The most dynamic shared memory each card's two kernels were prepared for
// (dtk_round_prepare), beyond the 48 KB a launch gets without asking.
int g_prepared[MAX_DEVICES];

size_t smem_bytes(int M) { return sizeof(double) * 2 * (size_t)M * WARPS; }

template <typename Tv>
int launch(const Tv* v, long v_stride, const double* Wr, const double* kr,
           const double* rd, const int* inst, long rd_stride, int M, int B,
           double* obj, double* w,
           double* n, cudaStream_t stream) {
  const int warps = WARPS;
  const int blocks = (B + warps - 1) / warps;
  const size_t sm = smem_bytes(M);
  if (sm > 48 * 1024) {
    // The attribute is set once a card by dtk_round_prepare, never here: a
    // launch inside a graph capture sets nothing.
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEVICES || (size_t)g_prepared[dev] < sm)
      return (int)cudaErrorInvalidConfiguration;
  }
  round_kernel<Tv><<<blocks, 32 * warps, sm, stream>>>(v, v_stride, Wr, kr, rd, inst,
                                                       rd_stride, M, B, obj, w, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Prepares this card's kernels for rows of M devices (the shared-memory
// attribute where a block needs more than 48 KB); once a card and M, before
// any launch (a graph capture included).
int dtk_round_prepare(int M) {
  const size_t sm = smem_bytes(M);
  if (sm <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if ((size_t)g_prepared[dev] >= sm) return 0;
  err = cudaFuncSetAttribute(round_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(round_kernel<double>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm);
  if (err != cudaSuccess) return (int)err;
  g_prepared[dev] = (int)sm;
  return 0;
}

int dtk_round_f32(const float* v, long v_stride, const double* Wr,
                  const double* kr, const double* rd, const int* inst,
                  long rd_stride, int M, int B, double* obj, double* w,
                  double* n, void* stream) {
  return launch<float>(v, v_stride, Wr, kr, rd, inst, rd_stride, M, B, obj, w, n,
                       (cudaStream_t)stream);
}

int dtk_round_f64(const double* v, long v_stride, const double* Wr,
                  const double* kr, const double* rd, const int* inst,
                  long rd_stride, int M, int B, double* obj, double* w,
                  double* n, void* stream) {
  return launch<double>(v, v_stride, Wr, kr, rd, inst, rd_stride, M, B, obj, w, n,
                        (cudaStream_t)stream);
}

}  // extern "C"
