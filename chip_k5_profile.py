"""Where a step of K5's cluster route spends its time on the card.

Prints, one JSON line each: the latency of a block barrier and of a cluster
barrier of C = 1, 2, 4 and 8 CTAs, cooperative groups' and the aligned one
the kernel uses (a probe kernel, n barriers in one launch, one 512-thread
CTA an SM); K5's time a launch and a step on the cluster
route at the 128-device root round (float32 and float64), the 512-device
one and the two 128-device lanes' root round (B=4, an A each); and the
cycles (clock64) of each part of a step from an instrumented copy of
``pdhg_cluster_kernel.cu``, read by two threads of element 0's rank-0 CTA:
thread 0 (warp 0, which walks the long column and the long row) and the
first thread of the last warp (short rows and columns only). A part ending
in a barrier includes the wait for the slowest warp of the cluster. The
marks are inserted at fixed places of the kernel's source; when the kernel
changes there, the script stops and names the place.

Run on a host with one CUDA card, from the repository root:

    python3 chip_k5_profile.py

Builds go to ``.cache/k5_profile/``. Exits non-zero without a card.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / ".cache" / "k5_profile"

SYNC_CU = r"""
#include <cooperative_groups.h>
#include <cstdio>
namespace cg = cooperative_groups;
// 0: __syncthreads; 1: cooperative groups' cluster.sync(); 2: the aligned
// cluster barrier the kernel uses (arrive.aligned, wait.aligned).
template <int KIND>
__global__ void __launch_bounds__(512, 1) probe(int n, int* out) {
  extern __shared__ unsigned char sm[];
  cg::cluster_group cl = cg::this_cluster();
  for (int i = 0; i < n; ++i) {
    if (KIND == 0) __syncthreads();
    if (KIND == 1) cl.sync();
    if (KIND == 2)
      asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;\n" ::: "memory");
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = n + sm[0];
}
template <int KIND>
void run(int C, int* d) {
  const int smem = 200000, n = 20000;
  cudaFuncSetAttribute(probe<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(512);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float ms = 0;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(a);
    cudaLaunchKernelEx(&cfg, probe<KIND>, n, d);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
  }
  const char* names[] = {"__syncthreads", "cg cluster.sync()", "barrier.cluster aligned"};
  printf("{\"barrier\": \"%s\", \"cluster\": %d, \"us\": %.5f, \"barriers\": %d, \"err\": \"%s\"}\n",
         names[KIND], C, ms * 1e3 / n, n, cudaGetErrorString(cudaGetLastError()));
}
int main() {
  int* d;
  cudaMalloc(&d, 4);
  run<0>(1, d);
  for (int C : {1, 2, 4, 8}) {
    run<1>(C, d);
    run<2>(C, d);
  }
  return 0;
}
"""

# The parts of a step, by the mark that closes them.
PARTS = {0: "chunk boundary (convergence test, once a chunk) and step head",
         1: "column phase", 2: "barrier 1", 3: "row phase and warp partials",
         4: "barrier 2", 5: "every warp's cluster reduction and decision",
         6: "commit of x, y and the replicas", 7: "barrier 3"}

PROFILE_HEAD = r"""
__device__ unsigned long long dtk_prof[32];
__device__ long long dtk_prof_last[2];
__device__ int dtk_prof_on;
#define PMARK(k) do { if (dtk_prof_on && blockIdx.x == 0 && \
    (threadIdx.x == 0 || threadIdx.x == DTK_PDHGC_THREADS - 32)) { \
  const int _w = threadIdx.x == 0 ? 0 : 1; const long long _t = clock64(); \
  dtk_prof[16 * _w + (k)] += (unsigned long long)(_t - dtk_prof_last[_w]); \
  dtk_prof_last[_w] = _t; } } while (0)
"""

PROFILE_READ = r"""
int dtk_pdhgc_prof(unsigned long long* out, int on) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, dtk_prof, sizeof(unsigned long long) * 32);
  unsigned long long z[32] = {};
  cudaMemcpyToSymbol(dtk_prof, z, sizeof(z));
  cudaMemcpyToSymbol(dtk_prof_on, &on, sizeof(int));
  return (int)cudaDeviceSynchronize();
}
"""

# (place in the source, the same with its marks)
MARKS = [
    ("extern __shared__ __align__(16) unsigned char dtk_pdhgc_smem[];\n",
     "extern __shared__ __align__(16) unsigned char dtk_pdhgc_smem[];\n" + PROFILE_HEAD),
    ("""  // ---- chunked Halpern loop ----
""", """  // ---- chunked Halpern loop ----
  PMARK(14);
"""),
    ("""      const T tf = T(t);
      const T wgt = (tf + T(1)) / (tf + T(2));
      ColPhase<T> cp{k, cl, V_X, true, wgt, T(0), 0};
      walk(sm<int>(k.cptr), nc, k.lc, k.nlc, k.L, cp);
      csync(C);
      RowPhase<T> rp{k, R_Y, true, wgt, cp.q, cp.fl};
      walk(sm<int>(k.rptr), nr, k.lr, k.nlr, k.L, rp);
      wpart(rp.q, Sum(), h.ws[S_Q]);
      wpart(rp.fl, Or(), h.wf);
      csync(C);
""", """      PMARK(0);
      const T tf = T(t);
      const T wgt = (tf + T(1)) / (tf + T(2));
      ColPhase<T> cp{k, cl, V_X, true, wgt, T(0), 0};
      walk(sm<int>(k.cptr), nc, k.lc, k.nlc, k.L, cp);
      PMARK(1);
      csync(C);
      PMARK(2);
      RowPhase<T> rp{k, R_Y, true, wgt, cp.q, cp.fl};
      walk(sm<int>(k.rptr), nr, k.lr, k.nlr, k.L, rp);
      wpart(rp.q, Sum(), h.ws[S_Q]);
      wpart(rp.fl, Or(), h.wf);
      PMARK(3);
      csync(C);
      PMARK(4);
"""),
    ("""      it += 1;
      const bool last = st == p.chunk - 1;
""", """      it += 1;
      PMARK(5);
      const bool last = st == p.chunk - 1;
"""),
    ("""          bcast(cl, k, k.rowR, r0 + ii, rowv<T>(k, R_ROWS, ii) * yn);
        }
      }
      csync(C);
    }
""", """          bcast(cl, k, k.rowR, r0 + ii, rowv<T>(k, R_ROWS, ii) * yn);
        }
      }
      PMARK(6);
      csync(C);
      PMARK(7);
      if (dtk_prof_on && blockIdx.x == 0 && threadIdx.x == 0) dtk_prof[31] += 1;
    }
"""),
    ('extern "C" {\n', 'extern "C" {\n' + PROFILE_READ),
]


def instrumented_source(src: str) -> str:
    for old, new in MARKS:
        if src.count(old) != 1:
            sys.exit(f"chip_k5_profile: the kernel changed at a mark's place:\n{old}")
        src = src.replace(old, new)
    return src


def nvcc(args):
    r = subprocess.run(["/usr/local/cuda/bin/nvcc", *args], capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"nvcc failed:\n{r.stderr[-4000:]}")


def lanes_root(cs, torch):
    """The two 128-device lanes' root round: both fleets' root LPs (B=4),
    each with its own A, as values on the union structure."""
    from distilp_torch.ops.pdhg import elem_a

    batches = [cs.pdhg_roots(128, torch.float32, seed)[0] for seed in (123, 124)]
    A3 = torch.cat([b.A.expand(b.b.shape[0], *b.A.shape) for b in batches])
    rest = [torch.cat([getattr(b, f) for b in batches]) for f in ("b", "c", "l", "u")]
    return type(batches[0])(elem_a(A3), *rest)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_k5_profile: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from distilp_torch.kernels import build
    from distilp_torch.ops.ipm import ipm_sparsity
    from distilp_torch.ops.pdhg import pdhg_solve_batch
    from distilp_torch.solver.standard_form import default_pdhg_iters

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "sync.cu").write_text(SYNC_CU)
    nvcc([*build.ARCH, "-O3", "-o", str(OUT / "sync"), str(OUT / "sync.cu")])
    print(subprocess.run([str(OUT / "sync")], capture_output=True, text=True,
                         timeout=120).stdout.strip(), flush=True)

    (OUT / "common.cuh").write_text((build.CSRC / "common.cuh").read_text())
    (OUT / "pdhg_cluster_kernel.cu").write_text(
        instrumented_source((build.CSRC / "pdhg_cluster_kernel.cu").read_text()))
    so = OUT / "libpdhg_cluster_profile.so"
    nvcc([*build.ARCH, *build.BASE_FLAGS, *build.SOURCES["pdhg_cluster"][1], "-o", str(so),
          str(OUT / "pdhg_cluster_kernel.cu")])
    build.load_all()
    plain_lib = build._LIBS["pdhg_cluster"]
    prof_lib = ctypes.CDLL(str(so))
    for fn, argtypes in build.SIGNATURES["pdhg_cluster"].items():
        f = getattr(prof_lib, fn)
        f.argtypes = argtypes
        f.restype = build.RESTYPES.get(fn, ctypes.c_int)
    prof_lib.dtk_pdhgc_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": cs.smi_line(), "clocks": clocks.stdout.strip()}), flush=True)

    it128 = default_pdhg_iters(128)
    runs = []
    for M, dtype, iters in ((128, torch.float32, it128), (128, torch.float64, it128),
                            (512, torch.float32, 1000)):
        batch, _ = cs.pdhg_roots(M, dtype)
        sp = ipm_sparsity(batch.A != 0)
        runs.append((f"shared M={M} {str(dtype).split('.')[-1]} route "
                     f"{cs.k5_route(batch.A, dtype)}",
                     lambda batch=batch, sp=sp, iters=iters: pdhg_solve_batch(
                         batch, iters=iters, sparsity=sp)))
    lanes = lanes_root(cs, torch)
    runs.append((f"per-element lanes' root B=4 route {cs.k5_route(lanes.A, torch.float32)}",
                 lambda: pdhg_solve_batch(lanes, iters=it128)))
    for label, run in runs:
        steps = int(run().iters_run.max())
        ms = cs.cuda_ms(run, reps=5, warmup=1)
        dev = cs.device_ms(run, cs.K5_KERNEL["cluster"], reps=5)
        print(json.dumps({"run": label, "ms": ms, "device_ms": dev, "steps": steps,
                          "us_per_step": (dev or ms) / steps * 1e3}), flush=True)
    build._LIBS["pdhg_cluster"] = prof_lib
    for is_f64 in (0, 1):  # the wrapper prepared the plain library's kernel only
        if prof_lib.dtk_pdhgc_prepare(is_f64) != 0:
            raise RuntimeError("the profiled cluster kernel could not be prepared")
    buf = (ctypes.c_ulonglong * 32)()
    for label, run in runs:
        run()
        prof_lib.dtk_pdhgc_prof(buf, 1)
        run()
        prof_lib.dtk_pdhgc_prof(buf, 0)
        steps = max(1, buf[31])
        for w, who in ((0, "thread 0 (long column and row)"), (1, "last warp (short ones)")):
            parts = {f"{k} {name}": round(buf[16 * w + k] / steps, 1)
                     for k, name in PARTS.items()}
            print(json.dumps({"profiled": label, "thread": who, "steps": steps,
                              "cycles_per_step": round(sum(parts.values()), 1),
                              "by_part": parts}), flush=True)
    build._LIBS["pdhg_cluster"] = plain_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
