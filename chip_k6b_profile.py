"""Where a step of K6b's fused route spends its time on the card.

Prints, one JSON line each: the latency of a cooperative grid sync (a small
probe kernel, n syncs of one launch); the times of the fused route at the
128-device root round (shared A) and at Mixtral M=4's root round (B6c, its
row blocks built once, as the search passes them), S = 1 and 4, beside K5's;
and the cycles (clock64 of block 0, thread 0) of each part of a fused step
from an instrumented copy of ``pdhg_sharded_kernel.cu``. The marks are
inserted at fixed places of the kernel's source; when the kernel changes
there, the script stops and names the place.

Run on a host with one CUDA card, from the repository root:

    python3 chip_k6b_profile.py

Builds go to ``.cache/k6b_profile/``. Exits non-zero without a card.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / ".cache" / "k6b_profile"

GSYNC_CU = r"""
#include <cooperative_groups.h>
#include <cstdio>
namespace cg = cooperative_groups;
__global__ void k(int n, int* out) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = n;
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  int* d;
  cudaMalloc(&d, 4);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int blocks : {sms, 33}) {
    int n = 20000, threads = 512;
    void* args[] = {&n, &d};
    cudaLaunchCooperativeKernel((void*)k, blocks, threads, args, 0, 0);
    cudaEventRecord(a);
    cudaLaunchCooperativeKernel((void*)k, blocks, threads, args, 0, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0;
    cudaEventElapsedTime(&ms, a, b);
    printf("{\"grid_sync_us\": %.4f, \"blocks\": %d, \"threads\": %d, \"syncs\": %d, \"err\": \"%s\"}\n",
           ms * 1e3 / n, blocks, threads, n, cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
"""

# The parts of a fused step, by the mark that closes them.
PARTS = {1: "STEP head (live mask, w)", 2: "t_cols", 3: "sync", 4: "t_rows", 5: "sync",
         13: "block 0's reductions (step scalars)", 6: "sync STEP -> COMMIT",
         7: "COMMIT head (the shards' step scalars, decisions)", 9: "updates of x, y",
         10: "sync", 11: "colpart", 12: "sync COMMIT -> STEP"}

PROFILE_HEAD = r"""
__device__ unsigned long long dtk_prof[32];
__device__ long long dtk_prof_last;
__device__ int dtk_prof_on;
#define PMARK(k) do { if (dtk_prof_on && blockIdx.x == 0 && threadIdx.x == 0) { \
  const long long _t = clock64(); dtk_prof[k] += (unsigned long long)(_t - dtk_prof_last); \
  dtk_prof_last = _t; } } while (0)
"""

PROFILE_READ = r"""
int dtk_pdhgs_prof(unsigned long long* out, int on) {
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
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + PROFILE_HEAD),
    ("""    __syncthreads();
    t_step<kElem>(p, s, grid, grp, pr, x, y, live, true);
""", """    __syncthreads();
    PMARK(1);
    t_step<kElem>(p, s, grid, grp, pr, x, y, live, true);
    PMARK(13);
"""),
    ("""  t_cols(p, s, grp, pr, x, mask, halpern);
  grid.sync();
  t_rows<kElem>(p, s, grp, y, mask, halpern);
  grid.sync();
""", """  t_cols(p, s, grp, pr, x, mask, halpern);
  if (halpern) PMARK(2);
  grid.sync();
  if (halpern) PMARK(3);
  t_rows<kElem>(p, s, grp, y, mask, halpern);
  if (halpern) PMARK(4);
  grid.sync();
  if (halpern) PMARK(5);
"""),
    ("""    __syncthreads();
    const T* tx = colv(p, V_TX);
""", """    __syncthreads();
    PMARK(7);
    const T* tx = colv(p, V_TX);
"""),
    ("""    grid.sync();
    // Every block has read the state it decided from: block 0 commits it.
""", """    PMARK(9);
    grid.sync();
    PMARK(10);
    // Every block has read the state it decided from: block 0 commits it.
"""),
    ("""    colpart<kElem, T>(p, grp, ys, p.part, live, false);
  } else if constexpr (PHASE == P_STATS) {
""", """    colpart<kElem, T>(p, grp, ys, p.part, live, false);
    PMARK(11);
  } else if constexpr (PHASE == P_STATS) {
"""),
    ("""        run_phase<T, kElem, P_STEP>(p, s, grid, grp, pr, 0);
        grid.sync();
        run_phase<T, kElem, P_COMMIT>(p, s, grid, grp, pr, 0);
        grid.sync();
""", """        PMARK(0);
        run_phase<T, kElem, P_STEP>(p, s, grid, grp, pr, 0);
        grid.sync();
        PMARK(6);
        run_phase<T, kElem, P_COMMIT>(p, s, grid, grp, pr, 0);
        grid.sync();
        PMARK(12);
        if (blockIdx.x == 0 && threadIdx.x == 0) dtk_prof[31] += 1;
"""),
    ('extern "C" {\n', 'extern "C" {\n' + PROFILE_READ),
]


def instrumented_source(src: str) -> str:
    for old, new in MARKS:
        if src.count(old) != 1:
            sys.exit(f"chip_k6b_profile: the kernel changed at a mark's place:\n{old}")
        src = src.replace(old, new)
    return src


def nvcc(args):
    r = subprocess.run(["/usr/local/cuda/bin/nvcc", *args], capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"nvcc failed:\n{r.stderr[-4000:]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_k6b_profile: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from distilp_torch.kernels import build
    from distilp_torch.ops.meshlp import row_blocks, sharded_pdhg
    from distilp_torch.ops.pdhg import DEFAULT_RESTART_TOL, _default_tol_pdhg, pdhg_solve_batch
    from distilp_torch.parallel import Mesh
    from distilp_torch.solver.standard_form import default_pdhg_iters

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "gsync.cu").write_text(GSYNC_CU)
    nvcc([*build.ARCH, "-O3", "-o", str(OUT / "gsync"), str(OUT / "gsync.cu")])
    print(subprocess.run([str(OUT / "gsync")], capture_output=True, text=True,
                         timeout=120).stdout.strip(), flush=True)

    (OUT / "common.cuh").write_text((build.CSRC / "common.cuh").read_text())
    (OUT / "pdhg_sharded_kernel.cu").write_text(
        instrumented_source((build.CSRC / "pdhg_sharded_kernel.cu").read_text()))
    so = OUT / "libpdhg_sharded_profile.so"
    nvcc([*build.ARCH, *build.BASE_FLAGS, *build.SOURCES["pdhg_sharded"][1], "-o", str(so),
          str(OUT / "pdhg_sharded_kernel.cu")])
    build.load_all()
    plain_lib = build._LIBS["pdhg_sharded"]
    prof_lib = ctypes.CDLL(str(so))
    for fn, argtypes in build.SIGNATURES["pdhg_sharded"].items():
        f = getattr(prof_lib, fn)
        f.argtypes = argtypes
        f.restype = build.RESTYPES.get(fn, ctypes.c_int)
    prof_lib.dtk_pdhgs_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": cs.smi_line(), "clocks": clocks.stdout.strip()}), flush=True)

    rt = DEFAULT_RESTART_TOL
    tol = _default_tol_pdhg(torch.float32)
    iters = default_pdhg_iters(128)
    batch, _ = cs.pdhg_roots(128, torch.float32)
    _, eb, eiters, warm, skip = cs.mixtral_mesh_calls()[0]
    runs = []
    for S in (1, 4):
        mesh = Mesh((torch.device("cuda", 0),) * S, True)
        blocks = row_blocks(eb.A.sparsity, S)
        runs.append((f"shared M=128 root S={S}", lambda mesh=mesh: sharded_pdhg(
            batch, mesh, iters, tol, rt)))
        runs.append((f"per-element Mixtral M=4 root S={S}", lambda mesh=mesh, blocks=blocks:
                     sharded_pdhg(eb, mesh, eiters, tol, rt, warm=warm, skip=skip,
                                  blocks=blocks)))
    k5 = cs.cuda_ms(lambda: pdhg_solve_batch(batch, iters=iters), reps=5, warmup=1)
    k5e = cs.cuda_ms(lambda: pdhg_solve_batch(eb, iters=eiters, tol=tol, restart_tol=rt,
                                              warm=warm, skip=skip), reps=5, warmup=1)
    print(json.dumps({"k5_shared_ms": k5, "k5_per_element_ms": k5e}), flush=True)
    for label, run in runs:
        ms = cs.cuda_ms(run, reps=5, warmup=1)
        dev = cs.device_ms(run, "pdhgs_fused_kernel", reps=3)
        print(json.dumps({"run": label, "ms": ms, "device_ms": dev}), flush=True)
    build._LIBS["pdhg_sharded"] = prof_lib
    buf = (ctypes.c_ulonglong * 32)()
    for label, run in runs:
        run()
        prof_lib.dtk_pdhgs_prof(buf, 1)
        run()
        prof_lib.dtk_pdhgs_prof(buf, 0)
        steps = max(1, buf[31])
        parts = {f"{k} {name}": round(buf[k] / steps, 1) for k, name in PARTS.items()}
        print(json.dumps({"profiled": label, "steps": steps,
                          "cycles_per_step": round(sum(parts.values()), 1),
                          "by_part": parts}), flush=True)
    build._LIBS["pdhg_sharded"] = plain_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
