"""Where K7's fused ascent and K2's MoE mode spend their time on the card.

Prints, one JSON line each:
- the latency of a cooperative grid sync of 256-thread blocks at 1 to 4
  blocks an SM (a small probe kernel, n syncs of one launch);
- the fused ascent (``ops/decomp.py::ascend_fused``) on the DeepSeek-V3
  flagship, Qwen3-30B-A3B on 16 devices, Mixtral 8x7B on 4 devices alone
  and as 4 lanes, at 1 to 4 blocks an SM: ms a call (CUDA events) at 1
  and 300 steps, and the microseconds a step between them;
- K2's MoE mode on the flagship's rows (16 LP rows with 8 moves, the hint
  row repaired with y_steps = E + 4, the warm row with 2 moves) at 256, 512
  and 768 threads a block.

Run on a host with one CUDA card, from the repository root:

    python3 chip_k7_profile.py

The probe builds to ``.cache/k7_profile/``. Exits non-zero without a card.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / ".cache" / "k7_profile"

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
  for (int per_sm = 1; per_sm <= 4; ++per_sm) {
    int n = 20000, threads = 256, blocks = per_sm * sms;
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


def grid_sync_probe():
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "gsync.cu").write_text(GSYNC_CU)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", str(OUT / "gsync"), str(OUT / "gsync.cu")], check=True)
    out = subprocess.run([str(OUT / "gsync")], capture_output=True, text=True, check=True,
                         timeout=300)
    print(out.stdout.strip(), flush=True)


def ascent_cases(C):
    import torch

    from distilp_torch.ops import decomp as D
    from distilp_torch.utils import make_synthetic_fleet

    dev = torch.device("cuda")
    cases = []
    for case in (C.FLAGSHIP, C.MOE_CASES[2]):
        cases.append((case[0], C.moe_instance(case)[8][0]))
    mdevs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    lanes = C.lane_inputs([mdevs] * 4, C.moe_model(C.MOE_CASES[0][1]), "8bit",
                          C.MIXTRAL_REGIMES)
    w_max, E = max(W for _, W in lanes[0].feasible), int(lanes[0].E)
    p32 = D.stack_problems([D.decomp_problem(ln.rd_np, ln.sf.ks, ln.sf.Ws, w_max, E,
                                             torch.float32, dev) for ln in lanes])
    cases.append(("mixtral_M4_x4", p32))
    cases.append(("mixtral_M4", D.stack_problems([p32.instance(0)])))
    return cases


def profile_ascent(C):
    from distilp_torch.ops import decomp as D

    per_sm0 = D.ASCENT_BLOCKS_PER_SM
    for name, p32 in ascent_cases(C):
        S, n_k = p32.ks.shape
        M = p32.rdv.shape[-1]
        for per_sm in (1, 2, 3, 4):
            D.ASCENT_BLOCKS_PER_SM = per_sm
            plan, per_block = D.ascent_layout(
                S, n_k, M, p32.w_max, p32.e_max, D._sm_count("cuda"),
                functools.partial(D._ascent_grid, "cuda", M))
            t1 = C.cuda_ms(lambda: D.ascend_fused(p32, 1), reps=10)
            t300 = C.cuda_ms(lambda: D.ascend_fused(p32, 300), reps=5)
            print(json.dumps({"ascent": name, "blocks_per_sm": per_sm, "plan": plan._asdict(),
                              "owner_states_a_block": per_block,
                              "ms_1_step": t1, "ms_300_steps": t300,
                              "us_a_step": (t300 - t1) / 299 * 1e3}), flush=True)
        D.ASCENT_BLOCKS_PER_SM = per_sm0


def profile_round_moe(C):
    import numpy as np
    import torch

    from distilp_torch.ops.decomp import decomp_bound_roots
    from distilp_torch.ops.ipm import ipm_solve_batch
    from distilp_torch.solver import rounding as R
    from distilp_torch.solver.standard_form import MOE_LOCAL_MOVES, MOE_LOCAL_MOVES_WARM

    *_, data, (p32, p64), host = C.moe_instance(C.FLAGSHIP)
    M, E = data.rd.a.shape[0], p64.e_max
    batch, _, _ = C.moe_ipm_batch(data, host, 16, torch.float32, np.random.default_rng(5))
    v_lp = ipm_solve_batch(batch, iters=13, chunk=4).v
    kidx = torch.as_tensor(np.random.default_rng(6).integers(0, data.ks.shape[0], 16),
                           device="cuda")
    _, w_s, n_s, y_s = (x[0] for x in decomp_bound_roots(
        p32, p64, R.stack_rounding_data([data.rd]), 300)[:4])
    nf = v_lp.shape[1]
    v_hint = torch.zeros((w_s.shape[0], nf), dtype=torch.float64, device="cuda")
    v_hint[:, :M], v_hint[:, M:2 * M], v_hint[:, 2 * M:3 * M] = w_s, n_s, y_s
    fix = R.round_moe_reference(v_hint[:1], data.Ws[:1], data.ks[:1], data.rd, y_steps=E + 4)
    v_warm = torch.zeros((1, nf), dtype=torch.float64, device="cuda")
    v_warm[0, :M], v_warm[0, M:2 * M], v_warm[0, 2 * M:3 * M] = fix[1][0], fix[2][0], fix[3][0]
    modes = {
        "lp_rows_moves8": (v_lp, data.Ws[kidx], data.ks[kidx], dict(moves=MOE_LOCAL_MOVES)),
        "hint_rows_repair": (v_hint, data.Ws, data.ks, dict(y_steps=E + 4)),
        "warm_row_moves2": (v_warm, data.Ws[:1], data.ks[:1], dict(moves=MOE_LOCAL_MOVES_WARM)),
        "hint_rows_repair_only": (v_hint, data.Ws, data.ks, dict(y_steps=E + 4, moves=0)),
    }
    threads0 = R.MOE_THREADS
    for threads in (256, 512, 768):
        R.MOE_THREADS = threads
        for name, (v, W, k, kw) in modes.items():
            def run():
                return R.round_to_incumbent(v, W, k, data.rd, data.rd_packed, moe=True, **kw)  # noqa: B023

            try:
                ms = C.cuda_ms(run, reps=20)
                dev = C.device_ms(run, "round_moe_kernel")
            except RuntimeError as e:  # a block the card cannot hold (registers)
                ms = dev = str(e)
            print(json.dumps({"round_moe": name, "threads": threads, "rows": int(v.shape[0]),
                              "call_ms": ms, "device_ms": dev}), flush=True)
    R.MOE_THREADS = threads0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_k7_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from distilp_torch.kernels import build

    print("gpu:", C.smi_line(), flush=True)
    build.load_all()
    grid_sync_probe()
    profile_ascent(C)
    profile_round_moe(C)
    return 0


if __name__ == "__main__":
    sys.exit(main())
