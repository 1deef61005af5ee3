#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the HALDA solver on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the six kernel libraries from ``distilp_torch/kernels/csrc``, one
     nvcc each, all started together (timed);
  3. each kernel against its plain PyTorch version on the card, at the shapes
     of the 16-device north-star instance (the IPM also at M=32, and at M=192
     where its vectors leave shared memory; the PDHG at the root batches of
     the 128- and 512-device fleets, cold and warm, in float64 and float32,
     with every bound checked against the HiGHS LP optimum; the mixed-
     precision entry's float64 fallback), and at the MoE shapes: the IPM
     with a per-node A on the DeepSeek-V3 flagship's root and beam batches,
     the MoE rounding in its three modes, and the decomposition bound (K7)
     in float32 (bound and gradient) and float64 (bound, y-profile, hint)
     on Qwen3-30B-A3B and the flagship; with the tolerances stated below,
     and each kernel's time beside its plain version's and its least
     possible time on an H100;
  4. the main path, in three runs, each with the launch counts zeroed before
     it and read after it: (a) the dense slice, ``halda_solve`` on the four
     golden fixtures (pinned k and objective), the north star (pinned
     objective) and a 32-device fleet (against the port's HiGHS oracle);
     (b) fleet scale, ``halda_solve`` with the defaults on the 128-device
     fleet (the PDHG engine; pinned), the same instance on the IPM engine
     and with float64 PDHG iterates, the north star on the PDHG engine, and
     the 512-device fleet at gap 0.05 (pinned); (c) MoE co-assignment,
     ``halda_solve`` on Mixtral 8x7B (4 and 8 devices), Qwen3-30B-A3B (16
     devices) and the DeepSeek-V3 flagship (E=256 over 32 devices, pinned
     and against the HiGHS oracle), then a warm re-solve of the flagship
     after t_comm drift that re-evaluates the bound at the stored duals;
  5. one ``{"kernels": [...]}`` line, the nvidia-smi line as it prints it,
     and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_F64_S = 34e12

GOLDEN = [
    ("hermes_70b", 40, 29.643569),
    ("llama_3_70b/4bit", 8, 12.834690),
    ("llama_3_70b/online", 2, 1.934942),
    ("qwen3_32b/bf16", 16, 12.072837),
]
NORTH_STAR_OBJ = -38.374803
# Fleet-scale pins (k, objective), from the JAX package on the CPU:
#   distilp_tpu.solver.halda_solve(make_synthetic_fleet(M, seed=123),
#       stretch_model_for_fleet(llama_3_70b/online, M), mip_gap=...,
#       kv_bits="4bit", backend="jax")
# with the default lp_backend='auto' (the PDHG engine at M >= 128) unless
# named. The IPM value is the cross-engine check: both certify gap 1e-3.
FLEET128_GAP = 1e-3
FLEET128_PDHG = (1, -312.9522665906968)
FLEET128_IPM = (1, -312.9222174356161)  # lp_backend='ipm'
FLEET512_GAP = 0.05
FLEET512_PDHG = (1, -1255.833655005908)
# MoE pins (k, objective), from the JAX package on the CPU at mip_gap 1e-3,
# kv 8bit, lp_backend 'auto' (the IPM engine below 128 devices):
#   distilp_tpu.solver.halda_solve(make_synthetic_fleet(M, seed=S,
#       pool_bytes=P), profile_model(tests/configs/<cfg>.json,
#       batch_sizes=[1], sequence_length=128).to_model_profile(),
#       mip_gap=1e-3, kv_bits="8bit", backend="jax")
# (name, config, M, seed, pool bytes, pin). Qwen3's fleet seed is one the
# JAX package certifies at gap 0.
MOE_GAP = 1e-3
MOE_CASES = [
    ("mixtral_M4", "mixtral_8x7b", 4, 7, 64e9, (4, -132.93320566181376)),
    ("mixtral_M8", "mixtral_8x7b", 8, 7, 64e9, (4, -244.53183237917105)),
    ("qwen3_30b_a3b_M16", "qwen3_30b_a3b_8bit", 16, 1, 64e9, (3, -396.7709977962328)),
    ("deepseek_v3_M32", "deepseek_v3", 32, 11, 32e9, (1, -400.80947050866087)),
]
FLAGSHIP = MOE_CASES[-1]

# Kernel-vs-plain tolerances. K2 and K3 are exact (same float64/float32
# operations, no contraction): integer outputs, boxes and flags equal,
# float64 objectives within 1e-12 relative (sum order). K1 iterates the same
# algorithm in another summation order: in float64 every field agrees to
# 1e-6 relative (scale max(1, |ref|)) with equal iteration counts. In
# float32 the certificate, the float64 Lagrangian bound, agrees to 1e-3
# relative; the other fields, the convergence flags and the iteration counts
# are reported, not held: a float32 run stops when its residuals cross 1e-5,
# and rounding (summation order, fused multiply-adds) moves that crossing by
# steps, after which the two iterates differ by whatever those steps moved.
TOL_IPM_F64 = 1e-6
TOL_IPM_F32_CERT = 1e-3
TOL_EXACT_F64 = 1e-12
# K5 (PDHG) against its plain version. Float64: every field within 1e-6
# relative (scale max(1, |ref|)) with equal iteration counts: the two take
# the same steps in another summation order. Float32: the float64 bound
# within 1e-3 relative on every element, at equal step counts (an element
# the two runs stop at different chunks is run again in both with the
# budget cut to the earlier stop); the other fields, the flags and the
# iteration counts are reported, not held: the adaptive restart test
# (res <= 0.2 res_anchor) | (res > res_anchor) is a discrete branch that
# summation order flips in float32, and the two iterates then follow
# different (equally valid) restart sequences. Soundness, in both dtypes:
# every bound at most the HiGHS LP optimum + 1e-6 max(1, |optimum|).
TOL_PDHG_F64 = 1e-6
TOL_PDHG_F32_CERT = 1e-3
TOL_SOUND = 1e-6
# K2's MoE mode: integer vectors equal, objectives within 1e-12 relative
# (TOL_EXACT_F64). K7 float32: the bound within 1e-5 relative (scale
# max(1, |ref|)) and the tie-averaged w, y and cyc within 1e-5 (the two sum
# the tied cells' values in another order); float64: bound and m_y within
# 1e-12 relative, the hint (w*, n*, y*) equal.
TOL_DECOMP_F32 = 1e-5
# K1 with a per-node A in float64: its iterate fields within this multiple
# of the plain version's own change under a 4-ulp change of b (see
# check_ipm_moe). Summation order perturbs every step, not b alone, hence
# the wide factor; a wrong per-element index moves fields by O(1) and is
# also caught by the batch-against-each-element-alone equality.
TOL_IPM_MOE_SENS = 100.0


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _device_us(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    return float(us if us is not None else getattr(evt, "self_cuda_time_total", 0.0))


def _is_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def device_ms(fn, kernel: str, reps: int = 20):
    """Device time per launch (ms) of the kernels whose name contains
    ``kernel`` (one launch per call of every wrapper timed here), from
    torch.profiler's CUPTI trace, averaged over the launches the trace
    holds: it has been seen to hold two of three 181 ms launches. None when
    the profiler recorded no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if _is_device(e) and kernel in e.key]
    us = sum(_device_us(e) for e in evts)
    launches = sum(e.count for e in evts)
    if launches != reps:
        print(f"profiler: {launches} {kernel} launches recorded for {reps} calls",
              flush=True)
    return us / launches / 1e3 if us > 0 else None


def time_kernel(fn, kernel: str):
    """(ms on the card, ms per call, source): the kernel's device time per
    call from the profiler, else (profiler saw nothing) the call's CUDA-event
    time; the call time includes the host's launch overhead."""
    call = cuda_ms(fn)
    dev = device_ms(fn, kernel)
    return (dev, call, "profiler") if dev is not None else (call, call, "cuda_events")


def max_err(a, b):
    """(max abs, max rel with scale max(1, |b|)) over finite entries; inf
    and NaN must sit at the same places."""
    import torch

    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    same_nonfinite = torch.equal(~torch.isfinite(a), ~torch.isfinite(b)) and torch.equal(
        a[~torch.isfinite(a)].nan_to_num(0.0, 1.0, -1.0),
        b[~torch.isfinite(b)].nan_to_num(0.0, 1.0, -1.0),
    )
    fin = torch.isfinite(b) & torch.isfinite(a)
    if not same_nonfinite:
        return float("inf"), float("inf")
    if not bool(fin.any()):
        return 0.0, 0.0
    d = (a[fin] - b[fin]).abs()
    return float(d.max()), float((d / b[fin].abs().clamp(min=1.0)).max())


# ---------------------------------------------------------------- instances


def online_model(M: int = 0):
    """The llama-3-70B online profile; stretched to L = 2M layers for a
    fleet deeper than the model (the fleet-scale instance of bench.py)."""
    from distilp_torch.common import load_model_profile
    from distilp_torch.utils import stretch_model_for_fleet

    model = load_model_profile(
        ROOT / "tests" / "profiles" / "llama_3_70b" / "online" / "model_profile.json"
    )
    return stretch_model_for_fleet(model, M) if M > model.L else model


def load_instance(M: int, seed: int):
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.backend_torch import device_arrays
    from distilp_torch.solver.standard_form import build_standard_form
    from distilp_torch.utils import make_synthetic_fleet

    model = online_model(M)
    devs = make_synthetic_fleet(M, seed=seed)
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "4bit", None, None)
    feasible = [(k, model.L // k) for k in Ks if model.L // k >= M]
    sf = build_standard_form(arrays, coeffs, feasible)
    return devs, model, coeffs, arrays, feasible, sf, device_arrays(sf)


def ipm_batch(M: int, seed: int, B: int, dtype, rng):
    """B LPs of the M-device fleet's family: each row a root of a random k
    with branch-like fixed columns (some devices' GPU layers n_i := 0, some
    layer counts w_i := 1; both stay feasible), plus warm iterates from a
    short plain solve (perturbed, some rows not ok) and a skip mask."""
    import numpy as np
    import torch

    from distilp_torch.ops.ipm import IPMWarmState, LPBatch, ipm_solve_batch_reference

    *_, feasible, sf, host = load_instance(M, seed)
    n_k = len(feasible)
    kidx = rng.integers(0, n_k, B)
    lo = host["lo_k"][kidx].astype(np.float64)
    hi = host["hi_k"][kidx].astype(np.float64)
    for r in range(B):
        fix_n = np.nonzero(rng.random(M) < 0.3)[0]
        lo[r, M + fix_n] = 0.0
        hi[r, M + fix_n] = 0.0
        fix_w = np.nonzero(rng.random(M) < 0.15)[0]
        lo[r, fix_w] = 1.0
        hi[r, fix_w] = 1.0
        hi[r, M + fix_w] = np.minimum(hi[r, M + fix_w], 1.0)
    dev = torch.device("cuda")
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)  # noqa: E731
    batch = LPBatch(
        A=T(host["A"]), b=T(host["b_k"][kidx]), c=T(host["c_k"][kidx]),
        l=T(lo), u=T(hi),
    )
    pre = ipm_solve_batch_reference(batch, iters=4)
    noise = lambda t: t * (1.0 + 0.05 * T(rng.standard_normal(tuple(t.shape))))  # noqa: E731
    warm = IPMWarmState(
        v=noise(pre.v), y=noise(pre.y_dual), z=noise(pre.z_dual).abs(),
        f=noise(pre.f_dual).abs(),
        ok=torch.as_tensor(rng.random(B) < 0.75, device=dev),
    )
    skip = torch.as_tensor(rng.random(B) < 0.2, device=dev)
    return batch, warm, skip


def ipm_flops_bytes(m: int, n: int, B: int, iters_total: int, itemsize: int,
                    warm: bool = False):
    """Least work of one IPM launch: per executed step the normal matrix
    (m(m+1)/2 dot products of length n), a Cholesky (m^3/3), four
    triangular solves (4 m^2) and about six matvecs (12 m n); per element
    the float64 bound (4 m n). Bytes: every input read once (A shared), every
    output written once."""
    per_step = m * (m + 1) * n + m ** 3 / 3 + 4 * m * m + 12 * m * n + 60 * n
    flops = iters_total * per_step + B * 4 * m * n
    inputs = m * n * itemsize + B * (m + 3 * n) * itemsize
    if warm:
        inputs += B * (3 * n + m) * itemsize + 2 * B
    outputs = B * (4 * n + m) * itemsize + B * n * 8 + B * (8 + 4 * itemsize + 5)
    return flops, inputs + outputs


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------- phase 3


def check_ipm(report: dict) -> None:
    import numpy as np
    import torch

    from distilp_torch.ops.ipm import (
        ipm_solve_batch,
        ipm_solve_batch_reference,
        ipm_workspace_route,
    )

    # Where the kernel library puts one LP's vectors on this card, at the
    # edges of what an H100 block's shared memory holds (m = 6M+1, n = 13M+1;
    # tests/test_torch_ipm.py drives the wrapper with the same table).
    routes = {(M, str(dt).split(".")[-1]): ipm_workspace_route(6 * M + 1, 13 * M + 1, dt, "cuda")
              for M, dt in ((172, torch.float32), (173, torch.float32),
                            (86, torch.float64), (87, torch.float64))}
    print("ipm routes", json.dumps({f"M={M} {d}": r for (M, d), r in routes.items()}),
          flush=True)
    want = {(172, "float32"): "shared", (173, "float32"): "global",
            (86, "float64"): "shared", (87, "float64"): "global"}
    if routes != want:
        fail(f"ipm workspace routes {routes}, expected {want}")

    rng = np.random.default_rng(1234)
    rows = []
    cases = [
        (M, seed, 16, cfg)
        for M, seed in ((16, 123), (32, 32))
        for cfg in (
            (torch.float32, 8, 8),  # cold root round of the default budget
            (torch.float32, 6, 4),  # warm round
            (torch.float32, 26, 4),  # escalated budget
            (torch.float64, 26, 4),
        )
    ]
    # Above the old shared-memory ceiling (M > 172 in float32, M > 86 in
    # float64) the vectors live in a per-block global workspace: a cold
    # root-round budget, B=2, both elements live (no skip).
    global_cases = [(192, 192, 2, (torch.float32, 8, 8)),
                    (128, 123, 2, (torch.float64, 8, 8))]
    cases += global_cases
    for M, seed, B, (dtype, iters, chunk) in cases:
        batch, warm, skip = ipm_batch(M, seed, B, dtype, rng)
        if (M, seed, B, (dtype, iters, chunk)) in global_cases:
            skip = torch.zeros_like(skip)
        route = ipm_workspace_route(*batch.A.shape, dtype, batch.A.device)
        k = ipm_solve_batch(batch, iters=iters, warm=warm, skip=skip, chunk=chunk)
        r = ipm_solve_batch_reference(batch, iters=iters, warm=warm, skip=skip, chunk=chunk)
        torch.cuda.synchronize()
        errs = {f: max_err(getattr(k, f), getattr(r, f))
                for f in k._fields if f not in ("converged", "iters_run")}
        d_it = int((k.iters_run - r.iters_run).abs().max())
        conv_eq = bool(torch.equal(k.converged, r.converged))
        if dtype == torch.float64:
            ok = d_it == 0 and conv_eq and all(e[1] <= TOL_IPM_F64 for e in errs.values())
        else:
            ok = errs["bound"][1] <= TOL_IPM_F32_CERT
        line = {
            "M": M, "B": B, "route": route, "dtype": str(dtype).split(".")[-1],
            "iters": iters, "chunk": chunk, "iters_run": k.iters_run.tolist(),
            "d_iters": d_it, "converged_equal": conv_eq,
            "max_abs": {f: e[0] for f, e in errs.items()},
            "max_rel": {f: e[1] for f, e in errs.items()}, "ok": ok,
        }
        print("ipm vs plain", json.dumps(line), flush=True)
        rows.append(line)
    for r in rows[-len(global_cases):]:
        if r["route"] != "global" or min(r["iters_run"]) == 0:
            fail(f"ipm at M={r['M']} {r['dtype']}: route {r['route']}, iters_run "
                 f"{r['iters_run']}; expected the global route with every element live")
    bad = [(r["M"], r["dtype"], r["iters"], r["chunk"]) for r in rows if not r["ok"]]
    if bad:
        fail(f"ipm kernel disagrees with its plain version in (M, dtype, iters, chunk) {bad}")

    # Time at the north-star root-round shapes (B=16 LPs, f32, cold 8-step).
    batch, warm, skip = ipm_batch(16, 123, 16, torch.float32, np.random.default_rng(7))
    m, n = batch.A.shape
    run_k = lambda: ipm_solve_batch(batch, iters=8, chunk=8)  # noqa: E731
    run_p = lambda: ipm_solve_batch_reference(batch, iters=8, chunk=8)  # noqa: E731
    res = run_k()
    flops, nbytes = ipm_flops_bytes(m, n, 16, int(res.iters_run.sum()), 4)
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_F32_S)
    ms, call, src = time_kernel(run_k, "ipm_kernel")
    plain = cuda_ms(run_p, reps=5, warmup=1)
    # Yardstick: one batched library factor + solve of the same (16, m, m)
    # normal matrices, the core of one step (not the whole function).
    Mm = torch.eye(m, device="cuda").expand(16, m, m) * 2.0 + 0.01
    rhs = torch.ones(16, m, 1, device="cuda")
    chol = cuda_ms(lambda: torch.cholesky_solve(rhs, torch.linalg.cholesky(Mm)))
    report["ipm"] = dict(
        name="ipm", route="cuda", source="distilp_torch/kernels/csrc/ipm_kernel.cu",
        replaces="distilp_tpu/ops/ipm.py:149",
        max_abs_err=rows[0]["max_abs"]["bound"], ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        held_against_plain="ok", call_ms=call, ms_source=src, steps_timed=int(res.iters_run.sum()),
        chol_solve_ms_per_step=chol,
    )
    print(f"ipm: {ms:.4f} ms on the card, {call:.4f} ms per call "
          f"(plain {plain:.3f} ms, bound {b_ms:.5f} ms by {b_by}; "
          f"library cholesky+solve of one step {chol:.4f} ms) at B=16 m={m} n={n}",
          flush=True)


def main_path_state():
    """North-star sweep data + root state on the card (the solve's setup)."""
    import numpy as np
    import torch

    from distilp_torch.solver.rounding import pack_rounding_data, rounding_data
    from distilp_torch.solver.search import SweepData, root_state
    from distilp_torch.solver.standard_form import (
        resolve_search_params,
        rounding_arrays_np,
    )

    _, _, coeffs, _, feasible, sf, host = load_instance(16, 123)
    dev = torch.device("cuda")
    t = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    rd = rounding_data(rounding_arrays_np(coeffs, None), dev)
    data = SweepData(
        A=t["A"], b_k=t["b_k"], c_k=t["c_k"], int_mask=t["int_mask"],
        ks=torch.as_tensor(np.asarray(sf.ks, np.float64), device=dev),
        Ws=torch.as_tensor(np.asarray(sf.Ws, np.float64), device=dev),
        obj_const=float(sf.obj_const), rd=rd, rd_packed=pack_rounding_data(rd),
    )
    cap, *_ = resolve_search_params(False, len(feasible), None, None, None, None, M=16)
    state = root_state(t["lo_k"], t["hi_k"], 16, cap, data.A.shape[0])
    return data, state


def check_round(report: dict) -> None:
    import numpy as np
    import torch

    from distilp_torch.ops.ipm import ipm_solve_batch
    from distilp_torch.solver.rounding import (
        round_to_incumbent,
        round_to_incumbent_reference,
    )

    data, _ = main_path_state()
    # 16 rows of real LP points: a B=16 batch of the north-star family.
    batch, warm, skip = ipm_batch(16, 123, 16, torch.float32, np.random.default_rng(5))
    v = ipm_solve_batch(batch, iters=8, chunk=8).v
    kidx = torch.as_tensor(np.random.default_rng(6).integers(0, data.ks.shape[0], 16),
                           device="cuda")
    W, k = data.Ws[kidx], data.ks[kidx]
    got = round_to_incumbent(v, W, k, data.rd, data.rd_packed)
    ref = round_to_incumbent_reference(v, W, k, data.rd)
    torch.cuda.synchronize()
    w_eq = bool(torch.equal(got[1], ref[1]))
    n_eq = bool(torch.equal(got[2], ref[2]))
    oa, orel = max_err(got[0], ref[0])
    print("round vs plain", json.dumps({"w_equal": w_eq, "n_equal": n_eq,
          "obj_max_abs": oa, "obj_max_rel": orel,
          "finite_rows": int(torch.isfinite(ref[0]).sum())}), flush=True)
    if not (w_eq and n_eq and orel <= TOL_EXACT_F64):
        fail("round_incumbent kernel disagrees with its plain version")
    M, B = 16, 16
    run_k = lambda: round_to_incumbent(v, W, k, data.rd, data.rd_packed)  # noqa: E731
    ms, call, src = time_kernel(run_k, "round_kernel")
    plain = cuda_ms(lambda: round_to_incumbent_reference(v, W, k, data.rd), reps=5)
    nbytes = B * 2 * M * 4 + 13 * M * 8 + 2 * B * 8 + B * (1 + 2 * M) * 8
    flops = B * ((M + 4) * 3 * M + 40 * M)
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_F64_S)
    report["round_incumbent"] = dict(
        name="round_incumbent", route="cuda",
        source="distilp_torch/kernels/csrc/round_kernel.cu",
        replaces="distilp_tpu/solver/backend_jax.py:639",
        max_abs_err=oa, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, held_against_plain="ok", call_ms=call, ms_source=src,
    )
    print(f"round_incumbent: {ms:.4f} ms on the card, {call:.4f} ms per call (plain {plain:.3f} ms, bound {b_ms:.6f} ms "
          f"by {b_by}) at B=16 M=16", flush=True)


def check_epilogue(report: dict) -> None:
    import torch

    from distilp_torch.solver import search

    data, state = main_path_state()
    captured = {}
    orig = search.bnb_epilogue

    def capture(*args):
        captured["args"] = args
        return orig(*args)

    search.bnb_epilogue = capture
    try:
        n_k = data.ks.shape[0]
        search.bnb_round(data, state, 1e-3, ipm_iters=8, beam=n_k, ipm_chunk=8)
    finally:
        search.bnb_epilogue = orig
    args = captured["args"]
    got = search.bnb_epilogue(*args)
    ref = search.bnb_epilogue_reference(*args)
    torch.cuda.synchronize()
    bad = [f for f in got._fields
           if not torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu())]
    print("bnb_epilogue vs plain", json.dumps({"fields_differing": bad,
          "rows": int(args[0].shape[0])}), flush=True)
    if bad:
        fail(f"bnb_epilogue kernel disagrees with its plain version in {bad}")
    B, nf = args[0].shape
    m = args[2].y_dual.shape[1]
    run_k = lambda: search.bnb_epilogue(*args)  # noqa: E731
    ms, call, src = time_kernel(run_k, "bnb_epilogue_kernel")
    plain = cuda_ms(lambda: search.bnb_epilogue_reference(*args), reps=5)
    # In: 3 f32 boxes/points, f64 reduced costs, 2 f32 duals, 3 f32 carried
    # iterates per (row, column); 2 f32 dual rows of m; 4 f64 + 2 flag bytes
    # per row; the mask. Out: 7 f32 per (row, column), one f32 dual row,
    # a f64 bound and 2 flags per row.
    nbytes = B * nf * (40 + 28) + B * m * (8 + 4) + B * (32 + 2 + 10) + nf
    flops = B * nf * 30
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_F64_S)
    report["bnb_epilogue"] = dict(
        name="bnb_epilogue", route="cuda",
        source="distilp_torch/kernels/csrc/bnb_epilogue_kernel.cu",
        replaces="distilp_tpu/solver/backend_jax.py:1569",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, held_against_plain="ok", call_ms=call, ms_source=src,
    )
    print(f"bnb_epilogue: {ms:.4f} ms on the card, {call:.4f} ms per call (plain {plain:.3f} ms, bound {b_ms:.6f} ms "
          f"by {b_by}) at B={B} nf={nf}", flush=True)


def pdhg_roots(M: int, dtype):
    """The root-round LP batch (one LP per feasible k) of the M-device
    fleet, on the card, and the host arrays it came from."""
    import numpy as np
    import torch

    from distilp_torch.ops.ipm import LPBatch

    *_, host = load_instance(M, 123)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device="cuda")  # noqa: E731
    batch = LPBatch(A=T(host["A"]), b=T(host["b_k"]), c=T(host["c_k"]),
                    l=T(host["lo_k"]), u=T(host["hi_k"]))
    return batch, host


def lp_optima(host) -> list:
    """HiGHS optimum of every root LP, on the float64 values of the data."""
    import numpy as np
    from scipy.optimize import linprog

    A = np.asarray(host["A"], np.float64)
    out = []
    for e in range(host["b_k"].shape[0]):
        bounds = np.stack([host["lo_k"][e], host["hi_k"][e]], 1).astype(np.float64)
        r = linprog(np.asarray(host["c_k"][e], np.float64), A_eq=A,
                    b_eq=np.asarray(host["b_k"][e], np.float64), bounds=bounds,
                    method="highs")
        if r.status != 0:
            fail(f"HiGHS could not solve root LP {e}: {r.message}")
        out.append(float(r.fun))
    return out


def pdhg_flops_bytes(m: int, n: int, nnz: int, B: int, iters_run, chunk: int,
                     itemsize: int, warm: bool = False):
    """Least work of one PDHG launch: (operations, bytes, operations if A
    were dense). Operations, counted on A's nonzeros (the products need no
    others): per executed step the two products (4 nnz); per executed chunk
    the convergence test's two products (4 nnz); per element the setup's
    three passes over A (|A| diag(cs) row maxima and sums, A l; 6 nnz), the
    warm gate's extra step (4 nnz) and the float64 certificate (4 nnz).
    Bytes: every input read once (A shared; it is given dense, so all m n
    entries are read to find its nonzeros), every output written once."""
    steps = sum(int(i) for i in iters_run)
    chunks = sum(-(-int(i) // chunk) for i in iters_run)
    per_nnz = 4 * (steps + chunks) + B * (10 + (4 if warm else 0))
    inputs = m * n * itemsize + B * (m + 3 * n) * itemsize
    if warm:
        inputs += B * (3 * n + m) * itemsize + B
    outputs = B * (4 * n + m) * itemsize + B * n * 8 + B * (8 + 4 * itemsize + 5)
    return per_nnz * nnz, inputs + outputs, per_nnz * m * n


def pdhg_f32_bounds(k, r, batch, iters: int, warm):
    """The kernel's and the plain version's float64 bounds at equal step
    counts, and the elements re-run to get them. An element that both runs
    report converged, or that both ran the whole budget, is taken as it is;
    any other (the two stopped at different chunks) is run again in both
    versions with the budget cut to the step count of the one that stopped
    first, so every element's bound is held."""
    import torch

    from distilp_torch.ops.ipm import LPBatch
    from distilp_torch.ops.pdhg import (
        PDHGWarmState,
        pdhg_solve_batch,
        pdhg_solve_batch_reference,
    )

    kb, rb = k.bound.clone(), r.bound.clone()
    same = (k.converged & r.converged) | ((k.iters_run >= iters) & (r.iters_run >= iters))
    rerun = {}
    for e in torch.nonzero(~same).flatten().tolist():
        steps = int(torch.minimum(k.iters_run[e], r.iters_run[e]))
        sub = LPBatch(batch.A, *(t[e:e + 1] for t in batch[1:]))
        sw = None if warm is None else PDHGWarmState(*(t[e:e + 1] for t in warm))
        ke = pdhg_solve_batch(sub, iters=steps, warm=sw)
        re = pdhg_solve_batch_reference(sub, iters=steps, warm=sw)
        kb[e], rb[e] = ke.bound[0], re.bound[0]
        rerun[e] = (steps, int(ke.iters_run[0]), int(re.iters_run[0]))
    return kb, rb, rerun


def check_pdhg(report: dict) -> None:
    import torch

    from distilp_torch.ops.pdhg import (
        PDHG_DEFAULT_CHUNK,
        PDHGWarmState,
        pdhg_solve_batch,
        pdhg_solve_batch_reference,
    )
    from distilp_torch.solver.standard_form import default_pdhg_iters

    rows, bad = [], []
    for M, iters in ((128, default_pdhg_iters(128)), (512, 1000)):
        optima = None
        for dtype in (torch.float64, torch.float32):
            batch, host = pdhg_roots(M, dtype)
            if optima is None:
                optima = torch.tensor(lp_optima(host), dtype=torch.float64)
            cold = pdhg_solve_batch(batch, iters=iters)
            warm = PDHGWarmState(cold.v, cold.y_dual, cold.z_dual, cold.f_dual,
                                 torch.ones_like(cold.converged))
            for start, w in (("cold", None), ("warm", warm)):
                k = cold if w is None else pdhg_solve_batch(batch, iters=iters, warm=w)
                r = pdhg_solve_batch_reference(batch, iters=iters, warm=w)
                torch.cuda.synchronize()
                errs = {f: max_err(getattr(k, f), getattr(r, f))
                        for f in k._fields if f not in ("converged", "iters_run")}
                d_it = int((k.iters_run - r.iters_run).abs().max())
                conv_eq = bool(torch.equal(k.converged, r.converged))
                slack = (k.bound.cpu() - optima) / optima.abs().clamp(min=1.0)
                sound = bool((slack <= TOL_SOUND).all() & torch.isfinite(slack).all())
                rerun, f32_bound_rel = None, None
                if dtype == torch.float64:
                    ok = d_it == 0 and conv_eq and all(
                        e[1] <= TOL_PDHG_F64 for e in errs.values())
                else:
                    kb, rb, rerun = pdhg_f32_bounds(k, r, batch, iters, w)
                    f32_bound_rel = max_err(kb, rb)[1]
                    ok = f32_bound_rel <= TOL_PDHG_F32_CERT
                line = {
                    "M": M, "dtype": str(dtype).split(".")[-1], "start": start,
                    "iters": iters, "B": int(batch.b.shape[0]),
                    "iters_run": k.iters_run.tolist(),
                    "iters_run_plain": r.iters_run.tolist(),
                    "converged": k.converged.tolist(),
                    "converged_plain": r.converged.tolist(),
                    "bound": k.bound.tolist(), "lp_optimum": optima.tolist(),
                    "max_rel_slack_over_optimum": float(slack.max()),
                    "max_abs": {f: e[0] for f, e in errs.items()},
                    "max_rel": {f: e[1] for f, e in errs.items()},
                    "f32_bound_max_rel_all_elements": f32_bound_rel,
                    "f32_rerun_at_equal_steps": rerun,
                    "sound": sound, "ok": ok and sound,
                }
                print("pdhg vs plain", json.dumps(line), flush=True)
                rows.append(line)
                if not line["ok"]:
                    bad.append((M, line["dtype"], start))
    if bad:
        fail(f"pdhg kernel disagrees with its plain version or its bound is "
             f"unsound in (M, dtype, start) {bad}")

    # Time at the main path's shapes: the 128-device root round (float32,
    # cold, the default budget), and the 512-device one (1000 steps).
    timing = {}
    for M, iters, reps in ((128, default_pdhg_iters(128), 10), (512, 1000, 3)):
        batch, _ = pdhg_roots(M, torch.float32)
        m, n = batch.A.shape
        B = int(batch.b.shape[0])
        nnz = int(torch.count_nonzero(batch.A))
        run_k = lambda: pdhg_solve_batch(batch, iters=iters)  # noqa: E731
        res = run_k()
        flops, nbytes, dense_flops = pdhg_flops_bytes(
            m, n, nnz, B, res.iters_run.tolist(), PDHG_DEFAULT_CHUNK, 4)
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_F32_S)
        dense_b_ms, dense_b_by = bound_ms(dense_flops, nbytes, PEAK_F32_S)
        call = cuda_ms(run_k, reps=reps, warmup=1)
        dev = device_ms(run_k, "pdhg_kernel", reps=reps)
        ms, src = (dev, "profiler") if dev is not None else (call, "cuda_events")
        plain = cuda_ms(lambda: pdhg_solve_batch_reference(batch, iters=iters),
                        reps=1, warmup=0)
        # Yardstick: one step's two products as library calls at the root
        # batch width, times the steps the batch executed.
        X = torch.rand(n, B, device="cuda")
        Y = torch.rand(m, B, device="cuda")
        A = batch.A
        mm = cuda_ms(lambda: (torch.matmul(A, X), torch.matmul(A.t(), Y)))
        # The same two products as sparse (CSR) library calls, for scale.
        A_csr, At_csr = A.to_sparse_csr(), A.t().contiguous().to_sparse_csr()
        sp = cuda_ms(lambda: (torch.sparse.mm(A_csr, X), torch.sparse.mm(At_csr, Y)))
        steps = int(res.iters_run.max())
        timing[M] = dict(
            ms=ms, call_ms=call, ms_source=src, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, nnz=nnz, flops=flops, bytes=nbytes,
            dense_ops_bound_ms=dense_b_ms, dense_ops_bound_by=dense_b_by,
            library_ms=mm * steps, library_step_ms=mm,
            library_sparse_ms=sp * steps, library_sparse_step_ms=sp,
            steps=steps, iters_run=res.iters_run.tolist(), m=m, n=n, B=B,
        )
        print(f"pdhg M={M}: {ms:.4f} ms on the card, {call:.4f} ms per call "
              f"(plain {plain:.3f} ms, bound {b_ms:.5f} ms by {b_by} with "
              f"{nnz} nonzeros in A, {dense_b_ms:.5f} ms by {dense_b_by} if A "
              f"were dense; library products {mm:.4f} ms dense, {sp:.4f} ms "
              f"sparse, x {steps} steps) at B={B} m={m} n={n} "
              f"iters_run={res.iters_run.tolist()}", flush=True)
    t128 = timing[128]
    report["pdhg"] = dict(
        name="pdhg", route="cuda", source="distilp_torch/kernels/csrc/pdhg_kernel.cu",
        replaces="distilp_tpu/ops/pdhg.py:139",
        max_abs_err=max(r["max_abs"]["bound"] for r in rows),
        ms=t128["ms"], plain_ms=t128["plain_ms"], bound_ms=t128["bound_ms"],
        bound_by=t128["bound_by"], library_ms=t128["library_ms"],
        held_against_plain="ok", call_ms=t128["call_ms"], ms_source=t128["ms_source"],
        nnz=t128["nnz"], dense_ops_bound_ms=t128["dense_ops_bound_ms"],
        library_sparse_ms=t128["library_sparse_ms"],
        shapes_timed=f"M=128 root round, float32, cold, {default_pdhg_iters(128)} steps",
        m512_1000_steps=timing[512],
    )


def check_pdhg_mp() -> None:
    """K6a: the float32 run with the per-element float64 re-solve, on the
    128-device fleet's k=1 root LP (the one that decides the solve) at the
    escalated budget. (Its k=2 root does not reach the tolerance within
    16000 steps in either precision, so a batch holding it would rightly
    count a fallback.)"""
    import torch

    from distilp_torch.ops.ipm import LPBatch
    from distilp_torch.ops.meshlp import pdhg_solve_batch_mp
    from distilp_torch.solver.standard_form import default_pdhg_iters

    iters = 4 * default_pdhg_iters(128)
    roots, _ = pdhg_roots(128, torch.float64)
    batch = LPBatch(roots.A, *(t[:1].repeat(2, 1) for t in roots[1:]))
    rep = {}
    pdhg_solve_batch_mp(batch, iters=iters, dtype="f32", fallback_report=rep)
    healthy = rep["n_fallback"]
    b_bad = batch.b.clone()
    b_bad[0] *= 1e39  # float32(1e39) is inf: that element's float32 run cannot be finite
    poisoned = batch._replace(b=b_bad)
    rep = {}
    res = pdhg_solve_batch_mp(poisoned, iters=iters, dtype="f32", fallback_report=rep)
    r32 = pdhg_solve_batch_mp(poisoned, iters=iters, dtype="f32", f64_fallback=False)
    r64 = pdhg_solve_batch_mp(poisoned, iters=iters, dtype="f64")
    bad = ~r32.converged | ~torch.isfinite(r32.bound)
    spliced = all(
        torch.equal(getattr(res, f)[bad], getattr(r64, f).to(getattr(res, f).dtype)[bad])
        and torch.equal(getattr(res, f)[~bad], getattr(r32, f)[~bad])
        for f in res._fields
    )
    line = {"n_fallback_healthy": healthy, "n_fallback_poisoned": rep["n_fallback"],
            "poisoned_row_fell_back": bool(bad[0]), "splice_exact": spliced}
    print("pdhg_mp", json.dumps(line), flush=True)
    if healthy != 0 or rep["n_fallback"] < 1 or not bool(bad[0]) or not spliced:
        fail(f"pdhg_solve_batch_mp fallback check failed: {line}")


# ---------------------------------------------------------------- MoE shapes


def moe_model(config: str):
    from distilp_torch.profiler import profile_model

    return profile_model(str(ROOT / "tests" / "configs" / f"{config}.json"),
                         batch_sizes=[1], sequence_length=128).to_model_profile()


def moe_instance(case, device="cuda"):
    """The sweep of one MoE case on ``device``: (devs, model, coeffs, arrays,
    feasible, sf, rd_np, SweepData, (p32, p64))."""
    import numpy as np
    import torch

    from distilp_torch.ops.decomp import decomp_problem
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.backend_torch import device_arrays
    from distilp_torch.solver.rounding import pack_rounding_data, rounding_data
    from distilp_torch.solver.search import SweepData
    from distilp_torch.solver.standard_form import build_standard_form, rounding_arrays_np
    from distilp_torch.utils import make_synthetic_fleet

    _, config, M, seed, pool, _ = case
    model = moe_model(config)
    devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool))
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "8bit", None, None)
    feasible = [(k, model.L // k) for k in Ks if model.L // k >= M]
    sf = build_standard_form(arrays, coeffs, feasible)
    rd_np = rounding_arrays_np(coeffs, arrays.moe)
    host = device_arrays(sf, rd_np["g_raw"])
    t = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    rd = rounding_data(rd_np, device)
    data = SweepData(
        A=t["A"], b_k=t["b_k"], c_k=t["c_k"], int_mask=t["int_mask"],
        ks=torch.as_tensor(np.asarray(sf.ks, np.float64), device=device),
        Ws=torch.as_tensor(np.asarray(sf.Ws, np.float64), device=device),
        obj_const=float(sf.obj_const), rd=rd, rd_packed=pack_rounding_data(rd),
        gky=t["gky"],
    )
    w_max, E = max(sf.Ws), int(rd_np["E"])
    probs = tuple(decomp_problem(rd_np, sf.ks, sf.Ws, w_max, E, dt, device)
                  for dt in (torch.float32, torch.float64))
    return devs, model, coeffs, arrays, feasible, sf, rd_np, data, probs, host


def moe_ipm_batch(data, host, B: int, dtype, rng):
    """B nodes of the MoE family with their own A (the per-k expert-busy
    entries scattered in, as a round builds them): roots of random k with
    branch-like fixed columns (some n_i := 0, some y_i boxes cut to half),
    warm iterates from a short plain solve, and a skip mask (no skip at
    B=1)."""
    import numpy as np
    import torch

    from distilp_torch.ops.ipm import IPMWarmState, LPBatch, ipm_solve_batch_reference
    from distilp_torch.solver.search import node_A

    n_k = host["b_k"].shape[0]
    M = data.rd.a.shape[0]
    kidx = rng.integers(0, n_k, B)
    lo = host["lo_k"][kidx].astype(np.float64)
    hi = host["hi_k"][kidx].astype(np.float64)
    if B > 1:
        for r in range(B):
            fix_n = np.nonzero(rng.random(M) < 0.3)[0]
            lo[r, M + fix_n] = 0.0
            hi[r, M + fix_n] = 0.0
            cut = np.nonzero(rng.random(M) < 0.3)[0]
            hi[r, 2 * M + cut] = np.floor(hi[r, 2 * M + cut] / 2)
    dev = torch.device("cuda")
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)  # noqa: E731
    A = node_A(data, torch.as_tensor(kidx, device=dev), M).to(dtype)
    batch = LPBatch(A=A, b=T(host["b_k"][kidx]), c=T(host["c_k"][kidx]), l=T(lo), u=T(hi))
    pre = ipm_solve_batch_reference(batch, iters=4)
    noise = lambda t: t * (1.0 + 0.05 * T(rng.standard_normal(tuple(t.shape))))  # noqa: E731
    warm = IPMWarmState(
        v=noise(pre.v), y=noise(pre.y_dual), z=noise(pre.z_dual).abs(),
        f=noise(pre.f_dual).abs(),
        ok=torch.as_tensor(rng.random(B) < 0.75, device=dev),
    )
    skip = torch.as_tensor((rng.random(B) < 0.2) & (B > 1), device=dev)
    return batch, warm, skip


def check_ipm_moe(report: dict) -> None:
    """K1's per-element-A route at the flagship's shapes (m=258, n=513).

    Each element's block reads only its own A, so the batch's results must
    equal, bit for bit, those of each element run alone: that holds the
    per-element indexing. Against the plain version: float32 as above
    (the bound within TOL_IPM_F32_CERT); float64 the bound within
    TOL_IPM_F64 with equal iteration counts and flags, and every other field
    within TOL_IPM_MOE_SENS times what a 4-ulp change of b moves the plain
    version itself: these nodes' normal matrices are so ill-conditioned
    that their iterates carry that sensitivity (on the CPU a 4-ulp change of
    b moves v by 9e-5 relative and the bound by 1.6e-9)."""
    import numpy as np
    import torch

    from distilp_torch.ops.ipm import (
        IPMWarmState,
        LPBatch,
        ipm_solve_batch,
        ipm_solve_batch_reference,
        ipm_workspace_route,
    )

    *_, data, _, host = moe_instance(FLAGSHIP)
    rng = np.random.default_rng(77)
    bad, rows = [], []
    for B, dtype, iters, chunk in ((1, torch.float32, 26, 26), (16, torch.float32, 13, 4),
                                   (1, torch.float64, 26, 26), (16, torch.float64, 13, 4)):
        batch, warm, skip = moe_ipm_batch(data, host, B, dtype, rng)
        w = None if B == 1 else warm
        route = ipm_workspace_route(*batch.A.shape[1:], dtype, batch.A.device)
        k = ipm_solve_batch(batch, iters=iters, warm=w, skip=skip, chunk=chunk)
        r = ipm_solve_batch_reference(batch, iters=iters, warm=w, skip=skip, chunk=chunk)
        alone_equal = True
        if B > 1:
            for e in range(B):
                sub = LPBatch(*(t[e:e + 1] for t in batch))
                ke = ipm_solve_batch(sub, iters=iters, chunk=chunk, skip=skip[e:e + 1],
                                     warm=IPMWarmState(*(t[e:e + 1] for t in warm)))
                alone_equal &= all(torch.equal(getattr(ke, f), getattr(k, f)[e:e + 1])
                                   for f in k._fields)
        sens = None
        if dtype == torch.float64:
            bumped = batch._replace(b=batch.b * (1.0 + 2.0 ** -50))
            rs = ipm_solve_batch_reference(bumped, iters=iters, warm=w, skip=skip, chunk=chunk)
            sens = {f: max_err(getattr(rs, f), getattr(r, f))[1]
                    for f in k._fields if f not in ("converged", "iters_run")}
        torch.cuda.synchronize()
        errs = {f: max_err(getattr(k, f), getattr(r, f))
                for f in k._fields if f not in ("converged", "iters_run")}
        d_it = int((k.iters_run - r.iters_run).abs().max())
        conv_eq = bool(torch.equal(k.converged, r.converged))
        if dtype == torch.float64:
            ok = (d_it == 0 and conv_eq and errs["bound"][1] <= TOL_IPM_F64
                  and all(e[1] <= max(TOL_IPM_F64, TOL_IPM_MOE_SENS * sens[f])
                          for f, e in errs.items()))
        else:
            ok = errs["bound"][1] <= TOL_IPM_F32_CERT
        ok = ok and alone_equal
        line = {"instance": FLAGSHIP[0], "A": list(batch.A.shape), "route": route,
                "dtype": str(dtype).split(".")[-1], "iters": iters, "chunk": chunk,
                "iters_run": k.iters_run.tolist(), "d_iters": d_it,
                "converged_equal": conv_eq, "batch_equals_each_element_alone": alone_equal,
                "max_abs": {f: e[0] for f, e in errs.items()},
                "max_rel": {f: e[1] for f, e in errs.items()},
                "plain_max_rel_under_4ulp_b": sens, "ok": ok}
        print("ipm per-node A vs plain", json.dumps(line), flush=True)
        rows.append(line)
        if not ok:
            bad.append((B, line["dtype"]))
    if bad:
        fail(f"ipm kernel with a per-node A disagrees with its plain version in (B, dtype) {bad}")
    # Time: a MoE beam round (B=16 nodes, float32, 13 warm-budget steps).
    batch, warm, skip = moe_ipm_batch(data, host, 16, torch.float32, np.random.default_rng(78))
    _, m, n = batch.A.shape
    run_k = lambda: ipm_solve_batch(batch, iters=13, warm=warm, chunk=4)  # noqa: E731
    res = run_k()
    flops, nbytes = ipm_flops_bytes(m, n, 16, int(res.iters_run.sum()), 4, warm=True)
    nbytes += 15 * m * n * 4  # 16 matrices, not one shared
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_F32_S)
    ms, call, src = time_kernel(run_k, "ipm_kernel")
    plain = cuda_ms(lambda: ipm_solve_batch_reference(batch, iters=13, warm=warm, chunk=4),
                    reps=3, warmup=1)
    report["ipm"]["per_node_A"] = dict(
        shapes=f"B=16 m={m} n={n} float32, 13 steps", ms=ms, call_ms=call, ms_source=src,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        steps_timed=int(res.iters_run.sum()),
        max_abs_err_bound=max(r["max_abs"]["bound"] for r in rows),
    )
    print(f"ipm per-node A: {ms:.4f} ms on the card, {call:.4f} ms per call (plain "
          f"{plain:.3f} ms, bound {b_ms:.5f} ms by {b_by}) at B=16 m={m} n={n}", flush=True)


def round_moe_bytes_flops(B: int, M: int, moves: int, y_steps: int, cand_per_step: int):
    """Least work of one MoE rounding launch: every candidate priced once per
    step over M devices (~30 float64 operations each), the redistributions'
    O(M^2); bytes: the rows' LP points (float32 here), W and k, the packed
    data, the outputs."""
    flops = B * (moves * 5 * M * M + y_steps * cand_per_step) * M * 30 + B * 2 * (M + 4) * 3 * M
    nbytes = B * 3 * M * 4 + 2 * B * 8 + 17 * M * 8 + B * (1 + 3 * M) * 8
    return flops, nbytes


def check_round_moe(report: dict) -> None:
    """K2's MoE mode on the flagship, in its three modes."""
    import numpy as np
    import torch

    from distilp_torch.ops.decomp import decomp_bound_roots
    from distilp_torch.ops.ipm import ipm_solve_batch
    from distilp_torch.solver.rounding import round_moe_reference, round_to_incumbent
    from distilp_torch.solver.standard_form import MOE_LOCAL_MOVES, MOE_LOCAL_MOVES_WARM

    *_, data, (p32, p64), host = moe_instance(FLAGSHIP)
    M, E = data.rd.a.shape[0], p64.e_max
    # 16 LP points of a beam round.
    batch, _, _ = moe_ipm_batch(data, host, 16, torch.float32, np.random.default_rng(5))
    v_lp = ipm_solve_batch(batch, iters=13, chunk=4).v
    kidx = torch.as_tensor(np.random.default_rng(6).integers(0, data.ks.shape[0], 16),
                           device="cuda")
    # The Lagrangian-primal hint rows at the ascent's multipliers.
    _, w_s, n_s, y_s, _, _ = decomp_bound_roots(p32, p64, data.rd, 300)
    n_k, nf = w_s.shape[0], v_lp.shape[1]
    v_hint = torch.zeros((n_k, nf), dtype=torch.float64, device="cuda")
    v_hint[:, :M], v_hint[:, M:2 * M], v_hint[:, 2 * M:3 * M] = w_s, n_s, y_s
    # One warm row: the first hint row repaired, as a previous optimum.
    fix = round_moe_reference(v_hint[:1], data.Ws[:1], data.ks[:1], data.rd, y_steps=E + 4)
    v_warm = torch.zeros((1, nf), dtype=torch.float64, device="cuda")
    v_warm[0, :M], v_warm[0, M:2 * M], v_warm[0, 2 * M:3 * M] = fix[1][0], fix[2][0], fix[3][0]
    modes = {
        "lp_rows_moves8": (v_lp, data.Ws[kidx], data.ks[kidx], dict(moves=MOE_LOCAL_MOVES)),
        "hint_rows_repair": (v_hint, data.Ws, data.ks, dict(y_steps=E + 4)),
        "warm_row_moves2": (v_warm, data.Ws[:1], data.ks[:1], dict(moves=MOE_LOCAL_MOVES_WARM)),
    }
    bad = []
    for name, (v, W, k, kw) in modes.items():
        got = round_to_incumbent(v, W, k, data.rd, data.rd_packed, moe=True, **kw)
        ref = round_moe_reference(v, W, k, data.rd, **kw)
        torch.cuda.synchronize()
        eq = {f: bool(torch.equal(a, b)) for f, a, b in zip(("w", "n", "y"), got[1:], ref[1:])}
        oa, orel = max_err(got[0], ref[0])
        line = {"mode": name, "rows": int(v.shape[0]), **{f"{f}_equal": e for f, e in eq.items()},
                "obj_max_abs": oa, "obj_max_rel": orel,
                "finite_rows": int(torch.isfinite(ref[0]).sum()),
                "sum_y": ref[3].sum(1).tolist()}
        print("round_moe vs plain", json.dumps(line), flush=True)
        if not (all(eq.values()) and orel <= TOL_EXACT_F64):
            bad.append(name)
        report.setdefault("_round_moe_err", []).append(oa)
    if bad:
        fail(f"round_moe kernel disagrees with its plain version in {bad}")
    if not bool(torch.isfinite(ref[0]).all()):
        fail("the warm row did not price finite")
    v, W, k, kw = modes["lp_rows_moves8"]
    run_k = lambda: round_to_incumbent(v, W, k, data.rd, data.rd_packed, moe=True, **kw)  # noqa: E731
    ms, call, src = time_kernel(run_k, "round_moe_kernel")
    plain = cuda_ms(lambda: round_moe_reference(v, W, k, data.rd, **kw), reps=3, warmup=1)
    flops, nbytes = round_moe_bytes_flops(16, M, MOE_LOCAL_MOVES, 0, 0)
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_F64_S)
    vh, Wh, kh, kwh = modes["hint_rows_repair"]
    hint_ms = cuda_ms(lambda: round_to_incumbent(vh, Wh, kh, data.rd, data.rd_packed,
                                                 moe=True, **kwh), reps=5, warmup=1)
    report["round_moe"] = dict(
        name="round_moe", route="cuda",
        source="distilp_torch/kernels/csrc/round_moe_kernel.cu",
        replaces="distilp_tpu/solver/backend_jax.py:721",
        max_abs_err=max(report.pop("_round_moe_err")), ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, held_against_plain="ok",
        call_ms=call, ms_source=src,
        shapes_timed=f"{FLAGSHIP[0]}: 16 LP rows, M={M}, E={E}, 8 move steps",
        hint_rows_ms=hint_ms,
    )
    print(f"round_moe: {ms:.4f} ms on the card, {call:.4f} ms per call (plain {plain:.3f} ms, "
          f"bound {b_ms:.6f} ms by {b_by}) at B=16 M={M} moves=8; hint rows "
          f"(y_steps={E + 4}) {hint_ms:.4f} ms per call", flush=True)


def decomp_flops_bytes(p, n_evals: int = 1):
    """Least work of ``n_evals`` float32 evaluations: ~60 operations per
    cell (the five n candidates and the cell's slacks, costs and term) over
    5 n_k M w_max (e_max + 1) cells; bytes: the packed per-device vectors,
    the multipliers, and four (n_k, M) outputs."""
    n_k, M = p.ks.shape[0], p.rdv.shape[1]
    cells = 5 * n_k * M * p.w_max * (p.e_max + 1)
    isz = p.rdv.element_size()
    nbytes = (15 * M + 2 * n_k + n_k * (M + 2) + 4 * n_k * M) * isz
    return n_evals * cells * 60, n_evals * nbytes, cells


def check_decomp(report: dict) -> None:
    """K7 on Qwen3-30B-A3B (16 devices) and the flagship."""
    import numpy as np
    import torch

    from distilp_torch.ops import decomp as D
    from distilp_torch.solver.backend_cpu import Infeasible, solve_fixed_k_cpu

    rng = np.random.default_rng(11)
    bad, timing, abs_errs = [], {}, []
    for case in (MOE_CASES[2], FLAGSHIP):
        _, _, _, arrays, feasible, sf, _, data, (p32, p64), _ = moe_instance(case)
        n_k, M = p32.ks.shape[0], p32.rdv.shape[1]
        # (a) float32 bound and its gradient statistics at random multipliers.
        for trial in range(3):
            lam = torch.tensor(rng.normal(0, 1, n_k), dtype=torch.float32, device="cuda")
            mu = torch.tensor(rng.normal(0, 0.3, n_k), dtype=torch.float32, device="cuda")
            tau = torch.tensor(rng.normal(0, 1, (n_k, M)), dtype=torch.float32, device="cuda")
            theta = (p32.ks - 1.0)[:, None] * D.softmax(tau)
            got = D.eval32_kernel(p32, lam, mu, theta)
            ref = D.eval32_reference(p32, lam, mu, theta)
            torch.cuda.synchronize()
            errs = [max_err(a, b) for a, b in zip(got, ref)]
            abs_errs.append(errs[0][0])
            b_rel = max_err(got[0].double().sum(1), ref[0].double().sum(1))[1]
            line = {"instance": case[0], "trial": trial, "n_k": n_k, "M": M,
                    "min_max_rel": errs[0][1], "bound_max_rel": b_rel,
                    "w_bar_max_abs": errs[1][0], "y_bar_max_abs": errs[2][0],
                    "cyc_bar_max_rel": errs[3][1]}
            ok = (errs[0][1] <= TOL_DECOMP_F32 and b_rel <= TOL_DECOMP_F32
                  and all(e[1] <= TOL_DECOMP_F32 for e in errs[1:]))
            line["ok"] = ok
            print("decomp f32 vs plain", json.dumps(line), flush=True)
            if not ok:
                bad.append((case[0], "f32", trial))
        # (b) float64 evaluation at the multipliers the port's ascent chose.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lam, mu, tau = (x.double() for x in D.ascend(p32, 300))
        torch.cuda.synchronize()
        ascent_ms = (time.perf_counter() - t0) * 1e3
        theta = (p64.ks - 1.0)[:, None] * D.softmax(tau)
        got = D.eval64_kernel(p64, lam, mu, theta, True)
        ref = D.eval64_reference(p64, lam, mu, theta, True)
        bound_k = D.bound_of(p64, got[0], got[1], lam, mu)
        bound_r = D.bound_of(p64, ref[0], ref[1], lam, mu)
        torch.cuda.synchronize()
        my_rel = max_err(got[0], ref[0])[1]
        b_rel = max_err(bound_k, bound_r)[1]
        hint_eq = all(bool(torch.equal(a, b)) for a, b in zip(got[1:], ref[1:]))
        oracle = []
        for k, W in feasible:
            try:
                oracle.append(solve_fixed_k_cpu(arrays, k, W, mip_gap=1e-9).obj_value)
            except Infeasible:
                oracle.append(float("inf"))
        full = (bound_k + sf.obj_const).tolist()
        sound = all(b <= o + 1e-9 * max(1.0, abs(o)) for b, o in zip(full, oracle))
        line = {"instance": case[0], "ascent_steps": 300, "ascent_host_ms": ascent_ms,
                "bound_plus_obj_const": full, "highs_per_k_optimum": oracle,
                "m_y_max_rel": my_rel, "bound_max_rel": b_rel, "hint_equal": hint_eq,
                "sound": sound}
        ok = my_rel <= TOL_EXACT_F64 and b_rel <= TOL_EXACT_F64 and hint_eq and sound
        line["ok"] = ok
        print("decomp f64 vs plain", json.dumps(line), flush=True)
        if not ok:
            bad.append((case[0], "f64"))
        # Time one float32 evaluation at the ascent's shapes.
        lam32, mu32, tau32 = (x.float() for x in (lam, mu, tau))
        th32 = (p32.ks - 1.0)[:, None] * D.softmax(tau32)
        run_k = lambda: D.eval32_kernel(p32, lam32, mu32, th32)  # noqa: E731
        ms, call, src = time_kernel(run_k, "decomp_f32_kernel")
        plain = cuda_ms(lambda: D.eval32_reference(p32, lam32, mu32, th32), reps=3, warmup=1)
        ms64 = cuda_ms(lambda: D.eval64_kernel(p64, lam, mu, theta, True), reps=5, warmup=1)
        flops, nbytes, cells = decomp_flops_bytes(p32)
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_F32_S)
        timing[case[0]] = dict(ms=ms, call_ms=call, ms_source=src, plain_ms=plain,
                               bound_ms=b_ms, bound_by=b_by, cells=cells,
                               f64_eval_ms=ms64, ascent_host_ms=ascent_ms)
        print(f"decomp {case[0]}: f32 evaluation {ms:.4f} ms on the card, {call:.4f} ms per "
              f"call (plain {plain:.3f} ms, bound {b_ms:.5f} ms by {b_by}, {cells} cells); "
              f"f64 evaluation {ms64:.4f} ms; 300-step ascent {ascent_ms:.1f} ms of wall",
              flush=True)
    if bad:
        fail(f"decomp kernel disagrees with its plain version or is unsound in {bad}")
    t = timing[FLAGSHIP[0]]
    report["decomp"] = dict(
        name="decomp", route="cuda", source="distilp_torch/kernels/csrc/decomp_kernel.cu",
        replaces="distilp_tpu/solver/backend_jax.py:832",
        max_abs_err=max(abs_errs), ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None, held_against_plain="ok",
        call_ms=t["call_ms"], ms_source=t["ms_source"],
        shapes_timed=f"{FLAGSHIP[0]}: one float32 evaluation, {t['cells']} cells",
        by_instance=timing,
    )


# ---------------------------------------------------------------- phase 4


def solve(devs, model, gap, **kw):
    """One timed ``halda_solve`` on the card: (result, wall ms, timings)."""
    import torch

    from distilp_torch.solver import halda_solve

    tm = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = halda_solve(devs, model, mip_gap=gap, kv_bits="4bit", timings=tm, **kw)
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t) * 1e3, tm


def show(name, r, ms, tm):
    print(f"solve {name}: k={r.k} obj={r.obj_value!r} certified={r.certified} "
          f"gap={r.gap} wall_ms={ms:.2f} engine={tm.get('lp_backend')} "
          f"rounds={tm.get('bnb_rounds')} lp_iters={tm.get('ipm_iters_executed')} "
          f"escalated={tm.get('escalated', 0)} host_build_ms={tm.get('build_ms', 0.0):.2f} "
          f"build_sf_ms={tm.get('build_sf_ms', 0.0):.2f} "
          f"upload_ms={tm.get('upload_ms', 0.0):.2f} "
          f"search_ms={tm.get('solve_ms', 0.0):.2f}", flush=True)


DENSE_KERNELS = ("ipm", "round_incumbent", "bnb_epilogue")
MOE_KERNELS = ("ipm", "round_moe", "bnb_epilogue", "decomp")


def main_path() -> dict:
    """The dense slice's main path (IPM engine, M <= 32)."""
    import torch

    from distilp_torch import kernels
    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.solver import halda_solve
    from distilp_torch.utils import make_synthetic_fleet

    kernels.reset_launch_counts()
    for folder, k_star, obj in GOLDEN:
        devs, model = load_from_profile_folder(ROOT / "tests" / "profiles" / folder)
        r, ms, tm = solve(devs, model, 1e-4)
        show(folder, r, ms, tm)
        if r.k != k_star or abs(r.obj_value - obj) > 2e-4 * abs(obj):
            fail(f"{folder}: got k={r.k} obj={r.obj_value}, pinned k={k_star} obj={obj}")
    model = online_model()
    devs = make_synthetic_fleet(16, seed=123)
    r, ms, tm = solve(devs, model, 1e-3)
    show("north_star_M16", r, ms, tm)
    if not r.certified or abs(r.obj_value - NORTH_STAR_OBJ) > 2e-3 * abs(NORTH_STAR_OBJ):
        fail(f"north star: obj={r.obj_value} certified={r.certified}")
    if sum(r.w) * r.k != model.L or not all(0 <= n <= w for w, n in zip(r.w, r.n)):
        fail("north star: assignment does not place every layer")
    # Warm re-solve: the incumbent re-priced by the rounding kernel and the
    # root round warm-started from the carried root iterates.
    tm = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    r2 = halda_solve(devs, model, mip_gap=1e-3, kv_bits="4bit", warm=r, timings=tm)
    torch.cuda.synchronize()
    show("north_star_M16_warm", r2, (time.perf_counter() - t) * 1e3, tm)
    if not r2.certified or abs(r2.obj_value - r.obj_value) > 1e-9 * abs(r.obj_value):
        fail(f"warm north star: obj={r2.obj_value} vs cold {r.obj_value}")
    devs = make_synthetic_fleet(32, seed=32)
    r, ms, tm = solve(devs, model, 1e-3)
    show("synthetic_M32", r, ms, tm)
    launches = dict(kernels.LAUNCHES)
    t = time.perf_counter()
    ref = halda_solve(devs, model, mip_gap=1e-3, kv_bits="4bit", backend="cpu")
    print(f"highs oracle M32: k={ref.k} obj={ref.obj_value:.6f} "
          f"wall_ms={(time.perf_counter() - t) * 1e3:.1f}", flush=True)
    if not r.certified or abs(r.obj_value - ref.obj_value) > 2e-3 * abs(ref.obj_value):
        fail(f"M=32: obj={r.obj_value} vs oracle {ref.obj_value}")
    print("dense path launches", json.dumps(launches), flush=True)
    missing = [k for k in DENSE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"dense main path never launched {missing}")
    profile_solve(make_synthetic_fleet(16, seed=123), model, 1e-3, "north_star_M16")
    return launches


def fleet_path() -> dict:
    """The fleet-scale main path: the PDHG engine through ``halda_solve``."""
    from distilp_torch import kernels
    from distilp_torch.utils import make_synthetic_fleet

    def check(name, r, tm, pin, gap, engine, model):
        k_pin, obj_pin = pin
        rel = abs(r.obj_value - obj_pin) / abs(obj_pin)
        print(f"  {name}: objective {r.obj_value!r} vs pinned {obj_pin!r}: "
              f"relative difference {rel!r} (allowed {gap!r})", flush=True)
        if tm.get("lp_backend") != engine or r.k != k_pin or not r.certified or rel > gap:
            fail(f"{name}: engine={tm.get('lp_backend')} k={r.k} "
                 f"certified={r.certified} obj={r.obj_value}; expected engine "
                 f"{engine}, k={k_pin}, obj {obj_pin} within {gap} relative")
        if sum(r.w) * r.k != model.L or not all(0 <= n <= w for w, n in zip(r.w, r.n)):
            fail(f"{name}: assignment does not place every layer")

    kernels.reset_launch_counts()
    model128, devs128 = online_model(128), make_synthetic_fleet(128, seed=123)
    r, ms, tm = solve(devs128, model128, FLEET128_GAP)
    show("fleet_M128", r, ms, tm)
    check("fleet_M128", r, tm, FLEET128_PDHG, 2 * FLEET128_GAP, "pdhg", model128)
    # Cross-engine: the same instance on the IPM (K1 at m=769).
    ri, ms, tm = solve(devs128, model128, FLEET128_GAP, lp_backend="ipm")
    show("fleet_M128_ipm", ri, ms, tm)
    check("fleet_M128_ipm", ri, tm, FLEET128_IPM, 2 * FLEET128_GAP, "ipm", model128)
    if abs(ri.obj_value - r.obj_value) > 2 * FLEET128_GAP * abs(r.obj_value):
        fail(f"M=128: IPM engine {ri.obj_value} vs PDHG engine {r.obj_value}")
    # Float64 iterates on the main path (the f64 kernel instance).
    r64, ms, tm = solve(devs128, model128, FLEET128_GAP, pdhg_dtype="f64")
    show("fleet_M128_f64", r64, ms, tm)
    check("fleet_M128_f64", r64, tm, FLEET128_PDHG, 2 * FLEET128_GAP, "pdhg", model128)
    rn, ms, tm = solve(make_synthetic_fleet(16, seed=123), online_model(), 1e-3,
                       lp_backend="pdhg")
    show("north_star_M16_pdhg", rn, ms, tm)
    if tm.get("lp_backend") != "pdhg" or not rn.certified or \
            abs(rn.obj_value - NORTH_STAR_OBJ) > 2e-3 * abs(NORTH_STAR_OBJ):
        fail(f"north star on the PDHG engine: obj={rn.obj_value} certified={rn.certified}")
    model512, devs512 = online_model(512), make_synthetic_fleet(512, seed=123)
    r5, ms, tm = solve(devs512, model512, FLEET512_GAP)
    show("fleet_M512", r5, ms, tm)
    check("fleet_M512", r5, tm, FLEET512_PDHG, 2 * FLEET512_GAP, "pdhg", model512)
    launches = dict(kernels.LAUNCHES)
    print("fleet path launches", json.dumps(launches), flush=True)
    missing = [k for k in ("ipm", "round_incumbent", "bnb_epilogue", "pdhg") if launches[k] == 0]
    if missing:
        fail(f"fleet-scale main path never launched {missing}")
    profile_solve(devs128, model128, FLEET128_GAP, "fleet_M128_pdhg")
    profile_solve(devs512, model512, FLEET512_GAP, "fleet_M512_pdhg", reps=1)
    return launches


def moe_path() -> dict:
    """MoE co-assignment through ``halda_solve`` (IPM engine, K7 bounds)."""
    import numpy as np
    import torch

    from distilp_torch import kernels
    from distilp_torch.solver import halda_solve
    from distilp_torch.utils import make_synthetic_fleet

    def moe_solve(devs, model, **kw):
        tm = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = halda_solve(devs, model, mip_gap=MOE_GAP, kv_bits="8bit", timings=tm, **kw)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3, tm

    def check(name, r, tm, model, pin=None):
        print(f"  {name}: decomp_steps={tm.get('decomp_steps')} "
              f"decomp_enqueue_ms={tm.get('decomp_enqueue_ms', 0.0):.2f} y={r.y}", flush=True)
        if not r.certified or r.y is None or sum(r.y) != model.n_routed_experts:
            fail(f"{name}: certified={r.certified} y={r.y}")
        if sum(r.w) * r.k != model.L or not all(0 <= n <= w for w, n in zip(r.w, r.n)):
            fail(f"{name}: assignment does not place every layer")
        if pin is not None:
            rel = abs(r.obj_value - pin[1]) / abs(pin[1])
            print(f"  {name}: objective {r.obj_value!r} vs pinned {pin[1]!r}: relative "
                  f"difference {rel!r} (allowed {2 * MOE_GAP!r})", flush=True)
            if rel > 2 * MOE_GAP:
                fail(f"{name}: obj {r.obj_value} vs pinned {pin[1]}")

    kernels.reset_launch_counts()
    results = {}
    for case in MOE_CASES:
        name, config, M, seed, pool, pin = case
        model = moe_model(config)
        devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool))
        r, ms, tm = moe_solve(devs, model)
        show(name, r, ms, tm)
        check(name, r, tm, model, pin)
        results[name] = (devs, model, r)
    devs, model, cold = results[FLAGSHIP[0]]
    t = time.perf_counter()
    ref = halda_solve(devs, model, mip_gap=MOE_GAP, kv_bits="8bit", backend="cpu")
    print(f"highs oracle {FLAGSHIP[0]}: k={ref.k} obj={ref.obj_value!r} "
          f"wall_ms={(time.perf_counter() - t) * 1e3:.1f}", flush=True)
    if abs(cold.obj_value - ref.obj_value) > 2 * MOE_GAP * abs(ref.obj_value):
        fail(f"{FLAGSHIP[0]}: obj {cold.obj_value} vs oracle {ref.obj_value}")
    # Warm re-solve after +-5% t_comm drift: the stored duals make it
    # re-evaluate the bound (zero ascent steps).
    drifted = [d.model_copy() for d in devs]
    rng = np.random.default_rng(3)
    for d in drifted:
        d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.95, 1.05)))
    rw, ms, tm = moe_solve(drifted, model, warm=cold)
    show(f"{FLAGSHIP[0]}_warm", rw, ms, tm)
    check(f"{FLAGSHIP[0]}_warm", rw, tm, model)
    if tm.get("decomp_steps") != 0 or cold.duals is None or rw.duals is None:
        fail(f"warm flagship did not re-evaluate at the stored duals: "
             f"decomp_steps={tm.get('decomp_steps')}")
    launches = dict(kernels.LAUNCHES)
    print("moe path launches", json.dumps(launches), flush=True)
    missing = [k for k in MOE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"MoE main path never launched {missing}")
    profile_solve(devs, model, MOE_GAP, f"{FLAGSHIP[0]}_cold", kv_bits="8bit")
    profile_solve(drifted, model, MOE_GAP, f"{FLAGSHIP[0]}_warm", kv_bits="8bit", warm=cold)
    return launches


def profile_solve(devs, model, gap, name, reps: int = 5, kv_bits: str = "4bit",
                  **kw) -> None:
    """Where the device time of one solve goes: device time by kernel from
    a profiled solve, and the device's busy share against the same solve's
    unprofiled wall time (median of ``reps``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distilp_torch.solver import halda_solve

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        halda_solve(devs, model, mip_gap=gap, kv_bits=kv_bits, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = sorted(walls)[reps // 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        halda_solve(devs, model, mip_gap=gap, kv_bits=kv_bits, **kw)
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, _device_us(e), e.count) for e in prof.key_averages()
         if _is_device(e) and _device_us(e) > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in rows) / 1e3
    print("profile", json.dumps({
        "solve": name, f"wall_ms_median_of_{reps}": wall, "walls_ms": walls,
        "device_busy_ms": busy_ms if rows else None,
        "device_busy_share": busy_ms / wall if rows else None,
        "device_ops": len(rows),
        "top": [{"name": k[:80], "device_ms": us / 1e3, "count": c}
                for k, us, c in rows[:10]],
    }), flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    try:
        from distilp_torch.kernels import build
    except ImportError as e:
        fail(f"distilp_torch is not importable next to this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"gpu: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t = time.perf_counter()
    build.load_all()
    print(f"kernels built in {time.perf_counter() - t:.1f} s "
          f"(nvcc {build.BUILD_STATS.get('build_s', 0.0):.1f} s)", flush=True)
    print(build.ptxas_report(), flush=True)

    from distilp_torch import kernels

    report: dict = {}
    checks = [check_ipm, check_round, check_epilogue, check_pdhg,
              lambda r: check_pdhg_mp(), check_ipm_moe, check_round_moe, check_decomp]
    names = ["ipm", "round", "epilogue", "pdhg", "pdhg_mp", "ipm_moe", "round_moe",
             "decomp"]
    for name, check in zip(names, checks):
        kernels.reset_launch_counts()
        t = time.perf_counter()
        check(report)
        print(f"check {name}: {time.perf_counter() - t:.1f} s, launches "
              f"{json.dumps({k: v for k, v in kernels.LAUNCHES.items() if v})}", flush=True)

    paths = {"dense": main_path(), "fleet": fleet_path(), "moe": moe_path()}
    launches = {k: sum(p[k] for p in paths.values()) for k in report}
    print("main path launches", json.dumps(launches), flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"main path never launched {missing}")
    out = []
    for name in ("ipm", "round_incumbent", "round_moe", "bnb_epilogue", "pdhg", "decomp"):
        row = dict(report[name])
        row["launches"] = launches[name]
        row["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        out.append(row)
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
