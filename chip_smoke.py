#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the HALDA solver on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the three kernels from ``distilp_torch/kernels/csrc`` (timed);
  3. each kernel against its plain PyTorch version on the card, at the shapes
     of the 16-device north-star instance (and the IPM also at M=32), with
     the tolerances stated below, and each kernel's median time (CUDA events)
     beside its plain version's and its least possible time on an H100;
  4. the main path: ``distilp_torch.solver.halda_solve`` on the four golden
     fixtures (pinned k and objective), the north star (pinned objective) and
     a 32-device fleet (against the port's HiGHS oracle), with the kernel
     launch counts of that run;
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
    """Device time per call (ms) of the kernels whose name contains
    ``kernel``, from torch.profiler's CUPTI trace; None when the profiler
    recorded no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages()
             if _is_device(e) and kernel in e.key)
    return us / reps / 1e3 if us > 0 else None


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


def load_instance(M: int, seed: int):
    from distilp_torch.common import load_model_profile
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.backend_torch import device_arrays
    from distilp_torch.solver.standard_form import build_standard_form
    from distilp_torch.utils import make_synthetic_fleet

    model = load_model_profile(
        ROOT / "tests" / "profiles" / "llama_3_70b" / "online" / "model_profile.json"
    )
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

    from distilp_torch.ops.ipm import ipm_solve_batch, ipm_solve_batch_reference

    rng = np.random.default_rng(1234)
    rows = []
    for M, seed in ((16, 123), (32, 32)):
        for dtype, iters, chunk in (
            (torch.float32, 8, 8),  # cold root round of the default budget
            (torch.float32, 6, 4),  # warm round
            (torch.float32, 26, 4),  # escalated budget
            (torch.float64, 26, 4),
        ):
            batch, warm, skip = ipm_batch(M, seed, 16, dtype, rng)
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
                "M": M, "dtype": str(dtype).split(".")[-1], "iters": iters,
                "chunk": chunk, "iters_run": k.iters_run.tolist(),
                "d_iters": d_it, "converged_equal": conv_eq,
                "max_abs": {f: e[0] for f, e in errs.items()},
                "max_rel": {f: e[1] for f, e in errs.items()}, "ok": ok,
            }
            print("ipm vs plain", json.dumps(line), flush=True)
            rows.append(line)
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


# ---------------------------------------------------------------- phase 4


def main_path() -> dict:
    import torch

    from distilp_torch import kernels
    from distilp_torch.common import load_from_profile_folder, load_model_profile
    from distilp_torch.solver import halda_solve
    from distilp_torch.utils import make_synthetic_fleet

    def solve(devs, model, gap):
        tm = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = halda_solve(devs, model, mip_gap=gap, kv_bits="4bit", timings=tm)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3, tm

    def show(name, r, ms, tm):
        print(f"solve {name}: k={r.k} obj={r.obj_value:.6f} certified={r.certified} "
              f"gap={r.gap} wall_ms={ms:.2f} rounds={tm.get('bnb_rounds')} "
              f"ipm_iters={tm.get('ipm_iters_executed')} "
              f"escalated={tm.get('escalated', 0)}", flush=True)

    kernels.reset_launch_counts()
    for folder, k_star, obj in GOLDEN:
        devs, model = load_from_profile_folder(ROOT / "tests" / "profiles" / folder)
        r, ms, tm = solve(devs, model, 1e-4)
        show(folder, r, ms, tm)
        if r.k != k_star or abs(r.obj_value - obj) > 2e-4 * abs(obj):
            fail(f"{folder}: got k={r.k} obj={r.obj_value}, pinned k={k_star} obj={obj}")
    model = load_model_profile(
        ROOT / "tests" / "profiles" / "llama_3_70b" / "online" / "model_profile.json"
    )
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
    print("main path launches", json.dumps(launches), flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"main path never launched {missing}")
    profile_solve(make_synthetic_fleet(16, seed=123), model, 1e-3, "north_star_M16")
    return launches


def profile_solve(devs, model, gap, name) -> None:
    """Where the device time of one solve goes: device time by kernel from
    a profiled solve, and the device's busy share against the same solve's
    unprofiled wall time (median of 5)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distilp_torch.solver import halda_solve

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        halda_solve(devs, model, mip_gap=gap, kv_bits="4bit")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = sorted(walls)[2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        halda_solve(devs, model, mip_gap=gap, kv_bits="4bit")
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, _device_us(e), e.count) for e in prof.key_averages()
         if _is_device(e) and _device_us(e) > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in rows) / 1e3
    print("profile", json.dumps({
        "solve": name, "wall_ms_median_of_5": wall, "walls_ms": walls,
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

    report: dict = {}
    check_ipm(report)
    check_round(report)
    check_epilogue(report)

    launches = main_path()
    out = []
    for name in ("ipm", "round_incumbent", "bnb_epilogue"):
        row = dict(report[name])
        row["launches"] = launches[name]
        out.append(row)
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
