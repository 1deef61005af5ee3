#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the HALDA solver on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the twelve kernel libraries from ``distilp_torch/kernels/csrc``,
     one nvcc each, all started together (timed);
  3. each kernel against its plain PyTorch version on the card, at the shapes
     of the 16-device north-star instance (the IPM also at M=32, at M=128
     where its factor leaves shared memory and at M=192 where its vectors do
     too, each route timed, and on a batch whose theta is non-finite; the
     library's routes at their edges; the PDHG at the root batches of
     the 128- and 512-device fleets, cold and warm, in float64 and float32,
     with every bound checked against the HiGHS LP optimum; the mixed-
     precision entry's float64 fallback), and at the MoE shapes: the IPM
     with a per-node A on the DeepSeek-V3 flagship's root and beam batches,
     the MoE rounding in its three modes, and the decomposition bound (K7)
     in float32 (bound and gradient) and float64 (bound, y-profile, hint)
     on Qwen3-30B-A3B and the flagship, and its fused ascent (one launch
     for all steps) against the host loop over the per-step entry at 3
     steps, at 300 steps cold and warm-started from the stored duals (each
     bound sound against HiGHS per k) and at 0 steps, with lanes too; the twin's Monte-Carlo kernel (K8)
     on the north star's, the flagship's and the 512-device fleet's
     placements and on a vector set edited so that violations occur (equal
     flags, latencies within 1e-12, two launches bit-identical, the base
     row equal to ``simulate_placement``); the profiler's HBM roll (K9a,
     equal to ``torch.roll`` after 1 and 7 passes) and its GEMM-chain step
     (K9b: the product against ``torch.matmul`` in float32, float16 and
     bfloat16 at the chain's shapes and, in float32, at the edges of its
     persistent TMA-fed design, the scale bit for bit; the step beside
     ``torch.matmul`` in turns at the batches b_1, b_2, b_4, the SM clock
     sampled through the float32 window, the float32 product's ptxas line
     and the FFMA share of its main loop's SASS); the branch-and-
     bound epilogue's per-k entries (B15: on every call of per-k solves of
     hermes_70b, the north star, Mixtral M=4 and a forced small capacity that
     spills, and on 300 random frontiers, bit for bit) and the fixed-
     assignment pricer (B14: Mixtral M=4 and the flagship, the solver's
     assignment and edits breaking each validity test); the per-instance
     entries that search several sweeps as lanes (B12): K2 over the rows of
     8 north-star scenarios and a 12-device fleet padded to 16, K2's MoE
     mode on every call of the stream path's Mixtral batch over 4 load
     regimes (LP rows with move steps, hint rows repaired from the lockstep
     ascent) and over two flagship instances (LP and hint rows), K3 over the
     root round of the 8 scenarios, K3's per-k entries on every call of the
     stream path's per-k lanes and over 200 random frontiers of 2-8 lanes,
     K7 over 4 Mixtral load regimes and 2 flagship instances, each against
     its plain version and, bit for bit, against one single-instance launch
     per instance; the convergence traces (B13) of K1 on each route and of
     K5 on both entries: traced results bit for bit equal to untraced ones,
     the trace against the plain version's (float64); the mesh's collectives
     (psum and pmax over 4 shards of a virtual mesh of this card, bit for bit
     against their plain versions on every shard, a NaN part included) and
     the row-sharded PDHG (K6b) on the 128-device fleet's root LPs at 2 and 4
     shards in float64 and float32, against the unsharded K5 at equal step
     counts and its own plain version, every shard's copy of the result bit
     for bit equal; the round tail (R8, one launch for all of a round
     after its LP call) on every round tail of the north star's solve, of
     the S=8 scenario batch (and again with lane 3 frozen), of the
     flagship's first two MoE rounds, of the 128-device fleet on the PDHG
     engine and of the north star on K10's 8 virtual shards, and in per-k
     mode of hermes_70b, the north star and Mixtral M=4 per k, the per-k
     lanes (and again with lane 1 frozen), the north star per k on K10's
     shards, hermes_70b per k at a capacity that spills, and 24 per-k tails
     stretched up to 8 lanes of 1142 keys, against its plain version (K2,
     K3 and B15 inside it) in every field of the new state and the go
     flags, timed beside the sequence it replaced, with the launches of a
     north-star warm round and of per-k rounds fused and as before; the
     branch-and-bound loop's kernels (``bnb_loop_kernel.cu``: the seed, the
     round head, the loop's control and the answer) on the north star cold
     and warm and on the S=8 scenarios with lane 3 frozen, bit for bit
     against their plain versions, and their MoE modes (the seed with K7,
     its two float64 folds, the MoE seed's phases and K2 MoE's hint and
     warm rows against the host route's seeding; the head's per-node A;
     the answer's duals block) on Mixtral M=4 cold, per-k and over 4 load
     regimes and the flagship cold, warm and on a margin tick, bit for bit,
     and K7's folds within TOL_EXACT_F64, and their PDHG parts (the head's
     PDHG mode on the 128-device fleet warm in float32, a carried y holding
     a NaN, and in float64, and on Mixtral M=4 on the PDHG; the cast of a
     float64 K5 round to the search's float32), bit for bit;
     with the tolerances stated below, and each kernel's time beside its
     plain version's and its least possible time on an H100;
  4. the main path, in eleven runs, each with the launch counts zeroed before
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
     (d) profile -> solve -> evaluate through the port's CLIs: the profiler
     measures this card (every rate printed with its share of the card's
     published peak; over 105% or a zero GEMM/HBM rate fails), the
     2-device fleet of ``tests/profiles/llama_3_70b/4bit`` plus the card is
     solved on the card and by HiGHS (within 2x gap), ``evaluate
     --check-determinism`` must exit 0; then the twin's robustness report
     and risk score at full width on the north star, the flagship and the
     512-device fleet, and rank agreement on the golden fixtures' per-k
     placements (each k solved on the card and by HiGHS, which must agree
     on its feasibility and objective); (e) the sweep variants:
     ``halda_solve_per_k`` on hermes_70b (each k against the HiGHS oracle),
     the north star and Mixtral M=4 (each k certified and pinned),
     ``solve_load_aware`` on Mixtral M=4 with two hot experts and on the
     flagship with lognormal loads (the realized objective pinned), and
     ``halda_solve_async`` on the north star with the next instance built
     while it runs (``collect()`` equal to the synchronous solve); (f) the
     stream: ``StreamingReplanner`` on the north star (a cold tick and 8
     warm ticks under +-5% t_comm drift, pinned; pipelined
     ``submit``/``collect`` ticks equal to the sequential ones), the S=8
     scenario batch warm-seeded from the last tick (pinned, each within 2x
     gap of its own solve; placements/s) and the forced static-half
     fallback, lanes through ``solve_batch`` (the goldens padded to their
     bucket, a mixed-M bucket with ``lane_pad`` duplicates, per-k lanes),
     the DeepSeek-V3 flagship's replanner (cold, margin, warm after its
     memory pools grow, margin; every tick certified with sum(y) = 256,
     one margin bound against a full K7 evaluation) and a Mixtral M=4
     scenario batch under four load regimes (K7's instance axis); tick
     walls and busy shares beside them;
     (g) K5's per-element entry (B11): two 128-device fleets as lanes with
     an A each through ``solve_batch``, the 128-device scenario fallback
     (a future whose first device's CPU table doubles), Mixtral M=4 and
     Qwen3-30B-A3B M=16 with ``lp_backend='pdhg'``, all pinned against the
     JAX package; every per-element K5 call of these solves is then held
     against its plain version (float64 field by field, float32 on the
     bound), an equal-A batch against the shared entry, a structure missing
     a nonzero refused; (h) the convergence telemetry (B13) and the round
     log on the loop graph (R3d): ``halda_solve(convergence=...)`` on the
     north star (IPM), the 128-device fleet (PDHG, float32 and float64, and
     on a virtual row mesh of 4 shards) and Mixtral M=4 (MoE), and
     diagnostics replanners over the north star's warm ticks and Mixtral's
     margin ticks, each answer row equal bit for bit to the host loop's and
     its head to the untraced solve's, one graph launch, one upload, one
     read and no runtime kernel launch a solve (walls of the traced,
     untraced and host-loop solves printed); ``solver diagnose`` with its
     JSONL export and ``--load``; ``serve --solver-diagnostics`` with no
     search off the graph, beside a plain ``serve``; (i) the
     multi-device engine on a virtual mesh of this card: the 128-device fleet
     with ``mesh_shards=4`` (pinned; ``mesh_shards=1`` bit-identical to the
     default), the 512-device fleet and the online golden at 4 shards, the
     north star and Mixtral M=8 through the node-sharded sweep (K10) on 8
     shards (pinned; the north star's placement equal to the unsharded
     sweep's), ``solver --mesh-shards 4`` and ``measure_interconnect`` (K9c)
     over 4 shards (provenance "virtual"); (j) the packed halves and the
     loop as one CUDA graph: every dense IPM case (the goldens, the north
     star cold and warm, per-k hermes_70b and north star, 8 scenarios, two
     lanes with an A each, the async north star, the replanner's 9 ticks)
     and every MoE case on the IPM engine (Mixtral M=4 cold, per-k and
     over 4 load regimes as lanes, Qwen3-30B-A3B M=16, the flagship cold,
     warm and a replanner's cold, margin and margin ticks; each with
     ``route=graph moe_ipm``) on the graph route and again under the host
     loop, answers and final states bit for bit equal, one graph launch,
     one read and on a static hit one upload a solve, one capture a plan
     signature; the upload and search walls of both routes, the graph
     solve's bound, and the walls (MoE: and search times, runtime launches)
     and busy shares of both routes in turns (medians of 9), a MoE round's
     graph kernels; and every PDHG case (the 128-device fleet in float32,
     float64 and under a forced grid route, the 512-device fleet at gap
     0.05, the north star with ``lp_backend='pdhg'`` cold, warm and per k,
     the two 128-device lanes with an A each, the 128-device scenario
     fallback, Mixtral M=4 and Qwen3-30B-A3B M=16 on the PDHG; each with
     ``route=graph dense_pdhg|moe_pdhg``) held the same way, with their
     walls, upload and search times, graph spans, busy shares and runtime
     launches of both routes in turns (medians of 9; M=512 of 3), none on
     the graph route, and a PDHG round's graph kernels; (k) the
     scheduler daemon: the JAX package's Makefile smokes through the port's
     ``serve`` (the chaos soak, 9 faults and 4 quarantines, with and without
     ``--speculate``; the speculation smoke on ``spec_burst.jsonl``, hits and
     no failed or uncertified structural tick; ``--risk-aware``, at least
     one switch), the north star's 40-event mixed replay in process with
     speculation and risk-aware scoring (tick walls by mode, p50 and p99,
     spec hit rate, risk evaluations, graph launches and uploads a tick;
     every structural tick and the last certified within 2x gap of a
     one-shot solve; ``dump_state`` resumed warm in a new scheduler) and
     Mixtral M=4's drift ticks on the margin path;
     a path's comparison solves (its references) are left out of its launch
     counts; K1's and K5's launches of each path are also printed by shape,
     K7's by entry; every root bound (``decomp_bound_roots``) of the paths
     makes at most two K7 launches and none of the per-step entry; no
     path launches K3's entry or B15's (the round tail folds them; the
     per-k solves of the sweep path launch no K2 entry either), every MoE
     solve of the moe, sweep, stream and serve paths takes the graph
     (``route=graph moe_ipm``), no search of the fleet, profile, sweep,
     stream and elem paths keeps the host loop but inside ``captured``
     (the fleet path's PDHG solves take ``route=graph dense_pdhg``), and
     every other kernel is launched at least once;
  5. one ``{"kernels": [...]}`` line, the nvidia-smi line as it prints it,
     and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import statistics
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
PEAK_BF16_S = 989e12

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
# K7's fused ascent against the host loop over the per-step entry (the
# yardstick), on the same card: at 3 steps every field within
# TOL_DECOMP_F32 relative (the two sum over the devices in another order,
# so the multipliers part at the last bit); at 300 steps each (instance, k)'s
# float64 bound within TOL_ASCENT_BOUND relative and sound (at most the
# HiGHS per-k optimum), the hint equal wherever the bounds are; at 0 steps
# (the float64 evaluation alone) bit for bit. Bit-for-bit equality of the
# 300-step runs is reported.
TOL_ASCENT_BOUND = 1e-5
# K1 with a per-node A in float64: its iterate fields within this multiple
# of the plain version's own change under a 4-ulp change of b (see
# check_ipm_moe). Summation order perturbs every step, not b alone, hence
# the wide factor; a wrong per-element index moves fields by O(1) and is
# also caught by the batch-against-each-element-alone equality.
TOL_IPM_MOE_SENS = 100.0
# K9b's product against torch.matmul (TF32 and reduced-precision reductions
# off), as a share of max|y|: in float32 the two sum the K products in
# different orders; the 16-bit types round float32 sums once each, so two
# results sit at most one ulp apart (2^-10 and 2^-7 of max|y|), held to
# twice that. K9b's scale is exact given the product (bit for bit).
TOL_GEMM = {"float32": 1e-5, "float16": 2e-3, "bfloat16": 1.6e-2}


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


@contextlib.contextmanager
def smi_window(period_ms: int = 250):
    """Sample ``nvidia-smi --query-gpu=name,power.limit,clocks.sm,power.draw``
    every ``period_ms`` while the block runs. Yields a dict, filled when the
    block ends: the first sample as printed, the count, and the SM clock
    (MHz) and power draw (W) as min, median and max ({"samples": 0} when
    nvidia-smi gave nothing). Tells a kernel held back by its design from
    one held back by the card's clock."""
    out: dict = {}
    try:
        proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
             "--format=csv,noheader", "-lms", str(period_ms)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        proc = None
    try:
        yield out
    finally:
        text = ""
        if proc is not None:
            proc.terminate()
            try:
                text, _ = proc.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
        rows = [ln.split(", ") for ln in text.splitlines() if ln.count(", ") == 3]

        def spread(col: int, unit: str):
            vals = []
            for r in rows:
                try:
                    vals.append(float(r[col].replace(unit, "").strip()))
                except ValueError:
                    pass
            return [min(vals), statistics.median(vals), max(vals)] if vals else None

        out["samples"] = len(rows)
        if rows:
            out.update(first=", ".join(rows[0]), clocks_sm_mhz=spread(2, "MHz"),
                       power_draw_w=spread(3, "W"))


def ptxas_lines(log: str, kernel: str) -> list:
    """What ``-Xptxas -v`` said of each entry whose name holds ``kernel``
    (registers, barriers, stack, spills) in a library's build log."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            keep = kernel in ln
        if keep:
            out.append(ln.strip())
    return out


def sass_loop(lib: Path, kernel: str) -> list:
    """For each entry whose name holds ``kernel``, the innermost loop holding
    FFMA, read from the library's SASS (``cuobjdump -sass``; a loop is a
    backward branch and the instructions from its target to it): its
    instructions, FFMA, shared loads (LDS) and the FFMA share, which caps the
    kernel's rate at that share of the FP32 pipes' peak. Empty when cuobjdump
    is missing or finds no such loop."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).is_file():
        return []
    loops = []
    text = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        ins = []
        for addr, body in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part):
            toks = body.split()
            if toks and toks[0].startswith("@"):
                toks = toks[1:]
            if toks:
                ins.append((int(addr, 16), toks[0], body))
        best = None
        for addr, op, body in ins:
            target = re.search(r"0x([0-9a-f]+)", body)
            if op.split(".")[0] != "BRA" or target is None or int(target.group(1), 16) > addr:
                continue
            lo = int(target.group(1), 16)
            ops = [o for a, o, _ in ins if lo <= a <= addr]
            ffma = sum(o == "FFMA" for o in ops)
            if ffma and (best is None or len(ops) < best["instructions"]):
                lds = sum(o.startswith("LDS") for o in ops)
                best = dict(entry=name, instructions=len(ops), ffma=ffma, lds=lds,
                            other=len(ops) - ffma - lds, ffma_share=ffma / len(ops),
                            entry_instructions=len(ins),
                            entry_ffma=sum(o == "FFMA" for _, o, _ in ins))
        if best is not None:
            loops.append(best)
    return loops


def step_in_turns(D, x, b, reps: int = 5) -> dict:
    """K9b's whole step (product and scale) and ``torch.matmul`` on the same
    operands by CUDA events, in turns (step, matmul, matmul, step), each the
    median of ``reps`` calls; then the product alone and the scale alone."""
    import torch

    M, N, K = x.numel() // x.shape[-1], b.shape[1], b.shape[0]
    step = [cuda_ms(lambda: D.gemm_absmax_scale(x, b), reps, warmup=2)]
    lib = [cuda_ms(lambda: torch.matmul(x, b), reps, warmup=2) for _ in range(2)]
    step.append(cuda_ms(lambda: D.gemm_absmax_scale(x, b), reps, warmup=2))
    product = cuda_ms(lambda: D._gemm_absmax_kernel(x, b), reps, warmup=2)
    y, partial = D._gemm_absmax_kernel(x, b)
    scale = cuda_ms(lambda: D._rescale_kernel(y, partial, D.GEMM_EPS), reps, warmup=2)
    flops = 2.0 * M * N * K
    s_ms, l_ms = statistics.fmean(step), statistics.fmean(lib)
    return dict(step_ms=step, matmul_ms=lib, product_ms=product, scale_ms=scale,
                step_tflops=flops / (s_ms * 1e-3) / 1e12,
                matmul_tflops=flops / (l_ms * 1e-3) / 1e12, step_over_matmul=s_ms / l_ms)


# K9b's steps in turns: the chain's sizes as the profiler runs them (S = the
# model's hidden size, 4096 at least: 4096 for the 7-9B models, 5120 for
# qwen3-14b/32b, 7168 for deepseek-v3, 8192 for the 70B models), its
# batches, and the calls behind each median (the 16-bit steps are about a
# fourteenth of float32's, so they take more).
TURN_SIZES = (4096, 5120, 7168, 8192)
TURN_BATCHES = (1, 2, 4)
TURN_REPS = {"float32": 5, "float16": 25, "bfloat16": 25}


def gemm_turns(D, label: str = "") -> dict:
    """K9b's step against ``torch.matmul`` in turns (``step_in_turns``) at
    (B, S, S) @ (S, S) for every dtype, S in TURN_SIZES and B in
    TURN_BATCHES, with the bound and the step's share of it; nvidia-smi
    sampled through the float32 window. {dtype: {"S": {"b_B": ...},
    "nvidia_smi": ...}}, each step printed as it is timed."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for dt in (torch.float32, torch.float16, torch.bfloat16):
        tag = str(dt).split(".")[-1]
        peak = PEAK_F32_S if dt == torch.float32 else PEAK_BF16_S
        by_size = out[tag] = {}
        window = smi_window() if dt == torch.float32 else contextlib.nullcontext({})
        with window as clocks:
            for S in TURN_SIZES:
                b = torch.randn((S, S), generator=gen, device="cuda").to(dt)
                by_batch = by_size[str(S)] = {}
                for B in TURN_BATCHES:
                    x = torch.randn((B, S, S), generator=gen, device="cuda").to(dt)
                    t = step_in_turns(D, x, b, TURN_REPS[tag])
                    t["bound_ms"] = bound_ms(2.0 * B * S ** 3,
                                             (2 * B + 1) * S * S * x.element_size(), peak)[0]
                    t["bound_share"] = t["bound_ms"] / statistics.fmean(t["step_ms"])
                    by_batch[f"b_{B}"] = t
                    print(f"{label}gemm_absmax_scale {tag} S={S} b_{B}: step "
                          f"{t['step_ms'][0]:.4f} / {t['step_ms'][1]:.4f} ms per call "
                          f"(product {t['product_ms']:.4f} + scale {t['scale_ms']:.4f}), "
                          f"{t['step_tflops']:.2f} TFLOP/s, {t['bound_share']:.3f} of the "
                          f"bound; torch.matmul {t['matmul_ms'][0]:.4f} / "
                          f"{t['matmul_ms'][1]:.4f} ms, {t['matmul_tflops']:.2f} TFLOP/s; "
                          f"step / matmul {t['step_over_matmul']:.3f}", flush=True)
                    del x
                del b
        if clocks:
            print(f"{label}gemm {tag} window nvidia-smi {json.dumps(clocks)}", flush=True)
            by_size["nvidia_smi"] = clocks
    return out


def gemm_f32_repeats(D, n: int, shape=(4, 8192, 8192)) -> int:
    """Runs K9b's float32 product ``n`` times on the same operands at
    ``shape`` @ (S, S) and counts the runs whose product or partials differ
    bit for bit from the first: a race between the ring's producer and its
    consumers shows as a run that differs."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(shape, generator=gen, device="cuda")
    b = torch.randn((shape[-1], shape[-1]), generator=gen, device="cuda")
    y0, p0 = D._gemm_absmax_kernel(x, b)
    differ = 0
    for _ in range(n - 1):
        y, p = D._gemm_absmax_kernel(x, b)
        differ += not (torch.equal(y, y0) and torch.equal(p, p0))
    return differ


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


def tests_module(name: str):
    """A helper module of the test suite (``tests/<name>.py``, no JAX),
    loaded by path: a package named ``tests`` installed on the host would
    shadow the repo's folder."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def k7_calls(calls: list):
    """Record (steps, instances, K7 launches) of every ``decomp_bound_roots``
    call the search makes inside the block (phase 4: each must make at most
    two launches, whatever its steps)."""
    from distilp_torch import kernels
    from distilp_torch.solver import search

    orig = search.decomp_bound_roots

    def hook(p32, p64, rd, steps, *a, **kw):
        n0 = kernels.LAUNCHES["decomp"] + kernels.LAUNCHES["decomp_lanes"]
        res = orig(p32, p64, rd, steps, *a, **kw)
        n = kernels.LAUNCHES["decomp"] + kernels.LAUNCHES["decomp_lanes"] - n0
        calls.append((int(steps), int(p32.ks.shape[0]), n))
        return res

    search.decomp_bound_roots = hook
    try:
        yield calls
    finally:
        search.decomp_bound_roots = orig


@contextlib.contextmanager
def uncounted():
    """Launches inside the block are left out of the kernels' counts (a
    path's comparison solves, which are not the path's own work)."""
    from distilp_torch import kernels

    launches = dict(kernels.LAUNCHES)
    shapes = {k: dict(v) for k, v in kernels.SHAPES.items()}
    try:
        yield
    finally:
        kernels.LAUNCHES.update(launches)
        for k, v in shapes.items():
            kernels.SHAPES[k].clear()
            kernels.SHAPES[k].update(v)


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


def ipm_flops_bytes(sp, B: int, iters_total: int, itemsize: int, warm: bool = False,
                    a_copies: int = 1):
    """Least work of one IPM launch with A's structure known (``sp``, an
    ``IPMSparsity``): per executed step the normal matrix's structural
    entries (2 operations a contribution), a Cholesky (m^3/3), four
    triangular solves (4 m^2) and about six sparse matvecs (12 nnz); per
    element the float64 bound (4 nnz). Bytes: every input read once (A's
    nonzeros, ``a_copies`` times for a per-node A), every output written
    once."""
    m, n = sp.m, sp.n
    per_step = 2 * sp.ncontrib + m ** 3 / 3 + 4 * m * m + 12 * sp.nnz + 60 * n
    flops = iters_total * per_step + B * 4 * sp.nnz
    return flops, _ipm_bytes(a_copies * sp.nnz, m, n, B, itemsize, warm)


def ipm_dense_formula_flops_bytes(m: int, n: int, B: int, iters_total: int,
                                  itemsize: int, warm: bool = False):
    """K1's earlier figure, printed beside the bound so rows compare with
    the kernel table's older ones: A taken as dense, so per step the normal
    matrix as m(m+1)/2 dot products of length n and matvecs of 12 m n, per
    element 4 m n; A shared."""
    per_step = m * (m + 1) * n + m ** 3 / 3 + 4 * m * m + 12 * m * n + 60 * n
    flops = iters_total * per_step + B * 4 * m * n
    return flops, _ipm_bytes(m * n, m, n, B, itemsize, warm)


def _ipm_bytes(a_values: int, m: int, n: int, B: int, itemsize: int, warm: bool):
    inputs = a_values * itemsize + B * (m + 3 * n) * itemsize
    if warm:
        inputs += B * (3 * n + m) * itemsize + 2 * B
    outputs = B * (4 * n + m) * itemsize + B * n * 8 + B * (8 + 4 * itemsize + 5)
    return inputs + outputs


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@contextlib.contextmanager
def launch_bounds(out: dict):
    """Sum into ``out`` ({kernel: ms}) the bound of every kernel call the
    search makes inside the block, each from the call's own inputs and
    executed work: an LP call's as phase 3 computes it (``ipm_flops_bytes``
    on the sweep's structure, ``pdhg_flops_bytes``; the executed steps),
    K7's from the least work of a root bound (per instance: the fused
    ascent's ``ascent_flops_bytes`` at the float32 peak when the call
    ascends, one float64 evaluation, ``decomp_flops_bytes``, at the float64
    peak), K2 MoE's from ``round_moe_bytes_flops`` (the delta table's
    pricing, a hint row's repair included), dense K2's and K3's from
    their tensors' bytes (each input read once, each output written once),
    the round tail's from ``tail_flops_bytes``.
    A host loop's bound (B12, K10) is the sum over its launches. The hooks
    read results back, so the block is a separate, untimed run."""
    import torch

    from distilp_torch.ops.ipm import ipm_sparsity
    from distilp_torch.ops.pdhg import PDHG_DEFAULT_CHUNK, ElemA
    from distilp_torch.solver import device_loop, search
    from distilp_torch.solver.standard_form import MOE_LOCAL_MOVES

    def nbytes(obj):
        if isinstance(obj, torch.Tensor):
            return obj.numel() * obj.element_size()
        if isinstance(obj, (tuple, list)):
            return sum(nbytes(o) for o in obj)
        return 0

    def add(name, flops, nb, peak):
        out[name] = out.get(name, 0.0) + bound_ms(flops, nb, peak)[0]

    def ipm(batch, *a, **kw):
        res = orig["ipm_solve_batch"](batch, *a, **kw)
        A = batch.A
        sp = kw.get("sparsity") or ipm_sparsity((A != 0).reshape(-1, *A.shape[-2:]).any(0))
        isz = res.v.element_size()
        flops, nb = ipm_flops_bytes(sp, batch.b.shape[0], int(res.iters_run.sum()), isz,
                                    kw.get("warm") is not None,
                                    a_copies=A.shape[0] if A.dim() == 3 else 1)
        add("ipm", flops, nb, PEAK_F64_S if isz == 8 else PEAK_F32_S)
        return res

    def pdhg(batch, *a, **kw):
        res = orig["pdhg_solve_batch"](batch, *a, **kw)
        A, (B, n), m = batch.A, batch.c.shape, batch.b.shape[1]
        isz = res.v.element_size()
        if isinstance(A, ElemA):
            per = not A.shared
            nnz, a_bytes = A.sparsity.nnz, elem_a_bytes(A.sparsity, B if per else 1, isz)
        else:
            per, nnz, a_bytes = False, int(torch.count_nonzero(A)), None
        flops, nb, _ = pdhg_flops_bytes(m, n, nnz, B, res.iters_run.tolist(),
                                        PDHG_DEFAULT_CHUNK, isz, kw.get("warm") is not None,
                                        a_bytes=a_bytes)
        add("pdhg_elem" if per else "pdhg", flops, nb, PEAK_F64_S if isz == 8 else PEAK_F32_S)
        return res

    def rounding(v, W, k, rd, packed=None, moe=False, y_steps=None, *a, **kw):
        res = orig["round_to_incumbent"](v, W, k, rd, packed, moe, y_steps, *a, **kw)
        if moe:
            moves = kw.get("moves", a[0] if a else MOE_LOCAL_MOVES)
            M = rd.a.shape[-1]
            flops, nb = round_moe_bytes_flops(v.shape[0], M, moves, y_steps or 0)
            add("round_moe", flops, nb, PEAK_F64_S)
        else:
            nb = nbytes((v, W, k, rd if packed is None else packed, kw.get("inst"), res))
            add("round_incumbent", 0, nb, PEAK_F64_S)
        return res

    def epilogue(*a, **kw):
        res = orig["bnb_epilogue"](*a, **kw)
        add("bnb_epilogue", 0, nbytes((a, tuple(kw.values()), res)), PEAK_F64_S)
        return res

    def tail(*a):
        res = orig["round_tail"](*a)
        flops, nb = tail_flops_bytes(a)
        add("round_tail_lanes" if a[1].node_lo.shape[0] > 1 else "round_tail", flops, nb,
            PEAK_F64_S)
        return res

    def decomp(p32, p64, rd, steps, *a, **kw):
        res = orig["decomp_bound_roots"](p32, p64, rd, steps, *a, **kw)
        for s in range(p32.ks.shape[0]):
            if steps > 0:
                flops, nb = ascent_flops_bytes(p32.instance(s), steps)
                add("decomp", flops, nb, PEAK_F32_S)
            flops, nb, _ = decomp_flops_bytes(p64.instance(s))
            add("decomp", flops, nb, PEAK_F64_S)
        return res

    hooks = {"ipm_solve_batch": ipm, "pdhg_solve_batch": pdhg,
             "round_to_incumbent": rounding, "bnb_epilogue": epilogue,
             "round_tail": tail, "decomp_bound_roots": decomp}
    orig = {name: getattr(search, name) for name in hooks}
    for name, fn in hooks.items():
        setattr(search, name, fn)
    try:
        # The host loop calls every wrapper (a graph launch calls none): the
        # same kernels on the same rows, so the same bounds.
        with device_loop.host_loop():
            yield out
    finally:
        for name, fn in orig.items():
            setattr(search, name, fn)


# ------------------------------------------------------ the loop on the card


def bits_equal(a, b) -> bool:
    """Two tensors or arrays equal bit for bit (NaN where NaN)."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype.is_floating_point:
            return torch.equal(a.view(torch.int64 if a.element_size() == 8 else torch.int32),
                               b.view(torch.int64 if b.element_size() == 8 else torch.int32))
        return torch.equal(a, b)
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def state_diff(a, b) -> list:
    """The SearchState fields of ``a`` and ``b`` that differ (bitwise)."""
    return [f for f, x, y in zip(a._fields, a, b) if not bits_equal(x, y)]


def graph_prep(lanes, params, gap, diag=False):
    """A prepared sweep on the graph route (``diag``: with the round log),
    its plan staged and its static entry loaded: (prep, plan, data)."""
    import torch

    from distilp_torch.solver.backend_torch import _prepare

    prep = _prepare(lanes, params, gap, torch.device("cuda"), shared_A=True,
                    convergence={} if diag else None)
    if prep.plan is None:
        fail("a dense IPM sweep did not take the graph route")
    prep.plan.load_static(prep.entry)
    return prep, prep.plan, prep.plan.data(prep.entry)


def loop_bytes(tensors) -> int:
    import torch

    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def traced_untraced(plan, launch, kernel: str):
    """A diagnostics plan's root LP node (``launch``) timed traced (the
    plan's trace buffer) and untraced (the same launch with none) on the
    same staged inputs, and the result fields (the round's, and its float64
    result on the PDHG's f64) in which the two launches differ: none, since
    a trace changes no other output (B13), which keeps the logged search's
    trajectory the untraced one's. (traced, untraced, differing fields),
    each time as ``time_kernel`` gives it."""
    import torch

    outs = [plan.res[0]] + ([plan.res64[0]] if plan.sig.lp_f64 else [])

    def results():
        torch.cuda.synchronize()
        return {f"{i}.{f}": t.clone() for i, r in enumerate(outs)
                for f, t in zip(r._fields, r) if t is not None}

    with uncounted():
        launch()
        got = results()
        traced = time_kernel(launch, kernel)
        plan._traced = lambda which: False
        try:
            launch()
            ref = results()
            untraced = time_kernel(launch, kernel)
        finally:
            del plan._traced
    return traced, untraced, [f for f in got if not bits_equal(got[f], ref[f])]


def root_lp_nodes() -> list:
    """The traced root LP nodes of the diagnostics plans on the PDHG (R3d):
    K5 at the 128-device fleet's cold root in float32 and float64, and
    K6b's fused route there on a virtual row mesh of S=4 in both dtypes,
    each staged as the graph's root round stages it (seed, init control,
    head) and held to :func:`traced_untraced`. Rows of ``check_bnb_loop``'s
    root-LP lines: (name, kernel, rows, trace rows, traced, untraced,
    differing fields)."""
    import torch

    from distilp_torch import kernels
    from distilp_torch.kernels.build import library
    from distilp_torch.parallel import force_virtual_devices, shard_mesh
    from distilp_torch.solver.backend_torch import _prepare, _search_params
    from distilp_torch.utils import make_synthetic_fleet

    force_virtual_devices(8)
    lib = library("bnb_loop")
    dev = torch.device("cuda")
    sh = kernels.stream_handle(dev)
    lanes = lane_inputs([make_synthetic_fleet(128, seed=123)], online_model(128), "4bit")
    out = []
    for name, dtype, S in (("fleet_M128 pdhg f32 cold", None, None),
                           ("fleet_M128 pdhg f64 cold", "f64", None),
                           ("fleet_M128 row mesh S=4 f32 cold", None, 4),
                           ("fleet_M128 row mesh S=4 f64 cold", "f64", 4)):
        params = _search_params(lanes[0].sf, None, None, None, None, None, "pdhg", None, S,
                                dtype, False)
        prep = _prepare(lanes, params, FLEET128_GAP, dev, shared_A=True, convergence={},
                        row_mesh=None if S is None else shard_mesh(S, dev))
        plan = prep.plan
        if plan is None or not plan.sig.diag or plan.sig.engine != "pdhg":
            fail(f"root LP node {name}: no diagnostics plan on the PDHG's graph route")
        plan.load_static(prep.entry)
        data, sig = plan.data(prep.entry), plan.sig
        with uncounted():
            plan._seed(lib, data, sh)
            plan._control(lib, sh, init=True)
            plan._head(data, sh, 0, 0)
        R0 = sig.L * sig.B0
        if plan.row_mesh:
            kernel, launch = "pdhgs_fused_kernel", lambda: plan._k6b(sh, 0)  # noqa: B023
            label = f"K6b fused S={sig.S}"
        else:
            kernel, launch = K5_KERNEL[sig.route], lambda: plan._k5(sh, 0, 0, R0)  # noqa: B023
            label = f"K5 {sig.route}{sig.C if sig.route == 'cluster' else ''}"
        out.append((name, label, R0, sig.trace_rows, *traced_untraced(plan, launch, kernel)))
        prep.release()
    return out


def check_bnb_loop(report: dict) -> None:
    """The loop's kernels (bnb_loop_kernel.cu) against their plain versions,
    bit for bit, at the main path's shapes: the seed (the north star cold,
    and warm with its hint and root iterates), the init control, the head of
    the root and of a warm round (and the S=8 scenarios with lane 3 frozen),
    the step control and the answer; each timed beside its plain version
    and its bound. Then the same on diagnostics plans (R3d: the north star
    cold, and the scenarios warm with lane 3 frozen): the init control's
    zeroed log and trace, the step control's round-log row, the answer's
    log and root trace tail (and, with the frozen lane's ran set to 0 and
    words in its trace rows, the tail's mask), and the root round's traced
    K1 launch timed beside the untraced one on the same buffers; then the
    traced K5 and K6b root nodes of :func:`root_lp_nodes`."""
    import torch

    from distilp_torch import kernels
    from distilp_torch.kernels.build import library
    from distilp_torch.solver import device_loop as DL
    from distilp_torch.solver import packed as PK
    from distilp_torch.solver.backend_torch import _search_params
    from distilp_torch.solver.search import round_inputs, root_state, seed_warm
    from distilp_torch.solver.standard_form import MOE_LOCAL_MOVES_WARM
    from distilp_torch.solver import halda_solve
    from distilp_torch.utils import make_synthetic_fleet

    lib = library("bnb_loop")
    model = online_model()
    devs = make_synthetic_fleet(16, seed=123)
    with uncounted():
        cold = halda_solve(devs, model, mip_gap=1e-3, kv_bits="4bit")
    sh = kernels.stream_handle(torch.device("cuda"))
    rows = {k: [] for k in ("bnb_seed", "bnb_head", "bnb_control", "bnb_answer")}
    root_lp = []
    cases = [("north_star_cold", [devs], None, None, False),
             ("north_star_warm", [devs], cold, None, False),
             ("scenarios_x8_lane3_frozen", scenario_fleets(devs, 8, 17), cold, 3, False),
             ("north_star_cold log", [devs], None, None, True),
             ("scenarios_x8_lane3_frozen log", scenario_fleets(devs, 8, 17), cold, 3, True)]
    for name, fleets, warm, frozen_lane, diag in cases:
        lanes = lane_inputs(fleets, model, "4bit")
        if warm is not None:
            from distilp_torch.solver.backend_torch import warm_inputs

            wi = [warm_inputs(ln.sf, _as_ilp(warm), ln.feasible, 0) for ln in lanes]
            lanes = [ln._replace(warm_tuple=w[0], root_warm_tuple=w[2]) for ln, w in zip(lanes, wi)]
        params = _search_params(lanes[0].sf, None, None, None, None, None, "ipm", None, None,
                                None, False)
        prep, plan, data = graph_prep(lanes, params, 1e-3, diag)
        sig, v = plan.sig, plan.views
        # The control's buffers (a diagnostics plan's log and trace too:
        # NaN before each launch, so a row or word left unwritten shows).
        ctl_bufs = (plan.frozen, plan.ran, plan.ctl) + ((plan.log, plan.trace) if diag else ())
        ctl_names = ("frozen", "ran", "ctl", "log", "trace")

        def poison():
            if diag:
                plan.log.fill_(float("nan"))  # noqa: B023
                plan.trace.fill_(float("nan"))  # noqa: B023
        # Seed.
        plan._seed(lib, data, sh)
        st = root_state(v["lo_k"], v["hi_k"], sig.M, sig.cap, sig.m, prep.root_warm)
        if prep.warm is not None:
            st = seed_warm(st, data, prep.warm, False, MOE_LOCAL_MOVES_WARM)
        bad = state_diff(plan.states[0], st)
        seed_in = [v[k] for k in ("lo_k", "hi_k", "Ws", "ks", "rd", "obj_const")] + \
            [v[k] for k in ("rw_ok", "rw_v", "rw_y", "rw_z", "rw_f", "warm_kidx", "warm_w",
                            "warm_n") if k in v]
        nb = loop_bytes(seed_in) + loop_bytes(plan.states[0])
        ms, call, src = time_kernel(lambda: plan._seed(lib, data, sh), "bnb_seed_kernel")
        plain_ms = cuda_ms(lambda: seed_warm(root_state(v["lo_k"], v["hi_k"], sig.M, sig.cap,
                                                        sig.m, prep.root_warm), data, prep.warm,
                                             False, MOE_LOCAL_MOVES_WARM)
                           if prep.warm is not None else
                           root_state(v["lo_k"], v["hi_k"], sig.M, sig.cap, sig.m, None))
        rows["bnb_seed"].append((name, bad, ms, call, plain_ms, nb, src))
        # Init control.
        poison()
        plan._control(lib, sh, init=True)
        got = [t.clone() for t in ctl_bufs]
        poison()
        DL.control_reference(plan, init=True, state=plan.states[0])
        bad = [n for n, a, b in zip(ctl_names, got, ctl_bufs) if not bits_equal(a, b)]
        st0 = plan.states[0]
        nb = loop_bytes([st0.active, st0.node_bound, st0.node_kidx, st0.incumbent,
                         st0.dropped_bound, st0.per_k_best, st0.per_k_dropped, *ctl_bufs])
        ms, call, src = time_kernel(lambda: plan._control(lib, sh, init=True), "bnb_control_kernel")
        plain_ms = cuda_ms(lambda: DL.control_reference(plan, init=True, state=st0))
        rows["bnb_control"].append((name + " init", bad, ms, call, plain_ms, nb, src))
        if frozen_lane is not None:
            plan.frozen[frozen_lane] = True
        # Heads, the root round's and a warm round's rows of the seeded state.
        for which, B in ((0, sig.B0), (1, sig.Bw)):
            plan._head(data, sh, 0, which)
            ref = round_inputs(data, plan.states[0], B, plan.frozen)
            R, lp = sig.L * B, plan.lp_in
            pairs = [("b", ref.b), ("c", ref.c), ("l", ref.lo), ("u", ref.hi),
                     ("wv", ref.warm.v), ("wy", ref.warm.y), ("wz", ref.warm.z),
                     ("wf", ref.warm.f), ("wok", ref.warm.ok), ("skip", ref.skip)]
            bad = [n for n, t in pairs if not bits_equal(lp[n][:R], t)]
            nb = 2 * loop_bytes([lp[n][:R] for n, _ in pairs]) + loop_bytes(
                [st0.node_kidx[:, :B], st0.active[:, :B], plan.frozen])
            ms, call, src = time_kernel(lambda: plan._head(data, sh, 0, which), "bnb_head_kernel")  # noqa: B023
            plain_ms = cuda_ms(lambda: round_inputs(data, plan.states[0], B, plan.frozen))  # noqa: B023
            rows["bnb_head"].append((f"{name} B={B}", bad, ms, call, plain_ms, nb, src))
        # One root round, then the step control and the answer.
        plan._control(lib, sh, init=True)
        if frozen_lane is not None:
            plan.frozen[frozen_lane] = True
        plan._round(data, sh, 0, 1, 0)
        saved = [t.clone() for t in ctl_bufs]
        plan._control(lib, sh, go=1)
        got = [t.clone() for t in ctl_bufs]
        for t, s0 in zip(ctl_bufs, saved):
            t.copy_(s0)
        DL.control_reference(plan, go=plan.gos[1])
        bad = [n for n, a, b in zip(ctl_names, got, ctl_bufs) if not bits_equal(a, b)]
        if diag and frozen_lane is not None and float(plan.log[frozen_lane, 0, 5]) != 0.0:
            bad.append("the frozen lane's executed column")
        nb = loop_bytes([plan.gos[1], plan.frozen, plan.ctl])
        if diag:
            # The root round's log row (log_row): the beam's B0 active flags
            # before the round and its steps, every active flag after it and
            # the bounds of the active nodes, the incumbent, the dropped
            # bound and the steps; one row written a lane.
            st_b, st_a = plan.states[0], plan.states[1]
            nb += loop_bytes([st_b.active[:, :sig.B0], st_b.stat_ipm_iters, st_a.active,
                              st_a.incumbent, st_a.dropped_bound, st_a.stat_ipm_iters,
                              plan.log[:, 0]])
            nb += st_a.node_bound.element_size() * int(st_a.active.sum())

        def step_kernel():
            plan.ctl.copy_(saved[2])
            plan._control(lib, sh, go=1)

        def step_plain():
            plan.ctl.copy_(saved[2])
            DL.control_reference(plan, go=plan.gos[1])

        ms, call, src = time_kernel(step_kernel, "bnb_control_kernel")
        plain_ms = cuda_ms(step_plain)
        rows["bnb_control"].append((name + " step", bad, ms, call, plain_ms, nb, src))
        plan._answer(lib, sh)
        got = plan.answer.clone()
        ref = DL.answer_reference(plan, plan.states[1])
        bad = [] if bits_equal(got, ref) else ["answer"]
        if diag and frozen_lane is not None:
            # The frozen lane ran the root round but K1 skipped its rows.
            tail = PK.split_answer(got.cpu().numpy(), plan.alay)["conv"]
            if tail[1][frozen_lane].any() or not tail[1].any():
                bad.append("the frozen lane's root trace")
            # A lane settled at the seed (ran 0) whose trace rows hold
            # words: the answer's tail masks them by ran.
            ran0, trace0 = plan.ran.clone(), plan.trace.clone()
            plan.ran[frozen_lane] = 0
            plan.trace.view(sig.L, sig.B0, -1)[frozen_lane] = 1.5
            plan._answer(lib, sh)
            got0 = plan.answer.clone()
            if not bits_equal(got0, DL.answer_reference(plan, plan.states[1])):
                bad.append("the answer with the lane's ran 0")
            tail = PK.split_answer(got0.cpu().numpy(), plan.alay)["conv"]
            if tail[1][frozen_lane].any() or not tail[1].any():
                bad.append("the root trace's ran mask")
            plan.ran.copy_(ran0)
            plan.trace.copy_(trace0)
        st1, r0 = plan.states[1], plan.res[0]
        nb = loop_bytes([st1.incumbent, st1.node_bound, st1.active, st1.dropped_bound,
                         st1.inc_kidx, st1.stat_ipm_iters, st1.stat_rounds, st1.inc_w, st1.inc_n,
                         st1.inc_y, st1.per_k_best, plan.ran, plan.answer]) + loop_bytes(
            [t.reshape(sig.L, sig.B0, -1)[:, :sig.n_k] for t in (r0.v, r0.y_dual, r0.z_dual,
                                                                 r0.f_dual)])
        if diag:
            nb += loop_bytes([plan.log, plan.trace.reshape(sig.L, sig.B0, -1)[:, :sig.n_k]])
            # The root round's LP node, traced (the plan's) and untraced (the
            # same launch with no trace buffer), on the same buffers.
            R0 = sig.L * sig.B0
            root_lp.append((name, "K1", R0, sig.trace_rows, *traced_untraced(
                plan, lambda: plan._lp(sh, 0, 0, R0), "ipm_kernel")))  # noqa: B023
        ms, call, src = time_kernel(lambda: plan._answer(lib, sh), "bnb_answer_kernel")
        plain_ms = cuda_ms(lambda: DL.answer_reference(plan, plan.states[1]))
        rows["bnb_answer"].append((name, bad, ms, call, plain_ms, nb, src))
        prep.release()
    root_lp += root_lp_nodes()
    for name, label, R0, trows, traced, untraced, differ in root_lp:
        print(f"bnb root LP node {name}: {label} traced {traced[0]:.4f} ms ({traced[2]}; call "
              f"{traced[1]:.4f} ms), untraced {untraced[0]:.4f} ms ({untraced[2]}; call "
              f"{untraced[1]:.4f} ms) at B={R0}, {trows} trace rows a root; outputs differ in "
              f"{differ or 'nothing'}", flush=True)
        if differ:
            fail(f"the traced root LP node {name} differs from the untraced launch in {differ}")
    replaces = {
        "bnb_seed": "distilp_tpu/solver/backend_jax.py:1348",
        "bnb_head": "distilp_tpu/solver/backend_jax.py:1504",
        "bnb_control": "distilp_tpu/solver/backend_jax.py:2913",
        "bnb_answer": "distilp_tpu/solver/backend_jax.py:2100",
    }
    for kname, lines in rows.items():
        for case, bad, ms, call, plain_ms, nb, src in lines:
            b_ms, b_by = bound_ms(0.0, nb, PEAK_F64_S)
            print(f"{kname} vs plain {case}: differs in {bad or 'nothing'}; {ms:.4f} ms ({src}), "
                  f"call {call:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms!r} ms ({b_by})",
                  flush=True)
            if bad:
                fail(f"{kname} differs from its plain version on {case}: {bad}")
        case, bad, ms, call, plain_ms, nb, src = lines[0]
        b_ms, b_by = bound_ms(0.0, nb, PEAK_F64_S)
        report[kname] = dict(name=kname, route="cuda",
                             source="distilp_torch/kernels/csrc/bnb_loop_kernel.cu",
                             replaces=replaces[kname], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None, held_on=case,
                             call_ms=call, timing=src)
        # The diagnostics mode (R3d) of the control's step and the answer.
        logged = [ln for ln in lines if " log" in ln[0] and not ln[0].endswith("init")
                  and "scenarios" not in ln[0]]
        if kname in ("bnb_control", "bnb_answer") and logged:
            case, _, ms, call, plain_ms, nb, src = logged[0]
            b_ms, b_by = bound_ms(0.0, nb, PEAK_F64_S)
            report[kname]["log"] = dict(held_on=case, ms=ms, call_ms=call, timing=src,
                                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    report["bnb_answer"]["root_lp_nodes"] = [
        dict(case=name, node=label, rows=R0, trace_rows=trows, traced_ms=traced[0],
             untraced_ms=untraced[0], traced_call_ms=traced[1], untraced_call_ms=untraced[1],
             timing=traced[2]) for name, label, R0, trows, traced, untraced, _ in root_lp]


def moe_lane(case, warm=None, per_k=False, margin_state=None, devs=None):
    """The host half (``backend_torch.LaneInput``) of a MoE case's sweep at
    kv 8bit, on its own fleet or on ``devs``."""
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.backend_torch import lane_input
    from distilp_torch.utils import make_synthetic_fleet

    _, config, M, seed, pool, _ = case
    model = moe_model(config)
    if devs is None:
        devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool))
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "8bit", None, None)
    kWs = [(k, model.L // k) for k in Ks]
    feas = [(k, W) for k, W in kWs if W >= M]
    return lane_input(arrays, coeffs, kWs, feas, warm=warm, margin_state=margin_state,
                      per_k=per_k)


def moe_loop_cases():
    """(name, lanes, per_k) of the MoE loop checks: Mixtral M=4 cold, per-k
    and over 4 load regimes as lanes, the flagship cold, warm (stored duals
    and hint) and on a margin tick."""
    import warnings

    import numpy as np
    import torch

    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.backend_torch import lane_input, solve_sweep_torch
    from distilp_torch.utils import make_synthetic_fleet

    mix = MOE_CASES[0]
    mmodel = moe_model(mix[1])
    mdevs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    regimes = []
    for f in MIXTRAL_REGIMES:
        Ks, _, coeffs, arrays = _build_instance(mdevs, mmodel, None, "8bit", None, f)
        kWs = [(k, mmodel.L // k) for k in Ks]
        regimes.append(lane_input(arrays, coeffs, kWs, [(k, W) for k, W in kWs if W >= 4]))
    fdevs = make_synthetic_fleet(FLAGSHIP[2], seed=FLAGSHIP[3], pool_bytes=int(FLAGSHIP[4]))
    fmodel = moe_model(FLAGSHIP[1])
    Ks, _, coeffs, arrays = _build_instance(fdevs, fmodel, None, "8bit", None, None)
    kWs = [(k, fmodel.L // k) for k in Ks]
    ms: dict = {}
    with uncounted(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, cold = solve_sweep_torch(arrays, kWs, mip_gap=MOE_GAP, coeffs=coeffs,
                                    margin_state=ms)
    torch.cuda.synchronize()
    drifted = [d.model_copy() for d in fdevs]
    drift(drifted, np.random.default_rng(3))
    return [
        ("mixtral_M4 cold", [moe_lane(mix)], False),
        ("mixtral_M4 per_k", [moe_lane(mix, per_k=True)], True),
        ("mixtral_M4 x4 lanes", regimes, False),
        ("flagship cold", [moe_lane(FLAGSHIP, margin_state={})], False),
        ("flagship warm", [moe_lane(FLAGSHIP, warm=cold, devs=drifted)], False),
        ("flagship margin", [moe_lane(FLAGSHIP, warm=cold, margin_state=dict(ms))], False),
    ]


def check_bnb_loop_moe(report: dict) -> None:
    """The loop kernels' MoE modes against their plain versions, bit for
    bit, on ``moe_loop_cases``: the seed's (the root frontier, K7's problem
    from the upload, K7, its folds, the MoE seed's phases and K2's hint and
    warm rows, against ``backend_torch.seeded_state`` on the host route:
    every state field and the duals block), the head's (each row's per-node
    A and values against ``search.node_A``, its W and k, the LP inputs
    against ``round_inputs``) and the answer's (duals block and m_y
    included); each timed beside its plain version. Then K7's float64 folds
    (``decomp_theta``, ``decomp_bound``) against their plain versions at
    the flagship's and the lanes' shapes, within TOL_EXACT_F64 (sum order),
    timed beside them and their bounds."""
    import torch

    from distilp_torch import kernels
    from distilp_torch.kernels.build import library
    from distilp_torch.ops import decomp as D
    from distilp_torch.solver import device_loop as DL
    from distilp_torch.solver.backend_torch import _prepare, _search_params, seeded_state
    from distilp_torch.solver.search import node_A, round_inputs

    lib = library("bnb_loop")
    dev = torch.device("cuda")
    sh = kernels.stream_handle(dev)
    rows = {k: [] for k in ("bnb_seed", "bnb_head", "bnb_answer")}
    folds = {"decomp_theta": [], "decomp_bound": []}
    for name, lanes, per_k in moe_loop_cases():
        params = _search_params(lanes[0].sf, None, None, None, None, None, "ipm", None, None,
                                None, per_k)
        prep = _prepare(lanes, params, MOE_GAP, dev, per_k=per_k, shared_A=True)
        plan = prep.plan
        if plan is None or not plan.sig.moe:
            fail(f"MoE loop case {name} did not take the graph route")
        plan.load_static(prep.entry)
        data = plan.data(prep.entry)
        sig = plan.sig
        hp = _prepare(lanes, params, MOE_GAP, dev, per_k=per_k, shared_A=True, _host_loop=True)
        with uncounted():
            h_state, h_duals, h_raw, h_my, _ = seeded_state(hp)
            plan._seed(lib, data, sh)
        torch.cuda.synchronize()
        bad = state_diff(plan.states[0], h_state)
        n_k, M = sig.n_k, sig.M
        ref_duals = torch.cat([t.reshape(sig.L, -1).to(torch.float64) for t in h_duals]
                              + [h_raw.to(torch.float64)], 1)
        if not bits_equal(plan.duals_out, ref_duals):
            bad.append("duals")
        if sig.want_my and not bits_equal(plan.m_y, h_my):
            bad.append("m_y")

        def seed_kernel():
            with uncounted():
                plan._seed(lib, data, sh)

        def seed_plain():
            with uncounted():
                seeded_state(hp)

        ms = cuda_ms(seed_kernel, reps=5, warmup=1)
        plain_ms = cuda_ms(seed_plain, reps=5, warmup=1)
        rows["bnb_seed"].append((name, bad, ms, plain_ms))
        # Heads of the root round and a warm round on the seeded state.
        for which, B in ((0, sig.B0), (1, sig.Bw)):
            plan.frozen.zero_()
            plan._head(data, sh, 0, which)
            st = plan.states[0]
            R = sig.L * B
            ins = round_inputs(data, st, B, plan.frozen)
            ref_A = node_A(data, ins.kidx, M, ins.lane)
            lp = plan.lp_in
            pairs = [("b", lp["b"][:R], ins.b), ("c", lp["c"][:R], ins.c),
                     ("l", lp["l"][:R], ins.lo), ("u", lp["u"][:R], ins.hi),
                     ("skip", lp["skip"][:R], ins.skip), ("A", plan.A_rows[which], ref_A),
                     ("values", plan.val_rows[which],
                      ref_A.reshape(R, -1)[:, prep.entry.sparsity.src]),
                     ("W", plan.Wr[:R], data.Ws[ins.lane, ins.kidx]),
                     ("k", plan.kr[:R], data.ks[ins.lane, ins.kidx])]
            bad = [n for n, a, b in pairs if not bits_equal(a, b)]
            ms = cuda_ms(lambda: plan._head(data, sh, 0, which))  # noqa: B023
            plain_ms = cuda_ms(lambda: node_A(data, ins.kidx, M, ins.lane))  # noqa: B023
            rows["bnb_head"].append((f"{name} B={B}", bad, ms, plain_ms))
        # A root round, then the answer.
        with uncounted():
            plan._control(lib, sh, init=True)
            plan._round(data, sh, 0, 1, 0)
            plan._answer(lib, sh)
        torch.cuda.synchronize()
        duals = (plan.duals_out[:, :n_k], plan.duals_out[:, n_k:2 * n_k],
                 plan.duals_out[:, 2 * n_k:2 * n_k + n_k * M].reshape(sig.L, n_k, M))
        raw = plan.duals_out[:, 2 * n_k + n_k * M:]
        ref = DL.answer_reference(plan, plan.states[1], (duals, raw, plan.m_y))
        bad = [] if bits_equal(plan.answer, ref) else ["answer"]
        ms = cuda_ms(lambda: plan._answer(lib, sh))
        plain_ms = cuda_ms(lambda: DL.answer_reference(plan, plan.states[1],
                                                       (duals, raw, plan.m_y)))
        rows["bnb_answer"].append((name, bad, ms, plain_ms))
        # K7's folds at this case's shapes (K7's own launches lie outside).
        if not sig.has_margin:
            ks, tau = data.ks, plan.tau
            theta = D.theta_kernel(ks, tau)
            ref_t = (ks - 1.0)[..., None] * D.softmax(tau)
            err_t = max_err(theta, ref_t)
            p64 = D.DecompBatch(rdv=plan.rdv64, bp=plan.bp64, E=plan.E64, ks=ks, Ws=data.Ws,
                                w_max=sig.w_max, e_max=sig.e_max)
            bound = D.bound_kernel(p64, plan.m_y, plan.any_ok, plan.lam, plan.mu)
            ref_b = D.bound_of(p64, plan.m_y, plan.any_ok.bool(), plan.lam, plan.mu)
            err_b = max_err(bound, ref_b)
            nb_t = 8 * (ks.numel() + 2 * tau.numel())
            nb_b = 8 * (plan.m_y.numel() + 3 * ks.numel() + data.Ws.numel() + sig.L) + \
                plan.any_ok.numel()
            folds["decomp_theta"].append((name, err_t, *time_kernel(
                lambda: D.theta_kernel(ks, tau), "decomp_theta_kernel"),  # noqa: B023
                cuda_ms(lambda: (ks - 1.0)[..., None] * D.softmax(tau)),  # noqa: B023
                bound_ms(4.0 * tau.numel(), nb_t, PEAK_F64_S)))
            folds["decomp_bound"].append((name, err_b, *time_kernel(
                lambda: D.bound_kernel(p64, plan.m_y, plan.any_ok, plan.lam, plan.mu),  # noqa: B023
                "decomp_bound_kernel"),
                cuda_ms(lambda: D.bound_of(p64, plan.m_y, plan.any_ok.bool(), plan.lam,  # noqa: B023
                                           plan.mu)),
                bound_ms(float(plan.m_y.numel() + 4 * ks.numel()), nb_b, PEAK_F64_S)))
        prep.release()
        hp.release()
    for kname, lines in rows.items():
        for case, bad, ms, plain_ms in lines:
            print(f"{kname} moe mode vs plain {case}: differs in {bad or 'nothing'}; "
                  f"{ms:.4f} ms (call, CUDA events), plain {plain_ms:.4f} ms", flush=True)
            if bad:
                fail(f"{kname}'s MoE mode differs from its plain version on {case}: {bad}")
        report[kname]["moe_mode"] = [dict(case=c, call_ms=ms, plain_ms=p)
                                     for c, _, ms, p in lines]
    for kname, lines in folds.items():
        worst = 0.0
        for case, (err_abs, err_rel), ms, call, src, plain_ms, (b_ms, b_by) in lines:
            print(f"{kname} vs plain {case}: max abs err {err_abs!r} rel {err_rel!r} (allowed "
                  f"{TOL_EXACT_F64!r} rel); {ms:.5f} ms ({src}), call {call:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms!r} ms ({b_by})", flush=True)
            if not err_rel <= TOL_EXACT_F64:
                fail(f"{kname} differs from its plain version on {case}: {err_rel}")
            worst = max(worst, err_abs)
        case, _, ms, call, src, plain_ms, (b_ms, b_by) = next(
            ln for ln in lines if ln[0] == "flagship cold")
        report[kname] = dict(name=kname, route="cuda",
                             source="distilp_torch/kernels/csrc/decomp_kernel.cu",
                             replaces="distilp_tpu/solver/backend_jax.py:963",
                             max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None, held_on=case, call_ms=call,
                             timing=src)


def check_bnb_loop_pdhg(report: dict) -> None:
    """The loop kernels' PDHG parts against their plain versions, bit for
    bit, at the fleet path's shapes: the head's PDHG mode (``LoopPlan.
    head_pdhg_reference``: the LP's rows, in float64 for pdhg_dtype='f64',
    the warm flag cleared for a row whose carried y holds a NaN, a MoE row's
    values against ``search.node_values``, its W and k) on the 128-device
    fleet warm (root iterates) in float32 and float64 and on Mixtral M=4 on
    the PDHG, and the cast of a float64 K5 round (``bnb_cast_kernel``)
    against ``search.cast_lp_result``; each timed beside its plain version
    and its bound."""
    import torch

    from distilp_torch import kernels
    from distilp_torch.kernels.build import library
    from distilp_torch.ops.ipm import IPMResult
    from distilp_torch.solver import halda_solve
    from distilp_torch.solver.backend_torch import _prepare, _search_params, warm_inputs
    from distilp_torch.solver.search import _lanes_of, cast_lp_result, node_values
    from distilp_torch.utils import make_synthetic_fleet

    lib = library("bnb_loop")
    dev = torch.device("cuda")
    sh = kernels.stream_handle(dev)
    model128, devs = online_model(128), make_synthetic_fleet(128, seed=123)
    with uncounted():
        cold = halda_solve(devs, model128, mip_gap=FLEET128_GAP, kv_bits="4bit")
    lanes = lane_inputs([devs], model128, "4bit")
    wi = [warm_inputs(ln.sf, _as_ilp(cold), ln.feasible, 0) for ln in lanes]
    warm = [ln._replace(warm_tuple=w[0], root_warm_tuple=w[2]) for ln, w in zip(lanes, wi)]
    cases = [("fleet_M128 warm f32, root 0's y NaN", warm, None, FLEET128_GAP, True),
             ("fleet_M128 warm f64", warm, "f64", FLEET128_GAP, False),
             ("mixtral_M4 pdhg", [moe_lane(MOE_CASES[0])], None, MOE_GAP, False)]
    heads, casts = [], []
    for name, lns, dtype, gap, poison in cases:
        params = _search_params(lns[0].sf, None, None, None, None, None, "pdhg", None, None,
                                dtype, False)
        prep = _prepare(lns, params, gap, dev, shared_A=True)
        plan = prep.plan
        if plan is None or plan.sig.engine != "pdhg":
            fail(f"PDHG loop case {name} did not take the graph route")
        plan.load_static(prep.entry)
        data = plan.data(prep.entry)
        sig, st = plan.sig, plan.states[0]
        with uncounted():
            plan._seed(lib, data, sh)
        torch.cuda.synchronize()
        if poison:
            if not bool(st.node_warm[0, 0]):
                fail(f"{name}: root 0 carries no warm iterate to poison")
            st.node_y[0, 0, 0] = float("nan")
        plan.frozen.zero_()
        lp64 = plan.lp_in64 if sig.lp_f64 else plan.lp_in
        for which, B in ((0, sig.B0), (1, sig.Bw)):
            R = sig.L * B
            plan._head(data, sh, 0, which)
            got = {k: (lp64 if k in ("b", "c", "l", "u", "wv", "wy") else plan.lp_in)[k][:R]
                   .clone() for k in ("b", "c", "l", "u", "wv", "wy", "wz", "wf", "wok", "skip")}
            if sig.moe:
                got.update(values=plan.val_rows[which].clone(), W=plan.Wr[:R].clone(),
                           k=plan.kr[:R].clone())
            ref = plan.head_pdhg_reference(data, st, which)
            if sig.moe:
                kidx = st.node_kidx[:, :B].reshape(R).long()
                lane = _lanes_of(sig.L, B, dev)
                ref.update(values=node_values(data, kidx, lane).to(plan.lp_dtype),
                           W=data.Ws[lane, kidx], k=data.ks[lane, kidx])
            bad = [k for k in got if not bits_equal(got[k], ref[k])]
            if poison and which == 0 and (bool(ref["wok"][0]) or bool(got["wok"][0])):
                bad.append("wok of the poisoned row")
            nb = loop_bytes(got.values()) + loop_bytes(
                [st.node_kidx[:, :B], st.active[:, :B], st.node_warm[:, :B], st.node_lo[:, :B],
                 st.node_hi[:, :B], st.node_v[:, :B], st.node_y[:, :B], st.node_z[:, :B],
                 st.node_f[:, :B], plan.frozen])
            ms, call, src = time_kernel(lambda: plan._head(data, sh, 0, which),  # noqa: B023
                                        "bnb_head_kernel")
            plain_ms = cuda_ms(lambda: plan.head_pdhg_reference(data, st, which))  # noqa: B023
            heads.append((f"{name} B={B}", bad, ms, call, src, plain_ms,
                          bound_ms(0.0, nb, PEAK_F64_S)))
        if sig.lp_f64:
            plan._head(data, sh, 0, 0)
            plan._k5(sh, 0)
            r64, r = plan.res64[0], plan.res[0]
            red0 = r.reduced.clone()
            plan._cast(sh, 0)
            torch.cuda.synchronize()
            src_res = IPMResult(v=r64.v, bound=r.bound, obj=r64.obj, rp_norm=r64.rp_norm,
                                rd_norm=r64.rd_norm, mu=r64.mu, converged=r.converged,
                                reduced=red0, y_dual=r64.y_dual, z_dual=r64.z_dual,
                                f_dual=r64.f_dual, iters_run=r.iters_run)
            ref = cast_lp_result(src_res, torch.float32)
            fields = ("v", "obj", "rp_norm", "rd_norm", "mu", "reduced", "y_dual", "z_dual",
                      "f_dual")
            bad = [f for f in fields if not bits_equal(getattr(r, f), getattr(ref, f))]
            Rr, m, nf = r.v.shape[0], sig.m, sig.nf
            nb = Rr * (nf * 3 * (8 + 4) + m * (8 + 4) + 4 * (8 + 4) + nf * 2 * 8)
            ms, call, src = time_kernel(lambda: plan._cast(sh, 0), "bnb_cast_kernel")  # noqa: B023
            plain_ms = cuda_ms(lambda: cast_lp_result(src_res, torch.float32))  # noqa: B023
            casts.append((f"{name} B={sig.B0}", bad, ms, call, src, plain_ms,
                          bound_ms(float(Rr * (4 * nf + m + 4)), nb, PEAK_F64_S)))
        prep.release()
    for kname, lines in (("bnb_head pdhg mode", heads), ("bnb_cast", casts)):
        for case, bad, ms, call, src, plain_ms, (b_ms, b_by) in lines:
            print(f"{kname} vs plain {case}: differs in {bad or 'nothing'}; {ms:.4f} ms ({src}), "
                  f"call {call:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms!r} ms ({b_by})",
                  flush=True)
            if bad:
                fail(f"{kname} differs from its plain version on {case}: {bad}")
    report["bnb_head"]["pdhg_mode"] = [
        dict(case=c, ms=ms, call_ms=call, timing=src, plain_ms=p, bound_ms=b[0])
        for c, _, ms, call, src, p, b in heads]
    case, _, ms, call, src, plain_ms, (b_ms, b_by) = casts[0]
    report["bnb_cast"] = dict(name="bnb_cast", route="cuda",
                              source="distilp_torch/kernels/csrc/bnb_loop_kernel.cu",
                              replaces="distilp_tpu/solver/backend_jax.py:1414",
                              max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=None, held_on=case, call_ms=call,
                              timing=src)


MESH_LOOP_REPS = 9


def mesh_loop_cases() -> list:
    """The mesh sweeps of ``check_bnb_loop_mesh``, each through a user's
    entry point on a virtual mesh of this card: (name, fn(tm) -> result,
    reps, node). The row mesh (K6b/B6c): the 128-device fleet at S=4 in
    float32 and float64, the 512-device fleet at S=4 (one rep), the online
    golden at S=4, Mixtral M=4 at S=2 and S=4 cold, its per-k optima at
    S=2 and a replanner's cold solve and drifted tick at S=2 (the tick
    timed); the node mesh (K10): the north star on 8 shards on the IPM, on
    the PDHG and per k, and Mixtral M=8 on 8 shards."""
    import numpy as np

    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.parallel import make_mesh, solve_sweep_sharded
    from distilp_torch.solver import StreamingReplanner, halda_solve, halda_solve_per_k
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.utils import make_synthetic_fleet

    model128, devs128 = online_model(128), make_synthetic_fleet(128, seed=123)
    model512, devs512 = online_model(512), make_synthetic_fleet(512, seed=123)
    devs_o, model_o = load_from_profile_folder(ROOT / "tests" / "profiles" / "llama_3_70b" /
                                               "online")
    _, mconfig, mM, mseed, mpool, _ = MOE_CASES[0]
    mmodel = moe_model(mconfig)
    mdevs = make_synthetic_fleet(mM, seed=mseed, pool_bytes=int(mpool))
    f128 = dict(mip_gap=FLEET128_GAP, kv_bits="4bit", mesh_shards=4)
    moe = dict(mip_gap=MOE_GAP, kv_bits="8bit", lp_backend="pdhg")

    def tick(tm=None):
        planner = StreamingReplanner(mip_gap=MOE_GAP, kv_bits="8bit",
                                     search={"lp_backend": "pdhg", "mesh_shards": 2})
        devs = make_synthetic_fleet(mM, seed=mseed, pool_bytes=int(mpool))
        planner.step(devs, mmodel)
        drift(devs, np.random.default_rng(7))
        r, ms = timed(lambda: planner.step(devs, mmodel, timings=tm))
        if tm is not None:
            tm["tick_wall_ms"] = ms
        return r

    mesh8 = make_mesh(8)
    _, _, ns_coeffs, ns_arrays, ns_feas, _, _ = load_instance(16, 123)
    _, m8config, m8M, m8seed, m8pool, _ = MOE_CASES[1]
    m8model = moe_model(m8config)
    Ks, _, m8coeffs, m8arrays = _build_instance(
        make_synthetic_fleet(m8M, seed=m8seed, pool_bytes=int(m8pool)), m8model, None, "8bit",
        None, None)
    m8kWs = [(k, m8model.L // k) for k in Ks]
    return [
        ("fleet_M128 S=4", lambda tm=None: halda_solve(devs128, model128, timings=tm, **f128),
         MESH_LOOP_REPS, False),
        ("fleet_M128 S=4 f64", lambda tm=None: halda_solve(
            devs128, model128, pdhg_dtype="f64", timings=tm, **f128), MESH_LOOP_REPS, False),
        ("fleet_M512 S=4", lambda tm=None: halda_solve(
            devs512, model512, mip_gap=FLEET512_GAP, kv_bits="4bit", mesh_shards=4,
            timings=tm), 1, False),
        ("online S=4", lambda tm=None: halda_solve(
            devs_o, model_o, mip_gap=1e-4, kv_bits="4bit", lp_backend="pdhg", mesh_shards=4,
            timings=tm), MESH_LOOP_REPS, False),
        ("mixtral_M4 S=2", lambda tm=None: halda_solve(mdevs, mmodel, mesh_shards=2,
                                                        timings=tm, **moe),
         MESH_LOOP_REPS, False),
        ("mixtral_M4 S=4", lambda tm=None: halda_solve(mdevs, mmodel, mesh_shards=4,
                                                        timings=tm, **moe),
         MESH_LOOP_REPS, False),
        ("mixtral_M4 per_k S=2", lambda tm=None: halda_solve_per_k(
            mdevs, mmodel, mesh_shards=2, timings=tm, **moe), MESH_LOOP_REPS, False),
        ("mixtral_M4 tick S=2", tick, MESH_LOOP_REPS, False),
        ("north_star nodes=8", lambda tm=None: solve_sweep_sharded(
            ns_arrays, ns_feas, ns_coeffs, mesh8, mip_gap=MESH_SWEEP_GAP, timings=tm),
         MESH_LOOP_REPS, True),
        ("north_star nodes=8 pdhg", lambda tm=None: solve_sweep_sharded(
            ns_arrays, ns_feas, ns_coeffs, mesh8, mip_gap=MESH_SWEEP_GAP, lp_backend="pdhg",
            timings=tm), MESH_LOOP_REPS, True),
        ("north_star nodes=8 per_k", lambda tm=None: solve_sweep_sharded(
            ns_arrays, ns_feas, ns_coeffs, mesh8, mip_gap=MESH_SWEEP_GAP, per_k=True,
            timings=tm), MESH_LOOP_REPS, True),
        ("mixtral_M8 nodes=8", lambda tm=None: solve_sweep_sharded(
            m8arrays, m8kWs, m8coeffs, mesh8, mip_gap=MOE_GAP, timings=tm),
         MESH_LOOP_REPS, True),
    ]


def check_bnb_loop_mesh(report: dict) -> None:
    """The meshes' rounds on the loop graph (R3c). First the new loop
    kernel parts against their plain versions, bit for bit: the head's row
    mesh mode (``LoopPlan.head_mesh_reference``: b and the warm y in the S
    row blocks with zero padding, a MoE row's values against
    ``search.node_values`` taken by ``RowBlocks.take``, its W and k) on the
    128-device fleet at S=4 warm in float32 (root 0's y NaN) and float64 and
    on Mixtral M=4 at S=2; the head's W and k on the node mesh (the north
    star on 8 shards); the gather of the dual blocks (``bnb_gather_kernel``
    against ``ops.meshlp.gather_rows_reference``) in both dtypes, timed
    beside its plain version and its bound. Then every case of
    :func:`mesh_loop_cases` on the graph and on the host loop
    (``device_loop.host_loop``): the answers and final states equal bit for
    bit, one graph launch, one read and 0 runtime kernel launches a solve,
    one capture a signature, the graph's kernels a round; walls and search
    times of the two routes in turns, medians of 9."""
    import statistics

    import numpy as np
    import torch

    from distilp_torch import kernels
    from distilp_torch.kernels.build import library
    from distilp_torch.ops.meshlp import gather_rows_reference
    from distilp_torch.parallel import force_virtual_devices, shard_mesh
    from distilp_torch.solver import device_loop as DL
    from distilp_torch.solver import halda_solve
    from distilp_torch.solver import packed as PK
    from distilp_torch.solver.backend_torch import _prepare, _search_params, warm_inputs
    from distilp_torch.solver.search import node_values, round_inputs
    from distilp_torch.utils import make_synthetic_fleet

    force_virtual_devices(8)
    lib = library("bnb_loop")
    dev = torch.device("cuda")
    sh = kernels.stream_handle(dev)
    model128, devs = online_model(128), make_synthetic_fleet(128, seed=123)
    with uncounted():
        cold = halda_solve(devs, model128, mip_gap=FLEET128_GAP, kv_bits="4bit")
    lanes = lane_inputs([devs], model128, "4bit")
    wi = [warm_inputs(ln.sf, _as_ilp(cold), ln.feasible, 0) for ln in lanes]
    warm = [ln._replace(warm_tuple=w[0], root_warm_tuple=w[2]) for ln, w in zip(lanes, wi)]
    heads, gathers = [], []
    for name, lns, dtype, gap, S, poison in (
            ("fleet_M128 S=4 warm f32, root 0's y NaN", warm, None, FLEET128_GAP, 4, True),
            ("fleet_M128 S=4 warm f64", warm, "f64", FLEET128_GAP, 4, False),
            ("mixtral_M4 S=2", [moe_lane(MOE_CASES[0])], None, MOE_GAP, 2, False)):
        params = _search_params(lns[0].sf, None, None, None, None, None, "pdhg", None, S,
                                dtype, False)
        prep = _prepare(lns, params, gap, dev, shared_A=True, row_mesh=shard_mesh(S, dev))
        plan = prep.plan
        if plan is None or plan.sig.mesh != "row" or plan.sig.S != S:
            fail(f"row-mesh loop case {name} did not take the graph route")
        plan.load_static(prep.entry)
        data = plan.data(prep.entry)
        sig, st = plan.sig, plan.states[0]
        with uncounted():
            plan._seed(lib, data, sh)
        torch.cuda.synchronize()
        if poison:
            if not bool(st.node_warm[0, 0]):
                fail(f"{name}: root 0 carries no warm iterate to poison")
            st.node_y[0, 0, 0] = float("nan")
        plan.frozen.zero_()
        lp = plan.lp_in64 if sig.lp_f64 else plan.lp_in
        for which, B in ((0, sig.B0), (1, sig.Bw)):
            R = sig.L * B
            blocks = [plan.b_blk, plan.wy_blk] + ([plan.blk_vals] if plan.elem else [])
            base = [t.clone() for t in blocks]
            for t in blocks[:2]:
                t.fill_(float("nan"))
            plan._head(data, sh, 0, which)
            got = {k: t.clone() for k, t in zip(("b", "wy", "vals"), blocks)}
            got.update({k: (lp if k in ("c", "l", "u", "wv") else plan.lp_in)[k][:R].clone()
                        for k in ("c", "l", "u", "wv", "wok", "skip")})
            if sig.moe:
                got.update(W=plan.Wr[:R].clone(), k=plan.kr[:R].clone())
            for t, b0 in zip(blocks, base):
                t.copy_(b0)
            for t in blocks[:2]:
                t.fill_(float("nan"))
            ref = plan.head_mesh_reference(data, st, which)
            ref.update({k: t.clone() for k, t in zip(("b", "wy", "vals"), blocks)})
            if sig.moe:
                ref.update(W=plan.Wr[:R].clone(), k=plan.kr[:R].clone())
            bad = [k for k in got if not bits_equal(got[k], ref[k])]
            if plan.elem:
                # Independently: each block's values are the row's values on
                # the full structure taken at the block's places.
                ins = round_inputs(data, st, B, plan.frozen)
                full = node_values(data, ins.kidx, ins.lane).to(plan.lp_dtype)
                rb = prep.entry.mesh_blocks(S)
                for s in range(S):
                    n = sig.blk_nnz[s]
                    blk = got["vals"][plan.blk_off[s]:plan.blk_off[s] + R * n].view(R, n)
                    if not bits_equal(blk, full[:, rb.take[s]]):
                        bad.append(f"block {s}'s values against node_values")
            if poison and which == 0 and (bool(ref["wok"][0]) or bool(got["wok"][0])):
                bad.append("wok of the poisoned row")
            for t, b0 in zip(blocks, base):
                t.copy_(b0)
            nb = loop_bytes([t[:, :R] if t.dim() == 3 else t for t in blocks]) + loop_bytes(
                [lp[k][:R] for k in ("c", "l", "u", "wv")]) + loop_bytes(
                [st.node_kidx[:, :B], st.active[:, :B], st.node_warm[:, :B], st.node_lo[:, :B],
                 st.node_hi[:, :B], st.node_v[:, :B], st.node_y[:, :B], st.node_z[:, :B],
                 st.node_f[:, :B], plan.frozen])
            ms, call, src = time_kernel(lambda: plan._head(data, sh, 0, which),  # noqa: B023
                                        "bnb_head_kernel")
            plain_ms = cuda_ms(lambda: plan.head_mesh_reference(data, st, which))  # noqa: B023
            heads.append((f"{name} B={B}", bad, ms, call, src, plain_ms,
                          bound_ms(0.0, nb, PEAK_F64_S)))
            # The gather on random dual blocks.
            y = (plan.res64 if sig.lp_f64 else plan.res)[which].y_dual
            plan.y_blk.copy_(torch.randn(plan.y_blk.shape, dtype=plan.y_blk.dtype, device=dev))
            plan._gather(sh, which)
            want = gather_rows_reference([plan.y_blk[s, :R] for s in range(S)], sig.m)
            bad = [] if bits_equal(y[:R], want) else ["y"]
            nbg = 2 * R * sig.m * y.element_size()
            ms, call, src = time_kernel(lambda: plan._gather(sh, which),  # noqa: B023
                                        "bnb_gather_kernel")
            plain_ms = cuda_ms(lambda: gather_rows_reference(  # noqa: B023
                [plan.y_blk[s, :R] for s in range(S)], sig.m))  # noqa: B023
            # One PyTorch call: the blocks side by side (the padding then a
            # view's to drop).
            lib_ms = cuda_ms(lambda: torch.cat(  # noqa: B023
                [plan.y_blk[s, :R] for s in range(S)], 1))  # noqa: B023
            gathers.append((f"{name} B={B}", bad, ms, call, src, plain_ms,
                            bound_ms(0.0, nbg, PEAK_F64_S), lib_ms))
        prep.release()
    # The node mesh: the head writes each row's W and k for K2's dense entry.
    from distilp_torch.parallel import make_mesh, pad_cap_to_mesh

    mesh8 = make_mesh(8)
    ns = lane_inputs([make_synthetic_fleet(16, seed=123)], online_model(), "4bit")
    n_k = len(ns[0].sf.ks)
    params = _search_params(ns[0].sf, None, None, None, 48, None, None, None, None, None, False)
    cap = pad_cap_to_mesh(max(params["cap"], 2 * n_k), mesh8)
    params.update(cap=cap, beam=min(pad_cap_to_mesh(params["beam"], mesh8), cap))
    prep = _prepare(ns, params, MESH_SWEEP_GAP, dev, shared_A=True, node_mesh=mesh8,
                    root_beam=min(pad_cap_to_mesh(n_k, mesh8), cap))
    plan = prep.plan
    if plan is None or plan.sig.mesh != "node" or plan.sig.B0 % 8:
        fail("the node-mesh loop case did not take the graph route with a padded root round")
    plan.load_static(prep.entry)
    data = plan.data(prep.entry)
    with uncounted():
        plan._seed(lib, data, sh)
    plan.frozen.zero_()
    plan._head(data, sh, 0, 0)
    R = plan.sig.L * plan.sig.B0
    st = plan.states[0]
    ins = round_inputs(data, st, plan.sig.B0, plan.frozen)
    bad = [k for k, a, b in (("W", plan.Wr[:R], data.Ws[ins.lane, ins.kidx]),
                             ("k", plan.kr[:R], data.ks[ins.lane, ins.kidx]),
                             ("b", plan.lp_in["b"][:R], ins.b), ("skip", plan.lp_in["skip"][:R],
                                                                 ins.skip))
           if not bits_equal(a, b)]
    print(f"bnb_head node-mesh mode vs plain north_star 8 shards B={plan.sig.B0}: differs in "
          f"{bad or 'nothing'}", flush=True)
    if bad:
        fail(f"the head's node-mesh mode differs from its plain version: {bad}")
    prep.release()
    for kname, lines in (("bnb_head mesh mode", heads), ("bnb_gather", gathers)):
        for case, bad, ms, call, src, plain_ms, (b_ms, b_by), *lib_ms in lines:
            print(f"{kname} vs plain {case}: differs in {bad or 'nothing'}; {ms:.4f} ms ({src}), "
                  f"call {call:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms!r} ms ({b_by})"
                  + (f", torch.cat {lib_ms[0]:.4f} ms" if lib_ms else ""), flush=True)
            if bad:
                fail(f"{kname} differs from its plain version on {case}: {bad}")
    report["bnb_head"]["mesh_mode"] = [
        dict(case=c, ms=ms, call_ms=call, timing=src, plain_ms=p, bound_ms=b[0])
        for c, _, ms, call, src, p, b in heads]
    case, _, ms, call, src, plain_ms, (b_ms, b_by), lib_ms = gathers[0]
    report["bnb_gather"] = dict(name="bnb_gather", route="cuda",
                                source="distilp_torch/kernels/csrc/bnb_loop_kernel.cu",
                                replaces="distilp_tpu/ops/meshlp.py:165",
                                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib_ms, held_on=case, call_ms=call,
                                timing=src)

    # The mesh sweeps, graph against host loop (the plans of the checks
    # above dropped: each case's signature is captured once).
    DL.clear_plans()
    DL.CAPTURES.clear()
    cases = mesh_loop_cases()
    sigs0 = set()
    for name, fn, reps, node in cases:
        g0 = kernels.LAUNCHES["bnb_graph"]
        c0 = dict(PK.COPIES)
        routes0 = dict(kernels.SHAPES["bnb_graph"])
        graph_log: list = []
        with recorded_loops(graph_log):
            got = fn()
        torch.cuda.synchronize()
        n_graph = kernels.LAUNCHES["bnb_graph"] - g0
        d2h = PK.COPIES["d2h"] - c0["d2h"]
        routes = {k: v - routes0.get(k, 0) for k, v in kernels.SHAPES["bnb_graph"].items()
                  if v != routes0.get(k, 0)}
        host_log: list = []
        with DL.host_loop(), recorded_loops(host_log):
            fn()
        torch.cuda.synchronize()
        answers = [a for kind, a in graph_log if kind == "answer"]
        h_answers = [a for kind, a in host_log if kind == "answer"]
        same_ans = len(answers) == len(h_answers) and all(
            bits_equal(a, b) for a, b in zip(answers, h_answers))
        gs = [x for k, x in graph_log if k == "state"]
        hs = [x for k, x in host_log if k == "state"]
        diffs = [state_diff(a, b) for a, b in zip(gs, hs)]
        same_state = len(gs) == len(hs) and len(gs) > 0 and not any(diffs)
        solves = len(gs)
        print(f"mesh loop {name}: {solves} solves, graph launches {n_graph}, device-to-host "
              f"reads {d2h}; answers equal bit for bit: {same_ans} ({len(answers)}); final "
              f"states equal bit for bit: {same_state} {[d for d in diffs if d]}; routes "
              f"{json.dumps(routes)}", flush=True)
        if not (same_ans and same_state) or n_graph != solves or d2h != solves:
            fail(f"mesh loop {name}: the graph route differs from the host loop or did not run "
                 f"as one graph launch and one read a solve")
        want = "node_mesh" if node else "row_mesh"
        if not routes or any(not k.startswith("route=graph") or want not in k for k in routes):
            fail(f"mesh loop {name}: a search left the graph route: {routes}")
        del got
    caps = {f"mesh={s.mesh} S={s.S} L={s.L} B0={s.B0} Bw={s.Bw} M={s.M} per_k={s.per_k} "
            f"moe={s.moe} engine={s.engine} f64={s.lp_f64} Gs={s.Gs} margin={s.has_margin} "
            f"warm={s.has_warm}": c for s, c in DL.CAPTURES.items()}
    print("mesh loop graph captures per signature", json.dumps(caps), flush=True)
    if any(c != 1 for c in DL.CAPTURES.values()) or not any(s.mesh == "row" for s in DL.CAPTURES) \
            or not any(s.mesh == "node" for s in DL.CAPTURES):
        fail(f"a mesh plan signature was captured more than once, or a mesh never: {caps}")
    # The graph's kernels a round of each mesh signature.
    for sig in DL.CAPTURES:
        with uncounted():
            before = dict(kernels.LAUNCHES)
            DL.count_graph_launches(sig, np.array([[0.0, 0.0, 0.0, 0.0, 3.0]]))
            per = {k: (v - before[k]) // 3 for k, v in kernels.LAUNCHES.items()
                   if v != before[k] and k not in ("bnb_graph", "bnb_seed", "bnb_answer",
                                                   "decomp", "decomp_theta", "decomp_bound")}
        print(f"mesh loop graph kernels a round (mesh={sig.mesh} S={sig.S} M={sig.M} "
              f"moe={sig.moe} engine={sig.engine} f64={sig.lp_f64} per_k={sig.per_k}) "
              f"{json.dumps(per)} ({sum(per.values())} graph kernel nodes)", flush=True)
    # Walls and search times, host loop against graph, in turns.
    for name, fn, reps, node in cases:
        walls = {"host": [], "graph": []}
        search = {"host": [], "graph": []}
        for rep in range(reps):
            for route in (("host", "graph") if rep % 2 == 0 else ("graph", "host")):
                tm: dict = {}
                with DL.host_loop() if route == "host" else contextlib.nullcontext():
                    wall = timed(lambda: fn(tm))[1]  # noqa: B023
                walls[route].append(tm.get("tick_wall_ms", wall))
                search[route].append(tm.get("solve_ms", float("nan")))
        with DL.host_loop():
            host_kl = kernel_launches(lambda: fn({}))  # noqa: B023
        graph_kl = kernel_launches(lambda: fn({}))  # noqa: B023
        line = {"case": name, "card": smi_line(), "reps": reps}
        for route in ("host", "graph"):
            line[route] = {"wall_ms_median": statistics.median(walls[route]),
                           "search_ms_median": statistics.median(search[route]),
                           "walls_ms": walls[route], "search_ms": search[route]}
        line["host"].update(runtime_launches=host_kl["runtime_launches"])
        line["graph"].update(runtime_launches=graph_kl["runtime_launches"],
                             graph_launches=graph_kl["wrappers"].get("bnb_graph", 0))
        print("mesh loop timing", json.dumps(line), flush=True)
        if graph_kl["runtime_launches"] != 0:
            fail(f"mesh loop {name}: the graph route made {graph_kl['runtime_launches']} "
                 f"runtime kernel launches a solve")


@contextlib.contextmanager
def recorded_loops(log: list):
    """Record each search's answer (the read-back vector) and final state
    inside the block: the graph route's from its plan's state buffer, the
    host loop's from ``run_bnb_loop`` (the node-sharded sweep's too, which
    calls it from ``search``)."""
    from distilp_torch.solver import backend_torch as BT
    from distilp_torch.solver import device_loop as DL
    from distilp_torch.solver import packed as PK
    from distilp_torch.solver import search as SR

    orig = (DL.LoopPlan.run_graph, BT.run_bnb_loop, PK.split_answer)

    def run_graph(self, entry):
        ans = orig[0](self, entry)
        log.append(("state", type(self.states[1])(*[t.clone() for t in self.states[1]])))
        return ans

    def run_loop(*a, **kw):
        state, root, lg = orig[1](*a, **kw)
        log.append(("state", type(state)(*[t.clone() for t in state])))
        return state, root, lg

    def split(ans, lay):
        log.append(("answer", ans.copy()))
        return orig[2](ans, lay)

    DL.LoopPlan.run_graph, BT.run_bnb_loop, BT.packed.split_answer = run_graph, run_loop, split
    SR.run_bnb_loop = run_loop
    try:
        yield log
    finally:
        DL.LoopPlan.run_graph, BT.run_bnb_loop, BT.packed.split_answer = orig
        SR.run_bnb_loop = orig[1]


def _memcpys(fn) -> dict:
    """Host-to-device and device-to-host copies the profiler sees in
    ``fn()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"HtoD": 0, "DtoH": 0, "DtoD": 0}
    for e in prof.events():
        if _is_device(e):
            for k in out:
                if f"Memcpy {k}" in e.name:
                    out[k] += 1
    return out


def _busy_ms(fn) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages() if _is_device(e)) / 1e3


PACKED_KERNELS = ("bnb_graph", "bnb_seed", "bnb_head", "bnb_control", "bnb_answer", "ipm")


def h2d_rate(nbytes: int = 64 << 20) -> float:
    """Bytes/s of one pinned host-to-device copy of ``nbytes`` (CUDA
    events, median of 5)."""
    import torch

    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), reps=5, warmup=2)
    return nbytes / (ms / 1e3)


def packed_bound(report: dict, fn, sig_rounds: int, blob_bytes: int, rate: float) -> dict:
    """The least time of one graph solve: its K1 and round-tail launches'
    bounds (``launch_bounds``, the same kernels on the same rows), the loop
    kernels' bounds per launch (phase 3's rows) times their launches, and
    the dynamic blob's bytes at the measured host-to-device rate."""
    with uncounted(), launch_bounds({}) as lb:
        fn()
    rounds = 1 + 2 * math.ceil(max(sig_rounds - 1, 0) / 2)
    loop = (report["bnb_seed"]["bound_ms"] + report["bnb_answer"]["bound_ms"]
            + rounds * report["bnb_head"]["bound_ms"]
            + (rounds + 1) * report["bnb_control"]["bound_ms"])
    upload = blob_bytes / rate * 1e3
    return {"kernels_ms": sum(lb.values()), "by_kernel": lb, "loop_kernels_ms": loop,
            "blob_bytes": blob_bytes, "h2d_bytes_s": rate, "upload_ms": upload,
            "bound_ms": sum(lb.values()) + loop + upload}


@contextlib.contextmanager
def graph_spans():
    """The device span (ms, CUDA events around the launch) of each loop
    graph launched inside the block, filled in when it ends. The profiler
    does not reliably see the kernels inside the WHILE body (it saw all,
    some or none of them across solves), so a graph solve's device time is
    the span of its graph launch: its kernels and the gaps between them on
    the card."""
    import torch

    from distilp_torch.kernels.build import library

    lib = library("bnb_loop")
    launch = lib.dtk_bnb_graph_launch
    events, spans = [], []

    def spanned(graph, stream):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        err = launch(graph, stream)
        b.record()
        events.append((a, b))
        return err

    lib.dtk_bnb_graph_launch = spanned
    try:
        yield spans
    finally:
        lib.dtk_bnb_graph_launch = launch
        torch.cuda.synchronize()
        spans.extend(a.elapsed_time(b) for a, b in events)


def packed_path(report: dict) -> dict:
    """The packed halves and the loop on the card: every dense IPM case
    solved on the graph route (one upload, one graph launch, one read) and
    again with the host loop (``device_loop.host_loop``), the answers and
    the final states held equal bit for bit, each solve's graph launches,
    copies and the graph captures per signature printed; then walls and
    busy shares of the two routes, in turns, medians of 9."""
    import statistics

    import numpy as np
    import torch

    from distilp_torch import kernels
    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.solver import (
        StreamingReplanner,
        halda_solve,
        halda_solve_async,
        halda_solve_per_k,
        halda_solve_scenarios,
        solve_batch,
    )
    from distilp_torch.solver import device_loop as DL
    from distilp_torch.solver import packed as PK
    from distilp_torch.utils import make_synthetic_fleet

    kernels.reset_launch_counts()
    DL.CAPTURES.clear()
    model = online_model()
    north = make_synthetic_fleet(16, seed=123)
    hermes = load_from_profile_folder(ROOT / "tests" / "profiles" / "hermes_70b")
    with uncounted():
        cold_north = halda_solve(north, model, mip_gap=1e-3, kv_bits="4bit")

    def replanner_ticks():
        planner = StreamingReplanner(mip_gap=STREAM_GAP, kv_bits="4bit")
        devs = make_synthetic_fleet(16, seed=123)
        rng = np.random.default_rng(7)
        out = []
        for t in range(9):
            if t:
                drift(devs, rng)
            out.append(planner.step(devs, model))
        return out

    lanes2 = [pack_lane(f, model, STREAM_GAP, M_pad=8, k_candidates=MIXED_KS)[0]
              for f in mixed_m_fleets()[:2]]
    cases = []
    for folder, _, _ in GOLDEN:
        devs, gm = load_from_profile_folder(ROOT / "tests" / "profiles" / folder)
        cases.append((f"golden {folder}", lambda d=devs, mm=gm: halda_solve(
            d, mm, mip_gap=1e-4, kv_bits="4bit")))
    cases += [
        ("north_star cold", lambda: halda_solve(north, model, mip_gap=1e-3, kv_bits="4bit")),
        ("north_star warm", lambda: halda_solve(north, model, mip_gap=1e-3, kv_bits="4bit",
                                                warm=cold_north)),
        ("per_k hermes_70b", lambda: halda_solve_per_k(*hermes, mip_gap=1e-3, kv_bits="4bit")),
        ("per_k north_star", lambda: halda_solve_per_k(north, model, mip_gap=1e-3,
                                                       kv_bits="4bit")),
        ("scenarios x8", lambda: halda_solve_scenarios(
            scenario_fleets(north, 8, 17), model, kv_bits="4bit", mip_gap=STREAM_GAP,
            warms=[cold_north] * 8)),
        ("two lanes with an A each", lambda: solve_batch(lanes2)),
        ("async north_star", lambda: halda_solve_async(north, model, mip_gap=1e-3,
                                                       kv_bits="4bit").collect()),
        ("replanner 9 ticks", replanner_ticks),
    ]
    moe = moe_packed_cases()
    cases += moe["cases"]
    pd = pdhg_packed_cases()
    cases += pd["cases"]
    for name, fn in cases:
        # A forced K5 route is a comparison of routes, not the path's own
        # work: its launches are left out of the path's counts.
        with uncounted() if name in pd["uncounted"] else contextlib.nullcontext():
            routes0 = dict(kernels.SHAPES["bnb_graph"])
            g0 = kernels.LAUNCHES["bnb_graph"]
            c0 = dict(PK.COPIES)
            graph_log: list = []
            with recorded_loops(graph_log):
                got = fn()
            torch.cuda.synchronize()
            n_graph = kernels.LAUNCHES["bnb_graph"] - g0
            h2d, d2h = PK.COPIES["h2d"] - c0["h2d"], PK.COPIES["d2h"] - c0["d2h"]
            routes = {k: v - routes0.get(k, 0) for k, v in kernels.SHAPES["bnb_graph"].items()
                      if v != routes0.get(k, 0)}
        host_log: list = []
        with uncounted(), DL.host_loop(), recorded_loops(host_log):
            fn()
        answers = [a for kind, a in graph_log if kind == "answer"]
        solves = len(answers)
        same_ans = len(answers) == len([a for k, a in host_log if k == "answer"]) and all(
            bits_equal(a, b) for a, b in zip(answers, [x for k, x in host_log if k == "answer"]))
        gs = [x for k, x in graph_log if k == "state"]
        hs = [x for k, x in host_log if k == "state"]
        diffs = [state_diff(a, b) for a, b in zip(gs, hs)]
        same_state = len(gs) == len(hs) and not any(diffs)
        print(f"packed {name}: {solves} solves, graph launches {n_graph}, host-to-device copies "
              f"{h2d}, device-to-host reads {d2h}; answers equal bit for bit: {same_ans}; "
              f"final states equal bit for bit: {same_state} {[d for d in diffs if d]}",
              flush=True)
        if not (same_ans and same_state) or n_graph != solves or d2h != solves:
            fail(f"packed {name}: the graph route differs from the host loop or did not run "
                 f"as one graph launch and one read a solve")
        if name.startswith("moe "):
            print(f"packed {name}: routes {json.dumps(routes)}", flush=True)
            if any(not k.startswith("route=graph moe_ipm") for k in routes):
                fail(f"packed {name}: a MoE solve left the graph route: {routes}")
        if name.startswith("pdhg "):
            print(f"packed {name}: routes {json.dumps(routes)}", flush=True)
            if not routes or any(not k.startswith(("route=graph dense_pdhg",
                                                   "route=graph moe_pdhg")) for k in routes):
                fail(f"packed {name}: a PDHG solve left the graph route: {routes}")
        del got
    caps = {f"L={s.L} B0={s.B0} Bw={s.Bw} M={s.M} per_k={s.per_k} warm={s.has_warm} "
            f"moe={s.moe} decomp_steps={s.decomp_steps} margin={s.has_margin} "
            f"engine={s.engine} f64={s.lp_f64} route={s.route}{s.C or ''} "
            f"duals={s.has_duals} m_y={s.want_my}": c
            for s, c in DL.CAPTURES.items()}
    print("packed graph captures per signature", json.dumps(caps), flush=True)
    if any(c != 1 for c in DL.CAPTURES.values()):
        fail(f"a plan signature was captured more than once: {caps}")
    # A static hit: one host-to-device copy (the dynamic blob) and one read.
    for name, fn in (("north_star warm", cases[5][1]), ("north_star cold", cases[4][1]),
                     *[(n, f) for n, f in pd["cases"] if n in pd["static_hit"]]):
        fn()
        c0 = dict(PK.COPIES)
        mc = _memcpys(fn)
        print(f"packed {name} on a static hit: host-to-device copies {PK.COPIES['h2d'] - c0['h2d']}"
              f" (profiler {mc['HtoD']}), device-to-host reads {PK.COPIES['d2h'] - c0['d2h']} "
              f"(profiler {mc['DtoH']}), device-to-device {mc['DtoD']}", flush=True)
        if PK.COPIES["h2d"] - c0["h2d"] != 1 or PK.COPIES["d2h"] - c0["d2h"] != 1:
            fail(f"packed {name}: a static hit made more than one upload or read")
    launches = path_launches()
    print("packed path launches", json.dumps(launches), flush=True)
    # Upload and search walls of each route (a static hit), and the graph
    # solve's bound.
    with uncounted():
        for route in ("host", "graph"):
            with DL.host_loop() if route == "host" else contextlib.nullcontext():
                r, ms, tm = solve(north, model, 1e-3)
            show(f"packed north_star_M16 route={route}", r, ms, tm)
        rate = h2d_rate()
        sf = lane_inputs([north], model, "4bit")[0].sf
        blob = PK.dyn_layout(1, len(sf.ks), sf.A.shape[1], sf.A.shape[2], sf.M, False, False,
                             False, False).nbytes
        b = packed_bound(report, lambda: halda_solve(north, model, mip_gap=1e-3, kv_bits="4bit"),
                         int(tm.get("bnb_rounds", 1)), blob, rate)
    print("packed bound north_star solve", json.dumps(b), flush=True)
    # Walls and busy shares, host loop against graph, in turns.
    planner = StreamingReplanner(mip_gap=STREAM_GAP, kv_bits="4bit")
    planner.step(north, model)
    tick_devs = [d.model_copy(deep=True) for d in north]
    drift(tick_devs, np.random.default_rng(7))
    scen = scenario_fleets(north, 8, 17)
    timing = [
        ("north_star solve", lambda: halda_solve(north, model, mip_gap=1e-3, kv_bits="4bit")),
        ("north_star warm tick", lambda: halda_solve(tick_devs, model, mip_gap=1e-3,
                                                     kv_bits="4bit", warm=planner.last)),
        ("scenarios x8", lambda: halda_solve_scenarios(scen, model, kv_bits="4bit",
                                                       mip_gap=STREAM_GAP,
                                                       warms=[cold_north] * 8)),
        ("per_k north_star", lambda: halda_solve_per_k(north, model, mip_gap=1e-3,
                                                       kv_bits="4bit")),
    ]
    with uncounted():
        for name, fn in timing:
            walls = {"host": [], "graph": []}
            with graph_spans() as spans:
                for rep in range(9):
                    for route in (("host", "graph") if rep % 2 == 0 else ("graph", "host")):
                        ctx = DL.host_loop() if route == "host" else contextlib.nullcontext()
                        with ctx:
                            walls[route].append(timed(fn)[1])
            span = statistics.median(spans)
            with DL.host_loop():
                busy = _busy_ms(fn)
            line = {"case": name}
            for route in ("host", "graph"):
                wall = statistics.median(walls[route])
                line[route] = {"wall_ms_median_of_9": wall, "walls_ms": walls[route],
                               "kernel_busy_ms": busy, "busy_share": busy / wall}
            line["graph"].update(device_span_ms=span, span_share=span / line["graph"][
                "wall_ms_median_of_9"])
            print("packed timing", json.dumps(line), flush=True)
    moe_packed_timing(moe)
    pdhg_packed_timing(pd)
    return launches


def moe_packed_cases() -> dict:
    """Path (j)'s MoE cases: Mixtral M=4 cold, per-k and over 4 load
    regimes as lanes, Qwen3-30B-A3B M=16, the DeepSeek-V3 flagship cold,
    warm (stored duals and hint, drifted fleet) and a replanner's cold,
    margin and margin ticks; and the fleets and the flagship's cold result
    for the timing."""
    import warnings

    import numpy as np
    import torch

    from distilp_torch.solver import StreamingReplanner, halda_solve, halda_solve_per_k
    from distilp_torch.utils import make_synthetic_fleet

    def fleet(case):
        _, config, M, seed, pool, _ = case
        return make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool)), moe_model(config)

    mdevs, mmodel = fleet(MOE_CASES[0])
    qdevs, qmodel = fleet(MOE_CASES[2])
    fdevs, fmodel = fleet(FLAGSHIP)
    kw = dict(mip_gap=MOE_GAP, kv_bits="8bit")
    with uncounted():
        fcold = halda_solve(fdevs, fmodel, **kw)
    torch.cuda.synchronize()
    fdrift = [d.model_copy() for d in fdevs]
    drift(fdrift, np.random.default_rng(3))

    def flagship_ticks():
        planner = StreamingReplanner(**kw)
        devs = [d.model_copy() for d in fdevs]
        rng = np.random.default_rng(7)
        out = []
        for t in range(3):
            if t:
                drift(devs, rng)
            out.append(planner.step(devs, fmodel))
        if planner.last_tick_mode != "margin":
            fail(f"the flagship's third tick was {planner.last_tick_mode}, not a margin tick")
        return out

    def quiet(fn):
        def run():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return fn()
        return run

    cases = [
        ("moe mixtral_M4 cold", lambda: halda_solve(mdevs, mmodel, **kw)),
        ("moe mixtral_M4 per_k", quiet(lambda: halda_solve_per_k(mdevs, mmodel, **kw))),
        ("moe qwen3_30b_a3b_M16 cold", lambda: halda_solve(qdevs, qmodel, **kw)),
        ("moe flagship cold", lambda: halda_solve(fdevs, fmodel, **kw)),
        ("moe flagship warm", lambda: halda_solve(fdrift, fmodel, warm=fcold, **kw)),
        ("moe flagship ticks cold margin margin", flagship_ticks),
        ("moe mixtral_M4 x4 lanes", lambda: mixtral_regimes_solve(mmodel)),
    ]
    return dict(cases=cases, mixtral=(mdevs, mmodel), qwen=(qdevs, qmodel),
                flagship=(fdevs, fmodel, fcold, fdrift))


def moe_packed_timing(moe: dict) -> None:
    """Path (j)'s MoE walls: each case solved on the host loop and on the
    graph in turns (9 each), median wall and search time (``solve_ms``) of
    each route, the host loop's kernel busy time and share (profiler) and
    the graph launch's device span (CUDA events); then one solve's runtime
    kernel launches on each route and the graph's kernels a round."""
    import statistics

    import numpy as np

    from distilp_torch import kernels
    from distilp_torch.solver import StreamingReplanner, halda_solve
    from distilp_torch.solver import device_loop as DL

    mdevs, mmodel = moe["mixtral"]
    qdevs, qmodel = moe["qwen"]
    fdevs, fmodel, fcold, fdrift = moe["flagship"]
    kw = dict(mip_gap=MOE_GAP, kv_bits="8bit")
    planner = StreamingReplanner(**kw)
    tick = [d.model_copy() for d in fdevs]
    with uncounted():
        planner.step(tick, fmodel)
    drift(tick, np.random.default_rng(7))
    modes = []

    def margin_tick(tm):
        r = planner.step(tick, fmodel, timings=tm)
        modes.append(planner.last_tick_mode)
        return r

    timing = [
        ("mixtral_M4 cold", lambda tm: halda_solve(mdevs, mmodel, timings=tm, **kw)),
        ("qwen3_30b_a3b_M16 cold", lambda tm: halda_solve(qdevs, qmodel, timings=tm, **kw)),
        ("flagship cold", lambda tm: halda_solve(fdevs, fmodel, timings=tm, **kw)),
        ("flagship warm", lambda tm: halda_solve(fdrift, fmodel, warm=fcold, timings=tm, **kw)),
        ("flagship margin tick", margin_tick),
    ]
    with uncounted():
        for name, fn in timing:
            walls = {"host": [], "graph": []}
            search = {"host": [], "graph": []}
            with graph_spans() as spans:
                for rep in range(9):
                    for route in (("host", "graph") if rep % 2 == 0 else ("graph", "host")):
                        tm: dict = {}
                        with DL.host_loop() if route == "host" else contextlib.nullcontext():
                            walls[route].append(timed(lambda: fn(tm))[1])  # noqa: B023
                        search[route].append(tm.get("solve_ms", float("nan")))
            span = statistics.median(spans)
            with DL.host_loop():
                busy = _busy_ms(lambda: fn({}))  # noqa: B023
                host_kl = kernel_launches(lambda: fn({}))  # noqa: B023
            graph_kl = kernel_launches(lambda: fn({}))  # noqa: B023
            tm = {}
            fn(tm)
            line = {"case": name, "card": smi_line(), "rounds": tm.get("bnb_rounds"),
                    "decomp_steps": tm.get("decomp_steps")}
            for route in ("host", "graph"):
                wall = statistics.median(walls[route])
                line[route] = {"wall_ms_median_of_9": wall, "walls_ms": walls[route],
                               "search_ms_median_of_9": statistics.median(search[route]),
                               "search_ms": search[route]}
            line["host"].update(kernel_busy_ms=busy, busy_share=busy / line["host"][
                "wall_ms_median_of_9"], runtime_launches=host_kl["runtime_launches"],
                device_kernels=host_kl["device_kernels"])
            line["graph"].update(device_span_ms=span, span_share=span / line["graph"][
                "wall_ms_median_of_9"], runtime_launches=graph_kl["runtime_launches"],
                graph_launches=graph_kl["wrappers"].get("bnb_graph", 0))
            print("packed moe timing", json.dumps(line), flush=True)
    if any(m != "margin" for m in modes):
        fail(f"the timed flagship ticks were not all margin ticks: {modes}")
    # A MoE round in the graph: the head, K1, K2's MoE mode, the round tail
    # and the control (count_graph_launches' account of one round).
    sig = next(s for s in DL.CAPTURES if s.moe and s.L == 1 and not s.per_k)
    with uncounted():
        before = dict(kernels.LAUNCHES)
        DL.count_graph_launches(sig._replace(decomp_steps=0, has_margin=True, has_warm=False),
                                np.array([[0.0, 0.0, 0.0, 0.0, 3.0]]))
        per = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    per_round = {k: v // 3 for k, v in per.items()
                 if k in ("bnb_head", "ipm", "round_moe", "round_tail", "bnb_control")}
    print(f"packed moe graph kernels a round {json.dumps(per_round)} "
          f"({sum(per_round.values())} graph kernel nodes)", flush=True)


def pdhg_packed_cases() -> dict:
    """Path (j)'s PDHG cases, each a solve through the user's entry point:
    the 128-device fleet (the default engine at M >= 128; K5's cluster
    route) in float32, with pdhg_dtype='f64' and under a forced grid route,
    the 512-device fleet at gap 0.05 (C=4), the north star with
    lp_backend='pdhg' cold, warm and per k, the two 128-device lanes with an
    A each, the 128-device scenario fallback, Mixtral M=4 and Qwen3-30B-A3B
    M=16 with lp_backend='pdhg'. ``uncounted`` names the forced-route case,
    ``static_hit`` those held to one upload and one read on a static hit,
    ``timing`` (name, fn(timings), reps) the cases timed in turns."""
    from distilp_torch.solver import halda_solve, halda_solve_per_k, halda_solve_scenarios
    from distilp_torch.solver import device_loop as DL
    from distilp_torch.solver import solve_batch
    from distilp_torch.utils import make_synthetic_fleet

    model128, devs128 = online_model(128), make_synthetic_fleet(128, seed=123)
    model512, devs512 = online_model(512), make_synthetic_fleet(512, seed=123)
    model, north = online_model(), make_synthetic_fleet(16, seed=123)
    mix, qwen = MOE_PDHG_CASES
    mdevs = make_synthetic_fleet(mix[2], seed=mix[3], pool_bytes=int(mix[4]))
    qdevs = make_synthetic_fleet(qwen[2], seed=qwen[3], pool_bytes=int(qwen[4]))
    mmodel, qmodel = moe_model(mix[1]), moe_model(qwen[1])
    # The warm case's hint, from the host loop (bit for bit the graph's
    # answer): a capture here would be evicted from the plans' LRU before
    # the cold case solves again, and captured twice.
    with uncounted(), DL.host_loop():
        cold_north = halda_solve(north, model, mip_gap=1e-3, kv_bits="4bit", lp_backend="pdhg")
    insts = [pack_lane(make_synthetic_fleet(128, seed=s), model128, FLEET128_GAP)[0]
             for s, _ in LANES128]
    futures = [devs128, doubled_cpu_table(devs128)]
    f128 = dict(mip_gap=FLEET128_GAP, kv_bits="4bit")
    dense = dict(mip_gap=1e-3, kv_bits="4bit", lp_backend="pdhg")
    moe = dict(mip_gap=MOE_GAP, kv_bits="8bit", lp_backend="pdhg")

    def grid(tm=None):
        with forced_route("grid"):
            return halda_solve(devs128, model128, timings=tm, **f128)

    timing = [
        ("fleet_M128", lambda tm=None: halda_solve(devs128, model128, timings=tm, **f128), 9),
        ("fleet_M128 f64", lambda tm=None: halda_solve(devs128, model128, pdhg_dtype="f64",
                                                       timings=tm, **f128), 9),
        ("fleet_M128 grid", grid, 9),
        ("fleet_M512", lambda tm=None: halda_solve(devs512, model512, mip_gap=FLEET512_GAP,
                                                   kv_bits="4bit", timings=tm), 3),
        ("north_star cold", lambda tm=None: halda_solve(north, model, timings=tm, **dense), 9),
        ("north_star warm", lambda tm=None: halda_solve(north, model, warm=cold_north,
                                                        timings=tm, **dense), 9),
        ("north_star per_k", lambda tm=None: halda_solve_per_k(north, model, timings=tm,
                                                               **dense), 9),
        ("lanes fleet_M128 x2", lambda tm=None: solve_batch(insts, timings=tm), 9),
        ("scenario fallback fleet_M128", lambda tm=None: halda_solve_scenarios(
            futures, model128, timings=tm, **f128), 9),
        ("mixtral_M4", lambda tm=None: halda_solve(mdevs, mmodel, timings=tm, **moe), 9),
        ("qwen3_30b_a3b_M16", lambda tm=None: halda_solve(qdevs, qmodel, timings=tm, **moe), 9),
    ]
    cases = [(f"pdhg {n}", fn) for n, fn, _ in timing]
    return dict(cases=cases, timing=timing, uncounted={"pdhg fleet_M128 grid"},
                static_hit={"pdhg fleet_M128", "pdhg fleet_M128 f64"},
                fleet=(devs128, model128))


def pdhg_packed_timing(pd: dict) -> None:
    """Path (j)'s PDHG walls: each case on the host loop and on the graph in
    turns (medians of 9; the 512-device fleet of 3), wall, upload and
    search time (``upload_ms``, ``solve_ms``) of each route, the host
    loop's kernel busy time and share (profiler) and the graph launch's
    device span (CUDA events: the profiler does not reliably see a WHILE
    body's kernels); then one solve's runtime kernel launches on each route
    (the graph route must make none) and the graph's kernels a round."""
    import statistics

    import numpy as np

    from distilp_torch import kernels
    from distilp_torch.solver import device_loop as DL

    with uncounted():
        for name, fn, reps in pd["timing"]:
            walls = {"host": [], "graph": []}
            search = {"host": [], "graph": []}
            upload = {"host": [], "graph": []}
            with graph_spans() as spans:
                for rep in range(reps):
                    for route in (("host", "graph") if rep % 2 == 0 else ("graph", "host")):
                        tm: dict = {}
                        with DL.host_loop() if route == "host" else contextlib.nullcontext():
                            walls[route].append(timed(lambda: fn(tm))[1])  # noqa: B023
                        search[route].append(tm.get("solve_ms", float("nan")))
                        upload[route].append(tm.get("upload_ms", float("nan")))
            span = statistics.median(spans)
            with DL.host_loop():
                busy = _busy_ms(lambda: fn({}))  # noqa: B023
                host_kl = kernel_launches(lambda: fn({}))  # noqa: B023
            graph_kl = kernel_launches(lambda: fn({}))  # noqa: B023
            tm = {}
            fn(tm)
            line = {"case": name, "card": smi_line(), "reps": reps,
                    "rounds": tm.get("bnb_rounds"), "lp_backend": tm.get("lp_backend")}
            for route in ("host", "graph"):
                wall = statistics.median(walls[route])
                line[route] = {"wall_ms_median": wall, "walls_ms": walls[route],
                               "search_ms_median": statistics.median(search[route]),
                               "upload_ms_median": statistics.median(upload[route]),
                               "search_ms": search[route]}
            line["host"].update(kernel_busy_ms=busy, busy_share=busy / line["host"][
                "wall_ms_median"], runtime_launches=host_kl["runtime_launches"],
                device_kernels=host_kl["device_kernels"])
            line["graph"].update(device_span_ms=span, span_share=span / line["graph"][
                "wall_ms_median"], runtime_launches=graph_kl["runtime_launches"],
                graph_launches=graph_kl["wrappers"].get("bnb_graph", 0))
            print("packed pdhg timing", json.dumps(line), flush=True)
            if graph_kl["runtime_launches"] != 0:
                fail(f"packed pdhg {name}: the graph route made "
                     f"{graph_kl['runtime_launches']} runtime kernel launches a solve")
    # A PDHG round in the graph: the head, K5, (f64) the cast, the round
    # tail and the control (count_graph_launches' account of one round).
    for sig in [s for s in DL.CAPTURES if s.engine == "pdhg" and s.L == 1 and not s.per_k
                and not s.moe and s.M == 128]:
        with uncounted():
            before = dict(kernels.LAUNCHES)
            DL.count_graph_launches(sig, np.array([[0.0, 0.0, 0.0, 0.0, 3.0]]))
            per = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
        per_round = {k: v // 3 for k, v in per.items()
                     if k in ("bnb_head", "pdhg", "bnb_cast", "round_tail", "bnb_control")}
        print(f"packed pdhg graph kernels a round (M=128 route={sig.route}{sig.C or ''} "
              f"f64={sig.lp_f64}) {json.dumps(per_round)} "
              f"({sum(per_round.values())} graph kernel nodes)", flush=True)


# ------------------------------------------------------------ serve (path k)

SERVE_GAP = 1e-3
# The JAX package's Makefile smokes (smoke-chaos, smoke-spec, smoke-twin):
# Llama-3-70B online on synthetic fleet 4 (seed 11), k in {8, 10}.
SERVE_SMOKE = ["--profile", "tests/profiles/llama_3_70b/online", "--synthetic-fleet", "4",
               "--fleet-seed", "11", "--k-candidates", "8,10", "--quiet"]
SERVE_CHAOS = ["serve", "--trace", "tests/traces/scheduler_smoke_20.jsonl", *SERVE_SMOKE,
               "--fault-plan", "tests/traces/chaos_plan.json", "--deadline-ms", "60000",
               "--max-retries", "2", "--breaker-threshold", "2", "--chaos-check"]
SERVE_KERNELS = ("ipm", "round_tail", "round_tail_lanes", "bnb_graph", "twin_mc",
                 "round_moe", "decomp")


def serve_summary(out: str) -> dict:
    """The summary JSON line a ``serve`` run printed."""
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if not lines:
        fail(f"serve printed no summary line:\n{out[-2000:]}")
    return json.loads(lines[-1])


def quantiles(xs) -> dict:
    import numpy as np

    return {"n": len(xs), "p50_ms": float(np.percentile(xs, 50)),
            "p99_ms": float(np.percentile(xs, 99))}


def serve_path() -> dict:
    """The scheduler daemon on the card: the JAX package's Makefile smokes
    through the port's ``serve`` (the chaos soak with and without
    ``--speculate``, the speculation smoke, the risk-aware smoke); the
    north star's 40-event mixed replay in process with speculation and
    risk-aware scoring (tick walls by mode, spec hits, risk evaluations,
    graph launches and uploads a tick; every structural tick and the last
    held against a one-shot solve; the state dumped and resumed warm); and
    the Mixtral M=4 replay whose drift ticks ride the margin path."""
    import numpy as np

    from distilp_torch import kernels
    from distilp_torch.profiler import profile_model
    from distilp_torch.sched import (
        DeviceDegrade,
        LoadTick,
        Scheduler,
        generate_trace,
        is_structural,
        replay,
    )
    from distilp_torch.solver import halda_solve
    from distilp_torch.solver import packed as PK
    from distilp_torch.utils import make_synthetic_fleet

    kernels.reset_launch_counts()
    PK.reset_counts()
    cli = "distilp_torch.cli.solver_cli"
    child: dict = {}
    walls = {}
    for name, extra in (("chaos", []), ("chaos --speculate", ["--speculate"])):
        rc, out, err, walls[name] = run_cli(cli, SERVE_CHAOS + extra, child)
        ok = [ln for ln in out.splitlines() if ln.startswith("chaos soak OK")]
        print(f"serve {name}: {ok[0] if ok else err[-2000:]}", flush=True)
        if rc != 0 or not ok or "9 fault(s) injected, 4 quarantined" not in ok[0]:
            fail(f"serve {name}: exit {rc}, chaos line {ok}")
    rc, out, err, walls["spec"] = run_cli(cli, [
        "serve", "--trace", "tests/traces/spec_burst.jsonl", *SERVE_SMOKE, "--speculate",
        "--fail-uncertified"], child)
    s = serve_summary(out) if rc == 0 else {}
    sp, rp = s.get("speculation", {}), s.get("replay", {})
    print(f"serve spec_burst: speculation {json.dumps(sp)} replay {json.dumps(rp)}", flush=True)
    if (rc != 0 or sp.get("hits", 0) <= 0 or sp["hits"] + sp["misses"] > rp["events"]
            or rp["failed_ticks"] or rp["structural_uncertified"]):
        fail(f"serve speculation smoke: exit {rc} {err[-2000:]}")
    rc, out, err, walls["risk"] = run_cli(cli, [
        "serve", "--trace", "tests/traces/scheduler_smoke_20.jsonl", *SERVE_SMOKE,
        "--risk-aware"], child)
    risk = serve_summary(out).get("risk", {}) if rc == 0 else {}
    print(f"serve risk-aware: {json.dumps(risk)}", flush=True)
    if rc != 0 or risk.get("switches", 0) < 1 or risk.get("errors"):
        fail(f"serve risk-aware smoke: exit {rc} {risk} {err[-2000:]}")
    print("serve cli walls_s", json.dumps(walls), flush=True)

    # The north star, in process: 40 mixed churn events.
    model = online_model()
    fleet = make_synthetic_fleet(16, seed=123)
    trace = generate_trace("mixed", 40, seed=23, base_fleet=fleet)
    sched = Scheduler([d.model_copy(deep=True) for d in fleet], model, mip_gap=SERVE_GAP,
                      kv_bits="4bit", speculative=True, risk_aware=True)
    ticks: list = []
    last = {"graph": 0, "h2d": 0}

    def on_event(ev, view, ms):
        planner = sched.pool.peek(view.key)
        graph, h2d = kernels.LAUNCHES["bnb_graph"], PK.COPIES["h2d"]
        ticks.append({"kind": ev.kind, "mode": view.mode, "ms": ms,
                      "graph": graph - last["graph"], "h2d": h2d - last["h2d"],
                      "structural": is_structural(ev), "certified": view.result.certified,
                      "solved": planner.last if planner is not None else None,
                      "devs": [d.model_copy(deep=True) for d in sched.fleet.device_list()]})
        last.update(graph=graph, h2d=h2d)

    report = replay(sched, trace, on_event=on_event)
    if report.failed_ticks or any(v.events_behind for v in report.views):
        fail(f"serve north star: {report.failed_ticks} failed ticks, stale views")
    by_mode: dict = {}
    for t in ticks:
        by_mode.setdefault(t["mode"], []).append(t["ms"])
    c = sched.metrics.counters
    line = {
        "ticks": len(ticks), "walls_by_mode": {m: quantiles(v) for m, v in by_mode.items()},
        "speculation": sched.speculation_snapshot(),
        "risk": {"evals": c.get("risk_eval", 0), "candidates": c.get("risk_candidates", 0),
                 "switches": c.get("risk_switch", 0), "errors": c.get("risk_error", 0)},
        "graph_launches_per_tick": {m: float(np.mean([t["graph"] for t in ticks
                                                      if t["mode"] == m])) for m in by_mode},
        "h2d_per_tick": {m: float(np.mean([t["h2d"] for t in ticks if t["mode"] == m]))
                         for m in by_mode},
        "replay": report.summary(),
    }
    print("serve north_star", json.dumps(line), flush=True)
    if c.get("risk_eval", 0) != len(trace) or c.get("risk_error", 0):
        fail(f"serve north star: risk scoring {line['risk']}")
    held = [i for i, t in enumerate(ticks) if t["structural"]] + [len(ticks) - 1]
    with uncounted():
        for i in held:
            t = ticks[i]
            ref = halda_solve(t["devs"], model, mip_gap=SERVE_GAP, kv_bits="4bit")
            held_to(f"serve north_star tick {i} ({t['kind']}, {t['mode']})", t["solved"],
                    ref.obj_value, SERVE_GAP)
    # A snapshot of the daemon resumes warm in a new one.
    blob = json.loads(json.dumps(sched.dump_state()))
    resumed = Scheduler(fleet, model, mip_gap=SERVE_GAP, kv_bits="4bit", speculative=True,
                        risk_aware=True)
    resumed.load_state(blob)
    view = resumed.handle(LoadTick(t_comm_jitter={}))
    print(f"serve north_star resumed: mode {view.mode} certified {view.result.certified} "
          f"warm_resumes {resumed.metrics.counters.get('warm_resumes', 0)}", flush=True)
    if resumed.metrics.counters.get("warm_resumes", 0) != 1 or not view.result.certified:
        fail("serve north star: the restored daemon did not resume warm")

    # Mixtral 8x7B on 4 devices: drift ticks on the margin path (K7, K2 MoE).
    moe_model = profile_model(str(ROOT / "tests" / "configs" / "mixtral_8x7b.json"),
                              batch_sizes=[1], sequence_length=128).to_model_profile()
    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    sched = Scheduler(devs, moe_model, mip_gap=SERVE_GAP, kv_bits="8bit")
    names = [d.name for d in devs]
    modes = []
    for name, scale in ((names[1], 1.01), (names[2], 1.03), (names[2], 0.98)):
        view, ms = timed(lambda: sched.handle(DeviceDegrade(name=name, t_comm_scale=scale)))
        modes.append(view.mode)
        print(f"serve mixtral_M4 tick: mode {view.mode} wall_ms {ms:.2f} k {view.result.k} "
              f"objective {view.result.obj_value!r} certified {view.result.certified} "
              f"sum(y) {sum(view.result.y or [])}", flush=True)
        if not view.result.certified or view.result.y is None:
            fail(f"serve mixtral_M4: uncertified or dense tick {view.mode}")
    if modes[1:] != ["margin", "margin"] or sched.metrics.counters["drift_tick_margin"] != 2:
        fail(f"serve mixtral_M4: drift ticks did not ride the margin path: {modes}")
    launches = path_launches(child)
    print("serve path launches", json.dumps(launches), flush=True)
    missing = [k for k in SERVE_KERNELS if not launches.get(k)]
    if missing:
        fail(f"serve path never launched {missing}")
    return launches


# ---------------------------------------------------------- gateway (path l)

# The JAX package's Makefile smokes of the gateway tier (smoke-gateway,
# smoke-crash) through the port's ``serve``: 10 fleets of 3-4 devices,
# Llama-3-70B online, k in {8, 10}.
GATEWAY_SMOKE = ["serve", "--trace", "tests/traces/gateway_smoke_10f.jsonl", "--profile",
                 "tests/profiles/llama_3_70b/online", "--workers", "2", "--k-candidates",
                 "8,10", "--quiet"]
CRASH_SMOKE = ["serve", "--trace", "tests/traces/scheduler_smoke_20.jsonl", *SERVE_SMOKE,
               "--worker-backend", "process", "--supervise", "--snapshot-every", "4",
               "--fault-plan", "tests/traces/crash_plan.json", "--chaos-check"]
# The in-process gateway at full width: 8 fleets of 16 devices (the north
# star's fleet, seeds 123..130), 2 thread workers, combiner on.
GATEWAY_FLEETS = 8
GATEWAY_M = 16
GATEWAY_KERNELS = ("ipm", "round_tail", "round_tail_lanes", "bnb_graph", "bnb_seed",
                   "bnb_head", "bnb_control", "bnb_answer")
# The whole path gets this long; past it the script dumps every thread's
# stack and the card's utilization, then exits non-zero (a solve that never
# returns must not hold the card until the call's limit).
GATEWAY_LIMIT_S = 400


def gpu_utilization() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=utilization.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def _summary_file(path: Path) -> dict:
    return json.loads(path.read_text()) if path.is_file() else {}


def smoke_gateway(tmp: Path) -> dict:
    """(a) smoke-gateway: uninterrupted, snapshot + halt at 15, resume;
    the placements identical, the resumed shards warm, no cold re-solve."""
    launches: dict = {}
    walls = {}
    full, res = tmp / "full.json", tmp / "resumed.json"
    runs = (
        ("full", ["--fail-uncertified", "--metrics-out", str(full)]),
        ("halt", ["--snapshot-dir", str(tmp / "snap"), "--snapshot-at", "15",
                  "--halt-after-snapshot"]),
        ("resume", ["--fail-uncertified", "--snapshot-dir", str(tmp / "snap"), "--resume",
                    "--metrics-out", str(res)]),
    )
    for name, extra in runs:
        rc, _, err, walls[name] = run_cli("distilp_torch.cli.solver_cli",
                                          GATEWAY_SMOKE + extra, launches)
        if rc != 0:
            return {"error": f"smoke-gateway {name}: exit {rc} {err[-2000:]}"}
    a, b = _summary_file(full), _summary_file(res)
    g = b.get("gateway", {})
    line = {"walls_s": walls, "fleets": g.get("fleets"), "warm_resumes": g.get("warm_resumes"),
            "cold_resumes": g.get("cold_resumes"), "tick_cold": g.get("tick_cold"),
            "identical": a.get("final_placements") == b.get("final_placements"),
            "replay_full": a.get("replay"), "replay_resumed": b.get("replay")}
    ok = (line["identical"] and (g.get("warm_resumes") or 0) > 0
          and g.get("cold_resumes") == 0 and g.get("tick_cold") == 0)
    return {"line": line, "launches": launches,
            "error": None if ok else f"smoke-gateway contract: {json.dumps(line)}"}


def smoke_gateway_chaos() -> dict:
    """(a) continued: the chaos soak of smoke-chaos with --workers 2."""
    launches: dict = {}
    rc, out, err, wall = run_cli("distilp_torch.cli.solver_cli",
                                 SERVE_CHAOS + ["--workers", "2"], launches)
    ok = [ln for ln in out.splitlines() if ln.startswith("chaos soak OK")]
    good = rc == 0 and ok and "9 fault(s) injected, 4 quarantined" in ok[0]
    return {"line": {"wall_s": wall, "chaos": ok[0] if ok else None}, "launches": launches,
            "error": None if good else f"chaos soak --workers 2: exit {rc} {ok} {err[-2000:]}"}


def smoke_crash(tmp: Path, engine: str) -> dict:
    """(b) smoke-crash on one LP engine: supervised process workers, two
    child kills and a stalled RPC; each recovery's MTTR, each child's start
    and the nvcc runs of every child (none: they load the parent's
    kernels)."""
    launches: dict = {}
    out_json = tmp / f"crash_{engine}.json"
    rc, out, err, wall = run_cli("distilp_torch.cli.solver_cli", CRASH_SMOKE + [
        "--lp-backend", engine, "--recovery-dir", str(tmp / f"rec_{engine}"),
        "--metrics-out", str(out_json)], launches)
    s = _summary_file(out_json)
    rec = s.get("recovery", {})
    procs = s.get("gateway", {}).get("process_workers", [])
    ok = [ln for ln in out.splitlines() if ln.startswith("chaos soak OK")]
    nvcc = sorted({v for p in procs for v in p.get("nvcc_runs", {}).values()})
    line = {"engine": engine, "wall_s": wall, "chaos": ok[0] if ok else None,
            "mttr_ms": [r["mttr_ms"] for r in rec.get("recoveries", [])],
            "child_start_ms": [p["start_ms"] for p in procs], "child_nvcc_runs": nvcc,
            "events_lost": rec.get("events_lost"), "cold_resumes": rec.get("cold_resumes")}
    good = (rc == 0 and ok and "crash contract OK" in ok[0] and procs and nvcc == [0]
            and rec.get("worker_crashes", 0) >= 2 and rec.get("events_lost") == 0)
    return {"line": line, "launches": launches,
            "error": None if good else f"smoke-crash {engine}: exit {rc} {json.dumps(line)} "
                                       f"{err[-2000:]}"}


def _gateway_events(fleets: dict, j: int) -> dict:
    """One drift event per fleet: device (3j + 1) mod M slows its links."""
    from distilp_torch.sched import DeviceDegrade

    return {f: DeviceDegrade(name=devs[(3 * j + 1) % len(devs)].name,
                             t_comm_scale=1.0 + 0.03 * (j + 1)) for f, devs in fleets.items()}


def _drive(gw, fleets: dict, rounds, walls=None) -> None:
    """Every fleet's events of ``rounds`` submitted at once (asyncio
    ingest); per-fleet order is submission order."""
    import asyncio

    async def one(f, ev):
        t = time.perf_counter()
        await gw.handle_event_async(f, ev)
        if walls is not None:
            walls.append((time.perf_counter() - t) * 1e3)

    async def main():
        evs = [(f, ev) for j in rounds for f, ev in _gateway_events(fleets, j).items()]
        await asyncio.gather(*(one(f, ev) for f, ev in evs))

    asyncio.run(main())


def combined_gateway(model) -> dict:
    """(c) The thread-backend gateway at full width with the combiner on:
    a concurrent per-fleet warm-up (two workers solving at once), then
    ``warm_combine``, then two drift bursts of 5 events per fleet submitted
    together; against a combine-off gateway on the same events and a
    one-shot solve per fleet."""
    import numpy as np
    import torch

    from distilp_torch import kernels
    from distilp_torch.combine import BucketPolicy
    from distilp_torch.gateway import Gateway, make_fleet_from_spec
    from distilp_torch.solver import device_loop, halda_solve
    from distilp_torch.solver import packed as PK

    specs = {f"g{i}": {"m": GATEWAY_M, "seed": 123 + i} for i in range(GATEWAY_FLEETS)}
    fleets = {f: make_fleet_from_spec(f, s) for f, s in specs.items()}
    kw = dict(mip_gap=SERVE_GAP, kv_bits="4bit")
    policy = BucketPolicy(max_wait_ms=50.0)
    out: dict = {}
    finals: dict = {}
    for combine in (True, False):
        gw = Gateway(n_workers=2, scheduler_kwargs=kw)
        try:
            for f in fleets:
                gw.register_fleet(f, [d.model_copy(deep=True) for d in fleets[f]], model)
            t = time.perf_counter()
            _drive(gw, fleets, range(0, 2))  # the cold tick, then a warm one
            torch.cuda.synchronize()
            warmup_s = time.perf_counter() - t
            print(f"gateway combined={combine}: warm-up {warmup_s:.2f} s", flush=True)
            gw.configure_admission(coalesce=True, combine=combine,
                                   combine_policy=policy if combine else None)
            warm = gw.warm_combine() if combine else None
            caps0 = sum(device_loop.CAPTURES.values())
            graph0, h2d0 = kernels.LAUNCHES["bnb_graph"], PK.COPIES["h2d"]
            walls: list = []
            for burst in (range(2, 7), range(7, 12)):
                _drive(gw, fleets, burst, walls)
                print(f"gateway combined={combine}: burst {burst.start}-{burst.stop - 1} done",
                      flush=True)
            torch.cuda.synchronize()
            snap = gw.metrics_snapshot()
            finals[combine] = {f: gw.latest(f) for f in fleets}
            devs = {f: gw.read_shard(f, lambda s: s.fleet.device_list()) for f in fleets}
            c, totals = snap["counters"], snap["shard_totals"]
            lat = snap["latency"].get("combine_batch_ms", {})
            batches = c.get("combine_batches", 0)
            line = {
                "combine": combine, "warmup_s": warmup_s, "warm_combine": warm,
                "captures_in_bursts": sum(device_loop.CAPTURES.values()) - caps0,
                "batches": batches, "instances": c.get("combine_instances", 0),
                "lanes_per_dispatch": c.get("combine_instances", 0) / batches if batches else None,
                "combine_local": totals.get("combine_local", 0),
                "combine_fallback": totals.get("combine_fallback", 0),
                "dispatch_errors": c.get("combine_dispatch_error", 0),
                "flush_ms_p50": lat.get("p50_ms"), "flush_ms_p99": lat.get("p99_ms"),
                "event_ms": quantiles(walls) if walls else None,
                "graph_launches_per_batch": ((kernels.LAUNCHES["bnb_graph"] - graph0) / batches
                                             if batches else None),
                "h2d_per_batch": (PK.COPIES["h2d"] - h2d0) / batches if batches else None,
                "tick_failed": totals.get("tick_failed", 0),
            }
        finally:
            gw.close()
        print(f"gateway combined {json.dumps(line)}", flush=True)
        out["combine" if combine else "plain"] = line
        if combine:
            if not batches or line["lanes_per_dispatch"] <= 1:
                fail(f"gateway combined: no lanes shared a dispatch: {line}")
            if line["combine_local"] or line["combine_fallback"] or line["dispatch_errors"]:
                fail(f"gateway combined: ticks fell back or dispatches raised: {line}")
            if line["captures_in_bursts"]:
                fail(f"gateway combined: {line['captures_in_bursts']} graph captures after "
                     f"warm_combine")
            with uncounted():
                for f in fleets:
                    ref = halda_solve(devs[f], model, mip_gap=SERVE_GAP, kv_bits="4bit")
                    held_to(f"gateway combined {f} ({finals[True][f].mode})",
                            finals[True][f].result, ref.obj_value, SERVE_GAP)
        if line["tick_failed"]:
            fail(f"gateway {'combined' if combine else 'plain'}: failed ticks {line}")
    for f in fleets:
        a, b = finals[True][f].result, finals[False][f].result
        if (a.k, a.w, a.n) != (b.k, b.w, b.n):
            fail(f"gateway combined {f}: (k, w, n) {(a.k, a.w, a.n)} != combine-off "
                 f"{(b.k, b.w, b.n)}")
    print(f"gateway combined: every fleet's final (k, w, n) equals the combine-off "
          f"gateway's, {float(np.mean([finals[True][f].result.obj_value for f in fleets]))!r} mean "
          f"objective", flush=True)
    return out


def _http(port: int, path: str, body=None, accept=None):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="POST" if body is not None else "GET",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Accept": accept} if accept else {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def http_gateway(model) -> dict:
    """(d) ``GatewayHTTPServer`` on 127.0.0.1:0 over a two-fleet gateway on
    the card: the routes answer; at ``max_queue_depth=1`` a post gets 429
    with a parseable Retry-After, ordered by the worker's observed queue
    depth (the first post's solve is held in the scheduler's fault hook)."""
    import asyncio
    import threading

    from distilp_torch.gateway import Gateway, GatewayHTTPServer, make_fleet_from_spec

    gw = Gateway(n_workers=1, max_queue_depth=1, scheduler_kwargs=dict(
        mip_gap=SERVE_GAP, kv_bits="4bit", k_candidates=[8, 10]))
    gate, entered = threading.Event(), threading.Event()
    res: dict = {}
    try:
        for i, f in enumerate(("h0", "h1")):
            gw.register_fleet(f, make_fleet_from_spec(f, {"m": 4, "seed": 40 + i}), model)
        worker = gw.workers[0]

        def wait_for(cond):
            t = time.perf_counter()
            while not cond():
                if time.perf_counter() - t > 120:
                    fail("http: the worker never reached the expected queue state")
                time.sleep(0.002)

        async def main():
            srv = GatewayHTTPServer(gw)
            await srv.start()
            loop = asyncio.get_running_loop()
            call = lambda *a: loop.run_in_executor(None, *a)  # noqa: E731
            ev = {"fleet": "h0", "event": {"kind": "load", "t_comm_jitter": {}}}
            try:
                t = time.perf_counter()
                res["post"] = await call(_http, srv.port, "/events", ev)
                res["post_ms"] = (time.perf_counter() - t) * 1e3
                res["placement"] = await call(_http, srv.port, "/placement/h0")
                res["healthz"] = await call(_http, srv.port, "/healthz")
                res["metrics"] = await call(_http, srv.port, "/metrics")
                res["prom"] = await call(_http, srv.port, "/metrics", None, "text/plain")

                def hold(_attempt):
                    entered.set()
                    if not gate.wait(timeout=120):
                        raise RuntimeError("the test gate was never opened")

                gw.scheduler("h1").fault_hook = hold
                drift = {"fleet": "h1", "event": {"kind": "load", "t_comm_jitter": {}}}
                first = call(_http, srv.port, "/events", drift)
                await call(wait_for, entered.is_set)
                second = call(_http, srv.port, "/events", drift)
                await call(wait_for, lambda: worker.depth() == 1)
                res["third"] = await call(_http, srv.port, "/events", drift)
                gate.set()
                res["first"], res["second"] = await first, await second
            finally:
                gate.set()
                await srv.close()

        asyncio.run(main())
    finally:
        gate.set()
        gw.close()
    st, headers, body = res["third"]
    view = json.loads(res["post"][2]).get("view", {})
    line = {"post": res["post"][0], "post_ms": res["post_ms"], "k": view.get("k"),
            "certified": view.get("certified"), "placement": res["placement"][0],
            "healthz": res["healthz"][0], "metrics": res["metrics"][0],
            "prom_fleet_label": 'fleet="h0"' in res["prom"][2], "third": st,
            "retry_after": headers.get("Retry-After"),
            "first_second": [res["first"][0], res["second"][0]]}
    print(f"gateway http {json.dumps(line)}", flush=True)
    if (line["post"], line["placement"], line["healthz"], line["metrics"]) != (200,) * 4 \
            or not line["certified"] or not line["prom_fleet_label"]:
        fail(f"gateway http routes: {line}")
    if st != 429 or int(headers.get("Retry-After", "0")) < 1 \
            or line["first_second"] != [200, 200]:
        fail(f"gateway http: no 429 with a Retry-After at a full queue: {line}")
    return line


def loadgen_gateway(model) -> dict:
    """(e) ``run_loadgen``: 10 fleets of 3 devices (the shape of the smoke
    trace's), 5 measured events each after 2 warm-up events, at 1 and 2
    thread workers."""
    from distilp_torch.gateway import run_loadgen

    out = {}
    for n in (1, 2):
        r = run_loadgen(model, n_fleets=10, n_workers=n, events_per_fleet=5, fleet_size=3,
                        k_candidates=[8, 10], mip_gap=SERVE_GAP)
        out[n] = {k: r[k] for k in ("events", "wall_s", "events_per_sec", "p50_ms", "p99_ms",
                                   "tick_failed", "uncertified", "worker_events")}
        print(f"gateway loadgen workers={n} {json.dumps(out[n])}", flush=True)
        if r["tick_failed"] or r["uncertified"] or r["events"] != 50:
            fail(f"gateway loadgen workers={n}: {out[n]}")
    return out


def gateway_path() -> dict:
    """The gateway tier on the card (path l): the JAX package's
    smoke-gateway (three serve runs and the chaos soak on 2 workers) and
    smoke-crash (supervised process workers, both LP engines) through the
    port's ``serve``, run side by side in child processes; then in process
    the combined gateway at full width, the HTTP API and the load
    generator."""
    import os
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from distilp_torch import kernels
    from distilp_torch.solver import packed as PK

    def overdue():
        import faulthandler

        print(f"chip_smoke FAILED: the gateway path ran past {GATEWAY_LIMIT_S} s; "
              f"utilization {gpu_utilization()}; every thread:", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.flush()
        os._exit(1)

    watchdog = threading.Timer(GATEWAY_LIMIT_S, overdue)
    watchdog.daemon = True
    watchdog.start()
    t_path = time.perf_counter()
    kernels.reset_launch_counts()
    PK.reset_counts()
    child: dict = {}
    with tempfile.TemporaryDirectory(prefix="distilp_gateway_") as tmp:
        tmp = Path(tmp)
        with ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(smoke_gateway, tmp), ex.submit(smoke_gateway_chaos),
                    ex.submit(smoke_crash, tmp, "ipm"), ex.submit(smoke_crash, tmp, "pdhg")]
            results = [f.result() for f in futs]
    for r in results:
        print(f"gateway cli {json.dumps(r.get('line'))}", flush=True)
        for k, v in r.get("launches", {}).items():
            if k == "_shapes":
                merge_shapes(child.setdefault("_shapes", {}), v)
            else:
                child[k] = child.get(k, 0) + v
    errors = [r["error"] for r in results if r.get("error")]
    if errors:
        fail("; ".join(errors))
    t_cli = time.perf_counter() - t_path
    model = online_model()
    t = time.perf_counter()
    combined_gateway(model)
    t_combined = time.perf_counter() - t
    t = time.perf_counter()
    http_gateway(model)
    t_http = time.perf_counter() - t
    t = time.perf_counter()
    loadgen_gateway(model)
    t_loadgen = time.perf_counter() - t
    watchdog.cancel()
    launches = path_launches(child)
    print("gateway path launches", json.dumps(launches), flush=True)
    print(f"gateway path: {time.perf_counter() - t_path:.1f} s (cli side by side {t_cli:.1f} s, "
          f"combined {t_combined:.1f} s, http {t_http:.1f} s, loadgen {t_loadgen:.1f} s)",
          flush=True)
    missing = [k for k in GATEWAY_KERNELS if not launches.get(k)]
    if missing:
        fail(f"gateway path never launched {missing}")
    return launches


# ---------------------------------------------------------- traffic (path m)

# The JAX package's Makefile smokes of open-loop traffic, SLO alerting and
# the autoscaler (smoke-overload, smoke-slo, smoke-autoscale) and of the
# compile and memory ledgers (smoke-compile, smoke-memory) through the
# port's CLI: the committed diurnal+burst capture (6 fleets of 3 devices),
# Llama-3-70B online, k in {8, 10}, its 60 s schedule replayed in 60 ms.
OVERLOAD = ["overload", "--trace", "tests/traces/openloop_diurnal_burst.jsonl", "--profile",
            "tests/profiles/llama_3_70b/online", "--k-candidates", "8,10", "--time-scale",
            "0.001", "--quiet"]
SLO_OFFLINE = ["slo", "--spec", "tests/traces/slo_overload_spec.json", "--timeline",
               "tests/traces/slo_timeline_overload.jsonl", "--step-s", "0.1", "--expect",
               "tests/traces/slo_expected_alerts.json", "--check", "--quiet"]
AUTOSCALE_OFFLINE = ["autoscale", "--timeline", "tests/traces/slo_timeline_overload.jsonl",
                     "--policy", "tests/traces/control_policy.json", "--spec",
                     "tests/traces/slo_overload_spec.json", "--step-s", "0.5", "--expect",
                     "tests/traces/control_expected_actions.jsonl", "--check", "--quiet"]
TRAFFIC_KERNELS = ("ipm", "round_tail", "bnb_graph", "bnb_seed", "bnb_head", "bnb_control",
                   "bnb_answer")
# The whole path gets this long (the gateway path's watchdog, below).
TRAFFIC_LIMIT_S = 300


def cli_main(argv: list):
    """``solver_cli.main(argv)`` in this process: (exit code, stdout,
    stderr, wall s); no interpreter start is paid."""
    import contextlib
    import io

    from distilp_torch.cli import solver_cli

    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = solver_cli.main(argv)
    wall = time.perf_counter() - t
    print(f"$ solver_cli {' '.join(argv[:1])} ... -> exit {rc} in {wall:.1f} s", flush=True)
    return rc, out.getvalue(), err.getvalue(), wall


def overload_arm(tmp: Path, name: str, extra: list) -> dict:
    """One live ``overload`` arm in this process; its report."""
    out = tmp / f"overload_{name}.json"
    rc, _, err, wall = cli_main(OVERLOAD + extra + ["--metrics-out", str(out)])
    rep = _summary_file(out)
    if rc != 0:
        fail(f"traffic overload {name}: exit {rc} {err[-3000:]} slo "
             f"{json.dumps(rep.get('slo', {}).get('events'))} control "
             f"{json.dumps(rep.get('control', {}).get('actions'))}")
    rep["_wall_s"] = wall
    return rep


def overload_line(rep: dict) -> dict:
    keys = ("offered", "served", "shed", "events_shed", "events_coalesced", "failed",
            "invalid", "p50_ms", "p99_ms", "p999_ms", "max_ms", "dispatch_p99_late_ms",
            "max_queue_depth_seen", "goodput_eps", "wall_s", "_wall_s")
    line = {k: rep.get(k) for k in keys}
    line["shed_violations"] = rep.get("shed_violations")
    return line


def alert_times(timeline_path: Path, events: list) -> dict:
    """Each alert transition's time after the shed onset (the first point of
    ``openloop.sheds``) and after the flood drained (the last event's)."""
    from distilp_torch.obs import Timeline

    tl = Timeline.load(timeline_path)
    sheds = tl.series("openloop.sheds")
    done = [t for n in ("openloop.sheds", "openloop.latency_ms") for t, _ in tl.series(n)]
    onset, drained = (sheds[0][0] if sheds else None), (max(done) if done else None)
    return [{"severity": e["severity"], "state": e["state"],
             "after_shed_onset_s": None if onset is None else e["t"] - onset,
             "after_drain_s": None if drained is None else e["t"] - drained} for e in events]


def ledger_serve(tmp: Path) -> dict:
    """(d) and (e): smoke-compile's and smoke-memory's ``serve`` in a child
    process (its libraries come from the build cache; its graphs are
    captured fresh) with both ledgers on."""
    launches: dict = {}
    ledger, mem, summary = tmp / "ledger.jsonl", tmp / "memory.jsonl", tmp / "serve.json"
    rc, _, err, wall = run_cli("distilp_torch.cli.solver_cli", GATEWAY_SMOKE + [
        "--compile-ledger-out", str(ledger), "--memory-out", str(mem),
        "--metrics-out", str(summary)], launches)
    if rc != 0:
        return {"error": f"ledger serve: exit {rc} {err[-3000:]}"}
    return {"summary": _summary_file(summary), "paths": {"compiles": ledger, "memory": mem},
            "launches": launches, "wall_s": wall, "error": None}


def ledger_reports(res: dict) -> dict:
    """``compiles --load --check`` and ``memory --load --check`` twice each
    in this process: both pass and render the same bytes each time."""
    reports = {}
    for sub, path in res["paths"].items():
        outs = []
        for _ in range(2):
            rc, out, err, _ = cli_main([sub, "--load", str(path), "--check"])
            if rc != 0:
                fail(f"traffic {sub} --load --check: exit {rc} {err[-2000:]} {out[-2000:]}")
            outs.append(out)
        if outs[0] != outs[1]:
            fail(f"traffic {sub} --load rendered different bytes on a second replay")
        reports[sub] = outs[0]
    return reports


def compile_line(res: dict) -> dict:
    """The child's compile ledger: cold events by (entry, cause) with their
    ms, and what the warm phase paid."""
    from distilp_torch.obs.compile_ledger import BUILD_ENTRY, UNREGISTERED, ledger_from_jsonl

    c = res["summary"].get("compile", {})
    dump = ledger_from_jsonl(res["paths"]["compiles"].read_text())
    by: dict = {}
    for e in dump["events"]:
        key = f"{e['entry']} {e['cause']}"
        n, ms = by.get(key, (0, 0.0))
        by[key] = (n + 1, ms + e["compile_ms"])
    captures = [e for e in dump["events"] if e["entry"] != BUILD_ENTRY]
    return {
        "events": len(dump["events"]), "by_entry_cause": {k: {"n": n, "ms": round(ms, 3)}
                                                          for k, (n, ms) in sorted(by.items())},
        "loads": sum(e["entry"] == BUILD_ENTRY for e in dump["events"]),
        "nvcc_runs": sum(e["entry"] == BUILD_ENTRY and e["cache"] == "miss"
                         for e in dump["events"]),
        "captures": len(captures), "capture_ms": round(sum(e["compile_ms"] for e in captures), 3),
        "unregistered_captures": sum(e["entry"] == UNREGISTERED for e in captures),
        "warm_boundary_marked": c.get("warm_boundary_marked"),
        "warm_phase_compiles": c.get("warm_phase_compiles"),
        "storms": c.get("counters", {}).get("recompile_storms"),
    }


def memory_line(res: dict) -> dict:
    m = res["summary"].get("memory", {})
    entries = {name: {k: (e.get("memory") or {}).get(k) for k in ("peak_bytes",
                                                                   "reserved_bytes",
                                                                   "argument_bytes",
                                                                   "output_bytes")}
               | {"dispatches": e.get("dispatches")}
               for name, e in m.get("entries", {}).items() if e.get("memory")}
    return {"leak": m.get("leak"), "watermarks": m.get("watermarks"), "entries": entries}


def memory_model_ratios() -> dict:
    """A solve's peak allocation on the card (its first dispatch under a
    fresh memory ledger, the plan and static caches emptied first) over
    ``ops/memmodel.py``'s analytic peak, at the north star on the IPM and at
    the 128-device fleet on the PDHG."""
    import torch

    from distilp_torch.obs import memory
    from distilp_torch.ops.memmodel import peak_bytes
    from distilp_torch.solver import device_loop, halda_solve
    from distilp_torch.solver import packed as PK
    from distilp_torch.utils import make_synthetic_fleet

    out = {}
    for name, M, engine, gap in (("north_star", 16, "ipm", SERVE_GAP),
                                 ("fleet_M128", 128, "pdhg", FLEET128_GAP)):
        devs, model = make_synthetic_fleet(M, seed=123), online_model(M)
        device_loop.clear_plans()
        PK.clear_static_cache()
        torch.cuda.synchronize()
        led = memory.enable(memory.MemoryLedger())
        tm: dict = {}
        try:
            r = halda_solve(devs, model, mip_gap=gap, kv_bits="4bit", timings=tm)
        finally:
            memory.disable()
        m = (led.analyses.get("solver.solve_sweep") or {}).get("memory") or {}
        plan = (led.analyses.get(memory.PLAN_ENTRY) or {}).get("memory") or {}
        model_b = peak_bytes(M, engine)
        out[name] = {"M": M, "engine": tm.get("lp_backend"), "certified": r.certified,
                     "measured_peak_bytes": m.get("peak_bytes"),
                     "measured_reserved_bytes": m.get("reserved_bytes"),
                     "plan_bytes": plan.get("peak_bytes"), "analytic_bytes": model_b,
                     "ratio": (m["peak_bytes"] / model_b) if m.get("peak_bytes") else None}
        if tm.get("lp_backend") != engine or not m.get("peak_bytes") or not r.certified:
            fail(f"traffic memory model {name}: {out[name]}")
    return out


def traffic_path() -> dict:
    """Open-loop traffic, SLO alerting, the autoscaler and the compile and
    memory ledgers on the card (path m): smoke-overload's two arms,
    smoke-slo's and smoke-autoscale's live halves in this process (their
    offline halves too), then smoke-compile's and smoke-memory's ``serve``
    in a child process beside the live autoscale (whose children host the
    solver-free stub), then the memory model's ratio at two sizes."""
    import os
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from distilp_torch import kernels
    from distilp_torch.solver import packed as PK

    def overdue():
        import faulthandler

        print(f"chip_smoke FAILED: the traffic path ran past {TRAFFIC_LIMIT_S} s; "
              f"utilization {gpu_utilization()}; every thread:", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.flush()
        os._exit(1)

    watchdog = threading.Timer(TRAFFIC_LIMIT_S, overdue)
    watchdog.daemon = True
    watchdog.start()
    smi = smi_line()
    t_path = time.perf_counter()
    kernels.reset_launch_counts()
    PK.reset_counts()
    child: dict = {}
    with tempfile.TemporaryDirectory(prefix="distilp_traffic_") as tmp:
        tmp = Path(tmp)
        # (a) smoke-overload: a depth-2 gate sheds, reconciled record by
        # record; a depth-64 gate with coalescing folds and sheds nothing.
        shed = overload_arm(tmp, "depth2", ["--workers", "2", "--max-queue-depth", "2",
                                            "--check", "--expect-sheds"])
        print(f"traffic overload depth2 [{smi}] {json.dumps(overload_line(shed))}", flush=True)
        fold = overload_arm(tmp, "coalesce", ["--workers", "2", "--max-queue-depth", "64",
                                              "--coalesce", "--check", "--expect-coalesced",
                                              "--expect-no-sheds"])
        print(f"traffic overload coalesce [{smi}] {json.dumps(overload_line(fold))}",
              flush=True)
        # (b) smoke-slo: the committed timeline reproduces the committed
        # alerts; live, the page alert opens at the shed onset and closes
        # in the settle window.
        rc, _, err, wall = cli_main(SLO_OFFLINE)
        print(f"traffic slo offline: exit {rc} in {wall:.2f} s", flush=True)
        if rc != 0:
            fail(f"traffic slo offline: {err[-2000:]}")
        live = overload_arm(tmp, "slo", [
            "--workers", "2", "--max-queue-depth", "2", "--check", "--expect-sheds",
            "--slo", "tests/traces/slo_live_spec.json", "--settle-s", "3",
            "--expect-alert", "page", "--timeline-out", str(tmp / "slo_timeline.jsonl")])
        events = live.get("slo", {}).get("events", [])
        line = {"alerts": alert_times(tmp / "slo_timeline.jsonl", events),
                "opened": live["slo"].get("alerts_opened"),
                "closed": live["slo"].get("alerts_closed"), **overload_line(live)}
        print(f"traffic slo live [{smi}] {json.dumps(line)}", flush=True)
        # (c) smoke-autoscale: the offline replay reproduces the committed
        # actions byte for byte; live, one process worker hosting the stub
        # scales to two. (d), (e) beside it: the ledgers' serve.
        rc, _, err, wall = cli_main(AUTOSCALE_OFFLINE)
        print(f"traffic autoscale offline: exit {rc} in {wall:.2f} s", flush=True)
        if rc != 0:
            fail(f"traffic autoscale offline: {err[-2000:]}")
        # The stub's children import it as a top-level module from tests/
        # (another installed ``tests`` package may shadow the repository's).
        prev_path = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT / "tests"), prev_path) if p)
        try:
            with ThreadPoolExecutor(max_workers=1) as ex:
                fut = ex.submit(ledger_serve, tmp)
                scale = overload_arm(tmp, "autoscale", [
                    "--workers", "1", "--max-queue-depth", "2", "--worker-backend",
                    "process", "--scheduler-factory", "torch_procstub:make_scheduler",
                    "--autoscale", "tests/traces/control_live_policy.json", "--slo",
                    "tests/traces/slo_live_spec.json", "--capacity-probe", "3",
                    "--control-period-s", "0.05", "--check", "--expect-scale", "2",
                    "--expect-sheds", "--expect-alert", "page", "--settle-s", "3"])
                res = fut.result()
        finally:
            if prev_path is None:
                os.environ.pop("PYTHONPATH", None)
            else:
                os.environ["PYTHONPATH"] = prev_path
        ctl = scale.get("control", {})
        line = {"actions": [(a["kind"], a.get("target_workers")) for a in ctl.get("actions", [])],
                "workers_final": ctl.get("workers_final"),
                "violations": ctl.get("violations"),
                "spawn_to_first_ping_ms": [w["start_ms"] for w in
                                           scale.get("process_workers", [])],
                "child_nvcc_runs": [w["nvcc_runs"] for w in scale.get("process_workers", [])],
                "shed": scale.get("shed"), "wall_s": scale["_wall_s"]}
        print(f"traffic autoscale live [{smi}] {json.dumps(line)}", flush=True)
        if res.get("error"):
            fail(f"traffic ledgers: {res['error']}")
        for k, v in res["launches"].items():
            if k == "_shapes":
                merge_shapes(child.setdefault("_shapes", {}), v)
            else:
                child[k] = child.get(k, 0) + v
        reports = ledger_reports(res)
        comp = compile_line(res)
        print(f"traffic compile [{smi}] {json.dumps(comp)} (serve {res['wall_s']:.1f} s)",
              flush=True)
        print(reports["compiles"], flush=True)
        if (comp["warm_phase_compiles"] != 0 or not comp["warm_boundary_marked"]
                or comp["nvcc_runs"] or comp["unregistered_captures"] or not comp["captures"]
                or not comp["loads"]):
            fail(f"traffic compile ledger: {comp}")
        mem = memory_line(res)
        print(f"traffic memory [{smi}] {json.dumps(mem)}", flush=True)
        print(reports["memory"], flush=True)
        if not mem["leak"] or not mem["leak"]["flat"] or mem["leak"]["growth_bytes"] != 0:
            fail(f"traffic memory ledger: warm phase not flat: {mem['leak']}")
    ratios = memory_model_ratios()
    print(f"traffic memory model [{smi}] {json.dumps(ratios)}", flush=True)
    watchdog.cancel()
    launches = path_launches(child)
    print("traffic path launches", json.dumps(launches), flush=True)
    print(f"traffic path: {time.perf_counter() - t_path:.1f} s", flush=True)
    missing = [k for k in TRAFFIC_KERNELS if not launches.get(k)]
    if missing:
        fail(f"traffic path never launched {missing}")
    return launches


def _as_ilp(r):
    """A HALDAResult as the ILPResult a warm hint is read from."""
    from distilp_torch.solver.api import _warm_to_ilp

    return _warm_to_ilp(r)


# ---------------------------------------------------------------- phase 3


# K1's routes at the edges of what an H100 block's shared memory holds for
# an M-device fleet (m = 6M+1, n = 13M+1): the packed factor leaves shared
# memory above M=47 (float32) and M=31 (float64), the vectors above M=172
# and M=86 (tests/test_torch_ipm.py drives the wrapper with the same table).
IPM_ROUTE_EDGES = {(47, "float32"): "shared", (48, "float32"): "factor_global",
                   (172, "float32"): "factor_global", (173, "float32"): "global",
                   (31, "float64"): "shared", (32, "float64"): "factor_global",
                   (86, "float64"): "factor_global", (87, "float64"): "global"}


def ipm_non_finite_theta_batch(rng):
    """Four north-star LPs in float64, warm; element 0 has one active column
    of infinite width with a warm z of 0, so its z, and with it theta_j,
    is NaN (0 * inf): its normal matrix is non-finite and every step is
    zero, as the plain version's dense one (and the JAX package's) gives."""
    import torch

    batch, warm, skip = ipm_batch(16, 123, 4, torch.float64, rng)
    act = (batch.u[0] - batch.l[0] > 0).nonzero()
    j = int(act[len(act) // 2])
    u = batch.u.clone()
    u[0, j] = float("inf")
    z = warm.z.clone()
    z[0, j] = 0.0
    ok = warm.ok.clone()
    ok[0] = True
    return batch._replace(u=u), warm._replace(z=z, ok=ok), torch.zeros_like(skip)


def check_ipm(report: dict) -> None:
    import numpy as np
    import torch

    from distilp_torch.kernels import LAUNCHES
    from distilp_torch.ops.ipm import (
        ipm_solve_batch,
        ipm_solve_batch_reference,
        ipm_sparsity,
        ipm_workspace_route,
    )
    from distilp_torch.solver.search import node_sparsity

    routes = {(M, d): ipm_workspace_route(6 * M + 1, 13 * M + 1, getattr(torch, d), "cuda")
              for M, d in IPM_ROUTE_EDGES}
    print("ipm routes", json.dumps({f"M={M} {d}": r for (M, d), r in routes.items()}),
          flush=True)
    if routes != IPM_ROUTE_EDGES:
        fail(f"ipm workspace routes {routes}, expected {IPM_ROUTE_EDGES}")

    rng = np.random.default_rng(1234)
    rows = []
    cases = [
        (M, seed, 16, cfg, None)
        for M, seed in ((16, 123), (32, 32))
        for cfg in (
            (torch.float32, 8, 8),  # cold root round of the default budget
            (torch.float32, 6, 4),  # warm round
            (torch.float32, 26, 4),  # escalated budget
            (torch.float64, 26, 4),
        )
    ]
    # The factor_global and global routes at a cold root-round budget, B=2,
    # both elements live (no skip): M=128 float32 (the fleet forced onto the
    # IPM), M=192 float32 and M=128 float64.
    cases += [(128, 123, 2, (torch.float32, 8, 8), "factor_global"),
              (192, 192, 2, (torch.float32, 8, 8), "global"),
              (128, 123, 2, (torch.float64, 8, 8), "global")]
    # The north star (M=16) and the fleet forced onto the IPM (M=128) take
    # A's structure as a solve passes it (search.node_sparsity, built once
    # per sweep); M=32 and M=192 let the wrapper build it from A, as a
    # direct call does.
    for M, seed, B, (dtype, iters, chunk), want_route in cases:
        batch, warm, skip = ipm_batch(M, seed, B, dtype, rng)
        if want_route is not None:
            skip = torch.zeros_like(skip)
        route = ipm_workspace_route(*batch.A.shape, dtype, batch.A.device)
        sp = node_sparsity(batch.A, M, moe=False) if M in (16, 128) else None
        k = ipm_solve_batch(batch, iters=iters, warm=warm, skip=skip, chunk=chunk,
                            sparsity=sp)
        r = ipm_solve_batch_reference(batch, iters=iters, warm=warm, skip=skip, chunk=chunk)
        torch.cuda.synchronize()
        errs = {f: max_err(getattr(k, f), getattr(r, f))
                for f in k._fields if f not in ("converged", "iters_run", "trace_buf")}
        d_it = int((k.iters_run - r.iters_run).abs().max())
        conv_eq = bool(torch.equal(k.converged, r.converged))
        if dtype == torch.float64:
            ok = d_it == 0 and conv_eq and all(e[1] <= TOL_IPM_F64 for e in errs.values())
        else:
            ok = errs["bound"][1] <= TOL_IPM_F32_CERT
        if want_route is not None:
            ok = ok and route == want_route and min(k.iters_run.tolist()) > 0
        line = {
            "M": M, "B": B, "route": route, "dtype": str(dtype).split(".")[-1],
            "sparsity": "per call" if sp is None else "node_sparsity", "iters": iters, "chunk": chunk, "iters_run": k.iters_run.tolist(),
            "d_iters": d_it, "converged_equal": conv_eq,
            "max_abs": {f: e[0] for f, e in errs.items()},
            "max_rel": {f: e[1] for f, e in errs.items()}, "ok": ok,
        }
        print("ipm vs plain", json.dumps(line), flush=True)
        rows.append(line)

    # A non-finite theta: element 0 takes zero steps on both; the residual
    # norms are non-finite on both (the plain version's dense products give
    # NaN, the kernel's sparse ones +-inf or NaN); the other elements and
    # every other field as in float64 above.
    batch, warm, skip = ipm_non_finite_theta_batch(rng)
    k = ipm_solve_batch(batch, iters=8, warm=warm, skip=skip, chunk=4,
                        sparsity=node_sparsity(batch.A, 16, moe=False))
    r = ipm_solve_batch_reference(batch, iters=8, warm=warm, skip=skip, chunk=4)
    torch.cuda.synchronize()
    norms = ("rp_norm", "rd_norm")
    errs = {f: max_err(getattr(k, f), getattr(r, f))
            for f in k._fields if f not in ("converged", "iters_run", "trace_buf") + norms}
    errs.update({f: max_err(getattr(k, f)[1:], getattr(r, f)[1:]) for f in norms})
    nonfin = all(not bool(torch.isfinite(getattr(t, f)[0])) for t in (k, r) for f in norms)
    d_it = int((k.iters_run - r.iters_run).abs().max())
    conv_eq = bool(torch.equal(k.converged, r.converged))
    frozen = bool(torch.equal(k.y_dual[0], warm.y[0]))
    ok = (d_it == 0 and conv_eq and nonfin and frozen
          and all(e[1] <= TOL_IPM_F64 for e in errs.values()))
    line = {"case": "non-finite theta", "M": 16, "B": 4, "dtype": "float64",
            "iters_run": k.iters_run.tolist(), "d_iters": d_it, "converged_equal": conv_eq,
            "norms_non_finite_on_both": nonfin, "element0_dual_frozen": frozen,
            "max_rel": {f: e[1] for f, e in errs.items()}, "ok": ok}
    print("ipm vs plain", json.dumps(line), flush=True)
    rows.append(line)
    # A structure that misses one nonzero of A is refused before launch.
    short = batch.A != 0
    short[tuple(t[0] for t in short.nonzero(as_tuple=True))] = False
    before = LAUNCHES["ipm"]
    try:
        ipm_solve_batch(batch, iters=8, sparsity=ipm_sparsity(short))
        refused = False
    except ValueError:
        refused = True
    line = {"case": "structure missing a nonzero", "M": 16, "dtype": "float64",
            "refused_before_launch": refused and LAUNCHES["ipm"] == before}
    line["ok"] = line["refused_before_launch"]
    print("ipm vs plain", json.dumps(line), flush=True)
    rows.append(line)
    bad = [(r.get("M"), r["dtype"], r.get("iters"), r.get("chunk", r.get("case")))
           for r in rows if not r["ok"]]
    if bad:
        fail(f"ipm kernel disagrees with its plain version in (M, dtype, iters, chunk) {bad}")

    # Time each route at a main-path shape: the north-star root round (B=16,
    # float32, cold 8 steps; shared), the 128-device fleet forced onto the
    # IPM (B=2; factor_global) and M=192 (B=2; global). A's structure is
    # built once beforehand, as a solve does.
    timing = {}
    for name, M, seed, B in (("shared", 16, 123, 16), ("factor_global", 128, 123, 2),
                             ("global", 192, 192, 2)):
        batch, _, _ = ipm_batch(M, seed, B, torch.float32, np.random.default_rng(7))
        m, n = batch.A.shape
        sp = node_sparsity(batch.A, M, moe=False)
        run_k = lambda: ipm_solve_batch(batch, iters=8, chunk=8, sparsity=sp)  # noqa: E731
        run_p = lambda: ipm_solve_batch_reference(batch, iters=8, chunk=8)  # noqa: E731
        res = run_k()
        steps = int(res.iters_run.sum())
        b_ms, b_by = bound_ms(*ipm_flops_bytes(sp, B, steps, 4), PEAK_F32_S)
        dense_b_ms = bound_ms(*ipm_dense_formula_flops_bytes(m, n, B, steps, 4),
                              PEAK_F32_S)[0]
        ms, call, src = time_kernel(run_k, "ipm_kernel")
        plain = cuda_ms(run_p, reps=5 if M < 100 else 2, warmup=1)
        timing[name] = dict(shapes=f"B={B} m={m} n={n} float32, cold 8 steps",
                            route=ipm_workspace_route(m, n, torch.float32, "cuda"), ms=ms,
                            call_ms=call, ms_source=src, plain_ms=plain, bound_ms=b_ms,
                            bound_by=b_by, bound_ms_dense_formula=dense_b_ms,
                            steps_timed=steps)
        print(f"ipm {name}: {ms:.4f} ms on the card, {call:.4f} ms per call "
              f"(plain {plain:.3f} ms, bound {b_ms:.5f} ms by {b_by}, dense formula "
              f"{dense_b_ms:.5f} ms) at B={B} m={m} n={n}, {steps} steps", flush=True)
    # Yardstick: one batched library factor + solve of the same (16, m, m)
    # normal matrices, the core of one step (not the whole function).
    m = 97
    Mm = torch.eye(m, device="cuda").expand(16, m, m) * 2.0 + 0.01
    rhs = torch.ones(16, m, 1, device="cuda")
    chol = cuda_ms(lambda: torch.cholesky_solve(rhs, torch.linalg.cholesky(Mm)))
    t = timing["shared"]
    report["ipm"] = dict(
        name="ipm", route="cuda", source="distilp_torch/kernels/csrc/ipm_kernel.cu",
        replaces="distilp_tpu/ops/ipm.py:149",
        max_abs_err=rows[0]["max_abs"]["bound"], ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
        bound_ms_dense_formula=t["bound_ms_dense_formula"],
        held_against_plain="ok", call_ms=t["call_ms"], ms_source=t["ms_source"],
        steps_timed=t["steps_timed"], chol_solve_ms_per_step=chol, by_route=timing,
    )
    print(f"ipm: library cholesky+solve of one north-star step {chol:.4f} ms", flush=True)


def main_path_state():
    """North-star sweep data (one sweep's, no lane axis) and, as the search
    takes them, the L = 1 lane data and root state on the card (the solve's
    setup)."""
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
    state = root_state(t["lo_k"][None], t["hi_k"][None], 16, cap, data.A.shape[0])
    return data, tests_module("torch_lanes").lane_data(data), state


def check_round(report: dict) -> None:
    import numpy as np
    import torch

    from distilp_torch.ops.ipm import ipm_solve_batch
    from distilp_torch.solver.rounding import (
        round_to_incumbent,
        round_to_incumbent_reference,
    )

    data, _, _ = main_path_state()
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
    nbytes = B * 2 * M * 4 + (12 * M + 1) * 8 + 2 * B * 8 + B * (1 + 2 * M) * 8
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

    _, data, state = main_path_state()
    captured = {}
    orig = search.bnb_epilogue

    def capture(*args, **kw):
        captured["args"] = args
        captured["kw"] = kw
        return orig(*args, **kw)

    search.bnb_epilogue = capture
    try:
        n_k = data.ks.shape[1]
        # The round's epilogue inputs as K3 receives them: the round tail's
        # plain version runs K3.
        with reference_tail():
            search.bnb_round(data, state, 1e-3, ipm_iters=8, beam=n_k, ipm_chunk=8)
    finally:
        search.bnb_epilogue = orig
    args, kw = captured["args"], captured["kw"]
    got = search.bnb_epilogue(*args, **kw)
    ref = search.bnb_epilogue_reference(*args, **kw)
    torch.cuda.synchronize()
    bad = [f for f in got._fields
           if not torch.equal(getattr(got, f).cpu(), getattr(ref, f).cpu())]
    print("bnb_epilogue vs plain", json.dumps({"fields_differing": bad,
          "rows": int(args[0].shape[0])}), flush=True)
    if bad:
        fail(f"bnb_epilogue kernel disagrees with its plain version in {bad}")
    B, nf = args[0].shape
    m = args[2].y_dual.shape[1]
    run_k = lambda: search.bnb_epilogue(*args, **kw)  # noqa: E731
    ms, call, src = time_kernel(run_k, "bnb_epilogue_kernel")
    plain = cuda_ms(lambda: search.bnb_epilogue_reference(*args, **kw), reps=5)
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


def pdhg_roots(M: int, dtype, seed: int = 123):
    """The root-round LP batch (one LP per feasible k) of the M-device
    fleet, on the card, and the host arrays it came from."""
    import numpy as np
    import torch

    from distilp_torch.ops.ipm import LPBatch

    *_, host = load_instance(M, seed)
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
                     itemsize: int, warm: bool = False, a_bytes=None, trace_rows: int = 0):
    """Least work of one PDHG launch: (operations, bytes, operations if A
    were dense). Operations, counted on A's nonzeros (the products need no
    others): per executed step the two products (4 nnz); per executed chunk
    the convergence test's two products (4 nnz); per element the setup's
    three passes over A (|A| diag(cs) row maxima and sums, A l; 6 nnz), the
    warm gate's extra step (4 nnz) and the float64 certificate (4 nnz).
    Bytes: every input read once (A as the kernel reads it, ``a_bytes``:
    its structure once and nnz values, B nnz for a per-element A; a dense A
    given without them counts all m n entries), every output (the trace's
    ``trace_rows`` rows included) written once."""
    steps = sum(int(i) for i in iters_run)
    chunks = sum(-(-int(i) // chunk) for i in iters_run)
    per_nnz = 4 * (steps + chunks) + B * (10 + (4 if warm else 0))
    a_in = m * n * itemsize if a_bytes is None else a_bytes
    inputs = a_in + B * (m + 3 * n) * itemsize
    if warm:
        inputs += B * (3 * n + m) * itemsize + B
    outputs = B * (4 * n + m) * itemsize + B * n * 8 + B * (8 + 4 * itemsize + 5)
    outputs += B * trace_rows * 6 * itemsize
    return per_nnz * nnz, inputs + outputs, per_nnz * m * n


def elem_a_bytes(sp, B: int, itemsize: int) -> int:
    """Bytes of A as K5 reads it: B value sets of nnz (B = 1 for one shared
    A), and the structure's row and column index arrays (int32) once."""
    return B * sp.nnz * itemsize + 4 * (sp.m + 1 + 2 * sp.nnz + sp.n + 1 + sp.nnz)


def a_rows(A, e0: int, e1: int):
    """Elements e0:e1 of an LP batch's A: a shared (m, n) A as it is, a
    per-element one (ElemA) sliced."""
    from distilp_torch.ops.pdhg import ElemA

    return A._replace(values=A.values[e0:e1]) if isinstance(A, ElemA) else A


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
        sub = LPBatch(a_rows(batch.A, e, e + 1), *(t[e:e + 1] for t in batch[1:]))
        sw = None if warm is None else PDHGWarmState(*(t[e:e + 1] for t in warm))
        ke = pdhg_solve_batch(sub, iters=steps, warm=sw)
        re = pdhg_solve_batch_reference(sub, iters=steps, warm=sw)
        kb[e], rb[e] = ke.bound[0], re.bound[0]
        rerun[e] = (steps, int(ke.iters_run[0]), int(re.iters_run[0]))
    return kb, rb, rerun


K5_CLUSTER_SRC = "distilp_torch/kernels/csrc/pdhg_cluster_kernel.cu"
K5_GRID_SRC = "distilp_torch/kernels/csrc/pdhg_kernel.cu"
# K5's two routes as the profiler names their kernels.
K5_KERNEL = {"cluster": "pdhg_cluster_kernel", "grid": "pdhg_kernel"}
# Where pdhg_route changes K5's route for the M-device fleet (m = 6M+1,
# n = 13M+1): the cluster size C just below and just above each edge, and
# the grid route (0) past the largest cluster (tests/test_torch_pdhg_cluster.py
# holds the route function to the same table).
PDHG_ROUTE_EDGES = {"float32": [(181, 1), (182, 2), (341, 2), (342, 4), (609, 4), (610, 8),
                                (1002, 8), (1003, 0)],
                    "float64": [(105, 1), (106, 2), (196, 2), (197, 4), (344, 4), (345, 8),
                                (553, 8), (554, 0)]}


@contextlib.contextmanager
def forced_route(route: str):
    """K5's launches inside the block take ``route`` ('grid', or a cluster
    size as 'cluster<C>'), whatever pdhg_route would pick: a comparison of
    the two routes on the same inputs."""
    import torch

    from distilp_torch.ops import pdhg

    real = pdhg.kernel_route

    def pick(sp, dtype, c_max=8):
        if route == "grid":
            return "grid", 0, None
        C = int(route[len("cluster"):])
        return "cluster", C, pdhg.cluster_plan(sp, torch.empty((), dtype=dtype).element_size(), C)

    pdhg.kernel_route = pick
    try:
        yield
    finally:
        pdhg.kernel_route = real


def k5_route(A, dtype) -> str:
    """The route K5 takes for an LP batch's A (dense 2-D, or ElemA)."""
    import torch

    from distilp_torch.ops.ipm import ipm_sparsity
    from distilp_torch.ops.pdhg import ElemA, _cluster_max, kernel_route

    sp = A.sparsity if isinstance(A, ElemA) else ipm_sparsity(A != 0)
    route, C, _ = kernel_route(sp, dtype, _cluster_max(torch.device("cuda"),
                                                       dtype == torch.float64))
    return f"{route}{C or ''}"


def hold_pdhg(batch, iters: int, warm=None, skip=None, optima=None) -> dict:
    """K5 against its plain version on one batch: float64 field by field
    within TOL_PDHG_F64 with equal step counts and flags, float32 by the
    float64 bound at equal step counts (pdhg_f32_bounds); sound against the
    HiGHS optima where given."""
    import torch

    from distilp_torch.ops.pdhg import ElemA, pdhg_solve_batch, pdhg_solve_batch_reference

    k = pdhg_solve_batch(batch, iters=iters, warm=warm, skip=skip)
    r = pdhg_solve_batch_reference(batch, iters=iters, warm=warm, skip=skip)
    torch.cuda.synchronize()
    errs = {f: max_err(getattr(k, f), getattr(r, f))
            for f in k._fields if f not in ("converged", "iters_run", "trace_buf")}
    d_it = int((k.iters_run - r.iters_run).abs().max())
    conv_eq = bool(torch.equal(k.converged, r.converged))
    dtype = k.v.dtype
    A = batch.A
    rerun, f32_bound_rel = None, None
    if dtype == torch.float64:
        ok = d_it == 0 and conv_eq and all(e[1] <= TOL_PDHG_F64 for e in errs.values())
    else:
        sw = None if warm is None else warm
        kb, rb, rerun = pdhg_f32_bounds(k, r, batch, iters, sw)
        f32_bound_rel = max_err(kb, rb)[1]
        ok = f32_bound_rel <= TOL_PDHG_F32_CERT
    line = {"dtype": str(dtype).split(".")[-1], "iters": iters, "B": int(batch.b.shape[0]),
            "m": int(batch.b.shape[1]), "n": int(batch.c.shape[1]),
            "route": k5_route(A, dtype),
            "entry": "per-element" if isinstance(A, ElemA) and not A.shared else "shared",
            "iters_run": k.iters_run.tolist(), "iters_run_plain": r.iters_run.tolist(),
            "converged": k.converged.tolist(), "converged_plain": r.converged.tolist(),
            "bound": k.bound.tolist(),
            "max_abs": {f: e[0] for f, e in errs.items()},
            "max_rel": {f: e[1] for f, e in errs.items()},
            "f32_bound_max_rel_all_elements": f32_bound_rel,
            "f32_rerun_at_equal_steps": rerun}
    if optima is not None:
        slack = (k.bound.cpu() - optima) / optima.abs().clamp(min=1.0)
        sound = bool((slack <= TOL_SOUND).all() & torch.isfinite(slack).all())
        line.update(lp_optimum=optima.tolist(), max_rel_slack_over_optimum=float(slack.max()),
                    sound=sound)
        ok = ok and sound
    line["ok"] = ok
    return line


def k5_timing(batch, iters: int, route: str, reps: int, **kw) -> dict:
    """K5's device time a launch (the profiler's, else CUDA events) and its
    call time on one batch by ``route``, with its steps and microseconds a
    step."""
    from distilp_torch.ops.pdhg import pdhg_solve_batch

    with forced_route(route):
        run = lambda: pdhg_solve_batch(batch, iters=iters, **kw)  # noqa: E731
        res = run()
        call = cuda_ms(run, reps=reps, warmup=1)
        dev = device_ms(run, K5_KERNEL["grid" if route == "grid" else "cluster"], reps=reps)
    ms, src = (dev, "profiler") if dev is not None else (call, "cuda_events")
    steps = int(res.iters_run.max())
    return dict(route=route, ms=ms, call_ms=call, ms_source=src, steps=steps,
                iters_run=res.iters_run.tolist(), us_per_step=ms / max(steps, 1) * 1e3)


def check_pdhg(report: dict) -> None:
    """K5 on one shared A, read as values on its structure (the cluster
    route at the fleet's M=128 and M=512 roots): held against the plain
    version cold, warm and warm with a skip mask, in float64 field by field
    and in float32 by the bound; timed on both entries (the shared A, and
    every element its own copy of it) beside the grid route on the same
    inputs."""
    import torch

    from distilp_torch.ops.ipm import ipm_sparsity
    from distilp_torch.ops.pdhg import (
        PDHG_DEFAULT_CHUNK,
        PDHGWarmState,
        elem_a,
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
            B = int(batch.b.shape[0])
            warm = PDHGWarmState(cold.v, cold.y_dual, cold.z_dual, cold.f_dual,
                                 torch.ones_like(cold.converged))
            skip = torch.zeros(B, dtype=torch.bool, device="cuda")
            skip[-1] = True
            for start, w, sk in (("cold", None, None), ("warm", warm, None),
                                 ("warm+skip", warm, skip)):
                line = {"M": M, "start": start,
                        **hold_pdhg(batch, iters, w, sk, None if sk is not None else optima)}
                if sk is not None:
                    line["ok"] = line["ok"] and int(line["iters_run"][-1]) == 0
                print("pdhg vs plain", json.dumps(line), flush=True)
                rows.append(line)
                if not line["ok"]:
                    bad.append((M, line["dtype"], start))
    if bad:
        fail(f"pdhg kernel disagrees with its plain version or its bound is "
             f"unsound in (M, dtype, start) {bad}")

    # Time at the main path's shapes: the 128-device root round (float32,
    # cold, the default budget), and the 512-device one (1000 steps); each
    # entry on its route and the shared A on the grid route, in turns.
    timing = {}
    for M, iters, reps in ((128, default_pdhg_iters(128), 10), (512, 1000, 3)):
        batch, _ = pdhg_roots(M, torch.float32)
        m, n = batch.A.shape
        B = int(batch.b.shape[0])
        sp = ipm_sparsity(batch.A != 0)
        per = batch._replace(A=elem_a(batch.A.expand(B, m, n), sp))
        route = k5_route(batch.A, torch.float32)
        runs = {"shared": [], "per_element": [], "shared_grid": []}
        for name, bt, rt in (("shared", batch, route), ("shared_grid", batch, "grid"),
                             ("per_element", per, route), ("per_element", per, route),
                             ("shared_grid", batch, "grid"), ("shared", batch, route)):
            runs[name].append(k5_timing(bt, iters, rt, reps, sparsity=None if bt is per
                                        else sp))
        res = pdhg_solve_batch(batch, iters=iters, sparsity=sp)
        flops, nbytes, dense_flops = pdhg_flops_bytes(
            m, n, sp.nnz, B, res.iters_run.tolist(), PDHG_DEFAULT_CHUNK, 4,
            a_bytes=elem_a_bytes(sp, 1, 4))
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_F32_S)
        pe_flops, pe_bytes, _ = pdhg_flops_bytes(
            m, n, sp.nnz, B, res.iters_run.tolist(), PDHG_DEFAULT_CHUNK, 4,
            a_bytes=elem_a_bytes(sp, B, 4))
        pe_b_ms, pe_b_by = bound_ms(pe_flops, pe_bytes, PEAK_F32_S)
        dense_b_ms, dense_b_by = bound_ms(dense_flops, nbytes, PEAK_F32_S)
        plain = cuda_ms(lambda: pdhg_solve_batch_reference(batch, iters=iters),
                        reps=1, warmup=0)
        # Yardsticks: one step's two products as library calls at the root
        # batch width, dense and as sparse (CSR) products, times the steps
        # the batch executed.
        X = torch.rand(n, B, device="cuda")
        Y = torch.rand(m, B, device="cuda")
        A = batch.A
        mm = cuda_ms(lambda: (torch.matmul(A, X), torch.matmul(A.t(), Y)))
        A_csr, At_csr = A.to_sparse_csr(), A.t().contiguous().to_sparse_csr()
        spm = cuda_ms(lambda: (torch.sparse.mm(A_csr, X), torch.sparse.mm(At_csr, Y)))
        best = {k: min(v, key=lambda t: t["ms"]) for k, v in runs.items()}
        steps = best["shared"]["steps"]
        timing[M] = dict(
            ms=best["shared"]["ms"], call_ms=best["shared"]["call_ms"],
            ms_source=best["shared"]["ms_source"], route=route,
            us_per_step=best["shared"]["us_per_step"], plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, bound_us_per_step=b_ms / max(steps, 1) * 1e3, nnz=sp.nnz,
            flops=flops, bytes=nbytes, dense_ops_bound_ms=dense_b_ms,
            dense_ops_bound_by=dense_b_by, library_ms=mm * steps, library_step_ms=mm,
            library_sparse_ms=spm * steps, library_sparse_step_ms=spm, steps=steps,
            iters_run=best["shared"]["iters_run"], m=m, n=n, B=B,
            per_element=dict(best["per_element"], bound_ms=pe_b_ms, bound_by=pe_b_by),
            grid_route=best["shared_grid"], runs_in_turns=runs,
        )
        print(f"pdhg M={M}: route {route}, {timing[M]['ms']:.4f} ms on the card "
              f"({timing[M]['us_per_step']:.3f} us a step, {steps} steps), "
              f"{timing[M]['call_ms']:.4f} ms per call; per-element entry "
              f"{best['per_element']['ms']:.4f} ms ({best['per_element']['us_per_step']:.3f} "
              f"us a step); the grid route on the same inputs {best['shared_grid']['ms']:.4f} "
              f"ms ({best['shared_grid']['us_per_step']:.3f} us a step); plain {plain:.3f} ms; "
              f"bound {b_ms:.5f} ms by {b_by} with {sp.nnz} nonzeros "
              f"({timing[M]['bound_us_per_step']:.6f} us a step), {dense_b_ms:.5f} ms by "
              f"{dense_b_by} if A were dense; library products {mm:.4f} ms dense, "
              f"{spm:.4f} ms sparse a step) at B={B} m={m} n={n}", flush=True)
    t128 = timing[128]
    report["pdhg"] = dict(
        name="pdhg", route="cuda", source=K5_CLUSTER_SRC, grid_source=K5_GRID_SRC,
        replaces="distilp_tpu/ops/pdhg.py:139",
        max_abs_err=max(r["max_abs"]["bound"] for r in rows),
        ms=t128["ms"], plain_ms=t128["plain_ms"], bound_ms=t128["bound_ms"],
        bound_by=t128["bound_by"], library_ms=t128["library_ms"],
        held_against_plain="ok", call_ms=t128["call_ms"], ms_source=t128["ms_source"],
        k5_route=t128["route"], us_per_step=t128["us_per_step"],
        bound_us_per_step=t128["bound_us_per_step"],
        nnz=t128["nnz"], dense_ops_bound_ms=t128["dense_ops_bound_ms"],
        library_sparse_ms=t128["library_sparse_ms"],
        per_element=t128["per_element"], grid_route=t128["grid_route"],
        shapes_timed=f"M=128 root round, float32, cold, {default_pdhg_iters(128)} steps",
        m512_1000_steps={k: v for k, v in timing[512].items() if k != "runs_in_turns"},
    )


def check_pdhg_routes(report: dict) -> None:
    """Both of K5's routes at the sizes where pdhg_route changes them (M just
    below and just above each edge, both dtypes: float64 field by field,
    float32 by the bound, the root batch for 256 steps; the first float64 M
    past the largest cluster is the grid route's own check), each launch
    taking the route the table says."""
    import torch

    from distilp_torch import kernels

    from distilp_torch.ops.pdhg import PDHGWarmState, pdhg_solve_batch

    rows, bad = [], []
    for dname, edges in PDHG_ROUTE_EDGES.items():
        dtype = getattr(torch, dname)
        for M, C in edges:
            batch, _ = pdhg_roots(M, dtype)
            want = f"cluster{C}" if C else "grid"
            starts = [("cold", None, None)]
            if not C and dtype == torch.float64:
                # The grid route's own check: warm, and warm with a skip mask.
                cold = pdhg_solve_batch(batch, iters=256)
                warm = PDHGWarmState(cold.v, cold.y_dual, cold.z_dual, cold.f_dual,
                                     torch.ones_like(cold.converged))
                skip = torch.zeros_like(cold.converged)
                skip[-1] = True
                starts += [("warm", warm, None), ("warm+skip", warm, skip)]
            for start, w, sk in starts:
                kernels.reset_launch_counts()
                line = {"M": M, "want": want, "start": start, **hold_pdhg(batch, 256, w, sk)}
                shapes = [k for k in kernels.SHAPES["pdhg"]]
                line["launched"] = shapes
                line["ok"] = line["ok"] and line["route"] == want and bool(shapes) and all(
                    k.endswith(f"route={want}") for k in shapes)
                if sk is not None:
                    line["ok"] = line["ok"] and int(line["iters_run"][-1]) == 0
                print("pdhg route edge", json.dumps(line), flush=True)
                rows.append(line)
                if not line["ok"]:
                    bad.append((M, dname, start))
    if bad:
        fail(f"pdhg route edges: {bad} took another route or disagree with the plain version")
    report["pdhg"]["route_edges_held"] = [(r["M"], r["dtype"], r["route"]) for r in rows]
    report["pdhg"]["route_edges_max_rel"] = max(
        (r["max_rel"]["bound"] for r in rows), default=0.0)


def check_pdhg_mp() -> None:
    """K6a on both of K5's routes: its own, and the grid route forced."""
    check_pdhg_mp_route()
    with forced_route("grid"):
        check_pdhg_mp_route("grid")


def check_pdhg_mp_route(route: str = "") -> None:
    """K6a: the float32 run with the per-element float64 re-solve, on the
    128-device fleet's k=1 root LP (the one that decides the solve) at the
    escalated budget; its poisoned element's rollback and fallback. (Its k=2
    root does not reach the tolerance within 16000 steps in either
    precision, so a batch holding it would rightly count a fallback.)"""
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
        for f in res._fields[:-1]  # trace_buf: None
    )
    line = {"route": route or k5_route(batch.A, torch.float32),
            "n_fallback_healthy": healthy, "n_fallback_poisoned": rep["n_fallback"],
            "poisoned_row_fell_back": bool(bad[0]), "splice_exact": spliced}
    print("pdhg_mp", json.dumps(line), flush=True)
    if healthy != 0 or rep["n_fallback"] < 1 or not bool(bad[0]) or not spliced:
        fail(f"pdhg_solve_batch_mp fallback check failed: {line}")


def pdhg_call_opts(kw: dict) -> dict:
    """The options of a captured ``pdhg_solve_batch`` call that a rerun
    repeats (iteration precision aside)."""
    return {k: kw[k] for k in ("iters", "restart_tol", "warm", "skip") if k in kw}


def check_pdhg_elem(report: dict, calls: list) -> None:
    """K5's per-element entry (B11) on every call that the ``elem`` path's
    solves made of it (captured in the path; reruns here are comparisons,
    not counted): in float64 field by field against the plain version within
    TOL_PDHG_F64 with equal step counts, and at the call's own float32
    precision the float64 bound within TOL_PDHG_F32_CERT at equal step
    counts (as check_pdhg). Then a batch whose elements all carry the
    128-device fleet's A against the shared-A entry (float64), a structure
    missing a nonzero refused before launch, and the time at the lanes'
    root round."""
    import torch

    from distilp_torch.kernels import LAUNCHES
    from distilp_torch.ops.ipm import LPBatch, ipm_sparsity
    from distilp_torch.ops.pdhg import (
        PDHG_DEFAULT_CHUNK,
        ElemA,
        elem_a,
        pdhg_solve_batch,
        pdhg_solve_batch_reference,
    )
    from distilp_torch.solver.standard_form import default_pdhg_iters

    elem_calls = [(a[0], kw) for a, kw in calls
                  if isinstance(a[0].A, ElemA) and not a[0].A.shared]
    if not elem_calls:
        fail("the elem path made no per-element PDHG call")
    rows, bad = [], []
    held: list = []  # (inputs, call) of each call held so far
    for i, (batch, kw) in enumerate(elem_calls):
        opts = pdhg_call_opts(kw)
        # A call with the inputs of one already held (the path's bound
        # measurement reruns its lanes' solve) is held there.
        inputs = [batch.A.values, *batch[1:], opts.get("skip"), *(opts.get("warm") or ()),
                  opts.get("iters"), opts.get("restart_tol"), kw.get("dtype")]

        def same_input(x, y):
            if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
                return isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) and \
                    bits_equal(x, y)
            return x == y

        same = next((j for prev, j in held if len(prev) == len(inputs) and all(
            same_input(x, y) for x, y in zip(prev, inputs))), None)
        if same is not None:
            print(f"pdhg_elem vs plain: call {i} has the inputs of call {same}, held there",
                  flush=True)
            continue
        held.append((inputs, i))
        B, n = batch.c.shape
        m = batch.b.shape[1]
        b64 = LPBatch(batch.A._replace(values=batch.A.values.double()),
                      *(t.double() for t in batch[1:]))
        k = pdhg_solve_batch(b64, **opts)
        r = pdhg_solve_batch_reference(b64, **opts)
        torch.cuda.synchronize()
        errs = {f: max_err(getattr(k, f), getattr(r, f))
                for f in k._fields if f not in ("converged", "iters_run", "trace_buf")}
        d_it = int((k.iters_run - r.iters_run).abs().max())
        ok64 = d_it == 0 and bool(torch.equal(k.converged, r.converged)) and all(
            e[1] <= TOL_PDHG_F64 for e in errs.values())
        k32 = pdhg_solve_batch(batch, dtype=kw.get("dtype"), **opts)
        b32 = batch if batch.b.dtype == k32.v.dtype else LPBatch(
            batch.A._replace(values=batch.A.values.to(k32.v.dtype)),
            *(t.to(k32.v.dtype) for t in batch[1:]))
        r32 = pdhg_solve_batch_reference(b32, **opts)
        kb, rb, rerun = pdhg_f32_bounds(k32, r32, b32, opts["iters"], opts.get("warm"))
        f32_rel = max_err(kb, rb)[1]
        line = {"call": i, "B": B, "m": m, "n": n, "nnz": batch.A.sparsity.nnz,
                "route": k5_route(b64.A, torch.float64),
                "route_f32": k5_route(batch.A, k32.v.dtype),
                "iters": opts["iters"], "warm": opts.get("warm") is not None,
                "iters_run_f64": k.iters_run.tolist(), "d_iters_f64": d_it,
                "max_rel_f64": {f: e[1] for f, e in errs.items()},
                "bound_max_abs_f64": errs["bound"][0],
                "f32_bound_max_rel": f32_rel, "f32_rerun_at_equal_steps": rerun,
                "ok": ok64 and f32_rel <= TOL_PDHG_F32_CERT}
        print("pdhg_elem vs plain", json.dumps(line), flush=True)
        rows.append(line)
        if not line["ok"]:
            bad.append(i)

    # Every element carries the same A: the per-element entry against the
    # shared one (float64, the 128-device root batch).
    iters = 1000
    roots, _ = pdhg_roots(128, torch.float64)
    B, (m, n) = roots.b.shape[0], roots.A.shape
    shared = pdhg_solve_batch(roots, iters=iters)
    per = pdhg_solve_batch(roots._replace(A=elem_a(roots.A.expand(B, m, n))), iters=iters)
    torch.cuda.synchronize()
    errs = {f: max_err(getattr(per, f), getattr(shared, f))
            for f in per._fields if f not in ("converged", "iters_run", "trace_buf")}
    same_ok = bool(torch.equal(per.iters_run, shared.iters_run)) and all(
        e[1] <= TOL_PDHG_F64 for e in errs.values())
    line = {"case": "every element the shared A", "M": 128, "B": B,
            "iters_run": per.iters_run.tolist(),
            "max_rel": {f: e[1] for f, e in errs.items()}, "ok": same_ok}
    print("pdhg_elem vs shared", json.dumps(line), flush=True)
    # A structure missing one nonzero: refused, nothing launched.
    A3 = roots.A.expand(B, m, n).contiguous()
    short = A3[0] != 0
    short[tuple(t[0] for t in short.nonzero(as_tuple=True))] = False
    before = LAUNCHES["pdhg_elem"]
    try:
        pdhg_solve_batch(roots._replace(A=A3), iters=8, sparsity=ipm_sparsity(short))
        refused = False
    except ValueError:
        refused = True
    refused = refused and LAUNCHES["pdhg_elem"] == before
    print("pdhg_elem structure missing a nonzero refused before launch:", refused, flush=True)
    if bad or not same_ok or not refused:
        fail(f"pdhg_elem: calls {bad} disagree with the plain version, equal-A check "
             f"{same_ok}, refusal {refused}")

    # Time at the lanes' root round (of the captured calls, the 128-device
    # fleets' with the largest budget: 2 lanes x 2 roots, float32, the
    # cold 2000-step budget).
    batch, kw = max(elem_calls, key=lambda c: (c[0].b.shape[1], c[1]["iters"],
                                              c[0].b.shape[0]))
    opts = pdhg_call_opts(kw)
    B, n = batch.c.shape
    m = batch.b.shape[1]
    sp = batch.A.sparsity
    run_k = lambda: pdhg_solve_batch(batch, **opts)  # noqa: E731
    res = run_k()
    flops, nbytes, _ = pdhg_flops_bytes(
        m, n, sp.nnz, B, res.iters_run.tolist(), PDHG_DEFAULT_CHUNK, 4,
        warm=opts.get("warm") is not None, a_bytes=elem_a_bytes(sp, B, 4))
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_F32_S)
    route = k5_route(batch.A, batch.b.dtype)
    ms, call, src = time_kernel(run_k, K5_KERNEL["grid" if route == "grid" else "cluster"])
    with forced_route("grid"):
        grid = time_kernel(run_k, K5_KERNEL["grid"])
    plain = cuda_ms(lambda: pdhg_solve_batch_reference(batch, **opts), reps=1, warmup=0)
    # Yardstick: one step's two products as batched library calls on the
    # dense (B, m, n) A, times the steps the batch executed.
    A3 = batch.A.dense()
    X = torch.rand(B, n, 1, device="cuda")
    Y = torch.rand(B, m, 1, device="cuda")
    mm = cuda_ms(lambda: (torch.bmm(A3, X), torch.bmm(A3.transpose(1, 2), Y)))
    steps = int(res.iters_run.max())
    print(f"pdhg_elem: route {route}, {ms:.4f} ms on the card, {call:.4f} ms per call "
          f"(the grid route on the same inputs {grid[0]:.4f} ms, "
          f"{grid[0] / max(steps, 1) * 1e3:.3f} us a step; plain {plain:.3f} ms, bound "
          f"{b_ms:.6f} ms by {b_by}, {b_ms / max(steps, 1) * 1e3:.6f} us a step; library bmm "
          f"pair {mm:.4f} ms x {steps} steps) at B={B} m={m} n={n} nnz={sp.nnz} "
          f"iters_run={res.iters_run.tolist()}; {ms / max(steps, 1) * 1e3:.3f} us a step",
          flush=True)
    # The two entries on one batch whose elements share the fleet's A (the
    # 128-device root round, float32, cold), in turns: shared, per-element,
    # per-element, shared.
    roots32, _ = pdhg_roots(128, torch.float32)
    B2 = roots32.b.shape[0]
    per32 = roots32._replace(A=elem_a(roots32.A.expand(B2, *roots32.A.shape)))
    it128 = default_pdhg_iters(128)
    sp32 = per32.A.sparsity
    ab = {"shared": [], "per_element": []}
    for name, bt, kw in (("shared", roots32, dict(sparsity=sp32)), ("per_element", per32, {}),
                         ("per_element", per32, {}), ("shared", roots32, dict(sparsity=sp32))):
        ab[name].append(cuda_ms(lambda: pdhg_solve_batch(bt, iters=it128, **kw), reps=5,
                                warmup=1))
    steps_ab = int(pdhg_solve_batch(per32, iters=it128).iters_run.max())
    print(f"pdhg same A, shared vs per-element entry (B={B2}, {steps_ab} steps, ms per "
          f"call by CUDA events, in turns): {json.dumps(ab)}; a step "
          f"{min(ab['shared']) / steps_ab * 1e3:.2f} us vs "
          f"{min(ab['per_element']) / steps_ab * 1e3:.2f} us", flush=True)
    report["pdhg_elem"] = dict(
        name="pdhg_elem", route="cuda", source=K5_CLUSTER_SRC, grid_source=K5_GRID_SRC,
        replaces="distilp_tpu/ops/pdhg.py:569", k5_route=route,
        grid_route=dict(ms=grid[0], call_ms=grid[1], ms_source=grid[2],
                        us_per_step=grid[0] / max(steps, 1) * 1e3),
        bound_us_per_step=b_ms / max(steps, 1) * 1e3,
        max_abs_err=max(r["bound_max_abs_f64"] for r in rows),
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=mm * steps,
        library_step_ms=mm, held_against_plain="ok", call_ms=call, ms_source=src,
        calls_held=len(elem_calls), steps=steps, us_per_step=ms / max(steps, 1) * 1e3,
        same_a_ms={"B": B2, "steps": steps_ab, **ab},
        shapes_timed=f"B={B} m={m} n={n} nnz={sp.nnz} float32 "
                     f"{'warm' if opts.get('warm') is not None else 'cold'}, "
                     f"{opts['iters']} steps budget",
    )


def check_traces(report: dict) -> None:
    """The convergence trace (B13) of K1 on each route (shared,
    factor_global, global, per-node A) and of K5 on both entries: the traced
    launch's every output field equals the untraced one's bit for bit, and
    its trace (float64) equals the plain version's in the iters, restarts
    and live columns, rp/rd/gap within the kernel's float64 tolerance
    (scale max(1, |ref|)). Then the traced launch's time against the
    untraced one's at a main-path shape of each kernel."""
    import numpy as np
    import torch

    from distilp_torch.ops.ipm import (
        ipm_solve_batch,
        ipm_solve_batch_reference,
        ipm_sparsity,
        ipm_workspace_route,
    )
    from distilp_torch.ops.pdhg import (
        PDHG_DEFAULT_CHUNK,
        elem_a,
        pdhg_solve_batch,
        pdhg_solve_batch_reference,
    )
    from distilp_torch.solver.search import node_sparsity
    from distilp_torch.solver.standard_form import default_pdhg_iters

    rng = np.random.default_rng(99)
    rows = []

    def held(name, k0, k1, r, tol):
        same = all(torch.equal(getattr(k0, f), getattr(k1, f)) for f in k0._fields[:-1])
        tk, tr = k1.trace_buf.double().cpu(), r.trace_buf.double().cpu()
        cols = bool(torch.equal(tk[..., [0, 4, 5]], tr[..., [0, 4, 5]]))
        diff = (tk[..., 1:4] - tr[..., 1:4]).abs()
        rel = float((diff / tr[..., 1:4].abs().clamp(min=1.0)).max()) if tk.numel() else 0.0
        line = {"case": name, "engine": name.split()[0], "trace_shape": list(tk.shape),
                "max_abs": float(diff.max()) if tk.numel() else 0.0,
                "live_rows": int((tk[..., 5] > 0.5).sum()), "traced_equals_untraced": same,
                "iters_restarts_live_equal": cols, "rp_rd_gap_max_rel": rel,
                "ok": same and cols and rel <= tol}
        print("trace", json.dumps(line), flush=True)
        rows.append(line)
        return tk

    # K1: the routes at float64 (edges M=31/86), and a per-node A.
    mix = moe_instance(MOE_CASES[0])
    cases = [("ipm shared", *ipm_batch(16, 123, 8, torch.float64, rng)),
             ("ipm factor_global", *ipm_batch(32, 32, 4, torch.float64, rng)),
             ("ipm global", *ipm_batch(87, 87, 2, torch.float64, rng)),
             ("ipm per-node A", *moe_ipm_batch(mix[7], mix[9], 8, torch.float64, rng))]
    for name, batch, warm, skip in cases:
        route = ipm_workspace_route(*batch.A.shape[-2:], torch.float64, "cuda")
        kw = dict(iters=12, warm=warm, skip=skip, chunk=4)
        k0 = ipm_solve_batch(batch, **kw)
        k1 = ipm_solve_batch(batch, trace=True, **kw)
        r = ipm_solve_batch_reference(batch, trace=True, **kw)
        torch.cuda.synchronize()
        held(f"{name} (route {route})", k0, k1, r, TOL_IPM_F64)
    # K5: the shared entry on the 128-device root batch, the per-element
    # entry on Mixtral M=4's per-node A's.
    roots, _ = pdhg_roots(128, torch.float64)
    from distilp_torch.solver.search import node_A

    data = tests_module("torch_lanes").lane_data(mix[7])
    host = mix[9]
    n_k = host["b_k"].shape[0]
    kidx = torch.arange(n_k, device="cuda").repeat(2)
    A3 = node_A(data, kidx, data.rd.a.shape[-1], torch.zeros_like(kidx)).double()
    T = lambda a: torch.as_tensor(np.asarray(a)[kidx.cpu().numpy()], dtype=torch.float64,  # noqa: E731
                                  device="cuda")
    elem = type(roots)(A=elem_a(A3), b=T(host["b_k"]), c=T(host["c_k"]), l=T(host["lo_k"]),
                       u=T(host["hi_k"]))
    skip = torch.zeros(2 * n_k, dtype=torch.bool, device="cuda")
    skip[1] = True
    for name, batch, kw, route in (
            ("pdhg shared", roots, dict(iters=600), None),
            ("pdhg per-element", elem, dict(iters=600, skip=skip), None),
            ("pdhg shared, grid route", roots, dict(iters=600), "grid"),
            ("pdhg per-element, grid route", elem, dict(iters=600, skip=skip), "grid")):
        with forced_route(route) if route else contextlib.nullcontext():
            k0 = pdhg_solve_batch(batch, **kw)
            k1 = pdhg_solve_batch(batch, trace=True, **kw)
        r = pdhg_solve_batch_reference(batch, trace=True, **kw)
        torch.cuda.synchronize()
        held(name, k0, k1, r, TOL_PDHG_F64)
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        fail(f"traces: {bad} disagree (traced vs untraced, or against the plain trace)")

    # Traced against untraced at main-path shapes: K1 on the north-star root
    # round at a warm root's chunk (B=16, float32, 26 steps in chunks of 4),
    # K5 on the 128-device fleet's root round (B=2, float32, cold).
    batch, _, _ = ipm_batch(16, 123, 16, torch.float32, np.random.default_rng(7))
    sp = node_sparsity(batch.A, 16, moe=False)
    kw = dict(iters=26, chunk=4, sparsity=sp)
    res = ipm_solve_batch(batch, trace=True, **kw)
    steps = int(res.iters_run.sum())
    chunks = int((res.trace_buf[..., 5] > 0.5).sum())
    flops, nbytes = ipm_flops_bytes(sp, 16, steps, 4)
    # The trace adds no operation (a chunk's row is the residuals the next
    # step computes anyway), only the rows written.
    b_ms, b_by = bound_ms(flops, nbytes + res.trace_buf.numel() * 4, PEAK_F32_S)
    untraced = time_kernel(lambda: ipm_solve_batch(batch, **kw), "ipm_kernel")
    ms, call, src = time_kernel(lambda: ipm_solve_batch(batch, trace=True, **kw), "ipm_kernel")
    plain = cuda_ms(lambda: ipm_solve_batch_reference(batch, iters=26, chunk=4, trace=True),
                    reps=3, warmup=1)
    print(f"ipm_trace: traced {ms:.4f} ms, untraced {untraced[0]:.4f} ms on the card "
          f"(calls {call:.4f} / {untraced[1]:.4f} ms; plain traced {plain:.3f} ms; bound "
          f"{b_ms:.6f} ms by {b_by}) at B=16 m={sp.m} n={sp.n} float32, {steps} steps, "
          f"{chunks} trace rows", flush=True)
    report["ipm_trace"] = dict(
        name="ipm_trace", route="cuda", source="distilp_torch/kernels/csrc/ipm_kernel.cu",
        replaces="distilp_tpu/ops/ipm.py:372",
        max_abs_err=max(r["max_abs"] for r in rows if r["engine"] == "ipm"), ms=ms,
        plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, untraced_ms=untraced[0],
        untraced_call_ms=untraced[1], call_ms=call, ms_source=src,
        held_against_plain="ok", trace_rows=chunks,
        shapes_timed=f"B=16 m={sp.m} n={sp.n} float32, 26 steps in chunks of 4",
    )
    batch, _ = pdhg_roots(128, torch.float32)
    iters = default_pdhg_iters(128)
    m, n = batch.A.shape
    B = batch.b.shape[0]
    sp = ipm_sparsity(batch.A != 0)
    res = pdhg_solve_batch(batch, iters=iters, trace=True, sparsity=sp)
    flops, nbytes, _ = pdhg_flops_bytes(m, n, sp.nnz, B, res.iters_run.tolist(),
                                        PDHG_DEFAULT_CHUNK, 4, a_bytes=elem_a_bytes(sp, 1, 4),
                                        trace_rows=res.trace_buf.shape[1])
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_F32_S)
    kname = K5_KERNEL["grid" if k5_route(batch.A, torch.float32) == "grid" else "cluster"]
    untraced = time_kernel(lambda: pdhg_solve_batch(batch, iters=iters, sparsity=sp), kname)
    ms, call, src = time_kernel(
        lambda: pdhg_solve_batch(batch, iters=iters, trace=True, sparsity=sp), kname)
    plain = cuda_ms(lambda: pdhg_solve_batch_reference(batch, iters=iters, trace=True),
                    reps=1, warmup=0)
    print(f"pdhg_trace: route {k5_route(batch.A, torch.float32)}, traced {ms:.4f} ms, untraced {untraced[0]:.4f} ms on the card "
          f"(calls {call:.4f} / {untraced[1]:.4f} ms; plain traced {plain:.3f} ms; bound "
          f"{b_ms:.6f} ms by {b_by}) at B={B} m={m} n={n} float32, "
          f"iters_run={res.iters_run.tolist()}", flush=True)
    report["pdhg_trace"] = dict(
        name="pdhg_trace", route="cuda", source=K5_CLUSTER_SRC, grid_source=K5_GRID_SRC,
        replaces="distilp_tpu/ops/pdhg.py:408",
        max_abs_err=max(r["max_abs"] for r in rows if r["engine"] == "pdhg"), ms=ms,
        plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, untraced_ms=untraced[0],
        untraced_call_ms=untraced[1], call_ms=call, ms_source=src,
        held_against_plain="ok", trace_rows=int(res.trace_buf.shape[1]),
        shapes_timed=f"B={B} m={m} n={n} float32 cold, {iters} steps budget",
    )
    report["ipm_trace"]["cases_held"] = report["pdhg_trace"]["cases_held"] = [
        r["case"] for r in rows]


# ---------------------------------------------------------------- MoE shapes


def moe_model(config: str):
    from distilp_torch.profiler import profile_model

    return profile_model(str(ROOT / "tests" / "configs" / f"{config}.json"),
                         batch_sizes=[1], sequence_length=128).to_model_profile()


def moe_instance(case, device="cuda"):
    """The sweep of one MoE case on ``device``: (devs, model, coeffs, arrays,
    feasible, sf, rd_np, SweepData (one sweep's, no lane axis), (p32, p64)
    as S = 1 ``DecompBatch``es, host arrays)."""
    import numpy as np
    import torch

    from distilp_torch.ops.decomp import decomp_problem, stack_problems
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
    probs = tuple(stack_problems([decomp_problem(rd_np, sf.ks, sf.Ws, w_max, E, dt, device)])
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
    A = node_A(tests_module("torch_lanes").lane_data(data), torch.as_tensor(kidx, device=dev),
               M, torch.zeros(B, dtype=torch.int64, device=dev)).to(dtype)
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
    from distilp_torch.solver.search import node_sparsity

    *_, data, _, host = moe_instance(FLAGSHIP)
    # Every node's structure, as a solve builds it once per sweep.
    sp = node_sparsity(data.A, data.rd.a.shape[0], moe=True)
    rng = np.random.default_rng(77)
    bad, rows = [], []
    for B, dtype, iters, chunk in ((1, torch.float32, 26, 26), (16, torch.float32, 13, 4),
                                   (1, torch.float64, 26, 26), (16, torch.float64, 13, 4)):
        batch, warm, skip = moe_ipm_batch(data, host, B, dtype, rng)
        w = None if B == 1 else warm
        route = ipm_workspace_route(*batch.A.shape[1:], dtype, batch.A.device)
        k = ipm_solve_batch(batch, iters=iters, warm=w, skip=skip, chunk=chunk, sparsity=sp)
        r = ipm_solve_batch_reference(batch, iters=iters, warm=w, skip=skip, chunk=chunk)
        alone_equal = True
        if B > 1:
            for e in range(B):
                sub = LPBatch(*(t[e:e + 1] for t in batch))
                ke = ipm_solve_batch(sub, iters=iters, chunk=chunk, skip=skip[e:e + 1],
                                     warm=IPMWarmState(*(t[e:e + 1] for t in warm)),
                                     sparsity=sp)
                alone_equal &= all(torch.equal(getattr(ke, f), getattr(k, f)[e:e + 1])
                                   for f in k._fields[:-1])
        sens = None
        if dtype == torch.float64:
            bumped = batch._replace(b=batch.b * (1.0 + 2.0 ** -50))
            rs = ipm_solve_batch_reference(bumped, iters=iters, warm=w, skip=skip, chunk=chunk)
            sens = {f: max_err(getattr(rs, f), getattr(r, f))[1]
                    for f in k._fields if f not in ("converged", "iters_run", "trace_buf")}
        torch.cuda.synchronize()
        errs = {f: max_err(getattr(k, f), getattr(r, f))
                for f in k._fields if f not in ("converged", "iters_run", "trace_buf")}
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
    run_k = lambda: ipm_solve_batch(batch, iters=13, warm=warm, chunk=4, sparsity=sp)  # noqa: E731
    res = run_k()
    steps = int(res.iters_run.sum())
    b_ms, b_by = bound_ms(*ipm_flops_bytes(sp, 16, steps, 4, warm=True, a_copies=16),
                          PEAK_F32_S)
    flops, nbytes = ipm_dense_formula_flops_bytes(m, n, 16, steps, 4, warm=True)
    nbytes += 15 * m * n * 4  # 16 matrices, not one shared
    dense_b_ms = bound_ms(flops, nbytes, PEAK_F32_S)[0]
    ms, call, src = time_kernel(run_k, "ipm_kernel")
    plain = cuda_ms(lambda: ipm_solve_batch_reference(batch, iters=13, warm=warm, chunk=4),
                    reps=3, warmup=1)
    report["ipm"]["per_node_A"] = dict(
        shapes=f"B=16 m={m} n={n} float32, 13 steps",
        route=ipm_workspace_route(m, n, torch.float32, "cuda"), ms=ms, call_ms=call,
        ms_source=src,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, bound_ms_dense_formula=dense_b_ms,
        steps_timed=steps,
        max_abs_err_bound=max(r["max_abs"]["bound"] for r in rows),
    )
    print(f"ipm per-node A: {ms:.4f} ms on the card, {call:.4f} ms per call (plain "
          f"{plain:.3f} ms, bound {b_ms:.5f} ms by {b_by}, dense formula {dense_b_ms:.5f} ms) "
          f"at B=16 m={m} n={n}", flush=True)


# K2's MoE mode before the delta table (this script on an NVIDIA H100 80GB
# HBM3 at 700 W, PERF.md §6): device ms (LP rows) and CUDA-event ms a call
# (hint rows); the flagship warm tick's launch (one warm row) took 0.634
# device ms in that run's profile.
ROUND_MOE_BEFORE_MS = {"lp_rows_moves8": 2.4786, "hint_rows_repair": 2.6393,
                     "warm_row_moves2": 0.634}


def round_moe_bytes_flops(B: int, M: int, moves: int, y_steps: int):
    """Least work of one MoE rounding launch of B rows: each device's costs
    at its 11 deltas priced once (~30 float64 operations each) and again
    for the devices a step moved (two on a move step, one on a repair
    step); per candidate one table entry a device, a nan_max and an add
    (2 M operations): 5 M^2 candidates a move step, M a repair step (its
    direction follows from the sum of y); the redistributions' O(M^2).
    Bytes: the rows' LP points (float32 here), W and k, the 16 rows of the
    packed data it reads and b', the outputs."""
    table = 11 * 30 * (M + 2 * moves + y_steps)
    cands = (moves * 5 * M * M + y_steps * M) * 2 * M
    flops = B * (table + cands) + B * 2 * (M + 4) * 3 * M
    nbytes = B * 3 * M * 4 + 2 * B * 8 + (16 * M + 1) * 8 + B * (1 + 3 * M) * 8
    return flops, nbytes


def round_moe_reference_flops(B: int, M: int, moves: int, y_steps: int) -> float:
    """The reference's pricing work for the same launch, beside the bound:
    every candidate re-prices all M devices (~30 float64 operations each),
    a repair step 2 M candidates."""
    return B * (moves * 5 * M * M + y_steps * 2 * M) * M * 30 + B * 2 * (M + 4) * 3 * M


@contextlib.contextmanager
def moe_table_in_global_memory():
    """K2's MoE mode keeps each row's delta table in a global workspace,
    the route its wrapper takes where a block's shared memory cannot hold
    the row's arrays and its table (M > 668 on an H100): the workspace
    sized as the kernel lays it out (187 M bytes a row, 256-byte rows)."""
    import torch

    from distilp_torch.solver import rounding as R

    orig = R.moe_table_workspace
    R.moe_table_workspace = lambda lib, M, B, dev: torch.empty(  # noqa: E731
        B * (-(-187 * M // 256) * 256), dtype=torch.uint8, device=dev)
    try:
        yield
    finally:
        R.moe_table_workspace = orig


def check_round_moe(report: dict) -> None:
    """K2's MoE mode on the flagship, in its three modes, with the delta
    table in shared memory (the route of every M up to 668) and in global
    memory."""
    import numpy as np
    import torch

    from distilp_torch.ops.decomp import decomp_bound_roots
    from distilp_torch.ops.ipm import ipm_solve_batch
    from distilp_torch.solver.rounding import (
        round_moe_reference,
        round_to_incumbent,
        stack_rounding_data,
    )
    from distilp_torch.solver.standard_form import MOE_LOCAL_MOVES, MOE_LOCAL_MOVES_WARM

    *_, data, (p32, p64), host = moe_instance(FLAGSHIP)
    M, E = data.rd.a.shape[0], p64.e_max
    # 16 LP points of a beam round.
    batch, _, _ = moe_ipm_batch(data, host, 16, torch.float32, np.random.default_rng(5))
    v_lp = ipm_solve_batch(batch, iters=13, chunk=4).v
    kidx = torch.as_tensor(np.random.default_rng(6).integers(0, data.ks.shape[0], 16),
                           device="cuda")
    # The Lagrangian-primal hint rows at the ascent's multipliers.
    _, w_s, n_s, y_s = (x[0] for x in decomp_bound_roots(
        p32, p64, stack_rounding_data([data.rd]), 300)[:4])
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
        with moe_table_in_global_memory():
            glob = round_to_incumbent(v, W, k, data.rd, data.rd_packed, moe=True, **kw)
        ref = round_moe_reference(v, W, k, data.rd, **kw)
        torch.cuda.synchronize()
        eq = {f: bool(torch.equal(a, b)) for f, a, b in zip(("w", "n", "y"), got[1:], ref[1:])}
        glob_eq = all(torch.equal(a, b) for a, b in zip(got, glob))
        oa, orel = max_err(got[0], ref[0])
        line = {"mode": name, "rows": int(v.shape[0]), **{f"{f}_equal": e for f, e in eq.items()},
                "obj_max_abs": oa, "obj_max_rel": orel,
                "finite_rows": int(torch.isfinite(ref[0]).sum()),
                "global_table_route_bit_for_bit": glob_eq,
                "sum_y": ref[3].sum(1).tolist()}
        print("round_moe vs plain", json.dumps(line), flush=True)
        if not (all(eq.values()) and orel <= TOL_EXACT_F64 and glob_eq):
            bad.append(name)
        report.setdefault("_round_moe_err", []).append(oa)
    if bad:
        fail(f"round_moe kernel disagrees with its plain version in {bad}")
    if not bool(torch.isfinite(ref[0]).all()):
        fail("the warm row did not price finite")
    times = {}
    for name, (v, W, k, kw) in modes.items():
        def run_k():
            return round_to_incumbent(v, W, k, data.rd, data.rd_packed, moe=True, **kw)  # noqa: B023

        ms, call, src = time_kernel(run_k, "round_moe_kernel")
        y_steps = kw.get("y_steps", 0)
        moves = kw.get("moves", MOE_LOCAL_MOVES)
        flops, nbytes = round_moe_bytes_flops(int(v.shape[0]), M, moves, y_steps)
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_F64_S)
        ref_ms = bound_ms(round_moe_reference_flops(int(v.shape[0]), M, moves, y_steps), nbytes,
                          PEAK_F64_S)[0]
        times[name] = dict(ms=ms, call_ms=call, ms_source=src, bound_ms=b_ms, bound_by=b_by,
                           bound_ms_reference_work=ref_ms)
        print(f"round_moe {name}: {ms:.4f} ms on the card, {call:.4f} ms per call, bound "
              f"{b_ms:.6f} ms by {b_by} ({ref_ms:.6f} ms for the reference's pricing work; "
              f"rows={int(v.shape[0])}, y_steps={y_steps}; before the delta table "
              f"{ROUND_MOE_BEFORE_MS.get(name)} ms)", flush=True)
    v, W, k, kw = modes["lp_rows_moves8"]
    plain = cuda_ms(lambda: round_moe_reference(v, W, k, data.rd, **kw), reps=3, warmup=1)
    t = times["lp_rows_moves8"]
    report["round_moe"] = dict(
        name="round_moe", route="cuda",
        source="distilp_torch/kernels/csrc/round_moe_kernel.cu",
        replaces="distilp_tpu/solver/backend_jax.py:721",
        max_abs_err=max(report.pop("_round_moe_err")), ms=t["ms"], plain_ms=plain,
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
        held_against_plain="ok", call_ms=t["call_ms"], ms_source=t["ms_source"],
        shapes_timed=f"{FLAGSHIP[0]}: 16 LP rows, M={M}, E={E}, 8 move steps",
        by_mode=times,
    )
    print(f"round_moe: {t['ms']:.4f} ms on the card (plain {plain:.3f} ms) at B=16 M={M} "
          f"moves=8", flush=True)


def decomp_flops_bytes(p, n_evals: int = 1):
    """Least work of ``n_evals`` float32 evaluations of one instance ``p``: ~60 operations per
    cell (the five n candidates and the cell's slacks, costs and term) over
    5 n_k M w_max (e_max + 1) cells; bytes: the packed per-device vectors,
    the multipliers, and four (n_k, M) outputs."""
    n_k, M = p.ks.shape[0], p.rdv.shape[1]
    cells = 5 * n_k * M * p.w_max * (p.e_max + 1)
    isz = p.rdv.element_size()
    nbytes = (15 * M + 2 * n_k + n_k * (M + 2) + 4 * n_k * M) * isz
    return n_evals * cells * 60, n_evals * nbytes, cells


def ascent_flops_bytes(p, steps: int):
    """Least work of a ``steps``-step ascent of one float32 instance ``p``:
    the cells' (lin, cyc), which do not depend on the multipliers, priced
    once (~60 operations a cell, as ``decomp_flops_bytes``), then steps + 1
    evaluations of the term over them (three products, three sums) and its
    minimum (one comparison): 7 operations a cell; a step's gradient and
    Adam update, ~20 operations for each of the n_k (M + 2) multipliers.
    Bytes: the packed per-device vectors, k, W, b' and E, the start and the
    (steps, 3) Adam table read once, the best multipliers written once."""
    n_k, M = p.ks.shape[0], p.rdv.shape[1]
    cells = 5 * n_k * M * p.w_max * (p.e_max + 1)
    flops = cells * 60 + (steps + 1) * cells * 7 + steps * n_k * (M + 2) * 20
    nbytes = (15 * M + 2 * n_k + 2 + 2 * n_k * (M + 2) + 3 * steps) * 4
    return flops, nbytes


DECOMP_SETTINGS = (("three_steps", 3, False), ("cold_300", 300, False),
                   ("warm_300", 300, True), ("zero_steps", 0, True))
DECOMP_FIELDS = ("bound", "w_star", "n_star", "y_star", "lam", "mu", "tau", "m_y")
# K7 before the fused ascent (this script on an NVIDIA H100 80GB HBM3 at
# 700 W, PERF.md §6): the 300-step ascent's wall, a host loop of one
# per-step launch and ~50 tensor operations a step.
ASCENT_300_BEFORE_MS = {"qwen3_30b_a3b_M16": 244.4, "deepseek_v3_M32": 202.8,
                      "mixtral_M4_x4": 199.7, "deepseek_v3_M32_x2": 248.1}


def highs_per_k(arrays, feasible) -> list:
    """The HiGHS optimum of each fixed k of the instance (inf where none)."""
    from distilp_torch.solver.backend_cpu import Infeasible, solve_fixed_k_cpu

    out = []
    for k, W in feasible:
        try:
            out.append(solve_fixed_k_cpu(arrays, k, W, mip_gap=1e-9).obj_value)
        except Infeasible:
            out.append(float("inf"))
    return out


def hold_fused_ascent(name, p32, p64, rd, oracle, obj_const):
    """``decomp_bound_roots`` as the solver calls it (the fused ascent, then
    the float64 evaluation: two K7 launches, one at 0 steps) against the
    same call with the host loop over the per-step entry, the yardstick, in
    DECOMP_SETTINGS: at 3 steps every field within TOL_DECOMP_F32 relative;
    at 300 steps, cold and warm-started from the cold run's multipliers
    (the duals a warm tick stores), each float64 bound within
    TOL_ASCENT_BOUND relative and sound against ``oracle`` (S, n_k) (the
    HiGHS per-k optima; ``obj_const`` (S,)), the hint equal wherever the
    bounds are; at 0 steps bit for bit. At every setting the fused launch
    with each unit's owner state in global memory (the route of batches
    whose states shared memory cannot hold) equals the shared-memory
    route's bit for bit. (ok, max abs bound error)."""
    import torch

    from distilp_torch import kernels
    from distilp_torch.ops import decomp as D

    def flat(out):
        return tuple(out[:4]) + tuple(out[4]) + (out[5],)

    def k7():
        return kernels.LAUNCHES["decomp"] + kernels.LAUNCHES["decomp_lanes"]

    ok_all, err, stored = True, 0.0, None
    oracle = torch.tensor(oracle, dtype=torch.float64)
    for label, steps, warm in DECOMP_SETTINGS:
        init = stored if warm else None
        n0 = k7()
        got = flat(D.decomp_bound_roots(p32, p64, rd, steps, init))
        torch.cuda.synchronize()
        n_launch = k7() - n0
        with stepwise_ascent():
            ref = flat(D.decomp_bound_roots(p32, p64, rd, steps, init))
        with owners_in_global_memory():
            glob = flat(D.decomp_bound_roots(p32, p64, rd, steps, init))
        torch.cuda.synchronize()
        glob_bits = all(torch.equal(a, b) for a, b in zip(got, glob))
        if label == "cold_300":
            stored = got[4:7]
        errs = {f: max_err(a, b) for f, a, b in zip(DECOMP_FIELDS, got, ref)}
        bits = all(torch.equal(a, b) for a, b in zip(got, ref))
        full = got[0].cpu() + torch.as_tensor(obj_const, dtype=torch.float64)[:, None]
        sound = bool((full <= oracle + 1e-9 * oracle.abs().clamp(min=1.0)).all())
        line = {"case": name, "setting": label, "steps": steps, "k7_launches": n_launch,
                "bit_for_bit": bits, **{f"{f}_max_rel": e[1] for f, e in errs.items()},
                "sound": sound, "global_owner_route_bit_for_bit": glob_bits}
        if steps == 3:
            ok = all(e[1] <= TOL_DECOMP_F32 for e in errs.values())
        elif steps == 0:
            ok = bits
        else:
            same = got[0] == ref[0]
            hint_eq = all(bool((a[same] == b[same]).all()) for a, b in zip(got[1:4], ref[1:4]))
            line.update(bounds_equal=f"{int(same.sum())} of {same.numel()}",
                        hint_equal_where_bounds_equal=hint_eq,
                        bound_plus_obj_const=full.tolist())
            ok = errs["bound"][1] <= TOL_ASCENT_BOUND and sound and hint_eq
        ok = ok and sound and glob_bits and n_launch <= (2 if steps > 0 else 1)
        line["ok"] = ok
        print("decomp fused vs stepwise", json.dumps(line), flush=True)
        err = max(err, errs["bound"][0])
        ok_all = ok_all and ok
    return ok_all, err


@contextlib.contextmanager
def stepwise_ascent():
    """``decomp_bound_roots`` ascends through the host loop over the
    per-step entry (``ascend_stepwise``, a K7 launch a step): the
    yardstick of the fused launch."""
    from distilp_torch.ops import decomp as D

    orig = D.ascend
    D.ascend = D.ascend_stepwise
    try:
        yield
    finally:
        D.ascend = orig


@contextlib.contextmanager
def owners_in_global_memory():
    """The fused ascent keeps every unit's owner state in global memory,
    the route ``ascent_layout`` takes where shared memory cannot hold a
    block's states (batches of thousands of rows)."""
    from distilp_torch.ops import decomp as D

    orig = D.ascent_layout
    D.ascent_layout = lambda *a: (orig(*a)[0], 0)
    try:
        yield
    finally:
        D.ascent_layout = orig


@contextlib.contextmanager
def plain_evaluations(p32):
    """``ascend_stepwise``'s float32 evaluations through the plain version
    on the card (each instance's cells built once): the plain ascent."""
    from distilp_torch.ops import decomp as D

    cells = [D.decomp_cells(p32.instance(s)) for s in range(p32.ks.shape[0])]
    orig = D.eval32_kernel
    D.eval32_kernel = lambda p, lam, mu, theta: D._reference_by_instance(
        D.eval32_reference, p, lam, mu, theta, cells=cells)
    try:
        yield
    finally:
        D.eval32_kernel = orig


def time_ascent(name, p32, p64, oracle, obj_const, steps: int = 300):
    """The 300-step ascent on the card: the fused launch, device ms
    (profiler) and CUDA-event ms a call; the host loop over the per-step
    entry (CUDA events and host wall); the plain ascent (CUDA events, one
    run). The fused launch is held against the plain ascent: at each one's
    multipliers, the float64 bound of each (s, k) within TOL_ASCENT_BOUND
    relative and sound against ``oracle`` (S, n_k) (the HiGHS per-k
    optima; ``obj_const`` (S,)). (times, ok, max abs bound error)."""
    import torch

    from distilp_torch.ops import decomp as D

    def run():
        return D.ascend_fused(p32, steps)

    call = cuda_ms(run, reps=5, warmup=1)
    dev = device_ms(run, "decomp_ascent_kernel", reps=3)
    stepwise = cuda_ms(lambda: D.ascend_stepwise(p32, steps), reps=3, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D.ascend_stepwise(p32, steps)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    plain_out = []
    with plain_evaluations(p32):
        plain = cuda_ms(lambda: plain_out.append(D.ascend_stepwise(p32, steps)), reps=1,
                        warmup=0)

    def bound64(params):
        return D.eval64(p64, *(x.double() for x in params), False)[0]

    got, ref = bound64(run()), bound64(plain_out[0])
    torch.cuda.synchronize()
    b_abs, b_rel = max_err(got, ref)
    oracle = torch.tensor(oracle, dtype=torch.float64)
    full = got.cpu() + torch.as_tensor(obj_const, dtype=torch.float64)[:, None]
    sound = bool((full <= oracle + 1e-9 * oracle.abs().clamp(min=1.0)).all())
    ok = b_rel <= TOL_ASCENT_BOUND and sound
    print("decomp fused vs plain ascent", json.dumps(
        {"case": name, "steps": steps, "bound_max_abs": b_abs, "bound_max_rel": b_rel,
         "bounds_equal": f"{int((got == ref).sum())} of {got.numel()}", "sound": sound,
         "ok": ok}), flush=True)
    out = dict(ms=dev if dev is not None else call,
               ms_source="profiler" if dev is not None else "cuda_events", call_ms=call,
               stepwise_call_ms=stepwise, stepwise_host_ms=host, plain_ms=plain)
    print(f"decomp ascent {name}: {steps} steps in one launch {out['ms']:.4f} ms on the card "
          f"({out['ms_source']}), {call:.4f} ms per call; host loop over the per-step entry "
          f"{stepwise:.2f} ms by CUDA events, {host:.2f} ms of wall (the host loop "
          f"before: {ASCENT_300_BEFORE_MS.get(name)} ms); plain ascent {plain:.1f} ms",
          flush=True)
    return out, ok, b_abs


def check_decomp(report: dict) -> None:
    """K7 on Qwen3-30B-A3B (16 devices) and the flagship: the per-step
    float32 entry and the float64 entry against their plain versions, the
    fused ascent against the host loop (``hold_fused_ascent``), times."""
    import numpy as np
    import torch

    from distilp_torch.ops import decomp as D
    from distilp_torch.solver.rounding import stack_rounding_data

    rng = np.random.default_rng(11)
    bad, timing, abs_errs = [], {}, []
    for case in (MOE_CASES[2], FLAGSHIP):
        _, _, _, arrays, feasible, sf, _, data, (p32, p64), _ = moe_instance(case)
        # p32/p64 are S = 1 batches: the kernel entries take the batch and
        # (1, ...) multipliers, the plain versions the instance.
        i32, i64 = p32.instance(0), p64.instance(0)
        n_k, M = i32.ks.shape[0], i32.rdv.shape[1]

        def k32(lam, mu, theta):
            return [x[0] for x in D.eval32_kernel(p32, lam[None], mu[None], theta[None])]

        def k64(lam, mu, theta):
            return [x[0] for x in D.eval64_kernel(p64, lam[None], mu[None], theta[None], True)]

        # (a) float32 bound and its gradient statistics at random multipliers.
        for trial in range(3):
            lam = torch.tensor(rng.normal(0, 1, n_k), dtype=torch.float32, device="cuda")
            mu = torch.tensor(rng.normal(0, 0.3, n_k), dtype=torch.float32, device="cuda")
            tau = torch.tensor(rng.normal(0, 1, (n_k, M)), dtype=torch.float32, device="cuda")
            theta = (i32.ks - 1.0)[:, None] * D.softmax(tau)
            got = k32(lam, mu, theta)
            ref = D.eval32_reference(i32, lam, mu, theta)
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
        # (b) float64 evaluation at the multipliers of the fused ascent.
        lam, mu, tau = (x[0].double() for x in D.ascend(p32, 300))
        theta = (i64.ks - 1.0)[:, None] * D.softmax(tau)
        got = k64(lam, mu, theta)
        ref = D.eval64_reference(i64, lam, mu, theta, True)
        bound_k = D.bound_of(p64, got[0][None], got[1][None], lam[None], mu[None])[0]
        bound_r = D.bound_of(p64, ref[0][None], ref[1][None], lam[None], mu[None])[0]
        torch.cuda.synchronize()
        my_rel = max_err(got[0], ref[0])[1]
        b_rel = max_err(bound_k, bound_r)[1]
        hint_eq = all(bool(torch.equal(a, b)) for a, b in zip(got[1:], ref[1:]))
        oracle = highs_per_k(arrays, feasible)
        full = (bound_k + sf.obj_const).tolist()
        sound = all(b <= o + 1e-9 * max(1.0, abs(o)) for b, o in zip(full, oracle))
        line = {"instance": case[0], "ascent_steps": 300, "bound_plus_obj_const": full,
                "highs_per_k_optimum": oracle, "m_y_max_rel": my_rel, "bound_max_rel": b_rel,
                "hint_equal": hint_eq, "sound": sound}
        ok = my_rel <= TOL_EXACT_F64 and b_rel <= TOL_EXACT_F64 and hint_eq and sound
        line["ok"] = ok
        print("decomp f64 vs plain", json.dumps(line), flush=True)
        if not ok:
            bad.append((case[0], "f64"))
        # (c) the fused ascent against the host loop over the per-step entry.
        rd = stack_rounding_data([data.rd])
        ok, err = hold_fused_ascent(case[0], p32, p64, rd, [oracle], [sf.obj_const])
        abs_errs.append(err)
        if not ok:
            bad.append((case[0], "fused ascent"))
        # Times: the per-step entry (one evaluation), the float64 entry, the
        # 300-step ascent.
        lam32, mu32, tau32 = (x.float() for x in (lam, mu, tau))
        th32 = (i32.ks - 1.0)[:, None] * D.softmax(tau32)
        ev_ms, ev_call, ev_src = time_kernel(lambda: k32(lam32, mu32, th32), "decomp_f32_kernel")
        ev_plain = cuda_ms(lambda: D.eval32_reference(i32, lam32, mu32, th32), reps=3, warmup=1)
        ms64, call64, src64 = time_kernel(lambda: k64(lam, mu, theta), "decomp_f64_kernel")
        t, ok, err = time_ascent(case[0], p32, p64, [oracle], [sf.obj_const])
        abs_errs.append(err)
        if not ok:
            bad.append((case[0], "fused vs plain ascent"))
        flops, nbytes = ascent_flops_bytes(i32, 300)
        ref_flops, ref_bytes, cells = decomp_flops_bytes(i32, 301)
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_F32_S)
        t.update(bound_ms=b_ms, bound_by=b_by,
                 bound_ms_reference_work=bound_ms(ref_flops, ref_bytes, PEAK_F32_S)[0],
                 cells=cells, f32_eval_ms=ev_ms, f32_eval_call_ms=ev_call,
                 f32_eval_source=ev_src, f32_eval_plain_ms=ev_plain,
                 f32_eval_bound_ms=bound_ms(*decomp_flops_bytes(i32)[:2], PEAK_F32_S)[0],
                 f64_eval_ms=ms64, f64_eval_call_ms=call64, f64_eval_source=src64,
                 f64_eval_bound_ms=bound_ms(*decomp_flops_bytes(i64)[:2], PEAK_F64_S)[0])
        timing[case[0]] = t
        print(f"decomp {case[0]}: per-step f32 evaluation {ev_ms:.4f} ms on the card "
              f"({ev_call:.4f} per call, plain {ev_plain:.3f}); f64 evaluation {ms64:.4f} ms "
              f"({call64:.4f} per call, bound {t['f64_eval_bound_ms']:.5f}); 300-step ascent "
              f"{t['ms']:.4f} ms (bound {t['bound_ms']:.5f} ms by {t['bound_by']}; "
              f"{t['bound_ms_reference_work']:.5f} ms for the reference's 301 pricings of "
              f"{cells} cells)", flush=True)
    if bad:
        fail(f"decomp kernel disagrees with its plain version, its yardstick or is unsound "
             f"in {bad}")
    t = timing[FLAGSHIP[0]]
    report["decomp"] = dict(
        name="decomp", route="cuda", source="distilp_torch/kernels/csrc/decomp_kernel.cu",
        replaces="distilp_tpu/solver/backend_jax.py:963",
        max_abs_err=max(abs_errs), ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None, held_against_plain="ok",
        call_ms=t["call_ms"], ms_source=t["ms_source"],
        shapes_timed=f"{FLAGSHIP[0]}: the 300-step ascent in one launch ({t['cells']} cells, "
                     f"301 evaluations)",
        by_instance=timing,
    )


# Violation share of the edited twin vector set must lie strictly inside
# (0, 1): the set exercises the violation flag both ways.
TWIN_SAMPLES = 1024
TWIN_MC = dict(sigmas=(0.08, 0.15, 0.10, 0.05), dropout_p=0.05, dropout_slowdown=8.0,
               degrade=1.25)


def twin_cases():
    """(name, devices, model, kv bits, arrays, placement result) of the three instances the twin runs
    at full width: the north star (M=16), the MoE flagship (M=32) and the
    512-device fleet, each placed by the port's ``halda_solve`` on the card
    (the flagship at kv 8bit, the others at 4bit)."""
    from distilp_torch.solver import halda_solve
    from distilp_torch.twin import build_twin_arrays
    from distilp_torch.utils import make_synthetic_fleet

    out = []
    model = online_model()
    devs = make_synthetic_fleet(16, seed=123)
    r = halda_solve(devs, model, mip_gap=1e-3, kv_bits="4bit")
    out.append(("north_star_M16", devs, model, "4bit",
                build_twin_arrays(devs, model, kv_bits="4bit"), r))
    name, config, M, seed, pool, _ = FLAGSHIP
    model = moe_model(config)
    devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool))
    r = halda_solve(devs, model, mip_gap=MOE_GAP, kv_bits="8bit")
    out.append((name, devs, model, "8bit", build_twin_arrays(devs, model, kv_bits="8bit"), r))
    model = online_model(512)
    devs = make_synthetic_fleet(512, seed=123)
    r = halda_solve(devs, model, mip_gap=FLEET512_GAP, kv_bits="4bit")
    out.append(("fleet_M512", devs, model, "4bit",
                build_twin_arrays(devs, model, kv_bits="4bit"), r))
    return out


def violation_edit(vec):
    """A copy of ``vec`` whose device 0 sits exactly at its RAM spill cap
    with positive headroom: memory jitter below 1 then pushes the spill one
    layer over the cap (a violation), above 1 keeps it inside."""
    import copy

    import numpy as np

    e = copy.deepcopy(vec)
    cap = float(np.floor(e.ram_lhs0[0] / e.bp / 2.0))
    e.s_cap = e.s_cap.copy()
    e.ram_rhs = e.ram_rhs.copy()
    e.s_cap[0] = cap
    e.ram_rhs[0] = e.ram_lhs0[0] - cap * e.bp + 1.0
    return e


def twin_mc_work(M: int, samples: int):
    """(float64 operations, bytes) a Monte-Carlo report needs: per sample
    cell two Box-Muller pairs (~16), four jitters (~20), the straggler (2)
    and the row math (~35); per fixed cell the row math; the 14 per-device
    vectors read once, R latencies and flags written once. The Philox
    integer work is not counted, so the bound is a floor."""
    R = samples + M + 1
    flops = samples * M * 73.0 + (M + 1) * M * 35.0
    nbytes = 14 * M * 8.0 + R * 9.0
    return flops, nbytes


def check_twin_mc(report: dict, cases: list) -> None:
    import torch

    from distilp_torch.twin import engine, placement_vectors, simulate_placement

    mc = TWIN_MC
    timing = {}
    errs = []
    sets = []
    for name, _devs, _model, _kv, arrays, r in cases:
        vec = placement_vectors(arrays, r.w, r.n, y=r.y, k=r.k)
        sim = simulate_placement(arrays, r.w, r.n, y=r.y, k=r.k).latency_s
        sets.append((name, vec, sim))
    sets.append(("north_star_M16_violation_edit", violation_edit(sets[0][1]), None))
    for name, vec, sim in sets:
        vecs, sc = engine.pack_vectors(vec, "cuda")
        args = (vecs, sc, TWIN_SAMPLES, 7, mc["sigmas"], mc["dropout_p"],
                mc["dropout_slowdown"], mc["degrade"])
        lk, vk = engine.twin_mc(*args)
        lk2, vk2 = engine.twin_mc(*args)
        lr, vr = engine.twin_mc_reference(*args)
        torch.cuda.synchronize()
        a_err, r_err = max_err(lk, lr)
        flags_eq = bool(torch.equal(vk, vr))
        repeat = bool(torch.equal(lk, lk2) and torch.equal(vk, vk2))
        share = float(vk[:TWIN_SAMPLES].double().mean())
        base_rel = None if sim is None else abs(float(lk[-1]) - sim) / abs(sim)
        M = vecs.shape[1]
        line = {"set": name, "M": M, "rows": int(lk.shape[0]), "max_abs": a_err,
                "max_rel": r_err, "flags_equal": flags_eq, "repeat_bit_identical": repeat,
                "violation_share": share, "base_vs_simulate_rel": base_rel}
        print("twin_mc vs plain", json.dumps(line), flush=True)
        if r_err > TOL_EXACT_F64 or not flags_eq or not repeat:
            fail(f"twin_mc kernel disagrees with its plain version on {name}: {line}")
        if base_rel is not None and base_rel > TOL_EXACT_F64:
            fail(f"twin_mc base row on {name} is {float(lk[-1])!r}, "
                 f"simulate_placement {sim!r}")
        if sim is None and not 0.0 < share < 1.0:
            fail(f"twin_mc violation share {share} on {name}: the edited set "
                 f"should violate on some rows and not on others")
        errs.append(a_err)
        if sim is None:
            continue
        ms, call, src = time_kernel(lambda: engine.twin_mc(*args), "twin_mc_kernel")
        plain = cuda_ms(lambda: engine.twin_mc_reference(*args), reps=5)
        flops, nbytes = twin_mc_work(M, TWIN_SAMPLES)
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_F64_S)
        timing[name] = dict(M=M, samples=TWIN_SAMPLES, ms=ms, call_ms=call, ms_source=src,
                            plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        print(f"twin_mc {name}: {ms:.4f} ms on the card, {call:.4f} ms per call (plain "
              f"{plain:.3f} ms, bound {b_ms:.6f} ms by {b_by}) at M={M}, "
              f"{TWIN_SAMPLES} samples", flush=True)
    t = timing["north_star_M16"]
    report["twin_mc"] = dict(
        name="twin_mc", route="cuda", source="distilp_torch/kernels/csrc/twin_mc_kernel.cu",
        replaces="distilp_tpu/twin/engine.py:50", max_abs_err=max(errs), ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=None, held_against_plain="ok", call_ms=t["call_ms"],
        ms_source=t["ms_source"], shapes_timed="north_star_M16: 1024 samples",
        by_instance=timing,
    )


def check_hbm_stream(report: dict) -> None:
    import os

    import torch

    from distilp_torch.profiler.device import roll1

    mb = int(os.environ.get("DPERF_HBM_MB", 256))
    n = mb * 1024 * 1024 // 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    for size in (n, 1_000_003):
        x = torch.randn(size, generator=gen, device="cuda")
        bufs = [x.clone(), torch.empty_like(x)]
        for passes in range(1, 8):
            roll1(bufs[0], bufs[1])
            bufs.reverse()
            if passes in (1, 7):
                ok = torch.equal(bufs[0], torch.roll(x, passes))
                print(f"hbm_stream vs torch.roll: n={size} after {passes} passes "
                      f"equal={ok}", flush=True)
                if not ok:
                    fail(f"hbm_stream kernel differs from torch.roll after {passes} "
                         f"passes at n={size}")
    x = torch.randn(n, generator=gen, device="cuda")
    out = torch.empty_like(x)
    ms, call, src = time_kernel(lambda: roll1(x, out), "roll1_kernel")
    plain = cuda_ms(lambda: torch.roll(x, 1))
    b_ms, b_by = bound_ms(0.0, 2.0 * n * 4, PEAK_F32_S)
    report["hbm_stream"] = dict(
        name="hbm_stream", route="cuda", source="distilp_torch/kernels/csrc/profiler_kernel.cu",
        replaces="distilp_tpu/profiler/device.py:521", max_abs_err=0.0, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=plain,
        held_against_plain="ok", call_ms=call, ms_source=src,
        shapes_timed=f"one pass over {mb} MB float32",
    )
    print(f"hbm_stream: {ms:.4f} ms on the card per pass over {mb} MB, {call:.4f} ms per "
          f"call (plain and library torch.roll {plain:.4f} ms, bound {b_ms:.4f} ms by "
          f"{b_by}): {2 * n * 4 / (ms * 1e-3) / 1e12:.3f} TB/s", flush=True)


# K9b's float32 product at the edges of its design, beside the chain's
# shapes and the ragged one, in each of its layouts (the tile the host
# picks on an H100: 128x128 for the first three, 128x192 for the last
# two): K below one stage (32 k), fewer output tiles than the persistent
# grid has blocks (one an SM), K not a multiple of the stage.
GEMM_F32_EDGES = [((1, 100, 12), (12, 260)), ((1, 256, 512), (512, 768)),
                  ((1, 520, 4100), (4100, 700)), ((1, 4300, 12), (12, 400)),
                  ((1, 3400, 1000), (1000, 520))]


def check_gemm_absmax_scale(report: dict) -> None:
    """K9b, one step of the profiler's GEMM chain, at the chain's shapes
    ((B, 8192, 8192) @ (8192, 8192), B = 1, 2, 4), a ragged one and, in
    float32, GEMM_F32_EDGES: the product against ``torch.matmul`` (TF32 off)
    within TOL_GEMM of max|y|, the scale bit for bit against the plain scale
    of the kernel's own product, and the whole step equal to that; the
    float32 product repeated bit for bit (``gemm_f32_repeats``). Then the
    step against ``torch.matmul`` in turns (``gemm_turns``: the product and
    the scale apart, nvidia-smi sampled through the float32 window); the
    float32 product's ptxas line and the FFMA share of its main loop."""
    import torch

    from distilp_torch.kernels import build
    from distilp_torch.profiler import device as D

    log = build.build_dir() / "profiler.log"
    ptxas = ptxas_lines(log.read_text() if log.exists() else "", "gemm_f32_kernel")
    print("gemm f32 ptxas: " + " | ".join(ptxas), flush=True)
    sass = sass_loop(Path(build.library("profiler")._name), "gemm_f32_kernel")
    print("gemm f32 sass main loop " + json.dumps(sass), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timing, step_errs = {}, []
    S = 8192
    for dt in (torch.float32, torch.float16, torch.bfloat16):
        tag = str(dt).split(".")[-1]
        k_ragged = 1004 if dt == torch.float32 else 1000
        shapes = [((B, S, S), (S, S)) for B in (1, 2, 4)] + [((3, 1000, k_ragged),
                                                              (k_ragged, 1032))]
        if dt == torch.float32:
            shapes += GEMM_F32_EDGES
        for xs, bs in shapes:
            x = torch.randn(xs, generator=gen, device="cuda").to(dt)
            b = torch.randn(bs, generator=gen, device="cuda").to(dt)
            prod, partial = D._gemm_absmax_kernel(x, b)
            unscaled = prod.clone()
            D._rescale_kernel(prod, partial, D.GEMM_EPS)
            whole = D.gemm_absmax_scale(x, b)
            lib = torch.matmul(x, b)
            torch.cuda.synchronize()
            prod_rel = float((unscaled.float() - lib.float()).abs().amax()
                             / lib.float().abs().amax())
            scale_exact = bool(torch.equal(prod, D.absmax_scale_reference(unscaled)))
            repeat = bool(torch.equal(whole, prod))
            step_err = float((whole.float() - D.absmax_scale_reference(lib).float())
                             .abs().amax())
            step_errs.append(step_err)
            M = x.numel() // x.shape[-1]
            line = {"dtype": tag, "x": list(xs), "b": list(bs),
                    "tile": list(D.gemm_tile(dt, M, bs[1])),
                    "product_max_err_over_max": prod_rel, "scale_bit_equal": scale_exact,
                    "step_equal_to_parts": repeat, "step_max_abs_err_vs_plain": step_err}
            print("gemm_absmax_scale vs plain", json.dumps(line), flush=True)
            if not (prod_rel <= TOL_GEMM[tag] and step_err <= 2 * TOL_GEMM[tag]) \
                    or not scale_exact or not repeat:
                fail(f"gemm_absmax_scale kernel disagrees with its plain version: {line}")
            del x, b, prod, partial, unscaled, whole, lib
        x = torch.randn((1, S, S), generator=gen, device="cuda").to(dt)
        b = torch.randn((S, S), generator=gen, device="cuda").to(dt)
        ms, call, src = time_kernel(lambda: D.gemm_absmax_scale(x, b), "gemm_")
        rescale = device_ms(lambda: D.gemm_absmax_scale(x, b), "rescale_kernel")
        total = ms + (rescale or 0.0) if src == "profiler" else ms
        plain = cuda_ms(lambda: D.gemm_absmax_scale_reference(x, b), reps=5)
        library = cuda_ms(lambda: torch.matmul(x, b), reps=5)
        flops = 2.0 * S * S * S
        nbytes = 3.0 * S * S * x.element_size()
        peak = PEAK_F32_S if dt == torch.float32 else PEAK_BF16_S
        b_ms, b_by = bound_ms(flops, nbytes, peak)
        timing[tag] = dict(ms=total, rescale_ms=rescale, call_ms=call, ms_source=src,
                           plain_ms=plain, library_ms=library, bound_ms=b_ms, bound_by=b_by,
                           tflops=flops / (total * 1e-3) / 1e12)
        print(f"gemm_absmax_scale {tag}: {total:.4f} ms on the card (product "
              f"{ms:.4f} + scale {rescale}), {call:.4f} ms per call, "
              f"{timing[tag]['tflops']:.2f} TFLOP/s (plain {plain:.4f} ms, library "
              f"torch.matmul {library:.4f} ms, bound {b_ms:.4f} ms by {b_by}) at "
              f"(1, {S}, {S}) @ ({S}, {S})", flush=True)
        del x, b
    repeats = 20
    differ = gemm_f32_repeats(D, n=repeats)
    print(f"gemm f32 repeats at (4, 8192, 8192): {differ} of {repeats - 1} differ from "
          f"the first", flush=True)
    if differ:
        fail(f"gemm_absmax_scale float32: {differ} of {repeats - 1} repeated products differ")
    for tag, by_size in gemm_turns(D).items():
        timing[tag]["turns"] = by_size
    t = timing["float32"]
    report["gemm_absmax_scale"] = dict(
        name="gemm_absmax_scale", route="cuda",
        source="distilp_torch/kernels/csrc/profiler_kernel.cu",
        replaces="distilp_tpu/profiler/device.py:225", max_abs_err=max(step_errs),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], held_against_plain="ok", call_ms=t["call_ms"],
        ms_source=t["ms_source"], shapes_timed="float32 (1, 8192, 8192) @ (8192, 8192)",
        by_dtype=timing, f32_ptxas=ptxas, f32_sass_main_loop=sass, f32_repeats_differ=differ,
    )


# ---------------------------------------------------------------- sweep shapes


def per_k_bytes(B: int, M: int, n_k: int, cap: int, total: int, has_y: bool) -> int:
    """Bytes K3's two per-k entries must move in one round: the incumbent
    entry reads the rows' objectives, k's and w, n (and y on MoE rounds) and
    the per-k state and writes the new state and cap thresholds; the rank
    entry reads the first order and the child rows' k, flag and bound, and
    writes the fair keys and the per-k floors."""
    inc = B * (8 + 4 + (3 if has_y else 2) * M * 8) + n_k * (8 + 3 * M * 8) * 2 + \
        cap * (4 + 8)
    rank = total * (8 + 4 + 1 + 8 + 8) + 2 * n_k * 8
    return inc + rank


def _per_k_inputs(rng, n_k: int, M: int, B: int, cap: int, has_y: bool):
    """One sweep's random per-k incumbent and rank inputs on the card, as
    the L = 1 lane batch: (incumbent args without the gap, rank args)."""
    import numpy as np
    import torch

    from distilp_torch.solver.search import SearchState

    T = lambda a: torch.as_tensor(a, device="cuda")[None]  # noqa: E731
    obj = rng.choice([np.inf, -5.0, -4.0, 1.0, 2.0], size=B) + rng.integers(0, 3, B)
    state = SearchState(*[None] * 23)._replace(
        node_kidx=T(rng.integers(0, n_k, cap).astype(np.int32)),
        per_k_best=T(rng.choice([np.inf, -4.5, 0.0, 1.5], size=n_k)),
        per_k_w=T(rng.integers(0, 9, (n_k, M)).astype(np.float64)),
        per_k_n=T(rng.integers(0, 9, (n_k, M)).astype(np.float64)),
        per_k_y=T(rng.integers(0, 9, (n_k, M)).astype(np.float64)),
    )
    rows = [T(rng.integers(0, 9, (B, M)).astype(np.float64)) for _ in range(3)]
    inc = (T(obj), T(rng.integers(0, n_k, B).astype(np.int32)), rows[0], rows[1],
           rows[2] if has_y else None, state)
    total = cap + B
    bound = rng.choice([-np.inf, -3.0, -2.5, 0.0, 1.0, 4.0], size=total) + \
        rng.integers(0, 4, total) * 0.25
    active = rng.random(total) < rng.random()
    order = torch.argsort(T(np.where(active, bound, np.inf)), dim=1, stable=True)
    rank = (order, T(rng.integers(0, n_k, total).astype(np.int32)), T(active), T(bound),
            cap, T(rng.choice([np.inf, -1.0, 2.0], size=n_k)))
    return inc, rank


def _per_k_shape(rng):
    """(n_k, M, B, cap) of a random per-k frontier: up to 44 k's, 4 n_k rows,
    36 n_k child rows."""
    n_k, M = int(rng.integers(1, 45)), int(rng.integers(1, 40))
    B = int(rng.integers(1, 4 * n_k + 2))
    return n_k, M, B, int(rng.integers(max(B, n_k), 36 * n_k + 2))


def random_per_k_trials(rng, trials: int):
    """Random per-k incumbent and rank inputs on the card: up to 44 k's, 4 n_k
    rows, 36 n_k child rows, ties in the objectives and bounds, -inf and
    +inf bounds, dense and sparse active flags (a spill in most)."""
    for _ in range(trials):
        inc, rank = _per_k_inputs(rng, *_per_k_shape(rng), has_y=rng.random() < 0.5)
        yield inc + (float(rng.choice([1e-3, 1e-4, 0.0])),), rank


def check_bnb_per_k(report: dict) -> None:
    """K3's per-k entries (B15) against their plain versions: on every call
    of per-k solves on the card (hermes_70b, the north star, Mixtral M=4, and
    hermes_70b with a forced small capacity, so that the frontier spills and
    the fair re-rank decides what is kept) and on 300 random frontiers; all
    outputs equal bit for bit. Timed at the largest round of the default
    solves. Since the round tail's per-k mode folds them, the solves'
    rounds take the tail's plain version here, which calls them."""
    import warnings

    import numpy as np
    import torch

    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.solver import halda_solve_per_k, search
    from distilp_torch.utils import make_synthetic_fleet

    calls = {"incumbent": [], "rank": []}
    orig = {"incumbent": search.per_k_incumbent, "rank": search.per_k_fair_rank}
    plain = {"incumbent": search.per_k_incumbent_reference,
             "rank": search.per_k_fair_rank_reference}

    def capture(name):
        def fn(*args):
            calls[name].append(args)
            return orig[name](*args)
        return fn

    hermes = load_from_profile_folder(ROOT / "tests" / "profiles" / "hermes_70b")
    mixtral = (make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9)), moe_model("mixtral_8x7b"))
    runs = [
        ("hermes_70b", hermes, dict(mip_gap=1e-4, kv_bits="4bit")),
        ("north_star_M16", (make_synthetic_fleet(16, seed=123), online_model()),
         dict(mip_gap=1e-3, kv_bits="4bit")),
        ("mixtral_M4", mixtral, dict(mip_gap=MOE_GAP, kv_bits="8bit")),
        ("hermes_70b_cap12", hermes, dict(mip_gap=1e-9, kv_bits="4bit", node_cap=12, beam=12,
                                          max_rounds=8)),
    ]
    search.per_k_incumbent, search.per_k_fair_rank = capture("incumbent"), capture("rank")
    timed = None
    try:
        with reference_tail():
            for name, (devs, model), kw in runs:
                n0 = len(calls["rank"])
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    halda_solve_per_k(devs, model, **kw)
                if not name.endswith("cap12"):
                    widest = max(range(n0, len(calls["rank"])),
                                 key=lambda i: calls["incumbent"][i][0].shape[-1])
                    if timed is None or calls["incumbent"][widest][0].shape[-1] > \
                            calls["incumbent"][timed[1]][0].shape[-1]:
                        timed = (name, widest)
    finally:
        search.per_k_incumbent, search.per_k_fair_rank = orig["incumbent"], orig["rank"]
    cases = list(zip(calls["incumbent"], calls["rank"]))
    spilled = sum(bool(torch.isfinite(a[5]).any() or torch.isfinite(orig["rank"](*a)[1]).any())
                  for _, a in cases)
    cases += list(random_per_k_trials(np.random.default_rng(0), 300))
    bad = []
    for i, (a_inc, a_rank) in enumerate(cases):
        got, ref = orig["incumbent"](*a_inc), plain["incumbent"](*a_inc)
        gk, rk = orig["rank"](*a_rank), plain["rank"](*a_rank)
        torch.cuda.synchronize()
        diff = [f for f in got._fields if not torch.equal(getattr(got, f), getattr(ref, f))]
        diff += [f for f, x, y in zip(("fair_key", "per_k_dropped"), gk, rk)
                 if not torch.equal(x, y)]
        if diff:
            bad.append((i, diff))
    print("bnb_per_k vs plain", json.dumps({
        "solve_calls": len(calls["rank"]), "random_frontiers": 300,
        "solve_rounds_with_a_spill": spilled, "differing": bad[:10]}), flush=True)
    if bad:
        fail(f"bnb_per_k kernel disagrees with its plain version: {bad[:5]}")
    if spilled == 0:
        fail("bnb_per_k: no per-k round of the forced-capacity solve spilled a node")
    name, i = timed
    a_inc, a_rank = calls["incumbent"][i], calls["rank"][i]
    ms_i, call_i, src_i = time_kernel(lambda: orig["incumbent"](*a_inc), "per_k_incumbent_kernel")
    ms_r, call_r, src_r = time_kernel(lambda: orig["rank"](*a_rank), "per_k_rank_kernel")
    plain_ms = cuda_ms(lambda: plain["incumbent"](*a_inc), reps=10) + \
        cuda_ms(lambda: plain["rank"](*a_rank), reps=10)
    B, M = a_inc[2].shape[-2:]
    n_k, cap, total = a_inc[5].per_k_best.shape[-1], a_rank[4], a_rank[0].shape[-1]
    nbytes = per_k_bytes(B, M, n_k, cap, total, has_y=a_inc[4] is not None)
    b_ms, b_by = bound_ms(B * n_k + total * 8, nbytes, PEAK_F64_S)
    report["bnb_per_k"] = dict(
        name="bnb_per_k", route="cuda",
        source="distilp_torch/kernels/csrc/bnb_epilogue_kernel.cu",
        replaces="distilp_tpu/solver/backend_jax.py:1597",
        max_abs_err=0.0, ms=ms_i + ms_r, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, held_against_plain="ok", call_ms=call_i + call_r,
        ms_source=f"{src_i}+{src_r}",
        shapes_timed=f"{name}, one round: B={B} rows, M={M}, n_k={n_k}, cap={cap}, "
                     f"{total} child rows; ms is both entries",
        incumbent_ms=ms_i, rank_ms=ms_r,
    )
    print(f"bnb_per_k: {ms_i + ms_r:.4f} ms on the card a round (incumbent {ms_i:.4f}, rank "
          f"{ms_r:.4f}), {call_i + call_r:.4f} ms per call (plain {plain_ms:.3f} ms, bound "
          f"{b_ms:.6f} ms by {b_by}) at {name} B={B} M={M} n_k={n_k} cap={cap}", flush=True)


def check_price_fixed(report: dict) -> None:
    """B14, the fixed-assignment pricer, against its plain version on
    Mixtral M=4 and the DeepSeek-V3 flagship: the solver's assignment and
    edits that break each validity test (objectives within 1e-12 relative,
    +inf in the same places). Timed at the routing path's shape (one
    assignment of the flagship's 32 devices) and on the batch of edits."""
    import torch

    from distilp_torch.solver import halda_solve
    from distilp_torch.solver.rounding import (
        price_fixed_assignment,
        price_fixed_assignment_reference,
    )

    # The test suite's edit builder (numpy only).
    edits_mod = tests_module("torch_price_edits")
    EDITS, validity_edits = edits_mod.EDITS, edits_mod.validity_edits

    err, lines, timing = 0.0, [], {}
    for case in (MOE_CASES[0], FLAGSHIP):
        devs, model, *_, rd_np, data, _, _ = moe_instance(case)
        res = halda_solve(devs, model, mip_gap=MOE_GAP, kv_bits="8bit")
        W = model.L // res.k
        edits = validity_edits(W, res.w, res.n, res.y, rd_np)
        if [e[0] for e in edits[1:]] != list(EDITS):
            fail(f"price_fixed on {case[0]}: found only the edits {[e[0] for e in edits]}, "
                 f"so not every validity test of the kernel is held")
        T = lambda rows: torch.tensor(rows, dtype=torch.float64, device="cuda")  # noqa: E731
        w, n, y = (T([e[i] for e in edits]) for i in (1, 2, 3))
        P = w.shape[0]
        k = torch.full((P,), float(res.k), dtype=torch.float64, device="cuda")
        Wt = torch.full((P,), float(W), dtype=torch.float64, device="cuda")
        got = price_fixed_assignment(data.rd, k, Wt, w, n, y)
        ref = price_fixed_assignment_reference(data.rd, k, Wt, w, n, y)
        torch.cuda.synchronize()
        a, rel = max_err(got, ref)
        inf_at = [e[0] for e, v in zip(edits, ref.tolist()) if v == float("inf")]
        solved = float(ref[0]) + data.obj_const
        line = {"case": case[0], "assignments": P, "max_abs": a, "max_rel": rel,
                "infeasible": inf_at, "as_solved_plus_obj_const": solved,
                "solver_objective": res.obj_value}
        print("price_fixed vs plain", json.dumps(line), flush=True)
        if rel > TOL_EXACT_F64 or inf_at != list(EDITS) or \
                abs(solved - res.obj_value) > 1e-9 * abs(res.obj_value):
            fail(f"price_fixed kernel disagrees with its plain version on {case[0]}: {line}")
        err = max(err, a)
        one = [t[:1] for t in (k, Wt, w, n, y)]
        run1 = lambda: price_fixed_assignment(data.rd, *one)  # noqa: E731
        runP = lambda: price_fixed_assignment(data.rd, k, Wt, w, n, y)  # noqa: E731
        ms1, call1, src1 = time_kernel(run1, "price_fixed_kernel")
        msP, _, _ = time_kernel(runP, "price_fixed_kernel")
        plain1 = cuda_ms(lambda: price_fixed_assignment_reference(data.rd, *one), reps=10)
        M = len(res.w)
        timing[case[0]] = dict(M=M, ms_one=ms1, call_ms_one=call1, ms_source=src1,
                               plain_ms_one=plain1, ms_batch=msP, batch=P)
        lines.append((case[0], M, ms1, call1, plain1, msP, P, src1))
    name, M, ms1, call1, plain1, msP, P, src1 = lines[-1]
    # One assignment: w, n, y and the 14 rows of the packed data that price()
    # reads (M each), b', W, k, E in; the objective out; ~40 float64
    # operations a device.
    b_ms, b_by = bound_ms(40 * M, (17 * M + 5) * 8, PEAK_F64_S)
    report["price_fixed"] = dict(
        name="price_fixed", route="cuda",
        source="distilp_torch/kernels/csrc/round_moe_kernel.cu",
        replaces="distilp_tpu/solver/backend_jax.py:791",
        max_abs_err=err, ms=ms1, plain_ms=plain1, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, held_against_plain="ok", call_ms=call1, ms_source=src1,
        shapes_timed=f"{name}: one assignment of M={M} devices (routing's shape)",
        by_instance=timing,
    )
    print(f"price_fixed: {ms1:.4f} ms on the card, {call1:.4f} ms per call (plain "
          f"{plain1:.3f} ms, bound {b_ms:.7f} ms by {b_by}) at one assignment of M={M}; "
          f"{msP:.4f} ms for {P} assignments", flush=True)


# ---------------------------------------------------------------- lanes


def scenario_fleets(devs, S: int, seed: int, lo: float = 0.5, hi: float = 2.0):
    """S what-if t_comm futures of ``devs`` (bench.py:809-816's draw)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(S):
        snap = [d.model_copy(deep=True) for d in devs]
        for d in snap:
            d.t_comm = max(0.0, d.t_comm * float(rng.uniform(lo, hi)))
        out.append(snap)
    return out


def lane_inputs(fleets, model, kv_bits: str, factors=None, M_pad=None):
    """The host half of each fleet's sweep (``backend_torch.LaneInput``),
    on one k grid; ``M_pad`` pads dense fleets with phantom devices."""
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.backend_torch import lane_input
    from distilp_torch.solver.batchlayout import pad_instance

    out = []
    for i, devs in enumerate(fleets):
        Ks, _, coeffs, arrays = _build_instance(
            devs, model, None, kv_bits, None, None if factors is None else factors[i], 1)
        kWs = [(k, model.L // k) for k in Ks]
        feasible = [(k, W) for k, W in kWs if W >= len(devs)]
        if M_pad is not None and M_pad != len(devs):
            coeffs, arrays = pad_instance(coeffs, arrays, M_pad)
        out.append(lane_input(arrays, coeffs, kWs, feasible))
    return out


def pack_lane(devs, model, mip_gap, M_pad=None, k_candidates=None, **kw):
    """``(PackedInstance, device sets)`` of one dense fleet at kv 4bit, as a
    batch-layout lane."""
    from distilp_torch.solver import pack_instance
    from distilp_torch.solver.api import _build_instance

    Ks, sets, coeffs, arrays = _build_instance(devs, model, k_candidates, "4bit", False, None, 1)
    return pack_instance(arrays, [(k, model.L // k) for k in Ks], mip_gap=mip_gap,
                         coeffs=coeffs, M_pad=M_pad, **kw), sets


# The stream path's mixed-M bucket: fleets of 4, 6 and 8 devices (seeds 4,
# 7, 8) padded to 8, at k 8 and 10 (tests/test_combine.py:103-125).
MIXED_M = [(4, 4), (6, 7), (8, 8)]
MIXED_KS = [8, 10]


def mixed_m_fleets():
    from distilp_torch.utils import make_synthetic_fleet

    return [make_synthetic_fleet(M, seed=s) for M, s in MIXED_M]


def per_k_lanes(model):
    """The mixed-M bucket's fleets as per-k lanes (``per_k_optima=True``)."""
    return [pack_lane(f, model, STREAM_GAP, M_pad=8, k_candidates=MIXED_KS,
                      per_k_optima=True)[0] for f in mixed_m_fleets()]


def mixtral_regimes_solve(model, timings=None):
    """``halda_solve_scenarios`` on Mixtral over make_synthetic_fleet(4,
    seed=7, pool_bytes=64e9) under the four MIXTRAL_REGIMES load factors."""
    import warnings

    from distilp_torch.solver import halda_solve_scenarios
    from distilp_torch.utils import make_synthetic_fleet

    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return halda_solve_scenarios([devs] * 4, model, kv_bits="8bit", mip_gap=MOE_GAP,
                                     load_factors_list=MIXTRAL_REGIMES, timings=timings)


@contextlib.contextmanager
def captured(module, name: str, calls: list):
    """Record every call of ``module.name`` (its args and keywords) made
    inside the block; yields the original function. Searches inside the
    block take the host loop, whose rounds call the wrappers one by one (a
    graph launch runs the same kernels on the same rows, bit for bit, the
    ``packed`` path holds, but calls no wrapper)."""
    from distilp_torch.solver import device_loop

    orig = getattr(module, name)

    def record(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    setattr(module, name, record)
    try:
        with device_loop.host_loop():
            yield orig
    finally:
        setattr(module, name, orig)


def stacked_rd(lanes):
    import torch

    from distilp_torch.solver.rounding import rounding_data, stack_rounding_data

    return stack_rounding_data([rounding_data(ln.rd_np, torch.device("cuda")) for ln in lanes])


def lane_row(name, source, replaces, err, ms, plain, single_ms, b_ms, b_by, call, src, shapes):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, held_against_plain="ok", call_ms=call, ms_source=src,
                single_instance_launches_ms=single_ms, held_against_single_launches="ok",
                shapes_timed=shapes)


def check_round_lanes(report: dict) -> None:
    """K2 with a per-row instance: the 48 beam rows of 8 north-star
    scenarios (t_comm 0.5-2.0x) and a 12-device fleet padded to 16, in one
    launch, against the plain version and, bit for bit, against one
    single-instance launch per instance."""
    import numpy as np
    import torch

    from distilp_torch.ops.ipm import ipm_solve_batch
    from distilp_torch.solver.rounding import (
        _by_instance,
        pack_rounding_data,
        rd_instance,
        round_to_incumbent,
        round_to_incumbent_reference,
    )
    from distilp_torch.utils import make_synthetic_fleet

    model = online_model()
    lanes = lane_inputs(scenario_fleets(make_synthetic_fleet(16, seed=123), 8, 17), model,
                        "4bit")
    lanes += lane_inputs([make_synthetic_fleet(12, seed=5)], model, "4bit", M_pad=16)
    rd = stacked_rd(lanes)
    packed = pack_rounding_data(rd)
    R, M, B = len(lanes), 16, 48
    rng = np.random.default_rng(5)
    batch, _, _ = ipm_batch(16, 123, B, torch.float32, rng)
    v = ipm_solve_batch(batch, iters=8, chunk=8).v
    kWs = lanes[0].feasible
    kidx = rng.integers(0, len(kWs), B)
    dev = torch.device("cuda")
    W = torch.tensor([float(kWs[j][1]) for j in kidx], dtype=torch.float64, device=dev)
    k = torch.tensor([float(kWs[j][0]) for j in kidx], dtype=torch.float64, device=dev)
    inst = torch.as_tensor(rng.integers(0, R, B), device=dev)
    got = round_to_incumbent(v, W, k, rd, packed, inst=inst)
    ref = _by_instance(round_to_incumbent_reference, v, W, k, rd, inst)
    groups = [(q, (inst == q).nonzero()[:, 0], rd_instance(rd, q)) for q in range(R)]
    groups = [(q, rows, rdq, pack_rounding_data(rdq)) for q, rows, rdq in groups if rows.numel()]

    def singles():
        return [round_to_incumbent(v[rows], W[rows], k[rows], rdq, pq)
                for _, rows, rdq, pq in groups]

    one = singles()
    torch.cuda.synchronize()
    eq_plain = bool(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]))
    oa, orel = max_err(got[0], ref[0])
    eq_single = all(torch.equal(g[rows], o) for (_, rows, _, _), out in zip(groups, one)
                    for g, o in zip(got, out))
    padded = got[1][inst == R - 1][:, 12:]
    line = {"rows": B, "instances": R, "w_n_equal_plain": eq_plain, "obj_max_rel": orel,
            "equal_to_single_launches": eq_single, "finite_rows": int(torch.isfinite(ref[0]).sum()),
            "padded_rows_phantom_w_zero": bool((padded == 0).all())}
    print("round_incumbent lanes", json.dumps(line), flush=True)
    if not (eq_plain and orel <= TOL_EXACT_F64 and eq_single and bool((padded == 0).all())):
        fail(f"round_incumbent per-instance entry disagrees: {line}")
    ms, call, src = time_kernel(lambda: round_to_incumbent(v, W, k, rd, packed, inst=inst),
                                "round_kernel")
    plain = cuda_ms(lambda: _by_instance(round_to_incumbent_reference, v, W, k, rd, inst), reps=5)
    single_ms = cuda_ms(singles, reps=10)
    nbytes = B * 2 * M * 4 + R * (12 * M + 1) * 8 + B * (4 + 16) + B * (1 + 2 * M) * 8
    b_ms, b_by = bound_ms(B * ((M + 4) * 3 * M + 40 * M), nbytes, PEAK_F64_S)
    report["round_incumbent_lanes"] = lane_row(
        "round_incumbent_lanes", "distilp_torch/kernels/csrc/round_kernel.cu",
        "distilp_tpu/solver/backend_jax.py:639 (vmapped over sweeps by :2577, :2633)",
        oa, ms, plain, single_ms, b_ms, b_by, call, src,
        f"{B} rows of {R} instances (8 north-star scenarios, one padded 12 -> 16), M=16")
    print(f"round_incumbent_lanes: {ms:.4f} ms on the card, {call:.4f} ms per call (plain "
          f"{plain:.3f} ms, {len(groups)} single-instance launches {single_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms by {b_by})", flush=True)


def round_moe_lane_check(round_fn, v, W, k, rd, packed, inst, y_steps, moves):
    """One per-instance launch of K2's MoE mode against the plain version
    and, bit for bit, against one single-instance launch per instance:
    (line, ok, max abs objective error)."""
    import torch

    from distilp_torch.solver.rounding import _by_instance, rd_instance, round_moe_reference

    kw = dict(moe=True, y_steps=y_steps, moves=moves)
    got = round_fn(v, W, k, rd, packed, inst=inst, **kw)
    ref = _by_instance(round_moe_reference, v, W, k, rd, inst, y_steps, moves)
    ones = []
    for q in torch.unique(inst).tolist():
        rows = (inst == q).nonzero()[:, 0]
        ones.append((rows, round_fn(v[rows], W[rows], k[rows], rd_instance(rd, q), **kw)))
    torch.cuda.synchronize()
    eq = all(torch.equal(a, b) for a, b in zip(got[1:], ref[1:]))
    oa, orel = max_err(got[0], ref[0])
    eq1 = all(torch.equal(g[rows], o) for rows, out in ones for g, o in zip(got, out))
    line = {"rows": int(v.shape[0]), "instances": len(ones), "y_steps": y_steps,
            "moves": moves, "w_n_y_equal_plain": eq, "obj_equal_plain": bool(torch.equal(
                got[0], ref[0])), "obj_max_rel": orel, "equal_to_single_launches": eq1,
            "finite_rows": int(torch.isfinite(ref[0]).sum())}
    return line, eq and orel <= TOL_EXACT_F64 and eq1, oa


def check_round_moe_lanes(report: dict) -> None:
    """K2's MoE mode with a per-row instance, each launch against the plain
    version and, bit for bit, against single-instance launches: every call
    of the stream path's Mixtral M=4 batch over four load regimes (its LP
    rows with 8 move steps, its Lagrangian hint rows repaired at
    y_steps = E + 4 from the lockstep ascent), and the flagship with a +-5%
    t_comm drift of it (two instances: 16 LP rows, the 2 n_k hint rows)."""
    import numpy as np
    import torch

    from distilp_torch.ops.decomp import decomp_bound_roots, decomp_problem, stack_problems
    from distilp_torch.ops.ipm import ipm_solve_batch
    from distilp_torch.solver import search
    from distilp_torch.solver.rounding import (
        _by_instance,
        pack_rounding_data,
        rd_instance,
        round_moe_reference,
        round_to_incumbent,
    )
    from distilp_torch.solver.standard_form import MOE_LOCAL_MOVES

    err, bad = 0.0, []
    # The stream path's own launches: the Mixtral scenario batch's calls.
    calls = []
    with captured(search, "round_to_incumbent", calls):
        mixtral_regimes_solve(moe_model(MOE_CASES[0][1]))
    stream = {"lp_rows": 0, "hint_rows": 0}
    for args, kw in calls:
        v, W, k, rd, packed = args
        if not kw.get("moe") or rd.a.dim() != 2 or rd.a.shape[0] < 2:
            continue
        mode = "hint_rows" if kw.get("y_steps") is not None else "lp_rows"
        stream[mode] += 1
        line, ok, oa = round_moe_lane_check(round_to_incumbent, v, W, k, rd, packed,
                                            kw["inst"], kw.get("y_steps"),
                                            kw.get("moves", MOE_LOCAL_MOVES))
        print("round_moe lanes", json.dumps({"case": "mixtral_M4_x4 stream call",
                                             "mode": mode, **line}), flush=True)
        if not ok:
            bad.append(("mixtral_M4_x4", mode, stream[mode]))
        err = max(err, oa)
    print("round_moe lanes: the Mixtral batch's multi-instance calls", json.dumps(stream),
          flush=True)
    if not (stream["lp_rows"] and stream["hint_rows"]):
        fail(f"round_moe lanes: the Mixtral batch gave no LP-row or hint-row call {stream}")

    devs, model, *_, data, _, host = moe_instance(FLAGSHIP)
    fleets = [devs] + scenario_fleets(devs, 1, 3, 0.95, 1.05)
    lanes = lane_inputs(fleets, model, "8bit")
    rd = stacked_rd(lanes)
    packed = pack_rounding_data(rd)
    M, E = 32, int(lanes[0].E)
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    batch, _, _ = moe_ipm_batch(data, host, 16, torch.float32, rng)
    v_lp = ipm_solve_batch(batch, iters=13, chunk=4).v
    kidx = torch.as_tensor(rng.integers(0, data.ks.shape[0], 16), device=dev)
    inst_lp = torch.as_tensor(np.arange(16) % 2, device=dev)
    w_max = max(W for _, W in lanes[0].feasible)
    probs = [stack_problems([decomp_problem(ln.rd_np, ln.sf.ks, ln.sf.Ws, w_max, E, dt, dev)
                             for ln in lanes]) for dt in (torch.float32, torch.float64)]
    _, w_s, n_s, y_s, _, _ = decomp_bound_roots(*probs, rd, 300)
    n_k, nf = w_s.shape[1], v_lp.shape[1]
    v_hint = torch.zeros((2 * n_k, nf), dtype=torch.float64, device=dev)
    for j, t in enumerate((w_s, n_s, y_s)):
        v_hint[:, j * M:(j + 1) * M] = t.reshape(-1, M)
    inst_h = torch.arange(2, device=dev).repeat_interleave(n_k)
    Ws, ks = torch.cat([data.Ws] * 2), torch.cat([data.ks] * 2)
    modes = {
        "lp_rows_moves8": (v_lp, data.Ws[kidx], data.ks[kidx], inst_lp, None, MOE_LOCAL_MOVES),
        "hint_rows_repair": (v_hint, Ws, ks, inst_h, E + 4, MOE_LOCAL_MOVES),
    }
    for name, (v, W, k, inst, y_steps, moves) in modes.items():
        line, ok, oa = round_moe_lane_check(round_to_incumbent, v, W, k, rd, packed, inst,
                                            y_steps, moves)
        print("round_moe lanes", json.dumps({"case": FLAGSHIP[0], "mode": name, **line}),
              flush=True)
        if not ok:
            bad.append((FLAGSHIP[0], name))
        err = max(err, oa)
    if bad:
        fail(f"round_moe per-instance entry disagrees in {bad}")
    v, W, k, inst, _, _ = modes["lp_rows_moves8"]
    kw = dict(moves=MOE_LOCAL_MOVES)
    ms, call, src = time_kernel(
        lambda: round_to_incumbent(v, W, k, rd, packed, moe=True, inst=inst, **kw),
        "round_moe_kernel")
    plain = cuda_ms(lambda: _by_instance(round_moe_reference, v, W, k, rd, inst, None,
                                         MOE_LOCAL_MOVES), reps=3, warmup=1)
    r0, r1 = rd_instance(rd, 0), rd_instance(rd, 1)
    single_ms = cuda_ms(lambda: [round_to_incumbent(v[q::2], W[q::2], k[q::2], rq, moe=True, **kw)
                                 for q, rq in ((0, r0), (1, r1))], reps=5, warmup=1)
    flops, nbytes = round_moe_bytes_flops(16, M, MOE_LOCAL_MOVES, 0)
    b_ms, b_by = bound_ms(flops, nbytes + (16 * M + 1) * 8 + 16 * 4, PEAK_F64_S)
    report["round_moe_lanes"] = lane_row(
        "round_moe_lanes", "distilp_torch/kernels/csrc/round_moe_kernel.cu",
        "distilp_tpu/solver/backend_jax.py:721 (vmapped over sweeps by :2577, :2633)",
        err, ms, plain, single_ms, b_ms, b_by, call, src,
        f"{FLAGSHIP[0]}: 16 LP rows of 2 instances, M={M}, E={E}, 8 move steps")
    report["round_moe_lanes"]["stream_calls_held"] = stream
    print(f"round_moe_lanes: {ms:.4f} ms on the card, {call:.4f} ms per call (plain "
          f"{plain:.3f} ms, 2 single-instance launches {single_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms by {b_by}; 2.459 ms on the card before the delta table)", flush=True)


def scenario_prep(fleets, model, kv_bits, factors=None, gap=1e-3):
    """The scenarios' lane data and root frontiers on the card, as
    ``solve_sweep_scenarios`` uploads them."""
    import torch

    from distilp_torch.solver.backend_torch import _prepare, _search_params

    lanes = lane_inputs(fleets, model, kv_bits, factors)
    params = _search_params(lanes[0].sf, None, None, None, None, None, "auto", None, None,
                            None, False)
    return _prepare(lanes, params, gap, torch.device("cuda"), shared_A=True)


def check_epilogue_lanes(report: dict) -> None:
    """K3 with a per-row instance (per-lane obj_const and integer mask) on
    the root round of the 8 north-star scenarios, against the plain version
    and, bit for bit, against one single-instance launch per lane."""
    import torch

    from distilp_torch.ops.ipm import IPMResult
    from distilp_torch.solver import search
    from distilp_torch.utils import make_synthetic_fleet

    prep = scenario_prep(scenario_fleets(make_synthetic_fleet(16, seed=123), 8, 17),
                         online_model(), "4bit")
    captured = {}
    orig = search.bnb_epilogue

    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return orig(*args, **kw)

    search.bnb_epilogue = capture
    try:
        n_k = prep.data.ks.shape[1]
        with reference_tail():
            search.bnb_round(prep.data, prep.state, 1e-3, ipm_iters=8, beam=n_k, ipm_chunk=8)
    finally:
        search.bnb_epilogue = orig
    args, kw = captured["args"], captured["kw"]
    inst = kw["inst"]
    got = orig(*args, **kw)
    ref = search.bnb_epilogue_reference(*args, **kw)
    L = prep.data.ks.shape[0]

    def singles():
        out = []
        for q in range(L):
            rows = (inst == q).nonzero()[:, 0]
            a = [t[rows] for t in args[:2]] + \
                [IPMResult(*[None if f is None else f[rows] for f in args[2]])] + \
                [t[rows] for t in args[3:7]] + [args[7][q:q + 1], args[8][q:q + 1]] + \
                [t[rows] for t in args[9:]]
            out.append((rows, orig(*a, inst=torch.zeros_like(rows))))
        return out

    ones = singles()
    torch.cuda.synchronize()
    bad = [f for f in got._fields if not torch.equal(getattr(got, f), getattr(ref, f))]
    bad1 = sorted({f for rows, o in ones for f in got._fields
                   if not torch.equal(getattr(got, f)[rows], getattr(o, f))})
    print("bnb_epilogue lanes", json.dumps({"rows": int(args[0].shape[0]), "lanes": L,
          "fields_differing_plain": bad, "fields_differing_single_launches": bad1}), flush=True)
    if bad or bad1:
        fail(f"bnb_epilogue per-instance entry disagrees: plain {bad}, single launches {bad1}")
    B, nf = args[0].shape
    m = args[2].y_dual.shape[1]
    ms, call, src = time_kernel(lambda: orig(*args, **kw), "bnb_epilogue_kernel")
    plain = cuda_ms(lambda: search.bnb_epilogue_reference(*args, **kw), reps=5)
    single_ms = cuda_ms(singles, reps=10)
    nbytes = B * nf * (40 + 28) + B * m * (8 + 4) + B * (32 + 2 + 10 + 4) + L * (nf + 8)
    b_ms, b_by = bound_ms(B * nf * 30, nbytes, PEAK_F64_S)
    report["bnb_epilogue_lanes"] = lane_row(
        "bnb_epilogue_lanes", "distilp_torch/kernels/csrc/bnb_epilogue_kernel.cu",
        "distilp_tpu/solver/backend_jax.py:1569 (vmapped over sweeps by :2577, :2633)",
        0.0, ms, plain, single_ms, b_ms, b_by, call, src,
        f"root round of {L} north-star scenarios: B={B} rows, nf={nf}")
    print(f"bnb_epilogue_lanes: {ms:.4f} ms on the card, {call:.4f} ms per call (plain "
          f"{plain:.3f} ms, {L} single-instance launches {single_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms by {b_by}) at B={B} nf={nf}", flush=True)


@contextlib.contextmanager
def reference_tail():
    """Rounds inside the block take the round tail's plain version (K2, the
    tensor code and K3, the sequence the fused launch replaced), on the
    host loop."""
    from distilp_torch.solver import device_loop, search

    orig = search.round_tail
    search.round_tail = search.round_tail_reference
    try:
        with device_loop.host_loop():
            yield
    finally:
        search.round_tail = orig


@contextlib.contextmanager
def plain_kernels():
    """K2's, K3's and B15's plain versions inside the round tail's plain
    version: the tail as plain PyTorch alone."""
    from distilp_torch.solver import search
    from distilp_torch.solver.rounding import (
        _by_instance,
        round_moe_reference,
        round_to_incumbent_reference,
    )
    from distilp_torch.solver.standard_form import MOE_LOCAL_MOVES

    def rounding(v, W, k, rd, packed=None, moe=False, y_steps=None, moves=MOE_LOCAL_MOVES,
                 inst=None):
        if moe:
            return _by_instance(round_moe_reference, v, W, k, rd, inst, y_steps, moves)
        return _by_instance(round_to_incumbent_reference, v, W, k, rd, inst)

    names = ("round_to_incumbent", "bnb_epilogue", "per_k_incumbent", "per_k_fair_rank")
    orig = {n: getattr(search, n) for n in names}
    plain = (rounding, search.bnb_epilogue_reference, search.per_k_incumbent_reference,
             search.per_k_fair_rank_reference)
    for n, fn in zip(names, plain):
        setattr(search, n, fn)
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(search, n, fn)


def tail_differs(got, ref) -> list:
    """The fields of two (state, go) pairs that differ: values equal, NaN at
    the same places (-0.0 counts as 0.0)."""
    import torch

    def same(a, b):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if not a.dtype.is_floating_point:
            return torch.equal(a, b)
        na, nb = torch.isnan(a), torch.isnan(b)
        return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])

    (s1, g1), (s2, g2) = got, ref
    bad = [f for f in s1._fields if not same(getattr(s1, f), getattr(s2, f))]
    return bad + ([] if same(g1, g2) else ["go"])


def tail_same_bits(got, ref) -> bool:
    import torch

    (s1, g1), (s2, g2) = got, ref
    return all(torch.equal(bits(a), bits(b)) for a, b in zip((*s1, g1), (*s2, g2)))


def tail_flops_bytes(args):
    """(operations, bytes) of one round tail: every state field it reads
    read once and its new state written once (in per-k mode the per-k
    assignments and floors too), the LP result and the rounding inputs read
    once; K2's rounding operations on the beam rows (dense mode, as
    check_round counts them) and K3's ~30 a column."""
    data, state, res, _, B, rounded, frozen, *per_k = args
    L, cap, nf = state.node_lo.shape
    M = state.inc_w.shape[1]

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    passed = () if per_k and per_k[0] else ("per_k_w", "per_k_n", "per_k_y", "per_k_dropped")
    fields = [t for f, t in zip(state._fields, state) if f not in passed]
    lp = (res.v, res.reduced, res.y_dual, res.z_dual, res.f_dual, res.bound, res.iters_run)
    ins = (*lp, data.int_mask, data.obj_const, frozen,
           *((data.Ws, data.ks, data.rd_packed) if rounded is None else rounded))
    nbytes = 2 * nb(*fields) + nb(*ins) + L
    flops = L * B * nf * 30
    if rounded is None:
        flops += L * B * ((M + 4) * 3 * M + 40 * M)
    return flops, nbytes


def kernel_launches(fn) -> dict:
    """One call's kernel launches: the wrappers' counts, the device kernels
    the profiler saw and the runtime launch calls it recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distilp_torch import kernels

    fn()
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evts = prof.key_averages()
    return {
        "wrappers": {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]},
        "device_kernels": sum(e.count for e in evts
                              if _is_device(e) and "memcpy" not in e.key.lower()
                              and "memset" not in e.key.lower()),
        "runtime_launches": sum(e.count for e in evts if not _is_device(e)
                                and "launch" in e.key.lower() and "kernel" in e.key.lower()),
    }


def host_ms(fn, reps: int = 20) -> float:
    """Median host wall (ms) of ``fn()``'s enqueue, the card drained before
    each call."""
    import torch

    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return sorted(walls)[reps // 2]


def round_tail_cases() -> dict:
    """The round tails of eleven cases as the search hands them over: the
    north star's rounds (cold solve), the S=8 scenario batch's and the same
    with lane 3 frozen, the DeepSeek-V3 flagship's root and second MoE
    rounds, the fleet M=128's rounds on the PDHG engine and the north star's
    rounds on K10's 8 shards of a virtual mesh of this card; per-k rounds
    (``per_k``): ``halda_solve_per_k`` on hermes_70b, the north star and
    Mixtral M=4 (MoE rows), the stream path's per-k lanes and the same with
    lane 1 frozen, three rounds of the north star per k on K10's 8 shards,
    and hermes_70b per k at a forced capacity of 12, whose rounds spill."""
    import warnings

    import torch

    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.parallel import solve_sweep_sharded
    from distilp_torch.solver import (
        halda_solve,
        halda_solve_per_k,
        halda_solve_scenarios,
        search,
        solve_batch,
    )
    from distilp_torch.solver.search import root_state
    from distilp_torch.utils import make_synthetic_fleet

    def tails(fn):
        calls = []
        with captured(search, "round_tail", calls):
            fn()
        return [a for a, _ in calls]

    cases = {}
    model = online_model()
    with uncounted():
        cases["north_star"] = tails(lambda: halda_solve(
            make_synthetic_fleet(16, seed=123), model, mip_gap=1e-3, kv_bits="4bit"))
        calls = tails(lambda: halda_solve_scenarios(
            scenario_fleets(make_synthetic_fleet(16, seed=123), 8, 17), model, mip_gap=1e-3,
            kv_bits="4bit"))
        frozen = torch.zeros(calls[0][1].node_lo.shape[0], dtype=torch.bool, device="cuda")
        frozen[3] = True
        cases["scenarios_S8_frozen"] = calls + [a[:6] + (frozen,) for a in calls]
        *_, feasible, sf, _, data, _, host = moe_instance(FLAGSHIP)
        ldata = tests_module("torch_lanes").lane_data(data)
        state = root_state(torch.as_tensor(host["lo_k"], device="cuda")[None],
                           torch.as_tensor(host["hi_k"], device="cuda")[None], sf.M, 256,
                           host["A"].shape[0])

        def flagship_rounds():
            root, _ = search.bnb_round(ldata, state, MOE_GAP, beam=len(feasible))
            search.bnb_round(ldata, root, MOE_GAP, beam=16)

        cases["flagship_moe"] = tails(flagship_rounds)
        cases["fleet_M128_pdhg"] = tails(lambda: halda_solve(
            make_synthetic_fleet(128, seed=123), online_model(128), mip_gap=FLEET128_GAP,
            kv_bits="4bit"))
        _, _, coeffs, arrays, feasible, _, _ = load_instance(16, 123)
        cases["k10_north_star_8_shards"] = tails(lambda: solve_sweep_sharded(
            arrays, feasible, coeffs, virtual_mesh(8), mip_gap=MESH_SWEEP_GAP))
        hermes = load_from_profile_folder(ROOT / "tests" / "profiles" / "hermes_70b")
        cases["per_k_hermes_70b"] = tails(lambda: halda_solve_per_k(
            *hermes, mip_gap=1e-4, kv_bits="4bit"))
        cases["per_k_north_star"] = tails(lambda: halda_solve_per_k(
            make_synthetic_fleet(16, seed=123), model, mip_gap=1e-3, kv_bits="4bit"))
        cases["per_k_mixtral_M4"] = tails(lambda: halda_solve_per_k(
            make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9)), moe_model("mixtral_8x7b"),
            mip_gap=MOE_GAP, kv_bits="8bit"))
        calls = tails(lambda: solve_batch(per_k_lanes(model)))
        frozen = torch.zeros(calls[0][1].node_lo.shape[0], dtype=torch.bool, device="cuda")
        frozen[1] = True
        cases["per_k_lanes_frozen"] = calls + [a[:6] + (frozen, True) for a in calls]
        cases["per_k_k10_north_star_8_shards"] = tails(lambda: solve_sweep_sharded(
            arrays, feasible, coeffs, virtual_mesh(8), mip_gap=MESH_SWEEP_GAP, per_k=True,
            max_rounds=3))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cases["per_k_hermes_cap12_spill"] = tails(lambda: halda_solve_per_k(
                *hermes, mip_gap=1e-9, kv_bits="4bit", node_cap=12, beam=12, max_rounds=8))
    for name, calls in cases.items():
        per_k = name.startswith("per_k_")
        if not calls or any(bool(len(a) > 7 and a[7]) != per_k for a in calls):
            fail(f"round tail case {name}: {len(calls)} tails, not all {'' if per_k else 'non-'}"
                 f"per-k")
    return cases


# Per-k tails stretched from a captured one: (L, n_k, cap, beam). The first
# is the largest per-k shape the tail takes (1142 keys a lane, B15's lane
# timing shape); the others spill hard, or hold few k's.
STRETCHED_PER_K = ((8, 43, 992, 150), (3, 9, 12, 12), (2, 5, 40, 30), (4, 20, 100, 64))


def stretched_per_k_tail(args, rng, L: int, n_k: int, cap: int, B: int):
    """A captured dense per-k round tail stretched to L lanes, n_k k's,
    capacity ``cap`` and beam ``B``: the state's rows and the LP rows drawn
    from the captured ones, each k's rounding data from a captured k's; the
    k's, active flags, bounds (ties, +-inf), per-k bests and floors and
    the frozen lanes drawn at random."""
    import numpy as np
    import torch

    from distilp_torch.solver.rounding import RoundingData

    data, state, res, gap, B0 = args[:5]
    dev = state.node_lo.device
    cap0, nk0 = state.node_lo.shape[1], state.per_k_best.shape[1]
    T = lambda a, dt=None: torch.as_tensor(a, device=dev, dtype=dt)  # noqa: E731
    rows, lp, ks = (T(rng.integers(0, cap0, (L, cap))), T(rng.integers(0, B0, L * B)),
                    T(rng.integers(0, nk0, n_k)))
    lanes = lambda t: t[:1].expand(L, *t.shape[1:]).contiguous()  # noqa: E731
    bound = state.node_bound[0][rows].clone()
    finite = bound[torch.isfinite(bound)]
    base = float(finite.median()) if finite.numel() else 0.0
    pick = T(rng.integers(0, 6, (L, cap)))
    steps = T([-np.inf, 0.0, 0.0, 1e-3, 2e-3, np.inf], torch.float64)
    bound = torch.where(pick == 1, bound, base + steps[pick] * max(1.0, abs(base)))
    best = state.per_k_best[0][ks]
    choice = T(rng.integers(0, 3, (L, n_k)))
    st = state._replace(
        **{f: getattr(state, f)[0][rows] for f in ("node_lo", "node_hi", "node_v", "node_y",
                                                   "node_z", "node_f", "node_warm")},
        node_kidx=T(rng.integers(0, n_k, (L, cap)), torch.int32), node_bound=bound,
        active=T(rng.random((L, cap)) < rng.uniform(0.3, 1.0)),
        incumbent=lanes(state.incumbent), inc_w=lanes(state.inc_w), inc_n=lanes(state.inc_n),
        inc_y=lanes(state.inc_y), inc_kidx=lanes(state.inc_kidx),
        dropped_bound=lanes(state.dropped_bound),
        per_k_best=torch.where(choice == 0, float("inf"), best + (choice == 2) * 1e-3),
        per_k_w=state.per_k_w[0][ks].expand(L, -1, -1).contiguous(),
        per_k_n=state.per_k_n[0][ks].expand(L, -1, -1).contiguous(),
        per_k_y=state.per_k_y[0][ks].expand(L, -1, -1).contiguous(),
        per_k_dropped=torch.where(choice == 1, base, float("inf")) + 0.0 * best,
        stat_ipm_iters=lanes(state.stat_ipm_iters), stat_rounds=lanes(state.stat_rounds))
    n0 = res.v.shape[0]
    res = type(res)(*[f[lp] if isinstance(f, torch.Tensor) and f.dim() and f.shape[0] == n0
                      else f for f in res])
    dt = data._replace(
        int_mask=lanes(data.int_mask), obj_const=lanes(data.obj_const),
        Ws=data.Ws[0][ks].expand(L, -1).contiguous(), ks=data.ks[0][ks].expand(L, -1).contiguous(),
        rd=RoundingData(*[lanes(f) for f in data.rd]), rd_packed=lanes(data.rd_packed))
    frozen = T(rng.random(L) < 0.25) if L > 1 and rng.random() < 0.5 else None
    return dt, st, res, gap, B, None, frozen, True


def check_round_tail(report: dict) -> None:
    """R8, the round tail: on every round tail of eleven cases
    (``round_tail_cases``, six of them per-k) the fused launch against its
    plain version on the same inputs (K2's and K3's entries inside it, and
    in per-k mode B15's), every field of the new state and the go flags
    equal; then per case the fused launch's device and call ms, its host
    enqueue, the plain version's ms with K2's, K3's and B15's plain versions
    (the tail as plain PyTorch), and the sequence it replaced (the plain
    version as the card ran it before: K2, the torch operations, K3, in
    per-k mode B15's two entries) by CUDA events and host enqueue; and the
    launches of one north-star warm round and one per-k round (hermes_70b,
    Mixtral M=4, the per-k lanes), fused and as before."""
    import numpy as np
    import torch

    from distilp_torch.solver import search

    def hold(name, calls):
        """Each tail against its plain version: (held, bit for bit, tails
        with a finite per-k floor)."""
        held, bitwise, spilled = 0, True, 0
        for args in calls:
            got = search.round_tail(*args)
            ref = search.round_tail_reference(*args)
            torch.cuda.synchronize()
            bad = tail_differs(got, ref)
            if bad:
                fail(f"round_tail kernel disagrees with its plain version on {name} "
                     f"(L={args[1].node_lo.shape[0]}, beam={args[4]}, "
                     f"pre-rounded={args[5] is not None}, frozen={args[6] is not None}, "
                     f"per-k={len(args) > 7 and args[7]}): {bad}")
            bitwise = bitwise and tail_same_bits(got, ref)
            spilled += int(bool(torch.isfinite(got[0].per_k_dropped).any()))
            held += 1
        return held, bitwise, spilled

    def timed(name, args, held, bitwise, spilled):
        ms, call, src = time_kernel(lambda: search.round_tail(*args), "round_tail_kernel")
        enq = host_ms(lambda: search.round_tail(*args))
        with plain_kernels():
            plain = cuda_ms(lambda: search.round_tail_reference(*args), reps=5)
        seq = cuda_ms(lambda: search.round_tail_reference(*args))
        seq_enq = host_ms(lambda: search.round_tail_reference(*args))
        flops, nbytes = tail_flops_bytes(args)
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_F64_S)
        L, cap, nf = args[1].node_lo.shape
        lines[name] = line = {
            "tails_held": held, "bit_for_bit": bitwise, "L": L, "beam": args[4], "cap": cap,
            "nf": nf, "M": args[1].inc_w.shape[1], "pre_rounded": args[5] is not None,
            "frozen": args[6] is not None, "per_k": bool(len(args) > 7 and args[7]),
            "n_k": args[1].per_k_best.shape[1], "tails_with_a_per_k_floor": spilled,
            "ms": ms, "call_ms": call, "ms_source": src,
            "host_enqueue_ms": enq, "plain_ms": plain, "replaced_sequence_ms": seq,
            "replaced_sequence_host_enqueue_ms": seq_enq, "bound_ms": b_ms, "bound_by": b_by}
        print("round tail vs plain", name, json.dumps(line), flush=True)

    cases = round_tail_cases()
    lines = {}
    for name, calls in cases.items():
        held, bitwise, spilled = hold(name, calls)
        if name.endswith("_spill") and not spilled:
            fail(f"round tail case {name}: no per-k round spilled a node")
        # Times on the case's widest round (the root round's copy phase).
        args = max(calls, key=lambda a: a[1].node_lo.numel() * (a[4] + 1))
        timed(name, args, held, bitwise, spilled)
    # Per-k tails stretched from the north star's last per-k tail to the
    # largest per-k shape and to hard-spilling ones, six of each, held bit
    # for bit; timed at the largest.
    rng = np.random.default_rng(15)
    stretched = [stretched_per_k_tail(cases["per_k_north_star"][-1], rng, *shape)
                 for shape in STRETCHED_PER_K for _ in range(6)]
    held, bitwise, spilled = hold("per_k_stretched", stretched)
    if not spilled:
        fail("round tail: no stretched per-k tail spilled a node")
    L, _, cap, B = STRETCHED_PER_K[0]
    stretched_name = f"per_k_stretched_{L}x{cap + B}"
    timed(stretched_name, stretched[0], held, bitwise, spilled)
    # One north-star warm round (its LP call included), fused and as before.
    data, state, _, gap, B, *_ = cases["north_star"][-1]
    run = lambda: search.bnb_round(data, state, gap, beam=B)  # noqa: E731
    fused = kernel_launches(run)
    with reference_tail():
        before = kernel_launches(run)
    print("round tail launches a round", json.dumps({
        "round": f"north star warm round, beam {B}", "fused": fused, "before": before}),
        flush=True)
    if fused["wrappers"].get("round_tail") != 1 or any(
            k in fused["wrappers"] for k in ("round_incumbent", "bnb_epilogue")):
        fail(f"a dense round did not run as one round_tail launch: {fused}")
    # A MoE round: its LP call, K2's MoE mode and one round tail.
    data, state, _, gap, B, *_ = cases["flagship_moe"][-1]
    moe = kernel_launches(lambda: search.bnb_round(data, state, gap, beam=B))
    print("round tail launches a MoE round", json.dumps({
        "round": f"flagship second round, beam {B}", "fused": moe}), flush=True)
    if moe["wrappers"] != {"ipm": 1, "round_moe": 1, "round_tail": 1}:
        fail(f"a MoE round did not run as K2 MoE and one round_tail launch: {moe}")
    # Per-k rounds (their LP call included): hermes_70b's warm round fused
    # and as before, a Mixtral MoE round, and the per-k lanes' first round.
    per_k_rounds = {}
    for case, want in (("per_k_hermes_70b", {"ipm": 1, "round_tail": 1}),
                       ("per_k_mixtral_M4", {"ipm": 1, "round_moe": 1, "round_tail": 1}),
                       ("per_k_lanes_frozen", {"ipm": 1, "round_tail_lanes": 1})):
        data, state, _, gap, B, *_ = cases[case][0 if case == "per_k_lanes_frozen" else -1]
        run = lambda: search.bnb_round(data, state, gap, beam=B, per_k=True)  # noqa: E731
        got = per_k_rounds[case] = {"beam": B, "fused": kernel_launches(run)}
        if case == "per_k_hermes_70b":
            with reference_tail():
                got["before"] = kernel_launches(run)
        if got["fused"]["wrappers"] != want:
            fail(f"a per-k round of {case} did not run as {want}: {got['fused']}")
    print("round tail launches a per-k round", json.dumps(per_k_rounds), flush=True)
    for key, case, pk in (("round_tail", "north_star", "per_k_hermes_70b"),
                          ("round_tail_lanes", "scenarios_S8_frozen", stretched_name)):
        ln = lines[case]
        report[key] = dict(
            name=key, route="cuda", source="distilp_torch/kernels/csrc/round_tail_kernel.cu",
            replaces="distilp_tpu/solver/backend_jax.py:1577 (the part of _bnb_round after its "
                     "LP call, to :1800) and :2704 (_certified); per-k mode :1597-1627, "
                     ":1699-1702, :1728-1774 and :2721 (_certified_per_k, :2709 _per_k_bound)",
            max_abs_err=0.0, ms=ln["ms"], plain_ms=ln["plain_ms"], bound_ms=ln["bound_ms"],
            bound_by=ln["bound_by"], library_ms=None, held_against_plain="ok",
            call_ms=ln["call_ms"], ms_source=ln["ms_source"],
            replaced_sequence_ms=ln["replaced_sequence_ms"],
            per_k={f: lines[pk][f] for f in ("ms", "call_ms", "ms_source", "plain_ms",
                                              "replaced_sequence_ms", "bound_ms", "bound_by",
                                              "L", "beam", "cap", "n_k")} | {"case": pk},
            per_k_round_launches=per_k_rounds, cases=lines)


def _lane(args, q: int):
    """Lane ``q`` (as an L = 1 batch) of per-k entry arguments: tensors and
    a SearchState's fields sliced, the rest passed through."""
    import torch

    from distilp_torch.solver.search import SearchState

    def one(a):
        if isinstance(a, torch.Tensor):
            return a[q:q + 1]
        if isinstance(a, SearchState):
            return SearchState(*[None if t is None else t[q:q + 1] for t in a])
        return a
    return tuple(one(a) for a in args)


def per_k_lane_diff(inc, rank) -> list:
    """The fields in which one lane launch of K3's per-k entries differs
    from the plain version or, bit for bit, from one single-lane launch per
    lane (empty when all agree)."""
    import torch

    from distilp_torch.solver import search

    got_i, ref_i = search.per_k_incumbent(*inc), search.per_k_incumbent_reference(*inc)
    got_r, ref_r = search.per_k_fair_rank(*rank), search.per_k_fair_rank_reference(*rank)
    L = rank[0].shape[0]
    one_i = [search.per_k_incumbent(*_lane(inc, q)) for q in range(L)]
    one_r = [search.per_k_fair_rank(*_lane(rank, q)) for q in range(L)]
    torch.cuda.synchronize()
    diff = [f for f in got_i._fields if not torch.equal(getattr(got_i, f), getattr(ref_i, f))]
    diff += [f for f, x, y in zip(("fair_key", "per_k_dropped"), got_r, ref_r)
             if not torch.equal(x, y)]
    diff += [f"single:{f}" for q, o in enumerate(one_i) for f in got_i._fields
             if not torch.equal(getattr(got_i, f)[q:q + 1], getattr(o, f))]
    diff += [f"single:rank{q}" for q, o in enumerate(one_r)
             if not (torch.equal(got_r[0][q:q + 1], o[0]) and torch.equal(got_r[1][q:q + 1], o[1]))]
    return sorted(set(diff))


def check_per_k_lanes(report: dict) -> None:
    """K3's per-k entries with a grid over lanes, each lane launch against
    the plain version and, bit for bit, against one single-lane launch per
    lane: on every call of the stream path's per-k lanes (the mixed-M
    bucket's three fleets through ``solve_batch``, their rounds through the
    round tail's plain version, which calls them) and on 200 random
    frontiers of 2-8 lanes."""
    import numpy as np
    import torch

    from distilp_torch.solver import search, solve_batch
    from distilp_torch.solver.search import SearchState

    calls = {"incumbent": [], "rank": []}
    with captured(search, "per_k_incumbent", calls["incumbent"]), \
            captured(search, "per_k_fair_rank", calls["rank"]), reference_tail():
        solve_batch(per_k_lanes(online_model()))
    bad = []
    stream = [(a_i, a_r) for (a_i, _), (a_r, _) in zip(calls["incumbent"], calls["rank"])]
    if not stream or any(a_r[0].shape[0] < 2 for _, a_r in stream):
        fail(f"bnb_per_k lanes: the per-k lanes gave {len(stream)} calls, not all multi-lane")
    for i, (inc, rank) in enumerate(stream):
        diff = per_k_lane_diff(inc, rank)
        if diff:
            bad.append(("stream", i, diff))
    rng = np.random.default_rng(1)
    timed = None
    for trial in range(200):
        L = int(rng.integers(2, 9))
        shape = _per_k_shape(rng)
        has_y, gap = rng.random() < 0.5, float(rng.choice([1e-3, 1e-4, 0.0]))
        per_lane = [_per_k_inputs(rng, *shape, has_y=has_y) for _ in range(L)]
        cat = lambda ts: torch.cat(list(ts))  # noqa: E731
        incs, ranks = zip(*per_lane)
        state = SearchState(*[None] * 23)._replace(**{
            f: cat(getattr(i[5], f) for i in incs)
            for f in ("node_kidx", "per_k_best", "per_k_w", "per_k_n", "per_k_y")})
        inc = tuple(cat(i[j] for i in incs) for j in range(4)) + \
            ((cat(i[4] for i in incs) if has_y else None), state, gap)
        rank = tuple(cat(r[j] for r in ranks) for j in range(4)) + (shape[3],) + \
            (cat(r[5] for r in ranks),)
        diff = per_k_lane_diff(inc, rank)
        if diff:
            bad.append(("random", trial, diff))
        if timed is None or L * shape[2] > timed[0]:
            timed = (L * shape[2], inc, rank, gap, L, shape)
    print("bnb_per_k lanes", json.dumps({
        "stream_calls": len(stream), "stream_lanes": int(stream[0][1][0].shape[0]),
        "random_lane_frontiers": 200, "differing": bad[:10]}), flush=True)
    if bad:
        fail(f"bnb_per_k lane entries disagree: {bad[:5]}")
    _, inc, rank, gap, L, (n_k, M, B, cap) = timed
    singles = [(_lane(inc, q), _lane(rank, q)) for q in range(L)]
    ms_i, call_i, src = time_kernel(lambda: search.per_k_incumbent(*inc), "per_k_incumbent_kernel")
    ms_r, call_r, _ = time_kernel(lambda: search.per_k_fair_rank(*rank), "per_k_rank_kernel")
    plain = cuda_ms(lambda: search.per_k_incumbent_reference(*inc), reps=10) + \
        cuda_ms(lambda: search.per_k_fair_rank_reference(*rank), reps=10)
    single_ms = cuda_ms(lambda: [(search.per_k_incumbent(*i), search.per_k_fair_rank(*r))
                                 for i, r in singles], reps=10)
    nbytes = L * per_k_bytes(B, M, n_k, cap, cap + B, has_y=inc[4] is not None)
    b_ms, b_by = bound_ms(L * (B * n_k + (cap + B) * 8), nbytes, PEAK_F64_S)
    report["bnb_per_k_lanes"] = lane_row(
        "bnb_per_k_lanes", "distilp_torch/kernels/csrc/bnb_epilogue_kernel.cu",
        "distilp_tpu/solver/backend_jax.py:1597 (vmapped over sweeps by :2633)",
        0.0, ms_i + ms_r, plain, single_ms, b_ms, b_by, call_i + call_r, src,
        f"{L} lanes of B={B} rows, M={M}, n_k={n_k}, cap={cap}; ms is both entries")
    report["bnb_per_k_lanes"]["stream_calls_held"] = len(stream)
    print(f"bnb_per_k_lanes: {ms_i + ms_r:.4f} ms on the card a round, {L} single-lane "
          f"rounds {single_ms:.4f} ms (plain {plain:.3f} ms, bound {b_ms:.6f} ms by {b_by})",
          flush=True)


MIXTRAL_REGIMES = [None, [1.5, 0.8, 1.0, 0.9], [0.7, 0.7, 1.6, 1.2], [1.0, 1.3, 0.9, 0.8]]


# Lanes of one root bound past what 16 owner states a block held (4224 rows
# at 2 blocks an SM of an H100): the flagship 140 times, 4480 rows.
MANY_LANES = 140


def many_lanes_ascent(devs, model) -> bool:
    """The flagship as MANY_LANES identical lanes of one root bound
    (``decomp_bound_roots``, 300 steps): two K7 launches, every lane's
    outputs equal to lane 0's bit for bit, lane 0's float64 bounds within
    TOL_ASCENT_BOUND relative of the single instance's."""
    import torch

    from distilp_torch import kernels
    from distilp_torch.ops import decomp as D
    from distilp_torch.solver.rounding import rounding_data, stack_rounding_data

    dev = torch.device("cuda")
    (lane,) = lane_inputs([devs], model, "8bit")
    w_max, E = max(W for _, W in lane.feasible), int(lane.E)
    one = [D.decomp_problem(lane.rd_np, lane.sf.ks, lane.sf.Ws, w_max, E, dt, dev)
           for dt in (torch.float32, torch.float64)]
    rd1 = rounding_data(lane.rd_np, dev)
    single = D.decomp_bound_roots(*(D.stack_problems([p]) for p in one),
                                  stack_rounding_data([rd1]), 300)
    n0 = kernels.LAUNCHES["decomp_lanes"]
    t0 = time.perf_counter()
    many = D.decomp_bound_roots(*(D.stack_problems([p] * MANY_LANES) for p in one),
                                stack_rounding_data([rd1] * MANY_LANES), 300)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    n_launch = kernels.LAUNCHES["decomp_lanes"] - n0
    flat = lambda out: tuple(out[:4]) + tuple(out[4]) + (out[5],)  # noqa: E731
    same = all(bool((x == x[:1]).all()) for x in flat(many))
    rel = max_err(many[0][0], single[0][0])[1]
    ok = n_launch == 2 and same and rel <= TOL_ASCENT_BOUND
    print("decomp many lanes", json.dumps(
        {"case": f"deepseek_v3_M32_x{MANY_LANES}", "rows": MANY_LANES * int(one[0].ks.shape[0])
         * int(one[0].rdv.shape[-1]), "k7_launches": n_launch, "lanes_equal": same,
         "bound_max_rel_vs_single": rel, "wall_ms": wall, "ok": ok}), flush=True)
    return ok


def check_decomp_lanes(report: dict) -> None:
    """K7's instance axis: the Mixtral M=4 scenario batch (4 load regimes)
    and the flagship with a t_comm drift (2 instances), float32 and float64
    evaluations against the plain version and, bit for bit, against one
    single-instance launch per instance; the fused ascent of all instances
    in lockstep against the host loop (``hold_fused_ascent``, each lane
    sound against its own HiGHS per-k optima), timed beside one
    instance's."""
    import numpy as np
    import torch

    from distilp_torch.ops import decomp as D
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.rounding import rounding_data, stack_rounding_data
    from distilp_torch.utils import make_synthetic_fleet

    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    cases = []
    mix = MOE_CASES[0]
    mdevs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    mmodel = moe_model(mix[1])
    cases.append(("mixtral_M4_x4", [mdevs] * 4, mmodel, MIXTRAL_REGIMES))
    fdevs, fmodel = moe_instance(FLAGSHIP)[:2]
    cases.append(("deepseek_v3_M32_x2", [fdevs] + scenario_fleets(fdevs, 1, 3, 0.95, 1.05),
                  fmodel, None))
    bad, timing, errs = [], {}, []
    for name, fleets, model, factors in cases:
        lanes = lane_inputs(fleets, model, "8bit", factors)
        w_max, E = max(W for _, W in lanes[0].feasible), int(lanes[0].E)
        p32, p64 = (D.stack_problems([D.decomp_problem(ln.rd_np, ln.sf.ks, ln.sf.Ws, w_max, E,
                                                       dt, dev) for ln in lanes])
                    for dt in (torch.float32, torch.float64))
        S, n_k = p32.ks.shape
        M = p32.rdv.shape[-1]
        lam = torch.tensor(rng.normal(0, 1, (S, n_k)), dtype=torch.float32, device=dev)
        mu = torch.tensor(rng.normal(0, 0.3, (S, n_k)), dtype=torch.float32, device=dev)
        tau = torch.tensor(rng.normal(0, 1, (S, n_k, M)), dtype=torch.float32, device=dev)
        th32 = (p32.ks - 1.0)[..., None] * D.softmax(tau)
        got = D.eval32_kernel(p32, lam, mu, th32)
        l64, m64, t64 = lam.double(), mu.double(), tau.double()
        th64 = (p64.ks - 1.0)[..., None] * D.softmax(t64)
        got64 = D.eval64_kernel(p64, l64, m64, th64, True)
        # Each instance alone: its S = 1 batch and (1, ...) multipliers.
        one32 = [D.stack_problems([p32.instance(s)]) for s in range(S)]
        one64 = [D.stack_problems([p64.instance(s)]) for s in range(S)]
        sl = lambda t, s: t[s:s + 1]  # noqa: E731
        ones = [[x[0] for x in D.eval32_kernel(one32[s], sl(lam, s), sl(mu, s), sl(th32, s))]
                for s in range(S)]
        ones64 = [[x[0] for x in D.eval64_kernel(one64[s], sl(l64, s), sl(m64, s),
                                                 sl(th64, s), True)] for s in range(S)]
        ref = [D.eval32_reference(p32.instance(s), lam[s], mu[s], th32[s]) for s in range(S)]
        ref64 = [D.eval64_reference(p64.instance(s), l64[s], m64[s], th64[s], True)
                 for s in range(S)]
        torch.cuda.synchronize()
        e32 = [max_err(g[s], r_s[i]) for s, r_s in enumerate(ref) for i, g in enumerate(got)]
        e64 = max(max_err(got64[0][s], ref64[s][0])[1] for s in range(S))
        hint_eq = all(torch.equal(got64[i][s], ref64[s][i]) for s in range(S) for i in (1, 2, 3))
        eq1 = all(torch.equal(g[s], o) for s, one in enumerate(ones) for g, o in zip(got, one))
        eq1 &= all(torch.equal(g[s], o) for s, one in enumerate(ones64)
                   for g, o in zip(got64, one))
        errs.append(max(e[0] for e in e32))
        line = {"case": name, "instances": S, "n_k": n_k, "M": M,
                "f32_max_rel": max(e[1] for e in e32), "f64_m_y_max_rel": e64,
                "hint_equal": hint_eq, "equal_to_single_launches": eq1}
        ok = (line["f32_max_rel"] <= TOL_DECOMP_F32 and e64 <= TOL_EXACT_F64 and hint_eq and eq1)
        line["ok"] = ok
        print("decomp lanes", json.dumps(line), flush=True)
        if not ok:
            bad.append(name)
        # The fused ascent of all lanes against the host loop, each lane
        # sound against its own instance's HiGHS per-k optima.
        oracle = []
        for i, devs in enumerate(fleets):
            _, _, _, arrays = _build_instance(devs, model, None, "8bit", None,
                                              None if factors is None else factors[i], 1)
            oracle.append(highs_per_k(arrays, lanes[i].feasible))
        rd = stack_rounding_data([rounding_data(ln.rd_np, dev) for ln in lanes])
        consts = [ln.sf.obj_const for ln in lanes]
        ok, err = hold_fused_ascent(name, p32, p64, rd, oracle, consts)
        errs.append(err)
        if not ok:
            bad.append((name, "fused ascent"))
        ev_ms, ev_call, ev_src = time_kernel(lambda: D.eval32_kernel(p32, lam, mu, th32),
                                             "decomp_f32_kernel")
        single_ms = cuda_ms(lambda: [D.eval32_kernel(one32[s], sl(lam, s), sl(mu, s),
                                                     sl(th32, s)) for s in range(S)], reps=10)
        t, ok, err = time_ascent(name, p32, p64, oracle, consts)
        errs.append(err)
        if not ok:
            bad.append((name, "fused vs plain ascent"))
        one_ms = cuda_ms(lambda: [D.ascend_fused(one32[s], 300) for s in range(S)], reps=5,
                         warmup=1)
        flops, nbytes = ascent_flops_bytes(p32.instance(0), 300)
        ref_flops, ref_bytes, cells = decomp_flops_bytes(p32.instance(0), 301)
        b_ms, b_by = bound_ms(S * flops, S * nbytes, PEAK_F32_S)
        t.update(bound_ms=b_ms, bound_by=b_by,
                 bound_ms_reference_work=bound_ms(S * ref_flops, S * ref_bytes, PEAK_F32_S)[0],
                 cells=S * cells, single_instance_ascents_ms=one_ms,
                 f32_eval_ms=ev_ms, f32_eval_call_ms=ev_call, f32_eval_source=ev_src,
                 f32_eval_single_launches_ms=single_ms)
        timing[name] = t
        print(f"decomp_lanes {name}: per-step f32 evaluation of {S} instances {ev_ms:.4f} ms "
              f"on the card, {ev_call:.4f} ms per call ({S} single launches {single_ms:.4f} "
              f"ms); 300-step ascent of all {t['ms']:.4f} ms on the card, {t['call_ms']:.4f} "
              f"ms per call ({S} single-instance ascents {one_ms:.4f} ms; bound {b_ms:.6f} ms "
              f"by {b_by})",
              flush=True)
    if not many_lanes_ascent(cases[1][1][0], cases[1][2]):
        bad.append(("deepseek_v3_M32", f"x{MANY_LANES}"))
    if bad:
        fail(f"decomp instance axis disagrees in {bad}")
    t = timing["mixtral_M4_x4"]
    report["decomp_lanes"] = lane_row(
        "decomp_lanes", "distilp_torch/kernels/csrc/decomp_kernel.cu",
        "distilp_tpu/solver/backend_jax.py:963 (vmapped over scenarios by :2577)",
        max(errs), t["ms"], t["plain_ms"], t["single_instance_ascents_ms"], t["bound_ms"],
        t["bound_by"], t["call_ms"], t["ms_source"],
        f"mixtral_M4_x4: the 300-step ascent of 4 instances in one launch, {t['cells']} "
        f"cells an evaluation")
    report["decomp_lanes"]["by_case"] = timing


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


# Since the loop runs as one graph, a dense sweep's warm hint is re-priced
# in the graph's seed (K2's per-row body), not by K2's entry.
DENSE_KERNELS = ("ipm", "round_tail", "bnb_graph", "bnb_seed", "bnb_head", "bnb_control",
                 "bnb_answer")
MOE_KERNELS = ("ipm", "round_moe", "round_tail", "decomp")
PROFILE_KERNELS = ("ipm", "round_tail", "twin_mc", "hbm_stream",
                   "gemm_absmax_scale")


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
    launches = path_launches()
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
    launches = path_launches()
    print("fleet path launches", json.dumps(launches), flush=True)
    missing = [k for k in ("ipm", "round_tail", "pdhg") if launches[k] == 0]
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
    launches = path_launches()
    print("moe path launches", json.dumps(launches), flush=True)
    missing = [k for k in MOE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"MoE main path never launched {missing}")
    profile_solve(devs, model, MOE_GAP, f"{FLAGSHIP[0]}_cold", kv_bits="8bit")
    profile_solve(drifted, model, MOE_GAP, f"{FLAGSHIP[0]}_warm", kv_bits="8bit", warm=cold)
    return launches


# Published peaks the profile path's measured rates are held to (H100 SXM,
# NVIDIA data sheet, dense): a measured rate above 105% of its peak is a
# probe that measured something else.
PEAK_HOST_LINK_S = 64e9  # PCIe Gen5 x16, per direction
PROFILE_CONFIG = "tests/configs/llama3_70b_4bit.json"
PROFILE_FIXTURE = "llama_3_70b/4bit"
PROFILE_GAP = 1e-3
PROFILE_MAX_BATCH_EXP = 3
# The profiler's knobs for this run (the reference's DPERF_* variables): a
# 256 MB disk file instead of a 70B layer's ~0.45 GB, and 2 timed repeats
# per chain length with no warm-up call instead of 4 after 1. The host's
# CPU sweep (torch float16 on a host without a native float16 path, ~0.6
# GFLOP/s) dominates the profiler's wall time; the profiler loads its
# kernels before it times anything, so the card's first timed chain pays
# for no build.
PROFILE_ENV = {"DPERF_DISK_FILE_MB": "256", "DPERF_GEMM_ITERS": "2",
               "DPERF_GEMM_WARMUP": "0"}
# The port's CLI run in a child process that reports, as its last line on
# stderr, the launches each kernel wrapper counted there.
CLI_CHILD = (
    "import atexit, json, runpy, sys\n"
    "from distilp_torch import kernels\n"
    "atexit.register(lambda: print('kernel launches ' + json.dumps("
    "{**kernels.LAUNCHES, '_shapes': kernels.SHAPES}), file=sys.stderr, flush=True))\n"
    "mod = sys.argv[1]\n"
    "sys.argv = [mod] + sys.argv[2:]\n"
    "runpy.run_module(mod, run_name='__main__')\n"
)


def merge_shapes(into: dict, more: dict) -> None:
    for k, per in more.items():
        for shape, c in per.items():
            into.setdefault(k, {})[shape] = into.setdefault(k, {}).get(shape, 0) + c


def path_launches(child=None) -> dict:
    """The launches each kernel wrapper counted since the last reset (plus
    a child process's), with K1's and K5's by shape under ``_shapes``."""
    from distilp_torch import kernels

    child = child or {}
    out = {k: v + child.get(k, 0) for k, v in kernels.LAUNCHES.items()}
    out["_shapes"] = {k: dict(v) for k, v in kernels.SHAPES.items()}
    merge_shapes(out["_shapes"], child.get("_shapes", {}))
    return out


def run_cli(module: str, args: list, launches: dict, env=None, timeout: int = 600):
    """Run ``python -m <module> <args>`` from the repository root; add the
    child's kernel launches to ``launches``; (exit code, stdout, wall s)."""
    import os

    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_CHILD, module, *args], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, **(env or {})},
    )
    wall = time.perf_counter() - t
    tail = [ln for ln in proc.stderr.splitlines() if ln.startswith("kernel launches ")]
    if not tail:
        fail(f"{module} {' '.join(args)} exited {proc.returncode} without its launch "
             f"counts:\n{proc.stderr[-3000:]}")
    for k, v in json.loads(tail[-1][len("kernel launches "):]).items():
        if k == "_shapes":
            merge_shapes(launches.setdefault("_shapes", {}), v)
        else:
            launches[k] = launches.get(k, 0) + v
    print(f"$ python -m {module} {' '.join(args)}  -> exit {proc.returncode} in "
          f"{wall:.1f} s", flush=True)
    return proc.returncode, proc.stdout, proc.stderr, wall


def profile_rates(raw: dict, prof: dict) -> list:
    """(name, measured rate, published peak, unit) of every rate the H100's
    profile carries."""
    rows = []
    for tag, peak in (("f32", PEAK_F32_S), ("fp16", PEAK_BF16_S), ("bf16", PEAK_BF16_S)):
        for b, v in raw["gpu"]["benchmarks"][tag].items():
            if b in prof["sgpu_cuda"]["F32"]:
                rows.append((f"gemm {tag} {b}", v, peak, "FLOP/s"))
    mem = raw["gpu"]["memory"]
    rows.append(("HBM stream (T_cuda)", prof["T_cuda"], PEAK_BYTES_S, "B/s"))
    rows.append(("host->device", mem["read_bw"], PEAK_HOST_LINK_S, "B/s"))
    rows.append(("device->host", mem["write_bw"], PEAK_HOST_LINK_S, "B/s"))
    return rows


def profile_path(cases: list) -> dict:
    """Profile -> solve -> evaluate through the port's CLIs, then the twin
    at full width through the library on ``cases`` (``twin_cases()``)."""
    import os
    import shutil
    import tempfile

    import torch

    from distilp_torch import kernels
    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.solver import halda_solve
    from distilp_torch.solver.backend_cpu import Infeasible
    from distilp_torch.twin import rank_agreement, robustness_report, twin_p95_score

    kernels.reset_launch_counts()
    child: dict = {}
    with tempfile.TemporaryDirectory(prefix="distilp_profile_") as tmp:
        # The profile folder holds the fixture and the measured card; the raw
        # DeviceInfo and the solutions stay outside it (the loader reads every
        # JSON of the folder as a device).
        fleet = Path(tmp, "fleet")
        fleet.mkdir()
        for f in (ROOT / "tests" / "profiles" / PROFILE_FIXTURE).glob("*.json"):
            shutil.copy(f, fleet)
        hbm_mb = os.environ.get("DPERF_HBM_MB", "256")
        print(f"profiler env: {json.dumps(PROFILE_ENV)}, HBM probe array {hbm_mb} MB "
              f"float32", flush=True)
        # Hand this process's cached blocks back, so the profiler sees the
        # card's memory as a fresh process would.
        torch.cuda.empty_cache()
        rc, _, err, wall = run_cli("distilp_torch.cli.profiler_cli", [
            "device", "-r", PROFILE_CONFIG, "--not-head",
            "--max-batch-exp", str(PROFILE_MAX_BATCH_EXP),
            "-o", f"{fleet}/h100.json", "--raw-out", f"{tmp}/h100_raw.json"], child,
            PROFILE_ENV)
        if rc != 0:
            fail(f"profiler CLI exited {rc}:\n{err[-3000:]}")
        raw = json.loads(Path(tmp, "h100_raw.json").read_text())
        prof = json.loads(Path(fleet, "h100.json").read_text())
        print(f"profiler wall {wall:.1f} s; device {raw['gpu']['device_kind']}, memory "
              f"{raw['gpu']['memory']['total']:.0f} B total, "
              f"{raw['gpu']['memory']['free']:.0f} B free "
              f"({raw['gpu']['memory']['capacity_source']}); disk read "
              f"{raw['disk']['read']:.4g} B/s write {raw['disk']['write']:.4g} B/s", flush=True)
        bad = []
        for name, v, peak, unit in profile_rates(raw, prof):
            share = v / peak
            print(f"  measured {name}: {v:.6g} {unit} = {100 * share:.2f}% of the "
                  f"published {peak:.4g}", flush=True)
            if share > 1.05:
                bad.append(f"{name} reads {100 * share:.1f}% of its peak")
        zero = [f"gemm {t} b_1" for t in ("f32", "fp16", "bf16")
                if not raw["gpu"]["benchmarks"][t]["b_1"] > 0]
        if not prof.get("T_cuda"):
            zero.append("T_cuda")
        if bad or zero:
            fail(f"profile path: {bad + [z + ' reads 0' for z in zero]}")
        print("profile stats (p50 ms, samples, valid) " + json.dumps(
            {k: [v["p50"] * 1e3, v["samples"], v["valid"]] for k, v in raw["stats"].items()}),
            flush=True)

        sol = f"{tmp}/solution.json"
        rc, out, err, wall = run_cli("distilp_torch.cli.solver_cli", [
            "-p", str(fleet), "--backend", "torch", "--mip-gap", str(PROFILE_GAP),
            "--save-solution", sol], child)
        if rc != 0:
            fail(f"solver CLI (torch) exited {rc}:\n{err[-3000:]}")
        print(out, flush=True)
        rc, _, err, _ = run_cli("distilp_torch.cli.solver_cli", [
            "-p", str(fleet), "--backend", "cpu", "--mip-gap", str(PROFILE_GAP),
            "--save-solution", f"{tmp}/solution_highs.json"], child)
        if rc != 0:
            fail(f"solver CLI (cpu) exited {rc}:\n{err[-3000:]}")
        got = json.loads(Path(sol).read_text())
        oracle = json.loads(Path(tmp, "solution_highs.json").read_text())["obj_value"]
        print(f"  2-device fleet: k={got['k']} w={got['w']} n={got['n']} objective "
              f"{got['obj_value']!r} vs HiGHS {oracle!r}", flush=True)
        if not got["certified"] or abs(got["obj_value"] - oracle) > 2 * PROFILE_GAP * max(1.0, abs(oracle)):
            fail(f"profile path: torch objective {got['obj_value']} vs HiGHS {oracle}")
        rc, out, err, wall = run_cli("distilp_torch.cli.solver_cli", [
            "evaluate", "-p", str(fleet), "--backend", "torch", "--samples", "1024",
            "--check-determinism", "--json"], child)
        if rc != 0:
            fail(f"solver evaluate exited {rc}:\n{err[-3000:]}")
        ev = json.loads(out.strip().splitlines()[-1])
        print(f"  evaluate ({wall:.1f} s): twin latency {ev['evaluation']['latency_s']!r}, "
              f"objective {ev['evaluation']['objective_s']!r}, rel err "
              f"{ev['evaluation']['rel_err']!r}; p95 {ev['robustness']['p95_s']!r}, "
              f"P(violation) {ev['robustness']['p_violation']!r}", flush=True)
        devs_tmp, _ = load_from_profile_folder(fleet)
        print("  fleet: " + ", ".join(f"{d.name} (cuda={d.has_cuda})" for d in devs_tmp),
              flush=True)

    # The twin at full width through the library, on the card.
    for name, devs, model, kv, arrays, r in cases:
        walls = []
        for _ in range(6):  # the first call is a warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            rep = robustness_report(devs, model, r, samples=TWIN_SAMPLES, seed=0,
                                    kv_bits=kv, arrays=arrays)
            walls.append((time.perf_counter() - t) * 1e3)
        ms = sorted(walls[1:])[2]
        score = twin_p95_score(devs, model, r, samples=TWIN_SAMPLES, seed=0, kv_bits=kv,
                               arrays=arrays)
        rel = abs(rep.base_latency_s - r.obj_value) / abs(r.obj_value)
        print(f"  twin {name}: robustness_report {ms:.2f} ms median of 5 after a "
              f"warm-up of {walls[0]:.2f} ms (M={len(devs)}, "
              f"{TWIN_SAMPLES} samples); base {rep.base_latency_s!r} vs objective "
              f"{r.obj_value!r} (rel {rel:.3g}); p50 {rep.p50_s!r} p95 {rep.p95_s!r} "
              f"p99 {rep.p99_s!r}; P(violation) {rep.p_violation}; score "
              f"{score['score']!r}; worst device {rep.sensitivity[0].name}", flush=True)
        if rel > 1e-6 or not all(map(math.isfinite, (rep.p95_s, score["score"]))):
            fail(f"twin {name}: base {rep.base_latency_s} vs objective {r.obj_value}")
    # Rank agreement over the per-k placements: each k is solved on the card
    # and by the HiGHS oracle; both must agree on whether k is feasible (only
    # the typed ``Infeasible`` is caught) and on its objective within 2x gap.
    for folder, _, _ in GOLDEN:
        devs, model = load_from_profile_folder(ROOT / "tests" / "profiles" / folder)
        per_k, n_feasible = [], 0
        for k in sorted({k for k in range(1, model.L) if model.L % k == 0}):
            kw = dict(k_candidates=[k], mip_gap=1e-4, kv_bits="4bit")
            try:
                oracle = halda_solve(devs, model, backend="cpu", **kw).obj_value
                n_feasible += 1
            except Infeasible:
                oracle = None
            try:
                r = halda_solve(devs, model, **kw)
            except Infeasible:
                r = None
            if (r is None) != (oracle is None) or (
                    r is not None and abs(r.obj_value - oracle) > 2e-4 * max(1.0, abs(oracle))):
                fail(f"per-k solve of {folder} at k={k}: card "
                     f"{None if r is None else r.obj_value}, HiGHS {oracle}")
            if r is not None:
                per_k.append(r)
        ra = rank_agreement(devs, model, per_k, kv_bits="4bit")
        print(f"  rank agreement {folder}: {len(per_k)} per-k placements of "
              f"{n_feasible} feasible k, inversions {ra['pairwise_inversions']} of "
              f"{ra['comparable_pairs']} pairs, spearman {ra['spearman']!r}", flush=True)
        if len(per_k) != n_feasible or len(per_k) < 2 or ra["pairwise_inversions"] != 0:
            fail(f"rank agreement on {folder}: {len(per_k)} placements of {n_feasible} "
                 f"feasible k, {ra['pairwise_inversions']} inversions")

    launches = path_launches(child)
    print("profile path launches", json.dumps(launches), flush=True)
    missing = [k for k in PROFILE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"profile path never launched {missing}")
    return launches



def profile_solve(devs, model, gap, name, reps: int = 5, kv_bits: str = "4bit",
                  fn=None, **kw) -> None:
    """Where the device time of one solve goes: device time by kernel from
    a profiled solve, and the device's busy share against the same solve's
    unprofiled wall time (median of ``reps``). ``fn`` (default
    ``halda_solve``) is the entry point solved."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distilp_torch.solver import halda_solve

    halda_solve = fn or halda_solve
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


# Sweep-variant pins, from the JAX package on the CPU. Per-k optima (k ->
# objective) of distilp_tpu.solver.api.halda_solve_per_k(devs, model,
# mip_gap=..., kv_bits=...) on the north star (gap 1e-3, kv 4bit) and on
# Mixtral 8x7B over make_synthetic_fleet(4, seed=7, pool_bytes=64e9) (gap
# 1e-3, kv 8bit); hermes_70b's per-k optima are held against the port's
# HiGHS oracle in the run itself.
NORTH_STAR_PER_K = {1: -38.36824122348659, 2: -38.02786870192999,
                    4: -37.44413064313286, 5: -37.11560522015951}
MIXTRAL_PER_K = {1: -131.51084293305297, 2: -132.5361931668962,
                 4: -132.93320566181376, 8: -132.84552879445647}
# Load-aware routing: (name, MoE case, loads, pinned realized objective) of
# distilp_tpu.solver.routing.solve_load_aware(devs, model, expert_loads=...,
# iters=2, kv_bits="8bit", mip_gap=1e-3, backend="jax"). Mixtral: two hot
# experts carry half the load; the flagship: 256 loads drawn
# numpy.random.default_rng(2026).lognormal(0.0, 1.0, 256).
ROUTING_HOT2 = [4.0, 4.0] + [1.0] * 6
ROUTING_CASES = [
    ("mixtral_M4_hot2", MOE_CASES[0], "hot2", -133.03134596488897),
    ("deepseek_v3_M32_lognormal", FLAGSHIP, "lognormal", -400.92408046855377),
]
SWEEP_KERNELS = ("ipm", "round_moe", "decomp", "price_fixed", "round_tail")
# Kernels whose work the round tail does on every path (K3's entry and
# B15's, per-k rounds included since the tail's per-k mode): they run only
# inside the tail's plain version, and no path may launch them.
FOLDED_INTO_TAIL = ("bnb_epilogue", "bnb_epilogue_lanes", "bnb_per_k", "bnb_per_k_lanes")
# K2's per-instance entry re-priced the dense lanes' warm hints; the graph's
# seed does that since the loop runs on the card (the entry is held in phase
# 3 and serves the host loop).
FOLDED_INTO_GRAPH = ("round_incumbent_lanes",)


def routing_loads(kind: str):
    import numpy as np

    if kind == "hot2":
        return ROUTING_HOT2
    return np.random.default_rng(2026).lognormal(0.0, 1.0, 256).tolist()


def sweep_path() -> dict:
    """The sweep variants: per-k optima (``halda_solve_per_k``), load-aware
    routing (``solve_load_aware``) and the async solve
    (``halda_solve_async``), through the port's entry points on the card."""
    import torch

    from distilp_torch import kernels
    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.solver import halda_solve_async, halda_solve_per_k, solve_load_aware
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.utils import make_synthetic_fleet

    def per_k(name, devs, model, gap, kv_bits):
        tm = {}
        before = {k: kernels.LAUNCHES[k] for k in ("round_incumbent",) + FOLDED_INTO_TAIL}
        torch.cuda.synchronize()
        t = time.perf_counter()
        rs = halda_solve_per_k(devs, model, mip_gap=gap, kv_bits=kv_bits, timings=tm)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        # Every per-k round rounds, prunes and compacts in the round tail.
        extra = {k: kernels.LAUNCHES[k] - v for k, v in before.items() if kernels.LAUNCHES[k] != v}
        if extra:
            fail(f"per-k {name}: its rounds launched {extra} beside the round tail")
        print(f"per-k {name}: {len(rs)} k's, wall_ms={ms:.2f} rounds={tm.get('bnb_rounds')} "
              f"lp_iters={tm.get('ipm_iters_executed')} build_sf_ms="
              f"{tm.get('build_sf_ms', 0.0):.2f} upload_ms={tm.get('upload_ms', 0.0):.2f} "
              f"search_ms={tm.get('solve_ms', 0.0):.2f} decomp_steps={tm.get('decomp_steps')}",
              flush=True)
        for r in rs:
            if not r.certified or sum(r.w) * r.k != model.L:
                fail(f"per-k {name}: k={r.k} certified={r.certified} w={r.w}")
        return {r.k: r for r in rs}

    def held(name, got, pins, gap):
        if sorted(got) != sorted(pins):
            fail(f"per-k {name}: k's {sorted(got)}, pinned {sorted(pins)}")
        for k, pin in sorted(pins.items()):
            rel = abs(got[k].obj_value - pin) / abs(pin)
            print(f"  {name} k={k}: objective {got[k].obj_value!r} vs {pin!r}: relative "
                  f"difference {rel!r} (allowed {2 * gap!r}) gap={got[k].gap}", flush=True)
            if rel > 2 * gap:
                fail(f"per-k {name} k={k}: {got[k].obj_value} vs {pin}")

    kernels.reset_launch_counts()
    hermes = load_from_profile_folder(ROOT / "tests" / "profiles" / "hermes_70b")
    got = per_k("hermes_70b", *hermes, 1e-4, "4bit")
    t = time.perf_counter()
    oracle = {r.k: r.obj_value for r in halda_solve_per_k(*hermes, mip_gap=1e-4,
                                                           kv_bits="4bit", backend="cpu")}
    print(f"  highs oracle hermes_70b per-k: {len(oracle)} k's, wall_ms="
          f"{(time.perf_counter() - t) * 1e3:.1f}", flush=True)
    held("hermes_70b", got, oracle, 1e-4)
    north = (make_synthetic_fleet(16, seed=123), online_model())
    held("north_star_M16", per_k("north_star_M16", *north, 1e-3, "4bit"),
         NORTH_STAR_PER_K, 1e-3)
    mixtral = (make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9)), moe_model("mixtral_8x7b"))
    got = per_k("mixtral_M4", *mixtral, MOE_GAP, "8bit")
    if any(sum(r.y) != mixtral[1].n_routed_experts for r in got.values()):
        fail("per-k mixtral_M4: an expert split does not cover E")
    held("mixtral_M4", got, MIXTRAL_PER_K, MOE_GAP)

    routed = {}
    for name, case, kind, pin in ROUTING_CASES:
        _, config, M, seed, pool, _ = case
        devs, model = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool)), moe_model(config)
        tm = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        r, mapping, realized = solve_load_aware(devs, model, expert_loads=routing_loads(kind),
                                                iters=2, kv_bits="8bit", mip_gap=MOE_GAP,
                                                timings=tm)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        rel = abs(realized - pin) / abs(pin)
        print(f"routing {name}: k={r.k} objective {r.obj_value!r} certified={r.certified} "
              f"realized {realized!r} vs pinned {pin!r}: relative difference {rel!r} "
              f"(allowed {2 * MOE_GAP!r}); wall_ms={ms:.2f} last solve: rounds="
              f"{tm.get('bnb_rounds')} decomp_steps={tm.get('decomp_steps')} "
              f"search_ms={tm.get('solve_ms', 0.0):.2f}; load share of the busiest device "
              f"{max(mapping.load_share):.4f}", flush=True)
        if not r.certified or sum(r.y) != model.n_routed_experts or rel > 2 * MOE_GAP:
            fail(f"routing {name}: certified={r.certified} realized {realized} vs {pin}")
        routed[name] = (devs, model, kind)

    # Async: dispatch the north star, build the next instance (the fleet
    # after t_comm drift) while it runs, collect; the result equals the
    # synchronous solve's. Twice: the first dispatch of the process also
    # creates its first side stream.
    import numpy as np

    devs, model = north
    with uncounted():
        sync, sync_ms, _ = solve(devs, model, 1e-3)
    drifted = [d.model_copy() for d in devs]
    rng = np.random.default_rng(3)
    for d in drifted:
        d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.95, 1.05)))
    for attempt in ("first", "second"):
        tm = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = halda_solve_async(devs, model, mip_gap=1e-3, kv_bits="4bit", timings=tm)
        t1 = time.perf_counter()
        _build_instance(drifted, model, None, "4bit", None, None)
        t2 = time.perf_counter()
        r = pending.collect()
        t3 = time.perf_counter()
        print(f"async north_star_M16 ({attempt}): dispatch_ms={(t1 - t0) * 1e3:.2f} "
              f"(build_sf_ms={tm.get('build_sf_ms', 0.0):.2f} upload_ms="
              f"{tm.get('upload_ms', 0.0):.2f}) next_instance_build_ms={(t2 - t1) * 1e3:.2f} "
              f"collect_ms={(t3 - t2) * 1e3:.2f} "
              f"dispatch_to_collect_ms={(t3 - t0) * 1e3:.2f} worker_search_ms="
              f"{tm.get('solve_ms', 0.0):.2f}; synchronous wall_ms={sync_ms:.2f}; "
              f"k={r.k} obj={r.obj_value!r}", flush=True)
        if (r.k, r.w, r.n, r.obj_value, r.certified) != \
                (sync.k, sync.w, sync.n, sync.obj_value, sync.certified):
            fail(f"async north star: ({r.k}, {r.w}, {r.obj_value}) vs synchronous "
                 f"({sync.k}, {sync.w}, {sync.obj_value})")
    launches = path_launches()
    print("sweep path launches", json.dumps(launches), flush=True)
    missing = [k for k in SWEEP_KERNELS if launches[k] == 0]
    if missing:
        fail(f"sweep path never launched {missing}")
    profile_solve(*north, 1e-3, "north_star_M16_per_k", fn=halda_solve_per_k)
    profile_solve(*mixtral, MOE_GAP, "mixtral_M4_per_k", kv_bits="8bit", fn=halda_solve_per_k)
    devs, model, kind = routed[ROUTING_CASES[-1][0]]
    profile_solve(devs, model, MOE_GAP, f"{ROUTING_CASES[-1][0]}_routing", reps=3,
                  kv_bits="8bit", fn=lambda d, m, mip_gap, kv_bits: solve_load_aware(
                      d, m, expert_loads=routing_loads(kind), iters=2, kv_bits=kv_bits,
                      mip_gap=mip_gap))
    return launches


# ---------------------------------------------------------------- stream path

# Stream-path pins, from the JAX package on the CPU (distilp_tpu.solver's
# StreamingReplanner and halda_solve_scenarios, backend 'jax', the same
# fleets, drifts and seeds as stream_path below): (k, objective) of the
# north star's cold tick and its 8 warm ticks under +-5% t_comm drift
# (default_rng(7), bench.py:752-764), of the 8 what-if scenarios drawn from
# the fleet after them (t_comm 0.5-2.0x, default_rng(17), bench.py:809-816)
# warm-seeded from the last tick, of Mixtral over make_synthetic_fleet(4,
# seed=7, pool_bytes=64e9) under the four MIXTRAL_REGIMES load factors, and
# of the DeepSeek-V3 flagship's ticks (cold, two +-5% drifts, a drift with
# every memory pool raised to 34e9 bytes, one more drift) with the tick mode
# the JAX package's replanner took.
STREAM_GAP = 1e-3
NORTH_TICK_PINS = [-38.36824122348659, -38.36704703976956, -38.369238193569586,
                   -38.3719559804616, -38.375984003461895, -38.37259742757424,
                   -38.36941596231185, -38.36534432201876, -38.36935639455396]
NORTH_SCENARIO_PINS = [-38.22217009436706, -38.18267973613846, -38.20562466894333,
                       -38.226872947727244, -38.19670036058756, -38.220260557614786,
                       -38.07130906254162, -38.28795468581493]
MIXTRAL_SCENARIO_PINS = [-132.93320566181376, -132.99713633798956, -133.14923728687404,
                         -132.9855039483965]
FLAGSHIP_TICK_PINS = [(-400.80947050866087, "cold"), (-400.81776379536154, "margin"),
                      (-400.8327422785259, "margin"), (-426.17321971790483, "warm"),
                      (-426.1811522913107, "margin")]
BUCKETS = (2, 4, 8, 16, 32, 64, 128)  # the JAX package's combine.BucketPolicy boundaries
STREAM_KERNELS = ("ipm", "bnb_graph", "bnb_seed", "round_moe",
                  "round_moe_lanes", "round_tail", "round_tail_lanes", "decomp", "decomp_lanes")


def held_to(name, r, pin, gap, k=None):
    rel = abs(r.obj_value - pin) / abs(pin)
    print(f"  {name}: k={r.k} objective {r.obj_value!r} vs pinned {pin!r}: relative "
          f"difference {rel!r} (allowed {2 * gap!r}) certified={r.certified}", flush=True)
    if not r.certified or rel > 2 * gap or (k is not None and r.k != k):
        fail(f"{name}: k={r.k} obj={r.obj_value} certified={r.certified}, pinned {pin}")


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def drift(devs, rng, lo=0.95, hi=1.05):
    for d in devs:
        d.t_comm = max(0.0, d.t_comm * float(rng.uniform(lo, hi)))


def profile_call(name, fn, reps: int = 3) -> None:
    """The device's busy share of ``fn`` (median wall of ``reps``) and its
    device time by kernel, from one profiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = sorted(timed(fn)[1] for _ in range(reps))
    wall = walls[reps // 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, _device_us(e), e.count) for e in prof.key_averages()
                   if _is_device(e) and _device_us(e) > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3
    print("profile", json.dumps({
        "call": name, f"wall_ms_median_of_{reps}": wall, "walls_ms": walls,
        "device_busy_ms": busy if rows else None,
        "device_busy_share": busy / wall if rows else None,
        "top": [{"name": k[:80], "device_ms": us / 1e3, "count": c} for k, us, c in rows[:8]],
    }), flush=True)


def stream_path() -> dict:
    """The streaming replanner and its what-if batches, through the port's
    entry points on the card: ``StreamingReplanner`` ticks (sequential and
    pipelined), ``halda_solve_scenarios`` (one shared A, and the batch-layout
    fallback), ``solve_batch`` lanes (goldens in padded buckets, a mixed-M
    bucket, lane_pad duplicates, per-k lanes), the DeepSeek-V3 flagship's
    cold, margin and warm ticks, and a Mixtral scenario batch (K7's instance
    axis)."""
    import statistics
    import warnings

    import numpy as np
    import torch

    from distilp_torch import kernels
    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.ops import decomp as D
    from distilp_torch.solver import (
        StreamingReplanner,
        halda_solve,
        halda_solve_per_k,
        halda_solve_scenarios,
        solve_batch,
    )
    from distilp_torch.solver.api import _best_to_result, _build_instance
    from distilp_torch.solver.backend_torch import margin_bounds_from_state
    from distilp_torch.solver.standard_form import build_standard_form, rounding_arrays_np
    from distilp_torch.utils import make_synthetic_fleet

    gap = STREAM_GAP
    kernels.reset_launch_counts()
    model = online_model()

    # (1) North star: a cold tick, then 8 warm ticks under +-5% drift.
    devs = make_synthetic_fleet(16, seed=123)
    planner = StreamingReplanner(mip_gap=gap, kv_bits="4bit")
    rng = np.random.default_rng(7)
    walls = []
    for t in range(9):
        if t:
            drift(devs, rng)
        tm = {}
        r, ms = timed(lambda: planner.step(devs, model, timings=tm))
        walls.append(ms)
        print(f"tick north_star_M16 {t}: mode={planner.last_tick_mode} wall_ms={ms:.2f} "
              f"rounds={tm.get('bnb_rounds')} lp_iters={tm.get('ipm_iters_executed')} "
              f"search_ms={tm.get('solve_ms', 0.0):.2f}", flush=True)
        held_to(f"north_star tick {t}", r, NORTH_TICK_PINS[t], gap, k=1)
        if planner.last_tick_mode != ("cold" if t == 0 else "warm"):
            fail(f"north star tick {t}: mode {planner.last_tick_mode}")
    print(f"north star ticks: cold {walls[0]:.2f} ms, warm median "
          f"{statistics.median(walls[1:]):.2f} ms", flush=True)

    # (2) Pipelined ticks: one in flight; each equals the sequential solve
    # seeded, as the pipeline seeds it, with the result two ticks back.
    fleets = [make_synthetic_fleet(16, seed=123)]
    prng = np.random.default_rng(9)
    for _ in range(4):
        fleets.append([d.model_copy() for d in fleets[-1]])
        drift(fleets[-1], prng, 0.9, 1.1)
    piped = StreamingReplanner(mip_gap=gap, kv_bits="4bit")

    def pipeline():
        got = []
        piped.reset()
        piped.submit(fleets[0], model)
        for f in fleets[1:]:
            piped.submit(f, model)
            got.append(piped.collect())
        got.append(piped.collect())
        return got

    got, pipe_ms = timed(pipeline)
    seq = []
    with uncounted():
        for t, f in enumerate(fleets):
            seq.append(halda_solve(f, model, mip_gap=gap, kv_bits="4bit",
                                   warm=seq[t - 2] if t >= 2 else None))
    same = all((a.k, a.w, a.n, a.obj_value) == (b.k, b.w, b.n, b.obj_value)
               for a, b in zip(got, seq))
    print(f"pipelined north star: {len(fleets)} ticks in {pipe_ms:.2f} ms "
          f"({len(fleets) * 1000.0 / pipe_ms:.1f} placements/s); equal to sequential: {same}",
          flush=True)
    if not same or not all(r.certified for r in got):
        fail("pipelined ticks differ from the sequential ones")

    # (3) The S=8 scenario batch, warm-seeded from the last tick.
    scen = scenario_fleets(devs, 8, 17)
    tm = {}
    rs, _ = timed(lambda: halda_solve_scenarios(scen, model, kv_bits="4bit", mip_gap=gap,
                                                warms=[planner.last] * 8, timings=tm))
    sc_ms = [timed(lambda: halda_solve_scenarios(scen, model, kv_bits="4bit", mip_gap=gap,
                                                 warms=[planner.last] * 8))[1]
             for _ in range(3)]
    with uncounted(), launch_bounds({}) as lb:
        halda_solve_scenarios(scen, model, kv_bits="4bit", mip_gap=gap,
                              warms=[planner.last] * 8)
    print(f"scenarios north_star x8: median {statistics.median(sc_ms):.2f} ms "
          f"({8000.0 / statistics.median(sc_ms):.1f} placements/s); rounds="
          f"{tm.get('bnb_rounds')} search_ms={tm.get('solve_ms', 0.0):.2f}; bound of its "
          f"launches {sum(lb.values())!r} ms {json.dumps(lb)}", flush=True)
    if "scenario_fallback" in tm:
        fail("the north-star scenarios took the fallback")
    for i, (f, r) in enumerate(zip(scen, rs)):
        held_to(f"scenario {i}", r, NORTH_SCENARIO_PINS[i], gap, k=1)
        with uncounted():
            own = halda_solve(f, model, mip_gap=gap, kv_bits="4bit")
        if abs(r.obj_value - own.obj_value) > 2 * gap * abs(own.obj_value):
            fail(f"scenario {i}: {r.obj_value} vs its own solve {own.obj_value}")

    # (4) The forced lane fallback: a scenario whose CPU table doubles.
    bad = [d.model_copy(deep=True) for d in scen[0]]
    for q in bad[0].scpu:
        bad[0].scpu[q] = {col: v * 2.0 for col, v in bad[0].scpu[q].items()}
    tm = {}
    rs, ms = timed(lambda: halda_solve_scenarios([scen[0], bad], model, kv_bits="4bit",
                                                 mip_gap=gap, timings=tm))
    print(f"scenario fallback: {tm.get('scenario_fallback')} wall_ms={ms:.2f}", flush=True)
    if tm.get("scenario_fallback") != 1.0:
        fail("the static-half fallback did not fire")
    for f, r in zip([scen[0], bad], rs):
        with uncounted():
            own = halda_solve(f, model, mip_gap=gap, kv_bits="4bit")
        if not r.certified or abs(r.obj_value - own.obj_value) > 2 * gap * abs(own.obj_value):
            fail(f"fallback lane: {r.obj_value} vs its own solve {own.obj_value}")

    # (5) Lanes: the goldens padded to their bucket boundaries.
    for folder, k_star, obj in GOLDEN:
        gdevs, gmodel = load_from_profile_folder(ROOT / "tests" / "profiles" / folder)
        M_pad = next(b for b in BUCKETS if b >= len(gdevs))
        inst, sets = pack_lane(gdevs, gmodel, 1e-4, M_pad=M_pad)
        out, ms = timed(lambda: solve_batch([inst]))
        r = _best_to_result(out[0][1], sets)
        print(f"lane {folder} (M={len(gdevs)} padded to {M_pad}): k={r.k} obj={r.obj_value!r} "
              f"wall_ms={ms:.2f}", flush=True)
        if r.k != k_star or abs(r.obj_value - obj) > 2e-4 * abs(obj) or not r.certified \
                or len(r.w) != len(gdevs):
            fail(f"lane {folder}: k={r.k} obj={r.obj_value}, pinned k={k_star} obj={obj}")

    # (6) A mixed-M bucket (4, 6 and 8 devices padded to 8), lane_pad
    # duplicates, and the same fleets as per-k lanes.
    ks = MIXED_KS
    mfleets = mixed_m_fleets()
    insts = [pack_lane(f, model, gap, M_pad=8, k_candidates=ks)[0] for f in mfleets]
    tm = {}
    plain, ms = timed(lambda: solve_batch(insts, timings=tm))
    padded = solve_batch(insts, lane_pad=4)
    for f, inst, (_, a), (_, b) in zip(mfleets, insts, plain, padded):
        with uncounted():
            own = halda_solve(f, model, mip_gap=gap, kv_bits="4bit", k_candidates=ks)
        print(f"lane mixed-M M={len(f)}: k={a.k} obj={a.obj_value!r} (own solve "
              f"{own.obj_value!r}) certified={a.certified}", flush=True)
        if not a.certified or len(a.w) != len(f) or \
                abs(a.obj_value - own.obj_value) > 2 * gap * abs(own.obj_value):
            fail(f"mixed-M lane M={len(f)}: {a.obj_value} vs {own.obj_value}")
        if (a.k, a.w, a.n, a.obj_value) != (b.k, b.w, b.n, b.obj_value):
            fail("a lane_pad duplicate changed a real lane")
    print(f"mixed-M bucket: wall_ms={ms:.2f} static_hit={tm.get('static_hit')}", flush=True)
    for f, (per_k, _) in zip(mfleets, solve_batch(per_k_lanes(model))):
        with uncounted():
            own = {r.k: r.obj_value for r in halda_solve_per_k(f, model, mip_gap=gap,
                                                               kv_bits="4bit", k_candidates=ks)}
        got = {r.k: r.obj_value for r in per_k if r is not None and r.w is not None}
        print(f"per-k lane M={len(f)}: {got} (own per-k solve {own})", flush=True)
        if sorted(got) != sorted(own) or any(
                abs(got[k] - own[k]) > 2 * gap * abs(own[k]) for k in own) or \
                not all(r.certified for r in per_k if r is not None and r.w is not None):
            fail(f"per-k lane M={len(f)}: {got} vs {own}")

    # (7) The DeepSeek-V3 flagship: cold, margin, warm (memory pools grown)
    # and margin ticks; one margin bound against a full K7 evaluation.
    fdevs, fmodel = moe_instance(FLAGSHIP)[:2]
    fplanner = StreamingReplanner(mip_gap=MOE_GAP, kv_bits="8bit")
    frng = np.random.default_rng(7)
    fwalls, margin_checked = [], False
    for t, (pin, mode) in enumerate(FLAGSHIP_TICK_PINS):
        if t:
            drift(fdevs, frng)
        if t == 3:
            for d in fdevs:
                d.d_avail_ram = int(34e9)
                if d.d_avail_metal is not None:
                    d.d_avail_metal = int(34e9)
                if d.d_avail_cuda is not None:
                    d.d_avail_cuda = int(34e9)
        if t == 2:
            # The margin bound this tick will use, against K7 at the anchor
            # (a comparison, not the path's work: its launch is not counted).
            ms_state = fplanner._margin_state
            Ks, _, coeffs, arrays = _build_instance(fdevs, fmodel, None, "8bit", None, None)
            feas = [(k, fmodel.L // k) for k in Ks if fmodel.L // k >= 32]
            sf = build_standard_form(arrays, coeffs, feas)
            rd_np = rounding_arrays_np(coeffs, arrays.moe)
            reused = margin_bounds_from_state(ms_state, rd_np, sf, ms_state["duals"])
            p64 = D.stack_problems([D.decomp_problem(
                rd_np, sf.ks, sf.Ws, max(sf.Ws), int(rd_np["E"]), torch.float64,
                torch.device("cuda"))])
            lam, mu, tau = (torch.as_tensor(np.asarray(x, np.float64), device="cuda")[None]
                            for x in ms_state["duals"])
            with uncounted():
                fresh = D.eval64(p64, lam, mu, tau, False)[0][0].cpu().numpy()
            rel = float(np.max(np.abs(reused - fresh) / np.abs(fresh)))
            print(f"margin bound vs full K7 evaluation: reused {reused.tolist()} fresh "
                  f"{fresh.tolist()} max relative difference {rel!r}", flush=True)
            if not (np.all(reused <= fresh + 1e-12 * np.abs(fresh)) and rel <= 1e-8):
                fail("the margin bound is unsound or far from the full evaluation")
            margin_checked = True
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tm = {}
            r, ms = timed(lambda: fplanner.step(fdevs, fmodel, timings=tm))
        fwalls.append(ms)
        print(f"tick {FLAGSHIP[0]} {t}: mode={fplanner.last_tick_mode} wall_ms={ms:.2f} "
              f"decomp_steps={tm.get('decomp_steps')} rounds={tm.get('bnb_rounds')} "
              f"search_ms={tm.get('solve_ms', 0.0):.2f}", flush=True)
        held_to(f"{FLAGSHIP[0]} tick {t}", r, pin, MOE_GAP)
        if fplanner.last_tick_mode != mode or sum(r.y) != fmodel.n_routed_experts:
            fail(f"flagship tick {t}: mode {fplanner.last_tick_mode} (pinned {mode}), "
                 f"sum(y)={sum(r.y)}")
    if not margin_checked:
        fail("no margin bound was checked")

    # (8) Mixtral M=4 under four load regimes: one search, one K7 ascent.
    mmodel = moe_model(MOE_CASES[0][1])
    tm = {}
    rs, ms = timed(lambda: mixtral_regimes_solve(mmodel, timings=tm))
    print(f"scenarios mixtral_M4 x4: wall_ms={ms:.2f} decomp_steps={tm.get('decomp_steps')} "
          f"rounds={tm.get('bnb_rounds')}", flush=True)
    for i, r in enumerate(rs):
        held_to(f"mixtral scenario {i}", r, MIXTRAL_SCENARIO_PINS[i], MOE_GAP, k=4)
        if sum(r.y) != mmodel.n_routed_experts:
            fail(f"mixtral scenario {i}: sum(y)={sum(r.y)}")

    launches = path_launches()
    print("stream path launches", json.dumps(launches), flush=True)
    missing = [k for k in STREAM_KERNELS if launches[k] == 0]
    if missing:
        fail(f"stream path never launched {missing}")
    print(f"stream tick walls (median): north star warm {statistics.median(walls[1:]):.2f} ms, "
          f"flagship margin {statistics.median([w for w, (_, m) in zip(fwalls, FLAGSHIP_TICK_PINS) if m == 'margin']):.2f} ms",
          flush=True)
    profile_call("north_star_M16_warm_tick", lambda: planner.step(devs, model))
    profile_call("north_star_scenarios_x8", lambda: halda_solve_scenarios(
        scen, model, kv_bits="4bit", mip_gap=gap, warms=[planner.last] * 8))
    profile_call(f"{FLAGSHIP[0]}_margin_tick", lambda: fplanner.step(fdevs, fmodel))
    return launches


# B11's paths: the 128-device fleet (model stretched to L = 256) as two
# batch lanes, each with its own A (distilp_tpu.solver.batchlayout:
# solve_batch([pack_instance(make_synthetic_fleet(128, seed=s), ...,
# mip_gap=1e-3) for s in (123, 124)]), kv 4bit, engine auto = pdhg), and as
# two futures whose static halves differ (halda_solve_scenarios([base, bad],
# ..., kv_bits="4bit", mip_gap=1e-3) with base = make_synthetic_fleet(128,
# seed=123) and bad = base with its first device's CPU table doubled: the
# batch-layout fallback); pins (k, objective) from the JAX package on the CPU.
LANES128 = [(123, (1, -312.9522665906968)), (124, (1, -315.7883953351909))]
FALLBACK128_PINS = [(1, -312.9522665906968), (1, -312.95378065386245)]
# MoE on the PDHG engine (lp_backend='pdhg'): Mixtral M=4 and Qwen3-30B-A3B
# M=16, pinned as on the IPM engine (the JAX package certifies the same
# objectives on its PDHG engine).
MOE_PDHG_CASES = [MOE_CASES[0], MOE_CASES[2]]
ELEM_KERNELS = ("pdhg_elem", "round_tail_lanes", "round_moe", "round_tail", "decomp")
DIAGNOSE_KERNELS = ("ipm_trace", "pdhg_trace", "ipm", "pdhg", "bnb_graph")


def doubled_cpu_table(devs):
    """A copy of a fleet whose first device's CPU throughput table is
    doubled: its static half differs from the fleet's (the stream path's
    fallback future)."""
    bad = [d.model_copy(deep=True) for d in devs]
    for q in bad[0].scpu:
        bad[0].scpu[q] = {col: v * 2.0 for col, v in bad[0].scpu[q].items()}
    return bad


def elem_path():
    """K5's per-element entry (B11) on its main paths: the 128-device fleets
    as batch lanes with an A each and as the scenario fallback, and MoE
    solves on the PDHG engine. Every K5 call the paths make is captured for
    check_pdhg_elem. Returns (launches, calls)."""
    from distilp_torch import kernels
    from distilp_torch.solver import halda_solve, halda_solve_scenarios, search, solve_batch
    from distilp_torch.utils import make_synthetic_fleet

    kernels.reset_launch_counts()
    calls: list = []
    model128 = online_model(128)
    fleets = {s: make_synthetic_fleet(128, seed=s) for s, _ in LANES128}
    with captured(search, "pdhg_solve_batch", calls):
        insts = [pack_lane(fleets[s], model128, FLEET128_GAP)[0] for s, _ in LANES128]
        tm = {}
        out, ms = timed(lambda: solve_batch(insts, timings=tm))
        print(f"lanes fleet_M128 x2: wall_ms={ms:.2f} engine={tm.get('lp_backend')} "
              f"rounds={tm.get('bnb_rounds')} search_ms={tm.get('solve_ms', 0.0):.2f}",
              flush=True)
        if tm.get("lp_backend") != "pdhg":
            fail(f"the 128-device lanes ran on {tm.get('lp_backend')}")
        for (s, (k, pin)), (_, best) in zip(LANES128, out):
            held_to(f"lane fleet_M128 seed {s}", best, pin, FLEET128_GAP, k=k)
        lanes_elem = kernels.LAUNCHES["pdhg_elem"]
        with uncounted(), launch_bounds({}) as lb:
            solve_batch(insts)
        print(f"lanes fleet_M128 x2: bound of its launches {sum(lb.values())!r} ms "
              f"{json.dumps(lb)}", flush=True)
        base = fleets[123]
        tm = {}
        rs, ms = timed(lambda: halda_solve_scenarios(
            [base, doubled_cpu_table(base)], model128, kv_bits="4bit", mip_gap=FLEET128_GAP,
            timings=tm))
        print(f"scenario fallback fleet_M128: {tm.get('scenario_fallback')} "
              f"engine={tm.get('lp_backend')} wall_ms={ms:.2f}", flush=True)
        if tm.get("scenario_fallback") != 1.0 or tm.get("lp_backend") != "pdhg":
            fail("the 128-device futures did not take the fallback on the PDHG engine")
        for i, (r, (k, pin)) in enumerate(zip(rs, FALLBACK128_PINS)):
            held_to(f"fallback fleet_M128 future {i}", r, pin, FLEET128_GAP, k=k)
        moe_before = kernels.LAUNCHES["pdhg_elem"]
        for name, config, M, seed, pool, (k, pin) in MOE_PDHG_CASES:
            model = moe_model(config)
            devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool))
            tm = {}
            r, ms = timed(lambda: halda_solve(devs, model, mip_gap=MOE_GAP, kv_bits="8bit",
                                              lp_backend="pdhg", timings=tm))
            show(f"{name}_pdhg", r, ms, tm)
            held_to(f"{name} on the PDHG engine", r, pin, MOE_GAP, k=k)
            if tm.get("lp_backend") != "pdhg" or sum(r.y) != model.n_routed_experts:
                fail(f"{name} pdhg: engine {tm.get('lp_backend')}, sum(y)={sum(r.y)}")
        moe_elem = kernels.LAUNCHES["pdhg_elem"] - moe_before
    launches = path_launches()
    print("elem path launches", json.dumps(launches), flush=True)
    missing = [k for k in ELEM_KERNELS if launches[k] == 0]
    if missing or lanes_elem == 0 or moe_elem == 0:
        fail(f"elem path never launched {missing} (pdhg_elem: lanes {lanes_elem}, "
             f"MoE {moe_elem})")
    with uncounted():
        for (s, _), (_, best) in zip(LANES128, out):
            own = halda_solve(fleets[s], model128, mip_gap=FLEET128_GAP, kv_bits="4bit")
            print(f"  lane seed {s}: {best.obj_value!r} vs its own solve {own.obj_value!r}",
                  flush=True)
            if abs(best.obj_value - own.obj_value) > 2 * FLEET128_GAP * abs(own.obj_value):
                fail(f"lane seed {s}: {best.obj_value} vs its own solve {own.obj_value}")
        profile_call("fleet_M128_lanes_x2", lambda: solve_batch(insts))
    return launches, calls


def diagnose_cases() -> list:
    """The diagnose path's solves, each through a user's entry point at
    full width, as (name, fn(conv) -> result, engine): ``conv`` is the
    caller's convergence dict, or None for the untraced solve. The north
    star cold on the IPM; the 128-device fleet on the PDHG in float32 and in
    float64; Mixtral 8x7B on 4 devices (MoE with LP rounds) on the IPM; a
    diagnostics replanner over the north star's cold and two warm ticks
    (warm roots: the IPM's chunked trace) and over Mixtral M=4's cold and
    two margin ticks; the 128-device fleet on a virtual row mesh of S=4."""
    import numpy as np

    from distilp_torch.solver import StreamingReplanner, halda_solve
    from distilp_torch.utils import make_synthetic_fleet

    ns, model = make_synthetic_fleet(16, seed=123), online_model()
    f128, model128 = make_synthetic_fleet(128, seed=123), online_model(128)
    _, mconfig, mM, mseed, mpool, _ = MOE_CASES[0]
    mmodel = moe_model(mconfig)

    def mdevs():
        return make_synthetic_fleet(mM, seed=mseed, pool_bytes=int(mpool))

    def solve(devs, mdl, gap, kv="4bit", **kw):
        return lambda conv: halda_solve(devs, mdl, mip_gap=gap, kv_bits=kv, convergence=conv,
                                        **kw)

    def ticks(make, mdl, gap, kv, moves, want):
        def run(conv):
            planner = StreamingReplanner(mip_gap=gap, kv_bits=kv, diagnostics=conv is not None)
            devs, modes = make(), []
            for move in [None] + moves:
                if move is not None:
                    move(devs)
                planner.step(devs, mdl)
                modes.append(planner.last_tick_mode)
                if conv is not None and not planner.last_convergence.get("round_log"):
                    fail(f"diagnostics tick {len(modes) - 1}: empty convergence report")
            if modes != want:
                fail(f"the diagnostics replanner's ticks were {modes}, not {want}")
            if conv is not None:
                conv.update(planner.last_convergence)
            return planner.last
        return run

    rng_moves = [lambda d: drift(d, np.random.default_rng(11)),
                 lambda d: drift(d, np.random.default_rng(12))]

    def scale(i, f):
        def move(devs):
            devs[i].t_comm = devs[i].t_comm * f
        return move

    return [
        ("north_star_M16 ipm cold", solve(ns, model, 1e-3), "ipm"),
        ("fleet_M128 pdhg f32", solve(f128, model128, FLEET128_GAP), "pdhg"),
        ("fleet_M128 pdhg f64", solve(f128, model128, FLEET128_GAP, pdhg_dtype="f64"), "pdhg"),
        ("mixtral_M4 ipm", solve(mdevs(), mmodel, MOE_GAP, "8bit"), "ipm"),
        ("north_star_M16 replanner cold warm warm",
         ticks(lambda: make_synthetic_fleet(16, seed=123), model, 1e-3, "4bit", rng_moves,
               ["cold", "warm", "warm"]), "ipm"),
        ("mixtral_M4 replanner cold margin margin",
         ticks(mdevs, mmodel, MOE_GAP, "8bit", [scale(1, 1.01), scale(2, 1.03)],
               ["cold", "margin", "margin"]), "ipm"),
        ("fleet_M128 pdhg row mesh S=4",
         solve(f128, model128, FLEET128_GAP, lp_backend="pdhg", mesh_shards=4), "pdhg"),
    ]


def diagnose_path() -> dict:
    """The convergence telemetry (B13) and the round log on the loop graph
    (R3d) through the port's entry points: every :func:`diagnose_cases`
    solve with the log on (its answer row, whole, against the host loop's
    under ``device_loop.host_loop``: head, root iterates, log and trace,
    bit for bit; the untraced graph solve's answer is its head and root
    iterates, bit for bit; one graph launch, one upload, one read and 0
    runtime kernel launches a solve; no search off the graph, every one
    marked ``+log``); the walls (medians of 5, in turns) of the north star
    and the 128-device fleet traced on the graph, untraced on the graph
    and traced on the host loop; the ``diagnose`` CLI with its JSONL export
    and ``--load``; and ``serve --solver-diagnostics`` over the scheduler
    smoke trace (no host route) beside a plain ``serve``."""
    import statistics
    import tempfile

    import torch

    from distilp_torch import kernels
    from distilp_torch.obs.convergence import CONV_DIGEST_KEYS, build_search_trace
    from distilp_torch.parallel import force_virtual_devices
    from distilp_torch.solver import device_loop as DL
    from distilp_torch.solver import packed as PK

    force_virtual_devices(8)
    kernels.reset_launch_counts()
    cases = diagnose_cases()
    walled = {"north_star_M16 ipm cold", "fleet_M128 pdhg f32"}
    for name, fn, engine in cases:
        conv, routes0 = {}, dict(kernels.SHAPES["bnb_graph"])
        graph_log: list = []
        g0, c0 = kernels.LAUNCHES["bnb_graph"], dict(PK.COPIES)
        with recorded_loops(graph_log):
            r, ms = timed(lambda: fn(conv))  # noqa: B023
        n_graph = kernels.LAUNCHES["bnb_graph"] - g0
        d2h = PK.COPIES["d2h"] - c0["d2h"]
        routes = {k: v - routes0.get(k, 0) for k, v in kernels.SHAPES["bnb_graph"].items()
                  if v != routes0.get(k, 0)}
        host_log: list = []
        plain_log: list = []
        with uncounted():
            with DL.host_loop(), recorded_loops(host_log):
                fn({})
            with recorded_loops(plain_log):
                fn(None)
            # A static hit: the uploads and reads of one more logged call,
            # and its runtime kernel launches (the profiler's).
            c1 = dict(PK.COPIES)
            fn({})
            torch.cuda.synchronize()
            h2d_hit = PK.COPIES["h2d"] - c1["h2d"]
            d2h_hit = PK.COPIES["d2h"] - c1["d2h"]
            kl = kernel_launches(lambda: fn({}))  # noqa: B023
        answers = [a for kind, a in graph_log if kind == "answer"]
        h_answers = [a for kind, a in host_log if kind == "answer"]
        u_answers = [a for kind, a in plain_log if kind == "answer"]
        solves = len(answers)
        same_host = solves > 0 and len(h_answers) == solves and all(
            bits_equal(a, b) for a, b in zip(answers, h_answers))
        same_untraced = len(u_answers) == solves and all(
            u.shape[1] < a.shape[1] and bits_equal(a[:, :u.shape[1]], u)
            for a, u in zip(answers, u_answers))
        digest = build_search_trace(conv).digest()
        line = {"case": name, "solves": solves, "engine": conv.get("lp_backend"), "k": r.k,
                "obj": r.obj_value, "rounds": len(conv.get("round_log", [])),
                "trace_rows": [len(t) for t in conv.get("root_trace", [])][:1],
                "answers_equal_host_loop": same_host, "same_as_untraced": same_untraced,
                "graph_launches": n_graph, "d2h": d2h, "h2d_static_hit": h2d_hit,
                "d2h_static_hit": d2h_hit,
                "graph_launches_profiled": kl["wrappers"].get("bnb_graph", 0),
                "runtime_launches": kl["runtime_launches"], "wall_ms": ms, "routes": routes,
                "digest": {k: digest[k] for k in CONV_DIGEST_KEYS if k in digest}}
        print("diagnose", json.dumps(line), flush=True)
        if not (same_host and same_untraced):
            fail(f"diagnose {name}: the logged graph solve differs from the host loop "
                 f"({same_host}) or from the untraced solve ({same_untraced})")
        if (n_graph != solves or d2h != solves or h2d_hit != solves or d2h_hit != solves
                or line["graph_launches_profiled"] != solves or kl["runtime_launches"] != 0):
            fail(f"diagnose {name}: not one graph launch, one upload, one read and no runtime "
                 f"kernel launch a solve: {line}")
        if not routes or any(not k.startswith("route=graph") or "+log" not in k
                             for k in routes):
            fail(f"diagnose {name}: a logged search left the graph route: {routes}")
        if conv.get("lp_backend") != engine or not conv.get("round_log") \
                or not line["digest"].get("conv_certified"):
            fail(f"diagnose {name}: engine {conv.get('lp_backend')}, digest {line['digest']}")
    # Walls: traced on the graph, untraced on the graph, traced on the host
    # loop, in turns, medians of 5; the graph routes' device spans (CUDA
    # events around the graph launch) and the host's decode of the log
    # (``backend_torch._decode_convergence``) beside them, so a logged
    # solve's cost over the untraced one splits into card and host.
    from distilp_torch.solver import backend_torch as BT

    decode_orig = BT._decode_convergence
    for name, fn, _ in cases:
        if name not in walled:
            continue
        walls = {"traced": [], "untraced": [], "traced_host_loop": []}
        spans = {"traced": [], "untraced": []}
        decode: dict = {"traced": [], "traced_host_loop": []}
        with uncounted():
            for rep in range(5):
                order = list(walls) if rep % 2 == 0 else list(walls)[::-1]
                for label in order:
                    ctx = DL.host_loop() if label == "traced_host_loop" else graph_spans()

                    def timed_decode(*a, _into=decode.get(label)):
                        t0 = time.perf_counter()
                        decode_orig(*a)
                        _into.append((time.perf_counter() - t0) * 1e3)

                    if label != "untraced":
                        BT._decode_convergence = timed_decode
                    try:
                        with ctx as sp:
                            walls[label].append(timed(
                                lambda: fn(None if label == "untraced" else {}))[1])  # noqa: B023
                    finally:
                        BT._decode_convergence = decode_orig
                    if label in spans:
                        spans[label].extend(sp)
        line = {"case": name, "card": smi_line(),
                **{f"{k}_ms_median_of_5": statistics.median(v) for k, v in walls.items()},
                **{f"{k}_device_span_ms_median": statistics.median(v)
                   for k, v in spans.items() if v},
                **{f"{k}_decode_ms_median": statistics.median(v)
                   for k, v in decode.items() if v},
                "walls_ms": walls}
        print("diagnose walls", json.dumps(line), flush=True)
    child: dict = {}
    with tempfile.TemporaryDirectory(prefix="distilp_diagnose_") as tmp:
        out = Path(tmp) / "diag.jsonl"
        rc, stdout, err, wall = run_cli("distilp_torch.cli.solver_cli", [
            "diagnose", "-p", "tests/profiles/llama_3_70b/online", "--out", str(out)], child)
        print(stdout[-1500:], flush=True)
        if rc != 0 or not out.is_file():
            fail(f"solver diagnose exited {rc}:\n{err[-2000:]}")
        rc2, stdout2, err2, _ = run_cli("distilp_torch.cli.solver_cli", [
            "diagnose", "--load", str(out)], child)
        if rc2 != 0 or "search:" not in stdout2:
            fail(f"solver diagnose --load exited {rc2}:\n{err2[-2000:]}")
    # serve --solver-diagnostics over the scheduler smoke trace, beside a
    # plain serve of the same trace (whose launches are not this path's).
    serve = ["serve", "--trace", "tests/traces/scheduler_smoke_20.jsonl", *SERVE_SMOKE]
    summaries = {}
    for label, extra, into in (("plain", [], {}), ("solver_diagnostics",
                                                   ["--solver-diagnostics"], child)):
        before = dict(into.get("_shapes", {}).get("bnb_graph", {}))
        rc, stdout, err, wall = run_cli("distilp_torch.cli.solver_cli", serve + extra, into)
        if rc != 0:
            fail(f"serve {label} exited {rc}:\n{err[-2000:]}")
        sm = serve_summary(stdout)
        after = into.get("_shapes", {}).get("bnb_graph", {})
        routes = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        counters = sm["metrics"]["counters"]
        summaries[label] = {
            "wall_s": wall, "replay": sm["replay"], "routes": routes,
            "ticks_by_mode": {k: v for k, v in counters.items() if k.startswith("tick_")},
            "tick_ms_by_kind": {k: {q: v[q] for q in ("count", "p50_ms", "p99_ms", "mean_ms")}
                                for k, v in sm["metrics"]["latency"].items()
                                if k in ("drift_tick", "structural_tick",
                                         "event_to_placement")}}
        print(f"serve {label}", json.dumps(summaries[label]), flush=True)
    logged = summaries["solver_diagnostics"]["routes"]
    if not logged or any(k.startswith("route=host") or "+log" not in k for k in logged):
        fail(f"serve --solver-diagnostics: a search left the logged graph route: {logged}")
    launches = path_launches(child)
    print("diagnose path launches", json.dumps(launches), flush=True)
    missing = [k for k in DIAGNOSE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"diagnose path never launched {missing}")
    return launches


# ------------------------------------------------------------- the mesh (K6b, K9c, K10)

# Collective bounds: a reduction reads S parts once and writes one result,
# per receiving shard; S - 1 operations per element.
MESH_SHARDS = (2, 4)
MESH_KERNELS = ("pdhg_sharded", "pdhg_sharded_elem", "collective", "pdhg", "ipm",
                "round_incumbent", "round_moe", "round_tail", "decomp", "bnb_gather",
                "bnb_graph")
# K6b against the unsharded K5 at equal step counts: float64 obj and bound
# within 1e-9 relative (the two sum the same products in another order);
# float32 holds the float64 bound as check_pdhg does (TOL_PDHG_F32_CERT).
TOL_PDHG_SHARDED_F64 = 1e-9


def virtual_mesh(S: int):
    """S shards on cuda:0: a virtual mesh of this one card."""
    import torch

    from distilp_torch.parallel import Mesh

    return Mesh((torch.device("cuda", 0),) * S, True)


def bits(t):
    """A tensor's bit pattern (NaN payloads included), for bit-for-bit checks;
    a non-float tensor as it is."""
    import torch

    t = t.detach().contiguous()
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# Every output of K6b (trace_buf None when untraced).
K6B_FIELDS = ("v", "bound", "obj", "rp_norm", "rd_norm", "mu", "converged", "reduced",
              "y_dual", "z_dual", "f_dual", "iters_run", "trace_buf")


def same_bits(a, b, fields=K6B_FIELDS) -> bool:
    """Two IPMResults equal bit for bit in ``fields``."""
    import torch

    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            if (x is None) != (y is None):
                return False
        elif not torch.equal(bits(x), bits(y)):
            return False
    return True


def route_launches(name: str) -> dict:
    """K6b launches (``name``: either entry's count) since the last reset, by
    route: the fused one (every shard of one card in one launch a slice)
    and the sequenced one (a launch per phase per shard)."""
    from distilp_torch import kernels

    out = {"fused": 0, "sequenced": 0}
    for shape, c in kernels.SHAPES[name].items():
        out[shape.rsplit("route=", 1)[-1]] += c
    return out


def routes_agree(name: str, run, k) -> dict:
    """The fused route's result ``k`` of ``run(**kw)`` (``sharded_pdhg`` on
    a one-card mesh) against a traced fused launch (equal to ``k`` in every
    untraced field) and the sequenced route at the fused route's per-shard
    grid, traced (equal to the traced fused launch in every field, the
    trace and every shard's copy included); with each route's launches a
    call."""
    import torch

    from distilp_torch import kernels

    kernels.reset_launch_counts()
    tr = run(trace=True)
    torch.cuda.synchronize()
    fused = route_launches(name)
    reps: list = []
    kernels.reset_launch_counts()
    sq = run(trace=True, _sequenced=True, replicas=reps)
    torch.cuda.synchronize()
    seq = route_launches(name)
    untraced = K6B_FIELDS[:-1]
    return {"traced_equal_untraced": same_bits(tr, k, untraced),
            "trace_rows": int((tr.trace_buf[..., 5] > 0).sum()),
            "sequenced_equal_fused": same_bits(sq, tr) and all(same_bits(r, sq) for r in reps),
            "launches_per_call": {"fused": fused["fused"], "sequenced": seq["sequenced"]},
            "fused_only": fused["sequenced"] == 0 and seq["fused"] == 0}


def check_collective(report: dict) -> None:
    """psum and pmax over a 4-shard virtual mesh against their plain versions
    on the card, bit for bit on every shard (a NaN part included), at the
    PDHG's per-step exchange (B=2 x n=1665) and a (1, 8) latency probe;
    all_gather against torch.cat."""
    import torch

    from distilp_torch.parallel.collectives import (
        AllReduce,
        all_gather,
        allreduce_reference,
    )

    S = 4
    mesh = virtual_mesh(S)
    gen = torch.Generator(device="cuda").manual_seed(9)
    bad, lines = [], []
    for dtype in (torch.float32, torch.float64):
        for shape in ((2, 1665), (1, 8)):
            parts = [torch.randn(shape, dtype=dtype, device="cuda", generator=gen)
                     for _ in range(S)]
            parts[2].view(-1)[3] = float("nan")
            for op in ("sum", "max"):
                out = [torch.empty_like(parts[0]) for _ in range(S)]
                AllReduce(parts, out, mesh, op)()
                ref = allreduce_reference(parts, op)
                torch.cuda.synchronize()
                same = all(torch.equal(bits(o), bits(ref)) for o in out)
                lines.append({"dtype": str(dtype).split(".")[-1], "shape": list(shape),
                              "op": op, "bit_equal_every_shard": same,
                              "nan_propagated": bool(torch.isnan(out[0].view(-1)[3]))})
                if not same or not lines[-1]["nan_propagated"]:
                    bad.append(lines[-1])
    blocks = [torch.randn((2, 193), device="cuda", generator=gen) for _ in range(S)]
    gathered = all_gather(blocks, mesh, dim=1)
    cat_ok = all(torch.equal(g, torch.cat(blocks, 1)) for g in gathered)
    print("collective vs plain", json.dumps({"cases": lines, "all_gather_equal": cat_ok}),
          flush=True)
    if bad or not cat_ok:
        fail(f"collective kernel disagrees with its plain version: {bad} "
             f"all_gather {cat_ok}")
    # Time at the per-step exchange: the S-receiver plan is S launches.
    parts = [torch.randn((2, 1665), device="cuda", generator=gen) for _ in range(S)]
    outs = [torch.empty_like(parts[0]) for _ in range(S)]
    plan = AllReduce(parts, outs, mesh, "sum")
    call = cuda_ms(plan) / S
    dev = device_ms(plan, "reduce_parts", reps=20)
    ms, src = (dev, "profiler") if dev is not None else (call, "cuda_events")
    plain = cuda_ms(lambda: allreduce_reference(parts, "sum"))
    lib = cuda_ms(lambda: torch.stack(parts).sum(0))
    n = parts[0].numel()
    b_ms, b_by = bound_ms((S - 1) * n, (S + 1) * n * 4, PEAK_F32_S)
    print(f"collective psum S={S} (2, 1665) float32: {ms:.5f} ms a launch ({src}), "
          f"{call:.5f} ms a launch with the host's share (plain {plain:.4f}, "
          f"torch.stack(...).sum(0) {lib:.4f}, bound {b_ms:.7f} by {b_by})", flush=True)
    report["collective"] = dict(
        name="collective", route="cuda",
        source="distilp_torch/kernels/csrc/collective_kernel.cu",
        replaces="distilp_tpu/ops/pdhg.py:164", max_abs_err=0.0, ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib, held_against_plain="bit for bit",
        call_ms=call, ms_source=src,
        shapes_timed=f"psum of {S} float32 (2, 1665) parts, one receiving shard",
    )


def sharded_flops_bytes(m: int, n: int, nnz: int, B: int, S: int, iters_run, chunk: int,
                        itemsize: int, warm: bool = False, a_bytes=None):
    """Least work of one row-sharded solve: K5's (pdhg_flops_bytes, A read
    once over all shards; a per-element A passes ``a_bytes``: each shard's
    values read once per element and its block's structure once) plus the
    collectives' bytes, each exchange S parts read and one result written
    per receiving shard: per step the (B, n) column partial and the (B, 3)
    step scalars, per chunk two (B,) scalars, at setup and exit the column
    1-norms, the warm start's and the certificate's (float64) column
    partials."""
    flops, nbytes, _ = pdhg_flops_bytes(m, n, nnz, B, iters_run, chunk, itemsize, warm,
                                        a_bytes=a_bytes)
    steps = max(int(i) for i in iters_run)
    chunks = -(-steps // chunk) + 1
    per = lambda ln, sz: S * (S + 1) * ln * sz  # noqa: E731
    coll = steps * (per(B * n, itemsize) + per(3 * B, itemsize))
    coll += chunks * 2 * per(B, itemsize)
    coll += (3 + (2 if warm else 0)) * per(B * n, itemsize) + per(B * n, 8) + per(B, 8)
    return flops, nbytes + coll


def at_equal_steps(batch, k, r, run_k, run_r, warm=None):
    """Two runs' (bound, obj) with every element at equal step counts: an
    element the two stopped at different chunks is run again in both
    (``run_k(sub_batch, steps)``, ``run_r(...)``; with ``warm``, the
    element's warm state as a third argument) with the budget cut to the
    earlier stop. Returns ((bound, obj) of k, of r, {element: steps})."""
    import torch

    from distilp_torch.ops.ipm import LPBatch

    kb, rb = k.bound.clone(), r.bound.clone()
    ko, ro = k.obj.clone().double(), r.obj.clone().double()
    rerun = {}
    for e in torch.nonzero(k.iters_run != r.iters_run).flatten().tolist():
        steps = int(torch.minimum(k.iters_run[e], r.iters_run[e]))
        sub = LPBatch(a_rows(batch.A, e, e + 1), *(t[e:e + 1] for t in batch[1:]))
        args = (sub, steps) if warm is None else (
            sub, steps, type(warm)(*(t[e:e + 1] for t in warm)))
        ke, re = run_k(*args), run_r(*args)
        kb[e], rb[e], ko[e], ro[e] = ke.bound[0], re.bound[0], ke.obj[0], re.obj[0]
        rerun[e] = steps
    return (kb, ko), (rb, ro), rerun


def fused_route_ok(line: dict, n_launch: int, n_coll: int, B: int) -> bool:
    """The fused route's call: one launch a slice of at most BMAX elements
    and no collective launch; its traced launch and the sequenced route
    equal to it (``routes_agree``)."""
    from distilp_torch.ops.pdhg import BMAX

    return (n_launch == -(-B // BMAX) and n_coll == 0
            and line["launches_per_call"]["fused"] == n_launch and line["fused_only"]
            and line["traced_equal_untraced"] and line["trace_rows"] > 0
            and line["sequenced_equal_fused"])


def check_pdhg_sharded(report: dict) -> None:
    """K6b on the 128-device fleet's root LPs (B=2, m=769, n=1665) at S=2
    and S=4 on a virtual mesh of cuda:0, float64 and float32, by its fused
    route (one launch a call): against the sequenced route at the same
    per-shard grid bit for bit (``routes_agree``), against the unsharded K5
    at equal step counts, against the sharded plain version on the card,
    every shard's copy of the result bit for bit equal, a traced launch
    equal to the untraced one; then the time per call of both routes,
    launches per call and per step, device busy and bound, beside two
    ``torch.matmul`` a step on each shard's block."""
    import torch

    from distilp_torch import kernels
    from distilp_torch.ops.meshlp import shard_rows, sharded_pdhg, sharded_pdhg_reference
    from distilp_torch.ops.pdhg import (
        DEFAULT_RESTART_TOL,
        PDHG_DEFAULT_CHUNK,
        _default_tol_pdhg,
        pdhg_solve_batch,
    )
    from distilp_torch.solver.standard_form import default_pdhg_iters

    iters = default_pdhg_iters(128)
    rt = DEFAULT_RESTART_TOL
    rows, bad = [], []
    for dtype in (torch.float64, torch.float32):
        batch, host = pdhg_roots(128, dtype)
        tol = _default_tol_pdhg(dtype)
        k5 = pdhg_solve_batch(batch, iters=iters)
        for S in MESH_SHARDS:
            mesh = virtual_mesh(S)
            reps: list = []
            kernels.reset_launch_counts()
            k = sharded_pdhg(batch, mesh, iters, tol, rt, replicas=reps)
            torch.cuda.synchronize()
            n_launch = kernels.LAUNCHES["pdhg_sharded"]
            n_coll = kernels.LAUNCHES["collective"]
            same = all(same_bits(a, reps[0]) for a in reps)
            routes = routes_agree("pdhg_sharded", lambda mesh=mesh, tol=tol, **kw: sharded_pdhg(
                batch, mesh, iters, tol, rt, **kw), k)
            run_s = (lambda sub, st, mesh=mesh, tol=tol:  # noqa: E731
                     sharded_pdhg(sub, mesh, st, tol, rt))
            (kb, ko), (rb, ro), rerun = at_equal_steps(
                batch, k, k5, run_s,
                lambda sub, st, tol=tol: pdhg_solve_batch(sub, iters=st, tol=tol,
                                                          restart_tol=rt))
            vs_k5 = {"bound": max_err(kb, rb)[1], "obj": max_err(ko, ro)[1]}
            line = {"S": S, "dtype": str(dtype).split(".")[-1], "iters": iters,
                    "iters_run": k.iters_run.tolist(), "iters_run_k5": k5.iters_run.tolist(),
                    "converged": k.converged.tolist(), "bound": k.bound.tolist(),
                    "max_rel_vs_unsharded_k5": vs_k5, "rerun_at_equal_steps": rerun,
                    "replicas_bit_equal": same, "launches": n_launch,
                    "collective_launches": n_coll,
                    "launches_per_step": (n_launch + n_coll) / max(1, int(k.iters_run.max())),
                    **routes}
            if dtype == torch.float64 or S == 4:
                m = batch.b.shape[1]

                def plain(sub, st, S=S, tol=tol):
                    A_b, b_b, *_ = shard_rows(sub, S)
                    out = sharded_pdhg_reference(A_b, b_b, sub.c, sub.l, sub.u, st, tol, rt)
                    return out._replace(y_dual=out.y_dual[:, :m])

                r = plain(batch, iters)
                torch.cuda.synchronize()
                errs = {f: max_err(getattr(k, f), getattr(r, f))
                        for f in ("v", "bound", "obj", "y_dual", "reduced")}
                (kb2, _), (rb2, _), rerun2 = at_equal_steps(batch, k, r, run_s, plain)
                line["max_rel_vs_sharded_plain"] = {f: e[1] for f, e in errs.items()}
                line["max_abs_bound_vs_sharded_plain"] = max_err(kb2, rb2)[0]
                line["iters_run_plain"] = r.iters_run.tolist()
                line["plain_rerun_at_equal_steps"] = rerun2
                if dtype == torch.float64:
                    line["plain_ok"] = not rerun2 and all(
                        e[1] <= TOL_PDHG_F64 for e in errs.values())
                else:
                    line["plain_ok"] = max_err(kb2, rb2)[1] <= TOL_PDHG_F32_CERT
            tol_k5 = TOL_PDHG_SHARDED_F64 if dtype == torch.float64 else TOL_PDHG_F32_CERT
            held = vs_k5["bound"] <= tol_k5 and (
                dtype != torch.float64 or vs_k5["obj"] <= tol_k5)
            line["ok"] = bool(held and same and line.get("plain_ok", True)
                              and fused_route_ok(line, n_launch, n_coll, int(batch.b.shape[0])))
            print("pdhg_sharded", json.dumps(line), flush=True)
            rows.append(line)
            if not line["ok"]:
                bad.append((S, line["dtype"]))
    if bad:
        fail(f"pdhg_sharded disagrees with K5, its plain version, the sequenced route, "
             f"across shards or traced in (S, dtype) {bad}")

    # Time at the main path's shape: the 128-device root round in float32,
    # S=2 and 4, both routes, beside the unsharded K5 launch on the same
    # rows and two torch.matmul a step on each shard's block.
    batch, _ = pdhg_roots(128, torch.float32)
    m, n = batch.A.shape
    B = int(batch.b.shape[0])
    nnz = int(torch.count_nonzero(batch.A))
    tol = _default_tol_pdhg(torch.float32)
    k5 = cuda_ms(lambda: pdhg_solve_batch(batch, iters=iters), reps=5, warmup=1)
    timing = {}
    for S in MESH_SHARDS:
        mesh = virtual_mesh(S)
        run = lambda **kw: sharded_pdhg(batch, mesh, iters, tol, rt, **kw)  # noqa: E731
        timing[S] = k6b_timing("pdhg_sharded", run, S, sharded_flops_bytes(
            m, n, nnz, B, S, run().iters_run.tolist(), PDHG_DEFAULT_CHUNK, 4))
        A_b, b_b, *_ = shard_rows(batch, S)
        X = torch.rand(n, B, device="cuda")
        Ys = [torch.rand(a.shape[0], B, device="cuda") for a in A_b]
        mm = cuda_ms(lambda: [(a @ X, a.T @ y) for a, y in zip(A_b, Ys)])
        timing[S].update(matmul_step_ms=mm, library_ms=mm * timing[S]["steps"], k5_ms=k5)
        print(f"pdhg_sharded M=128 S={S} float32: {json.dumps(timing[S])}; "
              f"unsharded K5 {k5:.3f} ms", flush=True)
    A_b, b_b, *_ = shard_rows(batch, 4)
    plain = cuda_ms(lambda: sharded_pdhg_reference(A_b, b_b, batch.c, batch.l, batch.u,
                                                   iters, tol, rt), reps=1, warmup=0)
    t4 = timing[4]
    report["pdhg_sharded"] = dict(
        name="pdhg_sharded", route="cuda",
        source="distilp_torch/kernels/csrc/pdhg_sharded_kernel.cu",
        replaces="distilp_tpu/ops/meshlp.py:96",
        max_abs_err=max(r_["max_abs_bound_vs_sharded_plain"] for r_ in rows
                        if "max_abs_bound_vs_sharded_plain" in r_),
        max_rel_vs_unsharded_k5=max(r_["max_rel_vs_unsharded_k5"]["bound"] for r_ in rows),
        ms=t4["ms"], plain_ms=plain, bound_ms=t4["bound_ms"], bound_by=t4["bound_by"],
        library_ms=t4["library_ms"],
        library="two torch.matmul a step on each shard's block x steps",
        k5_ms=k5, held_against_plain="ok", device_busy_ms=t4["device_busy_ms"],
        launches_per_call=t4["launches_per_call"], sequenced_ms=t4["sequenced_ms"],
        steps=t4["steps"],
        shapes_timed=f"M=128 root round, float32, S=4, {iters} steps, fused route",
        s2=timing[2],
    )


def k6b_timing(name: str, run, S: int, work) -> dict:
    """A K6b call (``run(**kw)`` on a one-card mesh) timed by both routes:
    the fused route's ms a call (CUDA events), its device busy ms a call
    (profiler) and launches a call; the sequenced route's at the fused
    route's per-shard grid, its launches and collective launches a call;
    the bound from ``work`` = (operations, bytes)."""
    from distilp_torch import kernels

    res = run()
    call = cuda_ms(lambda: run(), reps=3, warmup=1)
    busy = device_ms(lambda: run(), "pdhgs_fused_kernel", reps=2)
    kernels.reset_launch_counts()
    run()
    per_call = route_launches(name)["fused"]
    seq = cuda_ms(lambda: run(_sequenced=True), reps=3, warmup=1)
    kernels.reset_launch_counts()
    run(_sequenced=True)
    seq_launches = route_launches(name)["sequenced"]
    seq_coll = kernels.LAUNCHES["collective"]
    steps = int(res.iters_run.max())
    b_ms, b_by = bound_ms(work[0], work[1], PEAK_F32_S)
    return dict(S=S, ms=call, device_busy_ms=None if busy is None else busy * per_call,
                launches_per_call=per_call, steps=steps, sequenced_ms=seq,
                sequenced_launches_per_call=seq_launches,
                sequenced_collective_launches_per_call=seq_coll,
                sequenced_launches_per_step=(seq_launches + seq_coll) / max(1, steps),
                bound_ms=b_ms, bound_by=b_by)


def mixtral_mesh_calls(S: int = 2):
    """The K6b calls of Mixtral M=4's solve at ``S`` shards (gap 1e-3, kv
    8bit, the PDHG engine; run here uncounted): the root round's (B=4, m=34,
    n=65) and the first 16-node round's, each ``(batch, iters, warm, skip)``
    as the search sends them."""
    import os

    from distilp_torch.parallel import VIRTUAL_DEVICES_ENV
    from distilp_torch.solver import halda_solve, search
    from distilp_torch.utils import make_synthetic_fleet

    name, config, M, seed, pool, _ = MOE_CASES[0]
    model = moe_model(config)
    devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool))
    calls: list = []
    saved = os.environ.get(VIRTUAL_DEVICES_ENV)
    os.environ[VIRTUAL_DEVICES_ENV] = "8"  # this solve's own virtual mesh
    try:
        with uncounted(), captured(search, "sharded_pdhg", calls):
            halda_solve(devs, model, mip_gap=MOE_GAP, kv_bits="8bit", lp_backend="pdhg",
                        mesh_shards=S)
    finally:
        if saved is None:
            del os.environ[VIRTUAL_DEVICES_ENV]
        else:
            os.environ[VIRTUAL_DEVICES_ENV] = saved
    root = calls[0]
    wide = next((c for c in calls if c[0][0].b.shape[0] == 16), None)
    if wide is None:
        fail(f"the {name} solve at S={S} sent no 16-node batch to K6b")
    return [(label, a[0], a[2], kw.get("warm"), kw.get("skip"))
            for label, (a, kw) in (("root", root), ("nodes16", wide))]


def check_pdhg_sharded_elem(report: dict) -> None:
    """K6b's per-element entry (B6c) on Mixtral M=4's MoE node A's as its
    solve at S=2 sends them (the root round, B=4, m=34, n=65, and the first
    round of 16 nodes, warm, some skipped), at S=2 and S=4 on a virtual mesh
    of cuda:0, float64 and float32, by its fused route: against the
    sequenced route at the same per-shard grid bit for bit, against the
    unsharded K5 per-element entry at equal step counts, against the sharded
    plain version on the card, every shard's copy of the result bit for bit
    equal, a traced launch equal to the untraced one; then both routes'
    time per call, launches per call and per step and the bound at the root
    round, beside two ``torch.bmm`` a step."""
    import torch

    from distilp_torch import kernels
    from distilp_torch.ops.meshlp import shard_rows, sharded_pdhg, sharded_pdhg_reference
    from distilp_torch.ops.pdhg import (
        DEFAULT_RESTART_TOL,
        PDHG_DEFAULT_CHUNK,
        _default_tol_pdhg,
        cast_batch,
        pdhg_solve_batch,
    )

    rt = DEFAULT_RESTART_TOL
    cases = mixtral_mesh_calls()
    rows, bad = [], []
    for label, batch0, iters, warm0, skip in cases:
        for dtype in (torch.float64, torch.float32):
            batch = cast_batch(batch0, dtype)
            warm = None if warm0 is None else type(warm0)(
                *(t.to(dtype) if t.is_floating_point() else t for t in warm0))
            tol = _default_tol_pdhg(dtype)
            m = batch.b.shape[1]
            k5 = pdhg_solve_batch(batch, iters=iters, tol=tol, restart_tol=rt, warm=warm,
                                  skip=skip)
            for S in MESH_SHARDS:
                mesh = virtual_mesh(S)
                reps: list = []
                kernels.reset_launch_counts()
                k = sharded_pdhg(batch, mesh, iters, tol, rt, warm=warm, skip=skip,
                                 replicas=reps)
                torch.cuda.synchronize()
                n_launch = kernels.LAUNCHES["pdhg_sharded_elem"]
                n_coll = kernels.LAUNCHES["collective"]
                same = all(same_bits(a, reps[0]) for a in reps)
                routes = routes_agree(
                    "pdhg_sharded_elem",
                    lambda mesh=mesh, tol=tol, warm=warm, **kw: sharded_pdhg(
                        batch, mesh, iters, tol, rt, warm=warm, skip=skip, **kw), k)
                run_s = (lambda sub, st, sw=None, mesh=mesh, tol=tol:  # noqa: E731
                         sharded_pdhg(sub, mesh, st, tol, rt, warm=sw))
                run_5 = (lambda sub, st, sw=None, tol=tol:  # noqa: E731
                         pdhg_solve_batch(sub, iters=st, tol=tol, restart_tol=rt, warm=sw))
                (kb, ko), (rb, ro), rerun = at_equal_steps(batch, k, k5, run_s, run_5, warm)
                vs_k5 = {"bound": max_err(kb, rb)[1], "obj": max_err(ko, ro)[1]}
                line = {"batch": label, "S": S, "dtype": str(dtype).split(".")[-1],
                        "B": int(batch.b.shape[0]), "m": m, "n": int(batch.c.shape[1]),
                        "nnz": batch.A.sparsity.nnz, "iters": iters,
                        "iters_run": k.iters_run.tolist(),
                        "iters_run_k5": k5.iters_run.tolist(),
                        "converged": k.converged.tolist(),
                        "max_rel_vs_unsharded_k5": vs_k5, "rerun_at_equal_steps": rerun,
                        "replicas_bit_equal": same, "launches": n_launch,
                        "collective_launches": n_coll,
                        "launches_per_step": (n_launch + n_coll) / max(
                            1, int(k.iters_run.max())), **routes}
                if dtype == torch.float64 or S == 4:

                    def plain(sub, st, sw=None, S=S, tol=tol, m=m, sk=None):
                        A_b, b_b, wv, wy_b, wok = shard_rows(sub, S, sw)
                        out = sharded_pdhg_reference(A_b, b_b, sub.c, sub.l, sub.u, st, tol,
                                                     rt, wv=wv, wy=wy_b, wok=wok, skip=sk)
                        return out._replace(y_dual=out.y_dual[:, :m])

                    r = plain(batch, iters, warm, sk=skip)
                    torch.cuda.synchronize()
                    errs = {f: max_err(getattr(k, f), getattr(r, f))
                            for f in ("v", "bound", "obj", "y_dual", "reduced")}
                    (kb2, _), (rb2, _), rerun2 = at_equal_steps(batch, k, r, run_s, plain,
                                                                warm)
                    line["max_rel_vs_sharded_plain"] = {f: e[1] for f, e in errs.items()}
                    line["max_abs_bound_vs_sharded_plain"] = max_err(kb2, rb2)[0]
                    line["iters_run_plain"] = r.iters_run.tolist()
                    line["plain_rerun_at_equal_steps"] = rerun2
                    if dtype == torch.float64:
                        line["plain_ok"] = not rerun2 and all(
                            e[1] <= TOL_PDHG_F64 for e in errs.values())
                    else:
                        line["plain_ok"] = max_err(kb2, rb2)[1] <= TOL_PDHG_F32_CERT
                tol_k5 = TOL_PDHG_SHARDED_F64 if dtype == torch.float64 else TOL_PDHG_F32_CERT
                held = vs_k5["bound"] <= tol_k5 and (
                    dtype != torch.float64 or vs_k5["obj"] <= tol_k5)
                line["ok"] = bool(held and same and line.get("plain_ok", True)
                                  and fused_route_ok(line, n_launch, n_coll, line["B"]))
                print("pdhg_sharded_elem", json.dumps(line), flush=True)
                rows.append(line)
                if not line["ok"]:
                    bad.append((label, S, line["dtype"]))
    if bad:
        fail(f"pdhg_sharded_elem disagrees with K5's per-element entry, its plain version, "
             f"the sequenced route, across shards or traced in (batch, S, dtype) {bad}")

    # Time at the main path's shape: the root round in float32 (the solve's
    # iterate dtype), S=2 and 4, both routes, beside the unsharded K5
    # per-element launch on the same rows and two batched library products
    # a step.
    _, batch, iters, warm, skip = cases[0]
    B, n = batch.c.shape
    m = batch.b.shape[1]
    sp = batch.A.sparsity
    tol = _default_tol_pdhg(torch.float32)
    A3 = batch.A.dense()
    X = torch.rand(B, n, 1, device="cuda")
    Y = torch.rand(B, m, 1, device="cuda")
    mm = cuda_ms(lambda: (torch.bmm(A3, X), torch.bmm(A3.transpose(1, 2), Y)))
    timing = {}
    for S in MESH_SHARDS:
        mesh = virtual_mesh(S)
        run = lambda **kw: sharded_pdhg(batch, mesh, iters, tol, rt, warm=warm,  # noqa: E731
                                        skip=skip, **kw)
        blocks, _, _, _, _ = shard_rows(batch, S)
        a_bytes = sum(elem_a_bytes(b.sparsity, B, 4) for b in blocks)
        timing[S] = k6b_timing("pdhg_sharded_elem", run, S, sharded_flops_bytes(
            m, n, sp.nnz, B, S, run().iters_run.tolist(), PDHG_DEFAULT_CHUNK, 4,
            warm=warm is not None, a_bytes=a_bytes))
        timing[S].update(library_ms=mm * timing[S]["steps"], bmm_step_ms=mm)
        print(f"pdhg_sharded_elem Mixtral M=4 root S={S} float32: {json.dumps(timing[S])}",
              flush=True)
    k5 = cuda_ms(lambda: pdhg_solve_batch(batch, iters=iters, tol=tol, restart_tol=rt,
                                          warm=warm, skip=skip), reps=5, warmup=1)
    A_b, b_b, wv, wy_b, wok = shard_rows(batch, 4, warm)
    plain = cuda_ms(lambda: sharded_pdhg_reference(A_b, b_b, batch.c, batch.l, batch.u,
                                                   iters, tol, rt, wv=wv, wy=wy_b, wok=wok,
                                                   skip=skip), reps=1, warmup=0)
    t4 = timing[4]
    print(f"pdhg_sharded_elem root: unsharded K5 per-element {k5:.3f} ms, bmm pair "
          f"{mm:.4f} ms x {t4['steps']} steps, sharded plain S=4 {plain:.1f} ms", flush=True)
    report["pdhg_sharded_elem"] = dict(
        name="pdhg_sharded_elem", route="cuda",
        source="distilp_torch/kernels/csrc/pdhg_sharded_kernel.cu",
        replaces="distilp_tpu/ops/meshlp.py:155",
        max_abs_err=max(r_["max_abs_bound_vs_sharded_plain"] for r_ in rows
                        if "max_abs_bound_vs_sharded_plain" in r_),
        max_rel_vs_unsharded_k5=max(r_["max_rel_vs_unsharded_k5"]["bound"] for r_ in rows),
        ms=t4["ms"], plain_ms=plain, bound_ms=t4["bound_ms"], bound_by=t4["bound_by"],
        library_ms=t4["library_ms"],
        library="two torch.bmm a step on the dense (B, m, n) A x steps",
        library_bmm_step_ms=mm, k5_elem_ms=k5,
        held_against_plain="ok", device_busy_ms=t4["device_busy_ms"], steps=t4["steps"],
        launches_per_call=t4["launches_per_call"], sequenced_ms=t4["sequenced_ms"],
        shapes_timed=f"Mixtral M=4 root round B={B} m={m} n={n} nnz={sp.nnz}, float32, "
                     f"S=4, {iters} steps budget, fused route",
        s2=timing[2],
    )


MESH_SWEEP_GAP = 1e-4  # the north star through the node-sharded sweep (pin at 1e-4)
# MoE on the row mesh (B6c), pins from the JAX package on the CPU
# (distilp_tpu.solver.halda_solve(make_synthetic_fleet(M, seed=7,
# pool_bytes=64e9), Mixtral 8x7B, kv_bits="8bit", backend="jax",
# lp_backend="pdhg", mesh_shards=S) on a forced 4-device host mesh):
# (name, M, gap, S, (k, objective), w or None).
MIXTRAL_MESH_CASES = [
    ("mixtral_M4", 4, 1e-3, 2, (4, -132.93320566181376), [1, 5, 1, 1]),
    ("mixtral_M4", 4, 1e-3, 4, (4, -132.93320566181376), [1, 5, 1, 1]),
    ("mixtral_M16", 16, 1e-4, 2, (2, -405.8689785429697), [1] * 16),
]
# The JAX package's StreamingReplanner(mip_gap=1e-3, kv_bits="8bit",
# backend="jax", search={"lp_backend": "pdhg", "mesh_shards": 2}) on Mixtral
# M=4 (the fleet above), a cold tick and three ticks of +-5% t_comm drift
# (numpy default_rng(7), drift() below): (objective, tick mode), each k=4.
MIXTRAL_MESH_TICK_PINS = [(-132.93320566181376, "cold"), (-132.8993793850156, "margin"),
                          (-132.92550041503156, "margin"), (-132.94391814495046, "margin")]


def moe_mesh_solves() -> None:
    """MoE nodes on the row mesh (K6b's per-element entry, B6c), counted as
    the ``mesh`` path's own work: Mixtral M=4 at S=2 and S=4, M=16 at S=2,
    M=4's per-k optima, its async solve with the convergence telemetry and
    its streaming replanner at S=2, each held to the JAX package's pin,
    each wall with its launches by shape."""
    import numpy as np

    from distilp_torch import kernels
    from distilp_torch.solver import (
        StreamingReplanner,
        halda_solve,
        halda_solve_async,
        halda_solve_per_k,
    )
    from distilp_torch.utils import make_synthetic_fleet

    name, config, M, seed, pool, _ = MOE_CASES[0]
    model = moe_model(config)

    def counted(label, fn):
        before = dict(kernels.LAUNCHES)
        shapes = dict(kernels.SHAPES["pdhg_sharded_elem"])
        out, ms = timed(fn)
        delta = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
        by_shape = {sh: c - shapes.get(sh, 0)
                    for sh, c in kernels.SHAPES["pdhg_sharded_elem"].items()
                    if c != shapes.get(sh, 0)}
        print(f"  {label}: wall_ms={ms:.2f} launches {json.dumps(delta)} "
              f"pdhg_sharded_elem by shape {json.dumps(by_shape)}", flush=True)
        if not delta.get("pdhg_sharded_elem"):
            fail(f"{label} never launched pdhg_sharded_elem")
        return out, ms

    for case, Mx, gap, S, (k_pin, pin), w_pin in MIXTRAL_MESH_CASES:
        devs = make_synthetic_fleet(Mx, seed=seed, pool_bytes=int(pool))
        tm: dict = {}
        r, ms = counted(f"{case} mesh_shards={S}", lambda: halda_solve(
            devs, model, mip_gap=gap, kv_bits="8bit", lp_backend="pdhg", mesh_shards=S,
            timings=tm))
        show(f"{case}_S{S}", r, ms, tm)
        held_to(f"{case} mesh_shards={S}", r, pin, gap, k=k_pin)
        if r.w != w_pin or tm.get("mesh_shards") != S or sum(r.y) != model.n_routed_experts:
            fail(f"{case} at S={S}: w={r.w} shards {tm.get('mesh_shards')} sum(y)={sum(r.y)}")

    devs = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool))
    rs, ms = counted("mixtral_M4 per-k mesh_shards=2", lambda: halda_solve_per_k(
        devs, model, mip_gap=MOE_GAP, kv_bits="8bit", lp_backend="pdhg", mesh_shards=2))
    got = {r.k: r for r in rs}
    if sorted(got) != sorted(MIXTRAL_PER_K):
        fail(f"per-k mixtral_M4 at S=2: k's {sorted(got)}, pinned {sorted(MIXTRAL_PER_K)}")
    for k, pin in sorted(MIXTRAL_PER_K.items()):
        rel = abs(got[k].obj_value - pin) / abs(pin)
        print(f"  mixtral_M4 per-k S=2 k={k}: objective {got[k].obj_value!r} vs {pin!r}: "
              f"relative difference {rel!r} (allowed {2 * MOE_GAP!r}) "
              f"certified={got[k].certified}", flush=True)
        if rel > 2 * MOE_GAP or not got[k].certified:
            fail(f"per-k mixtral_M4 at S=2 k={k}: {got[k].obj_value} vs {pin}")

    conv: dict = {}
    tm: dict = {}
    r, _ = counted("mixtral_M4 async mesh_shards=2 with convergence", lambda: halda_solve_async(
        devs, model, mip_gap=MOE_GAP, kv_bits="8bit", lp_backend="pdhg", mesh_shards=2,
        timings=tm, convergence=conv).collect())
    held_to("mixtral_M4 async mesh_shards=2", r, MIXTRAL_MESH_CASES[0][4][1], MOE_GAP, k=4)
    print(f"  convergence: {len(conv.get('round_log', []))} rounds logged of "
          f"{tm.get('bnb_rounds')}, root trace rows {len(conv.get('root_trace') or [])}",
          flush=True)
    if len(conv.get("round_log", [])) != int(tm.get("bnb_rounds", -1)) or \
            not conv.get("root_trace"):
        fail(f"mixtral_M4 async at S=2: convergence {sorted(conv)} timings {tm}")

    planner = StreamingReplanner(mip_gap=MOE_GAP, kv_bits="8bit",
                                 search={"lp_backend": "pdhg", "mesh_shards": 2})
    rng = np.random.default_rng(7)
    for t, (pin, mode) in enumerate(MIXTRAL_MESH_TICK_PINS):
        if t:
            drift(devs, rng)
        r, _ = counted(f"mixtral_M4 tick {t} mesh_shards=2", lambda: planner.step(devs, model))
        held_to(f"mixtral_M4 tick {t} ({planner.last_tick_mode}) mesh_shards=2", r, pin,
                MOE_GAP, k=4)
        if planner.last_tick_mode != mode:
            fail(f"mixtral_M4 tick {t} at S=2: mode {planner.last_tick_mode}, JAX {mode}")


def mesh_path() -> dict:
    """The multi-device engine on a virtual mesh of this card: the 128-device
    fleet with ``mesh_shards=4`` (median of 3; ``mesh_shards=1`` equal to the
    default solve bit for bit), the 512-device fleet at S=4, the online
    golden at S=4, MoE nodes on the row mesh (``moe_mesh_solves``), the
    north star and Mixtral M=8 through the node-sharded sweep on 8 shards
    (the north star's placement equal to the unsharded sweep's at the padded
    capacity and beam), ``solver --mesh-shards 4`` and ``--mesh-shards 2``
    on the Mixtral profile, and ``measure_interconnect`` over 4 shards."""
    import statistics

    from distilp_torch import kernels
    from distilp_torch.parallel import force_virtual_devices, make_mesh, solve_sweep_sharded
    from distilp_torch.profiler.topology import measure_interconnect
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.backend_torch import solve_sweep_torch
    from distilp_torch.solver.search import best_bound
    from distilp_torch.utils import make_synthetic_fleet

    force_virtual_devices(8)
    kernels.reset_launch_counts()
    t_path = time.perf_counter()
    model128, devs128 = online_model(128), make_synthetic_fleet(128, seed=123)
    walls = []
    for _ in range(3):
        r4, ms, tm = solve(devs128, model128, FLEET128_GAP, mesh_shards=4)
        walls.append(ms)
    show("fleet_M128_S4", r4, statistics.median(walls), tm)
    held_to("fleet_M128 mesh_shards=4", r4, FLEET128_PDHG[1], FLEET128_GAP, k=FLEET128_PDHG[0])
    if tm.get("mesh_shards") != 4 or tm.get("lp_backend") != "pdhg":
        fail(f"fleet_M128 S=4 echoed {tm.get('mesh_shards')} on {tm.get('lp_backend')}")
    r1, ms1, _ = solve(devs128, model128, FLEET128_GAP, mesh_shards=1)
    with uncounted():
        r0, ms0, _ = solve(devs128, model128, FLEET128_GAP)
    same1 = (r1.k, r1.w, r1.n, r1.obj_value) == (r0.k, r0.w, r0.n, r0.obj_value)
    print(f"  fleet_M128 mesh_shards=1 {r1.obj_value!r} vs default {r0.obj_value!r}: "
          f"bit-identical={same1} (walls {ms1:.2f} / {ms0:.2f} ms; S=4 walls "
          f"{[round(w, 2) for w in walls]})", flush=True)
    if not same1:
        fail("mesh_shards=1 is not bit-identical to the default solve")
    model512, devs512 = online_model(512), make_synthetic_fleet(512, seed=123)
    r5, ms, tm = solve(devs512, model512, FLEET512_GAP, mesh_shards=4)
    show("fleet_M512_S4", r5, ms, tm)
    held_to("fleet_M512 mesh_shards=4", r5, FLEET512_PDHG[1], FLEET512_GAP, k=FLEET512_PDHG[0])
    from distilp_torch.common import load_from_profile_folder

    devs_o, model_o = load_from_profile_folder(ROOT / "tests" / "profiles" / "llama_3_70b" /
                                               "online")
    ro, ms, tm = solve(devs_o, model_o, 1e-4, lp_backend="pdhg", mesh_shards=4)
    show("online_S4", ro, ms, tm)
    held_to("online golden mesh_shards=4", ro, 1.934942, 1e-4, k=2)
    if ro.w != [13, 27]:
        fail(f"online golden at S=4: w={ro.w}")
    moe_mesh_solves()

    mesh8 = make_mesh(8)
    print(f"node mesh: {len(mesh8.devices)} shards on {sorted({str(d) for d in mesh8.devices})}"
          f" virtual={mesh8.virtual}", flush=True)
    devs, model, coeffs, arrays, feasible, sf, _ = load_instance(16, 123)
    (state, _), ms = timed(lambda: solve_sweep_sharded(arrays, feasible, coeffs, mesh8,
                                                       mip_gap=MESH_SWEEP_GAP))
    inc, bd = float(state.incumbent[0]), float(best_bound(state)[0])
    kidx = int(state.inc_kidx[0])
    w = [int(round(float(x))) for x in state.inc_w[0]]
    nn = [int(round(float(x))) for x in state.inc_n[0]]
    cap, beam = state.node_lo.shape[1], None
    with uncounted(), launch_bounds({}) as lb:
        solve_sweep_sharded(arrays, feasible, coeffs, mesh8, mip_gap=MESH_SWEEP_GAP)
    print(f"sweep north_star_M16 on 8 shards: incumbent {inc!r} bound {bd!r} k={sf.ks[kidx]} "
          f"cap={cap} wall_ms={ms:.2f}; bound of its launches {sum(lb.values())!r} ms "
          f"{json.dumps(lb)}", flush=True)
    if not (inc - bd <= MESH_SWEEP_GAP * abs(inc) + 1e-12) or \
            abs(inc - NORTH_STAR_OBJ) > 2 * MESH_SWEEP_GAP * abs(NORTH_STAR_OBJ) or cap % 8:
        fail(f"sharded sweep north star: {inc} bound {bd} cap {cap}")
    with uncounted():
        from distilp_torch.parallel import pad_cap_to_mesh
        from distilp_torch.solver.standard_form import default_search_params

        d_beam = default_search_params(False, len(sf.ks))[1]
        beam = min(pad_cap_to_mesh(d_beam, mesh8), cap)
        _, best = solve_sweep_torch(arrays, feasible, mip_gap=MESH_SWEEP_GAP, coeffs=coeffs,
                                    node_cap=cap, beam=beam)
    same = (best.k, best.w, best.n) == (int(sf.ks[kidx]), w, nn)
    print(f"  unsharded sweep at cap={cap} beam={beam}: k={best.k} obj={best.obj_value!r} "
          f"same (k, w, n)={same}", flush=True)
    if not same:
        fail(f"sharded sweep placement {(sf.ks[kidx], w, nn)} vs unsharded "
             f"{(best.k, best.w, best.n)}")
    name, config, M, seed, pool, (k_pin, pin) = MOE_CASES[1]
    model_m = moe_model(config)
    devs_m = make_synthetic_fleet(M, seed=seed, pool_bytes=int(pool))
    Ks, _, coeffs_m, arrays_m = _build_instance(devs_m, model_m, None, "8bit", None, None)
    kWs_m = [(k, model_m.L // k) for k in Ks]
    (state, sf_m), ms = timed(lambda: solve_sweep_sharded(arrays_m, kWs_m, coeffs_m, mesh8,
                                                          mip_gap=MOE_GAP))
    inc, bd = float(state.incumbent[0]), float(best_bound(state)[0])
    ysum = int(round(float(state.inc_y[0].sum())))
    with uncounted(), launch_bounds({}) as lb:
        solve_sweep_sharded(arrays_m, kWs_m, coeffs_m, mesh8, mip_gap=MOE_GAP)
    print(f"sweep {name} on 8 shards: incumbent {inc!r} (pin {pin!r}) bound {bd!r} "
          f"sum(y)={ysum} wall_ms={ms:.2f}; bound of its launches {sum(lb.values())!r} ms "
          f"{json.dumps(lb)}", flush=True)
    if not (inc - bd <= MOE_GAP * abs(inc) + 1e-12) or abs(inc - pin) > 2 * MOE_GAP * abs(pin) \
            or ysum != model_m.n_routed_experts:
        fail(f"sharded sweep {name}: {inc} bound {bd} sum(y) {ysum}")

    child: dict = {}
    rc, stdout, err, wall = run_cli("distilp_torch.cli.solver_cli", [
        "-p", "tests/profiles/llama_3_70b/online", "--lp-backend", "pdhg",
        "--mesh-shards", "4"], child)
    print(stdout[-800:], flush=True)
    if rc != 0 or "Optimality: certified" not in stdout:
        fail(f"solver --mesh-shards 4 exited {rc}:\n{err[-2000:]}")
    moe_child: dict = {}
    rc, stdout, err, wall = run_cli("distilp_torch.cli.solver_cli", [
        "-p", "tests/profiles/mixtral_8x7b", "--kv-bits", "8bit", "--lp-backend", "pdhg",
        "--mesh-shards", "2"], moe_child)
    print(stdout[-400:], flush=True)
    print(f"  solver --mesh-shards 2 mixtral_8x7b: {wall:.1f} s, launches "
          f"{json.dumps({k: v for k, v in moe_child.items() if v and k != '_shapes'})} "
          f"by shape {json.dumps(moe_child.get('_shapes', {}).get('pdhg_sharded_elem', {}))}",
          flush=True)
    # The JAX CLI prints k 4 and -82.677178 on this profile (tests/test_torch_cli.py).
    if rc != 0 or "Optimality: certified" not in stdout or "Optimal k: 4" not in stdout \
            or "Objective value: -82.677178" not in stdout:
        fail(f"solver --mesh-shards 2 on mixtral_8x7b exited {rc}:\n{err[-2000:]}")
    for k, v in moe_child.items():
        if k == "_shapes":
            merge_shapes(child.setdefault("_shapes", {}), v)
        else:
            child[k] = child.get(k, 0) + v
    info = measure_interconnect(devices=virtual_mesh(4))
    # Its bound: 11 psums of a (1, 8) float32 row a shard, one launch per
    # receiving shard (S parts read, one result written, S - 1 additions a
    # value), and the all_gather of 32 MiB of float32 a shard (each block
    # read once, every shard's S blocks written once).
    S, per = 4, 32 * 1024 * 1024
    psum_ms = 11 * S * bound_ms((S - 1) * 8, (S + 1) * 8 * 4, PEAK_F32_S)[0]
    gather_ms = bound_ms(0, S * per + S * S * per, PEAK_F32_S)[0]
    # Its PyTorch yardsticks at the probe's shapes: one torch call for a
    # psum of S (1, 8) float32 parts, and torch.cat of S 32 MiB blocks (the
    # all_gather's result on one shard).
    import torch

    parts = [torch.rand((1, 8), device="cuda") for _ in range(S)]
    blocks = [torch.rand(per // 4, device="cuda") for _ in range(S)]
    lib_psum = cuda_ms(lambda: torch.stack(parts).sum(0))
    lib_gather = cuda_ms(lambda: torch.cat(blocks), reps=10)
    del blocks
    print(f"interconnect over 4 virtual shards of {smi_line()}: provenance={info.provenance} "
          f"allreduce latency {info.ici_allreduce_latency_s!r} s, all_gather "
          f"{info.ici_bandwidth!r} B/s (the card's own memory: no link); bound of its "
          f"44 collective launches {psum_ms!r} ms, of the all_gather {gather_ms!r} ms; "
          f"torch.stack(parts).sum(0) of {S} (1, 8) parts {lib_psum!r} ms, torch.cat of "
          f"{S} 32 MiB blocks {lib_gather!r} ms", flush=True)
    if info.provenance != "virtual" or not (info.ici_allreduce_latency_s > 0
                                            and info.ici_bandwidth > 0):
        fail(f"measure_interconnect over the virtual mesh: {info}")
    launches = path_launches(child)
    print("mesh path launches", json.dumps(launches), flush=True)
    by_route = {name: {r: sum(c for sh, c in launches["_shapes"].get(name, {}).items()
                              if sh.endswith("route=" + r)) for r in ("fused", "sequenced")}
                for name in ("pdhg_sharded", "pdhg_sharded_elem")}
    print("mesh path K6b launches by route", json.dumps(by_route), flush=True)
    # Every search on a mesh of this card is one graph launch (R3c), the
    # logged ones too (R3d).
    routes = launches["_shapes"].get("bnb_graph", {})
    off = {k: v for k, v in routes.items() if k.startswith("route=host")}
    print(f"mesh path routes {json.dumps(routes)}", flush=True)
    print(f"mesh path: {time.perf_counter() - t_path:.1f} s", flush=True)
    if off:
        fail(f"a search on a mesh of one card took the host loop: {off}")
    if any(v["sequenced"] for v in by_route.values()):
        fail(f"the mesh path ran K6b's sequenced route on one card: {by_route}")
    missing = [k for k in MESH_KERNELS if launches[k] == 0]
    if missing:
        fail(f"mesh path never launched {missing}")
    return launches


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
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    t = time.perf_counter()
    cases = twin_cases()
    print(f"twin instances placed in {time.perf_counter() - t:.1f} s", flush=True)
    checks = [check_ipm, check_round, check_epilogue, check_pdhg, check_pdhg_routes,
              lambda r: check_pdhg_mp(), check_ipm_moe, check_round_moe, check_decomp,
              lambda r: check_twin_mc(r, cases), check_hbm_stream, check_gemm_absmax_scale,
              check_bnb_per_k, check_price_fixed, check_round_lanes, check_round_moe_lanes,
              check_epilogue_lanes, check_per_k_lanes, check_decomp_lanes, check_traces,
              check_collective, check_pdhg_sharded, check_pdhg_sharded_elem, check_round_tail,
              check_bnb_loop, check_bnb_loop_moe, check_bnb_loop_pdhg, check_bnb_loop_mesh]
    names = ["ipm", "round", "epilogue", "pdhg", "pdhg_routes", "pdhg_mp", "ipm_moe", "round_moe",
             "decomp", "twin_mc", "hbm_stream", "gemm_absmax_scale", "bnb_per_k",
             "price_fixed", "round_lanes", "round_moe_lanes", "epilogue_lanes",
             "per_k_lanes", "decomp_lanes", "traces", "collective", "pdhg_sharded",
             "pdhg_sharded_elem", "round_tail", "bnb_loop", "bnb_loop_moe", "bnb_loop_pdhg",
             "bnb_loop_mesh"]
    for name, check in zip(names, checks):
        kernels.reset_launch_counts()
        t = time.perf_counter()
        check(report)
        print(f"check {name}: {time.perf_counter() - t:.1f} s, launches "
              f"{json.dumps({k: v for k, v in kernels.LAUNCHES.items() if v})}", flush=True)

    k7 = []
    with k7_calls(k7):
        paths = {"dense": main_path(), "fleet": fleet_path(), "moe": moe_path(),
                 "profile": profile_path(cases), "sweep": sweep_path(),
                 "stream": stream_path()}
        paths["elem"], elem_calls = elem_path()
        paths["diagnose"] = diagnose_path()
        paths["mesh"] = mesh_path()
        paths["packed"] = packed_path(report)
        paths["serve"] = serve_path()
        paths["gateway"] = gateway_path()
        paths["traffic"] = traffic_path()
    # K7 on the main paths: at most two launches a root bound (the fused
    # ascent and the float64 evaluation), none of the per-step entry.
    per_call = {}
    for steps, S, n in k7:
        key = f"steps={steps} S={S} launches={n}"
        per_call[key] = per_call.get(key, 0) + 1
    print("main path decomp_bound_roots calls", json.dumps(per_call), flush=True)
    over = sorted({c for c in k7 if c[2] > 2})
    if over:
        fail(f"decomp_bound_roots calls with more than two K7 launches: {over}")
    stepwise = {f"{p} {k}": c["_shapes"].get(k, {}).get("eval32", 0)
                for p, c in paths.items() for k in ("decomp", "decomp_lanes")}
    if any(stepwise.values()) or not any(steps > 0 for steps, _, _ in k7):
        fail(f"the main paths launched K7's per-step entry or never ascended: {stepwise}")
    kernels.reset_launch_counts()
    t = time.perf_counter()
    with uncounted():
        check_pdhg_elem(report, elem_calls)
    print(f"check pdhg_elem: {time.perf_counter() - t:.1f} s", flush=True)
    launches = {k: sum(p[k] for p in paths.values()) for k in report}
    print("main path launches", json.dumps(launches), flush=True)
    by_shape = {k: {p: c["_shapes"].get(k, {}) for p, c in paths.items()}
                for k in ("ipm", "pdhg", "pdhg_elem", "ipm_trace", "pdhg_trace",
                          "pdhg_sharded", "pdhg_sharded_elem", "decomp", "decomp_lanes",
                          "gemm_absmax_scale", "bnb_graph")}
    print("main path launches by shape", json.dumps(by_shape), flush=True)
    # MoE sweeps on the IPM engine take the loop's graph on every path that
    # solves one (the host loop only where a comparison asks for it).
    for p in ("moe", "sweep", "stream", "serve"):
        routes = by_shape["bnb_graph"][p]
        moe_routes = {k: v for k, v in routes.items() if "moe" in k}
        print(f"{p} path MoE routes {json.dumps(moe_routes)}", flush=True)
        if not any(k.startswith("route=graph moe_ipm") for k in moe_routes) or any(
                k.startswith("route=host moe") for k in moe_routes):
            fail(f"the {p} path's MoE solves did not take the graph route: {moe_routes}")
    # PDHG sweeps take the loop's graph too: on these paths no search keeps
    # the host loop but those inside captured(...), which asks for it
    # (route=host host_loop_asked); the fleet path's solves are on the
    # PDHG's graph.
    for p in ("fleet", "profile", "sweep", "stream", "elem"):
        routes = by_shape["bnb_graph"][p]
        pdhg_routes = {k: v for k, v in routes.items() if "pdhg" in k}
        off = {k: v for k, v in routes.items()
               if k.startswith("route=host") and "host_loop_asked" not in k}
        print(f"{p} path PDHG routes {json.dumps(pdhg_routes)}; host loop {json.dumps(off)}",
              flush=True)
        if off:
            fail(f"the {p} path's searches left the graph route: {off}")
    if not any(k.startswith("route=graph dense_pdhg") for k in by_shape["bnb_graph"]["fleet"]):
        fail("the fleet path's PDHG solves did not take the graph route")
    # K3's entry and B15's run only inside the round tail's plain version:
    # every round, per-k or not, is one round tail after its LP call.
    folded = {k: launches[k] for k in FOLDED_INTO_TAIL if launches[k]}
    if folded:
        fail(f"the main paths launched kernels the round tail folds: {folded}")
    missing = [k for k, v in launches.items()
               if v == 0 and k not in FOLDED_INTO_TAIL + FOLDED_INTO_GRAPH]
    if missing:
        fail(f"main path never launched {missing}")
    # Every K5 element on the main paths fits a cluster: no launch of theirs
    # may take the grid route.
    k5_grid = [(k, p, shape) for k in ("pdhg", "pdhg_elem", "pdhg_trace")
               for p, shapes in by_shape[k].items() for shape in shapes
               if "route=cluster" not in shape]
    if k5_grid:
        fail(f"K5 launches of the main paths off the cluster route: {k5_grid}")
    out = []
    for name in ("ipm", "round_incumbent", "round_moe", "bnb_epilogue", "pdhg", "decomp",
                 "twin_mc", "hbm_stream", "gemm_absmax_scale", "bnb_per_k", "price_fixed",
                 "round_incumbent_lanes", "round_moe_lanes", "bnb_epilogue_lanes",
                 "bnb_per_k_lanes", "decomp_lanes", "pdhg_elem", "ipm_trace", "pdhg_trace",
                 "pdhg_sharded", "pdhg_sharded_elem", "collective", "round_tail",
                 "round_tail_lanes", "bnb_seed", "bnb_head", "bnb_control", "bnb_answer",
                 "decomp_theta", "decomp_bound", "bnb_cast", "bnb_gather"):
        row = dict(report[name])
        row["launches"] = launches[name]
        row["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        if name in by_shape:
            row["launches_by_shape"] = by_shape[name]
        out.append(row)
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
