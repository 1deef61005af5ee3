#!/usr/bin/env python3
"""Measure a branch-and-bound round's tail on one GPU, to compare two
checkouts of the repository on the same card.

    python3 chip_round_tail.py [--root DIR] [--label NAME] [--reps N]

imports ``distilp_torch`` from DIR (default: the folder of this script),
builds its kernels, and measures, with the card's name and power limit:

- rounds as the search hands them over (captured from real solves, then
  run again alone with ``search.bnb_round``): the north star's warm round
  (make_synthetic_fleet(16, seed=123), Llama-3-70B online, kv 4bit, gap
  1e-3), the first round of its S=8 scenario batch (t_comm 0.5-2.0x,
  default_rng(17)) and the same with lane 3 frozen, Mixtral 8x7B's second
  round (make_synthetic_fleet(4, seed=7, pool_bytes=64e9), kv 8bit), the
  128-device fleet's root round on the PDHG engine (make_synthetic_fleet(
  128, seed=123), the model stretched to L = 256) and the DeepSeek-V3
  flagship's root round (make_synthetic_fleet(32, seed=11,
  pool_bytes=32e9), kv 8bit; from its unseeded root state, since its solves
  certify with no LP round); per-k rounds (``per_k``): hermes_70b's warm
  round (``halda_solve_per_k``, kv 4bit, gap 1e-4) and the first round of
  the stream path's per-k lanes (``chip_smoke.per_k_lanes``: the mixed-M
  bucket's fleets through ``solve_batch``). For each: the kernel launches of one round
  (the wrappers' counts, and the device kernels and runtime launch calls
  the profiler records), its device time (profiler), the host wall of the
  round minus the host wall of its LP call (median of ``--reps``, the card
  drained before each), and the round's wall to the card's last kernel;
- per-k round tails alone (a tree whose ``search.round_tail`` has a per-k
  mode): the north star's last per-k tail stretched (``chip_smoke.
  stretched_per_k_tail``, default_rng(15)) to 8 lanes of 43 k's, cap 992
  and beam 150, then with a beam of 16, then also with cap 128; each
  tail's device ms (profiler) and call ms (CUDA events);
- the main paths' walls (median of ``--reps``, the card synchronized
  around each, one untimed run first): the north star cold (and its device
  busy share from one profiled solve) and warm after a +-5% t_comm drift
  (default_rng(7)), the S=8 batch, the 128-device fleet, Mixtral M=4 cold,
  and the DeepSeek-V3 flagship (make_synthetic_fleet(32, seed=11,
  pool_bytes=32e9), kv 8bit) warm after the same drift, which re-evaluates
  its bound at the stored duals; the per-k solves: ``halda_solve_per_k`` on
  hermes_70b (gap 1e-4), the north star and Mixtral M=4 (gap 1e-3), and
  the per-k lanes.

Prints the card's line and one JSON line. Run two checkouts on one card
in the order A, B, B, A and compare the same figures.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    warnings.filterwarnings("ignore")

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from distilp_torch import kernels
    from distilp_torch.common import load_model_profile
    from distilp_torch.kernels import build
    from distilp_torch.profiler import profile_model
    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.solver import (
        halda_solve,
        halda_solve_per_k,
        halda_solve_scenarios,
        search,
        solve_batch,
    )
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.backend_torch import device_arrays
    from distilp_torch.solver.rounding import pack_rounding_data, rounding_data
    from distilp_torch.solver.standard_form import build_standard_form, rounding_arrays_np
    from distilp_torch.utils import make_synthetic_fleet, stretch_model_for_fleet

    spec = importlib.util.spec_from_file_location("torch_lanes",
                                                  root / "tests" / "torch_lanes.py")
    lanes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lanes)
    # chip_smoke.py's lane helpers, run on the package imported above.
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  Path(__file__).resolve().parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"gpu: {smi}", flush=True)
    t = time.perf_counter()
    build.load_all()
    print(f"{args.label} ({root}): kernels loaded in {time.perf_counter() - t:.1f} s", flush=True)
    reps = args.reps

    def sync_wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def median_wall(fn):
        fn()
        walls = [sync_wall(fn)[1] for _ in range(reps)]
        return statistics.median(walls), walls

    def is_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    def device_us(e):
        us = getattr(e, "self_device_time_total", None)
        return float(us if us is not None else getattr(e, "self_cuda_time_total", 0.0))

    def profiled(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        kern = [e for e in ev if is_device(e) and "memcpy" not in e.key.lower()
                and "memset" not in e.key.lower()]
        return {"device_kernels": sum(e.count for e in kern),
                "runtime_launches": sum(e.count for e in ev if not is_device(e)
                                        and "launch" in e.key.lower()
                                        and "kernel" in e.key.lower()),
                "device_ms": sum(device_us(e) for e in ev if is_device(e)) / 1e3}

    # ------------------------------------------------------------ rounds
    online = load_model_profile(root / "tests" / "profiles" / "llama_3_70b" / "online" /
                                "model_profile.json")
    mixtral = profile_model(str(root / "tests" / "configs" / "mixtral_8x7b.json"),
                            batch_sizes=[1], sequence_length=128).to_model_profile()
    deepseek = profile_model(str(root / "tests" / "configs" / "deepseek_v3.json"),
                             batch_sizes=[1], sequence_length=128).to_model_profile()
    north = make_synthetic_fleet(16, seed=123)
    rng = np.random.default_rng(17)
    futures = []
    for _ in range(8):
        snap = [d.model_copy(deep=True) for d in north]
        for d in snap:
            d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.5, 2.0)))
        futures.append(snap)
    fleet128, model128 = make_synthetic_fleet(128, seed=123), stretch_model_for_fleet(online, 128)
    mix_devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    flag_devs = make_synthetic_fleet(32, seed=11, pool_bytes=int(32e9))
    hermes = load_from_profile_folder(root / "tests" / "profiles" / "hermes_70b")
    per_k_lanes = smoke.per_k_lanes(online)

    # The loop's round entry: its arguments bound by name, for search.bnb_round.
    entry = "_bnb_round" if hasattr(search, "_bnb_round") else "bnb_round"
    params = inspect.signature(getattr(search, entry))

    def rounds_of(fn):
        calls, orig = [], getattr(search, entry)

        def hook(*a, **kw):
            bound = params.bind(*a, **kw)
            calls.append(dict(bound.arguments))
            return orig(*a, **kw)

        setattr(search, entry, hook)
        try:
            fn()
        finally:
            setattr(search, entry, orig)
        return calls

    cases = {
        "north_star_warm_round": rounds_of(lambda: halda_solve(north, online, mip_gap=1e-3,
                                                               kv_bits="4bit"))[1],
        "scenarios_S8_first_round": rounds_of(lambda: halda_solve_scenarios(
            futures, online, mip_gap=1e-3, kv_bits="4bit"))[0],
        "mixtral_M4_second_round": rounds_of(lambda: halda_solve(
            mix_devs, mixtral, mip_gap=1e-3, kv_bits="8bit"))[1],
        "fleet_M128_pdhg_root_round": rounds_of(lambda: halda_solve(
            fleet128, model128, mip_gap=1e-3, kv_bits="4bit"))[0],
        "hermes_per_k_warm_round": rounds_of(lambda: halda_solve_per_k(
            *hermes, mip_gap=1e-4, kv_bits="4bit"))[1],
        "per_k_lanes_first_round": rounds_of(lambda: solve_batch(per_k_lanes))[0],
    }
    frozen = torch.zeros(len(futures), dtype=torch.bool, device="cuda")
    frozen[3] = True
    cases["scenarios_S8_first_round_lane3_frozen"] = {
        **cases["scenarios_S8_first_round"], "frozen": frozen}
    # The flagship certifies from its root bound with no LP round; its root
    # round is run here from the unseeded root state (K1 with a per-node A,
    # K2's MoE mode, the tail).
    Ks, _, coeffs, arrays = _build_instance(flag_devs, deepseek, None, "8bit", None, None)
    feasible = [(k, deepseek.L // k) for k in Ks if deepseek.L // k >= len(flag_devs)]
    sf = build_standard_form(arrays, coeffs, feasible)
    rd_np = rounding_arrays_np(coeffs, arrays.moe)
    host = {k: torch.as_tensor(v, device="cuda")
            for k, v in device_arrays(sf, rd_np["g_raw"]).items()}
    rd = rounding_data(rd_np, torch.device("cuda"))
    data = lanes.lane_data(search.SweepData(
        A=host["A"], b_k=host["b_k"], c_k=host["c_k"], int_mask=host["int_mask"],
        ks=torch.as_tensor(np.asarray(sf.ks, np.float64), device="cuda"),
        Ws=torch.as_tensor(np.asarray(sf.Ws, np.float64), device="cuda"),
        obj_const=float(sf.obj_const), rd=rd, rd_packed=pack_rounding_data(rd),
        gky=host["gky"]))
    cases["flagship_moe_root_round"] = dict(
        data=data, state=search.root_state(host["lo_k"][None], host["hi_k"][None], sf.M, 256,
                                           host["A"].shape[0]),
        mip_gap=1e-3, beam=len(feasible))
    lp_names = [n for n in ("ipm_solve_batch", "pdhg_solve_batch") if hasattr(search, n)]
    out_rounds = {}
    for name, kw in cases.items():
        kw = {k: v for k, v in kw.items() if k in inspect.signature(search.bnb_round).parameters}
        run = lambda: search.bnb_round(**kw)  # noqa: E731
        run()
        torch.cuda.synchronize()
        before = dict(kernels.LAUNCHES)
        prof = profiled(run)
        wrappers = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
        # Host wall of the round and of its LP call (the LP wrapper timed
        # from entry to return), the card drained before each round.
        lp_ms = []
        orig = {n: getattr(search, n) for n in lp_names}

        def timed_lp(fn):
            def call(*a, **k):
                t0 = time.perf_counter()
                r = fn(*a, **k)
                lp_ms.append((time.perf_counter() - t0) * 1e3)
                return r
            return call

        for n in lp_names:
            setattr(search, n, timed_lp(orig[n]))
        host, tails = [], []
        try:
            for _ in range(reps):
                torch.cuda.synchronize()
                lp_ms.clear()
                t0 = time.perf_counter()
                run()
                h = (time.perf_counter() - t0) * 1e3
                host.append(h)
                tails.append(h - sum(lp_ms))
        finally:
            for n in lp_names:
                setattr(search, n, orig[n])
        wall, walls = median_wall(run)
        out_rounds[name] = {
            "launches": {"wrappers": wrappers, **{k: v for k, v in prof.items()
                                                   if k != "device_ms"}},
            "device_ms": prof["device_ms"], "host_ms": statistics.median(host),
            "host_minus_lp_ms": statistics.median(tails), "host_minus_lp_all": tails,
            "wall_to_last_kernel_ms": wall}
        print(f"{args.label} round {name}: {json.dumps(out_rounds[name])}", flush=True)

    # ------------------------------------------------- per-k tails alone
    out_tails = {}
    if "per_k" in inspect.signature(search.round_tail).parameters:
        calls = []
        orig_tail = search.round_tail

        def capture(*a, **kw):
            calls.append(a)
            return orig_tail(*a, **kw)

        search.round_tail = capture
        try:
            halda_solve_per_k(north, online, mip_gap=1e-3, kv_bits="4bit")
        finally:
            search.round_tail = orig_tail
        rng = np.random.default_rng(15)
        for shape in ((8, 43, 992, 150), (8, 43, 992, 16), (8, 43, 128, 16)):
            tail = smoke.stretched_per_k_tail(calls[-1], rng, *shape)
            ms, call, src = smoke.time_kernel(lambda: search.round_tail(*tail),
                                              "round_tail_kernel")
            name = "per_k_tail_L{}_nk{}_cap{}_beam{}".format(*shape)
            out_tails[name] = {"ms": ms, "call_ms": call, "ms_source": src}
            print(f"{args.label} tail {name}: {json.dumps(out_tails[name])}", flush=True)

    # -------------------------------------------------------- main paths
    drifted = []
    rng = np.random.default_rng(7)
    for d in north:
        c = d.model_copy()
        c.t_comm = max(0.0, c.t_comm * float(rng.uniform(0.95, 1.05)))
        drifted.append(c)
    north_cold = halda_solve(north, online, mip_gap=1e-3, kv_bits="4bit")
    flag_cold = halda_solve(flag_devs, deepseek, mip_gap=1e-3, kv_bits="8bit")
    flag_drift = []
    rng = np.random.default_rng(3)
    for d in flag_devs:
        c = d.model_copy()
        c.t_comm = max(0.0, c.t_comm * float(rng.uniform(0.95, 1.05)))
        flag_drift.append(c)
    solves = {
        "north_star_cold": lambda: halda_solve(north, online, mip_gap=1e-3, kv_bits="4bit"),
        "north_star_warm": lambda: halda_solve(drifted, online, mip_gap=1e-3, kv_bits="4bit",
                                               warm=north_cold),
        "scenarios_S8": lambda: halda_solve_scenarios(futures, online, mip_gap=1e-3,
                                                      kv_bits="4bit", warms=[north_cold] * 8),
        "fleet_M128": lambda: halda_solve(fleet128, model128, mip_gap=1e-3, kv_bits="4bit"),
        "mixtral_M4_cold": lambda: halda_solve(mix_devs, mixtral, mip_gap=1e-3,
                                               kv_bits="8bit"),
        "flagship_warm": lambda: halda_solve(flag_drift, deepseek, mip_gap=1e-3,
                                             kv_bits="8bit", warm=flag_cold),
        "hermes_per_k": lambda: halda_solve_per_k(*hermes, mip_gap=1e-4, kv_bits="4bit"),
        "north_star_per_k": lambda: halda_solve_per_k(north, online, mip_gap=1e-3,
                                                      kv_bits="4bit"),
        "mixtral_M4_per_k": lambda: halda_solve_per_k(mix_devs, mixtral, mip_gap=1e-3,
                                                      kv_bits="8bit"),
        "per_k_lanes": lambda: solve_batch(per_k_lanes),
    }
    out_walls = {}
    for name, fn in solves.items():
        med, walls = median_wall(fn)
        r = fn()
        if name == "per_k_lanes":  # solve_batch: per lane (per-k results, best)
            r = [x for per_k, _ in r for x in per_k if x is not None and x.w is not None]
        if name.endswith("per_k") or name == "per_k_lanes":
            out_walls[name] = {"wall_ms": med, "walls_ms": walls,
                               "objs": {f"{i}:{x.k}": x.obj_value for i, x in enumerate(r)},
                               "certified": all(x.certified for x in r)}
            print(f"{args.label} wall {name}: {json.dumps(out_walls[name])}", flush=True)
            continue
        r0 = r[0] if isinstance(r, list) else r
        out_walls[name] = {"wall_ms": med, "walls_ms": walls, "obj": r0.obj_value,
                           "certified": r0.certified}
        if name == "north_star_cold":
            prof = profiled(fn)
            out_walls[name]["device_busy_ms"] = prof["device_ms"]
            out_walls[name]["device_busy_share"] = prof["device_ms"] / med
        print(f"{args.label} wall {name}: {json.dumps(out_walls[name])}", flush=True)
    print(json.dumps({"label": args.label, "root": str(root), "gpu": smi,
                      "rounds": out_rounds, "tails": out_tails, "walls": out_walls}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
