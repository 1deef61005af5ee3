#!/usr/bin/env python3
"""Time the port's solves on one GPU, to compare two checkouts of the
repository on the same card.

    python3 chip_walls.py [--root DIR] [--label NAME] [--reps N]

imports ``distilp_torch`` from DIR (default: the folder of this script),
builds its kernels, and times ``halda_solve`` on:

- the north star: make_synthetic_fleet(16, seed=123), Llama-3-70B online,
  kv 4bit, gap 1e-3, cold, and warm-started from its own result after a
  +-5% t_comm drift (default_rng(7));
- Mixtral 8x7B over make_synthetic_fleet(4, seed=7, pool_bytes=64e9) and
  the DeepSeek-V3 flagship over make_synthetic_fleet(32, seed=11,
  pool_bytes=32e9), kv 8bit, gap 1e-3, cold;
- the 128-device fleet (make_synthetic_fleet(128, seed=123), the model
  stretched to L = 256) forced onto the IPM engine, kv 4bit, gap 1e-3,
  cold: K1's factor_global route.

Each solve runs once untimed (kernel loads, first launches), then ``--reps``
times; the card is synchronized around each. Prints the card's name and
power limit, then one JSON line: per solve the median and every wall (ms),
the branch-and-bound rounds, the objective, and the median wall per round.
Run two checkouts in one session, in the order A, B, B, A, and compare the
medians of the same solve.
"""

from __future__ import annotations

import argparse
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

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the port on a GPU", file=sys.stderr)
        return 1
    from distilp_torch.common import load_model_profile
    from distilp_torch.kernels import build
    from distilp_torch.profiler import profile_model
    from distilp_torch.solver import halda_solve
    from distilp_torch.utils import make_synthetic_fleet, stretch_model_for_fleet

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"gpu: {smi.strip()}", flush=True)
    t = time.perf_counter()
    build.load_all()
    print(f"{args.label} ({root}): kernels loaded in {time.perf_counter() - t:.1f} s",
          flush=True)

    def moe_model(config):
        return profile_model(str(root / "tests" / "configs" / f"{config}.json"),
                             batch_sizes=[1], sequence_length=128).to_model_profile()

    online = load_model_profile(
        root / "tests" / "profiles" / "llama_3_70b" / "online" / "model_profile.json")
    north = make_synthetic_fleet(16, seed=123)
    drifted = [d.model_copy() for d in north]
    rng = np.random.default_rng(7)
    for d in drifted:
        d.t_comm = max(0.0, d.t_comm * float(rng.uniform(0.95, 1.05)))
    north_cold = halda_solve(north, online, mip_gap=1e-3, kv_bits="4bit")
    cases = {
        "north_star_M16_cold": (north, online, "4bit", None, "auto"),
        "north_star_M16_warm": (drifted, online, "4bit", north_cold, "auto"),
        "mixtral_M4_cold": (make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9)),
                            moe_model("mixtral_8x7b"), "8bit", None, "auto"),
        "deepseek_v3_M32_cold": (make_synthetic_fleet(32, seed=11, pool_bytes=int(32e9)),
                                 moe_model("deepseek_v3"), "8bit", None, "auto"),
        "fleet_M128_ipm_cold": (make_synthetic_fleet(128, seed=123),
                                stretch_model_for_fleet(online, 128), "4bit", None, "ipm"),
    }
    out = {"label": args.label, "root": str(root), "gpu": smi.strip(), "solves": {}}
    for name, (devs, model, kv, warm, engine) in cases.items():
        walls, rounds, obj = [], None, None
        for i in range(args.reps + 1):
            tm = {}
            torch.cuda.synchronize()
            t = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                r = halda_solve(devs, model, mip_gap=1e-3, kv_bits=kv, warm=warm, timings=tm,
                                lp_backend=engine)
            torch.cuda.synchronize()
            if i:
                walls.append((time.perf_counter() - t) * 1e3)
            rounds, obj = tm.get("bnb_rounds"), r.obj_value
        med = statistics.median(walls)
        out["solves"][name] = {"median_ms": med, "walls_ms": walls, "rounds": rounds,
                               "objective": obj,
                               "median_ms_per_round": med / rounds if rounds else None}
        print(f"{args.label} {name}: median {med:.3f} ms over {args.reps}, rounds={rounds} "
              f"obj={obj!r}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
