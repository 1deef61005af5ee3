"""What the process-wide graph lock costs the gateway on the card.

``solver/device_loop.py`` gives a plan's capture, instantiation, launch and
answer read one turn at a time across threads (``_GRAPH_LOCK``). This script
runs ``gateway.run_loadgen`` at 2 thread workers on two fleet shapes (10
fleets of 3 devices, k in {8, 10}; 8 fleets of 16 devices, every k; gap
1e-3, 10 measured events a fleet) in arms lock, free, free, lock, twice;
the first locked arm captures every plan, so no unlocked arm instantiates a
graph (two threads doing so at once is what the lock prevents). Prints the
card's name and power limit, then one JSON line an arm: events/s, p50/p99
event wall, wall, captures, failed ticks.

Run on a host with one CUDA card, from the repository root:

    python3 chip_graph_lock.py

Exits non-zero without a card.
"""

import contextlib
import faulthandler
import json
import sys
import time

import chip_smoke


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script measures the port on a GPU")
    from distilp_torch.gateway import run_loadgen
    from distilp_torch.kernels import build
    from distilp_torch.solver import device_loop

    faulthandler.dump_traceback_later(600, exit=True, file=sys.stderr)
    print("gpu:", chip_smoke.smi_line(), flush=True)
    t = time.perf_counter()
    build.load_all()
    print(f"built in {time.perf_counter() - t:.1f} s", flush=True)
    model = chip_smoke.online_model()
    lock = device_loop._GRAPH_LOCK
    cases = {"10x3": dict(n_fleets=10, fleet_size=3, k_candidates=[8, 10]),
             "8x16": dict(n_fleets=8, fleet_size=16, k_candidates=None)}
    try:
        for rep in range(2):
            for arm in ("lock", "free", "free", "lock"):
                device_loop._GRAPH_LOCK = lock if arm == "lock" else contextlib.nullcontext()
                for name, kw in cases.items():
                    caps = sum(device_loop.CAPTURES.values())
                    r = run_loadgen(model, n_workers=2, events_per_fleet=10, mip_gap=1e-3, **kw)
                    line = {"rep": rep, "arm": arm, "case": name,
                            "events_per_sec": r["events_per_sec"], "p50_ms": r["p50_ms"],
                            "p99_ms": r["p99_ms"], "wall_s": r["wall_s"],
                            "captures": sum(device_loop.CAPTURES.values()) - caps,
                            "tick_failed": r["tick_failed"]}
                    print("lock_cost", json.dumps(line), flush=True)
                    if r["tick_failed"] or (arm == "free" and line["captures"]):
                        chip_smoke.fail(f"lock_cost: {line}")
    finally:
        device_loop._GRAPH_LOCK = lock
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
