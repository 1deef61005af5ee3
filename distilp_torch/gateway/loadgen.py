"""Load generator: K synthetic fleets replayed through N solve workers.

The port's copy of ``distilp_tpu/gateway/loadgen.py``; every shard solves
on the card unless the caller asks for the CPU.

The gateway exists to keep many fleets' replanning concurrent; this
module measures exactly that. ``run_loadgen`` builds K deterministic
synthetic fleets (one shard each), generates a seeded drift trace per
fleet, warms every shard (first event = cold solve + graph capture,
excluded from the steady-state numbers), then replays the remaining events with
every fleet's stream concurrent — per-fleet order preserved (shard
serialization), cross-fleet parallelism bounded only by the workers.

Reported: sustained ``events_per_sec`` over the timed phase, p50/p99
event→placement latency (queue wait INCLUDED — it is what a client
sees), per-worker event counts, and failure/certification tallies.

This harness is CLOSED-loop by construction: each fleet's next event
waits for the previous placement, so offered load can never exceed
capacity and the numbers here are throughput at-or-below saturation.
The OPEN-loop side — timestamped arrival schedules fired regardless of
completion, against the gateway's admission control — lives in
``distilp_torch.traffic`` (its closed-loop capacity probe reuses this
module's ``replay_concurrent``). On a box with C cores the honest ceiling
of a worker sweep is min(workers, C)×, so read a scaling ratio next to the
machine.

Runnable directly:

    python -m distilp_torch.gateway.loadgen --fleets 10 --workers 2 \
        --events 5 --profile tests/profiles/llama_3_70b/online
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..sched.metrics import _quantile
from ..sched.sim import generate_trace
from .gateway import Gateway
from .traces import make_fleet_from_spec


class PromScraper:
    """Background Prometheus-exposition scrape loop against one gateway.

    The realistic sidecar load: every period the full labeled exposition renders, its
    per-worker round trips queueing behind live solves exactly like an
    external scraper hitting ``GET /metrics``.

    Lifecycle contract: ``stop()`` is idempotent and joins the thread,
    and the scraper registers itself with the gateway
    (``gateway.attach_sampler``), so ``Gateway.close()`` stops it BEFORE
    stopping the workers — a scrape can therefore never land on a
    stopping worker and count a ``prom_scrape_error`` on a clean
    shutdown.
    """

    def __init__(self, gateway: Gateway, period_s: float):
        if period_s <= 0:
            raise ValueError("scrape period must be > 0")
        self.gateway = gateway
        self.period_s = period_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.scrapes = 0
        gateway.attach_sampler(self)

    def start(self) -> "PromScraper":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="prom-scrape"
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.gateway.prometheus_text()
                self.scrapes += 1
            except Exception:
                # The scrape must never kill the arm; a failure is a
                # real observability signal, so it is counted.
                self.gateway.metrics.inc("prom_scrape_error")

    def stop(self, join: bool = True, timeout: float = 2.0) -> None:
        self._stop.set()
        thread = self._thread
        if join and thread is not None and thread.is_alive():
            thread.join(timeout=timeout)


def make_fleet_specs(
    n_fleets: int, fleet_size: int = 3, seed: int = 0
) -> Dict[str, dict]:
    """K deterministic synthetic-fleet specs (traces.py spec-line shape)."""
    return {
        f"f{i:03d}": {"m": fleet_size, "seed": seed * 1000 + i}
        for i in range(n_fleets)
    }


def make_loadgen_trace(
    specs: Dict[str, dict],
    events_per_fleet: int,
    seed: int = 0,
    scenario: str = "drift",
) -> List[Tuple[str, object]]:
    """Interleaved (fleet_id, event) items, round-robin across fleets.

    Drift-only by default: every post-warmup tick should ride the warm
    path, so the measured rate is the steady-state replanning rate, not a
    mixture with cold identity changes.
    """
    per_fleet: Dict[str, list] = {}
    for i, (fleet_id, spec) in enumerate(specs.items()):
        devices = make_fleet_from_spec(fleet_id, spec)
        per_fleet[fleet_id] = generate_trace(
            scenario, events_per_fleet, seed=seed * 7919 + i,
            base_fleet=devices,
        )
    items: List[Tuple[str, object]] = []
    for j in range(events_per_fleet):
        for fleet_id in specs:
            items.append((fleet_id, per_fleet[fleet_id][j]))
    return items


async def replay_concurrent(
    gateway: Gateway,
    items: Sequence[Tuple[str, object]],
    measure_from: Dict[str, int],
    on_timed_start=None,
) -> dict:
    """Replay items with one sequential task per fleet, all concurrent.

    ``measure_from[fleet]`` is the per-fleet index (0-based) of the first
    MEASURED event. The warmup prefix runs as its own concurrent phase
    with a barrier before the timed phase: cold solves AND the first warm
    tick's graph capture land entirely in warmup (a capture leaking into
    an arm's timed phase would make the first arm of a sweep look slower
    than the rest), and the reported wall clock covers only measured
    events.
    """
    per_fleet: Dict[str, list] = {}
    for fleet_id, ev in items:
        per_fleet.setdefault(fleet_id, []).append(ev)
    latencies: List[float] = []
    failures = {"tick_failed": 0, "uncertified": 0}

    async def _drive(fleet_id: str, events: list, record: bool) -> None:
        for ev in events:
            t0 = time.perf_counter()
            view = await gateway.handle_event_async(fleet_id, ev)
            ms = (time.perf_counter() - t0) * 1e3
            if record:
                latencies.append(ms)
                # getattr-tolerant: stub schedulers (process-worker test
                # factory) serve plain dicts, not PlacementViews.
                if getattr(view, "events_behind", 0) > 0:
                    failures["tick_failed"] += 1
                elif not getattr(
                    getattr(view, "result", None), "certified", True
                ):
                    failures["uncertified"] += 1

    split = {f: measure_from.get(f, 0) for f in per_fleet}
    await asyncio.gather(
        *(
            _drive(f, evs[: split[f]], record=False)
            for f, evs in per_fleet.items()
        )
    )
    if on_timed_start is not None:
        # The warmup barrier IS the cold/warm boundary: the compile
        # ledger's arm snapshots its event seq here, so compiles after
        # this callback are warm-phase compiles by construction.
        on_timed_start()
    t_start = time.perf_counter()
    await asyncio.gather(
        *(
            _drive(f, evs[split[f]:], record=True)
            for f, evs in per_fleet.items()
        )
    )
    wall_s = time.perf_counter() - t_start
    srt = sorted(latencies)
    return {
        "events": len(latencies),
        "wall_s": round(wall_s, 3),
        "events_per_sec": round(len(latencies) / wall_s, 2) if wall_s else 0.0,
        "p50_ms": round(_quantile(srt, 0.50), 3),
        "p99_ms": round(_quantile(srt, 0.99), 3),
        **failures,
    }


def run_loadgen(
    model,
    n_fleets: int,
    n_workers: int,
    events_per_fleet: int = 5,
    fleet_size: int = 3,
    seed: int = 0,
    # Two warmup events per fleet: the first pays the cold solve (and the
    # cold signature's graph capture), the second the first warm tick (and
    # the WARM signature's capture — a distinct graph). Both must precede
    # the timed phase or the first arm of a sweep eats a capture bill the
    # later arms don't.
    warmup_per_fleet: int = 2,
    k_candidates: Optional[Sequence[int]] = None,
    mip_gap: float = 1e-3,
    kv_bits: str = "4bit",
    scenario: str = "drift",
    scheduler_kwargs: Optional[dict] = None,
    tracer=None,
    prom_scrape_s: Optional[float] = None,
    timeline_period_s: Optional[float] = None,
    compile_ledger: bool = False,
    memory_ledger: bool = False,
    worker_backend: str = "thread",
    device=None,
) -> dict:
    """One full loadgen arm: build fleets, replay, report, tear down.

    The same (n_fleets, seed, events) always produces the same trace set,
    so arms at different worker counts compare like for like.

    Every shard solves on ``device`` (None = cuda, raising without a GPU;
    ``'cpu'`` runs the kernels' plain versions). ``tracer`` (an
    ``obs.Tracer``) instruments the whole arm; ``prom_scrape_s``
    additionally runs a background thread rendering the Prometheus
    exposition at that period for the arm's duration (its per-worker round
    trips queue behind live solves, exactly like a sidecar hitting
    ``/metrics``). ``compile_ledger``/``memory_ledger`` split the arm's
    kernel loads and graph captures, and its allocator watermarks, at the
    warmup barrier (``report["compile"]``, ``report["mem"]``; per child
    under ``report["proc_workers"]`` on the process backend).
    """
    total_events = events_per_fleet + warmup_per_fleet
    specs = make_fleet_specs(n_fleets, fleet_size=fleet_size, seed=seed)
    items = make_loadgen_trace(specs, total_events, seed=seed, scenario=scenario)
    kwargs = {
        "mip_gap": mip_gap,
        "kv_bits": kv_bits,
        "backend": "torch",
        "k_candidates": list(k_candidates) if k_candidates else None,
    }
    kwargs.update(scheduler_kwargs or {})
    # Compile-ledger arm: reuse the process
    # ledger if one is already enabled, otherwise enable for this arm and
    # disable after — the interleaved ledger-OFF arms must run the true
    # passthrough path or the overhead measurement lies. Enabled BEFORE
    # the Gateway exists: process workers inherit the ledger decision at
    # spawn time (the child gets --compile-ledger only if the parent's
    # ledger is live when _make_worker runs).
    led = led_owned = None
    warm_tok: dict = {"seq": None}
    if compile_ledger:
        from ..obs import compile_ledger as _cl

        led = _cl.current()
        if led is None:
            led = led_owned = _cl.enable()
    # Memory-ledger arm: same reuse-or-own
    # contract as the compile ledger — the interleaved OFF arms must run
    # the true passthrough path or the overhead measurement lies.
    mled = mled_owned = None
    if memory_ledger:
        from ..obs import memory as _mem

        mled = _mem.current()
        if mled is None:
            mled = mled_owned = _mem.enable()
    gateway = Gateway(
        n_workers=n_workers,
        scheduler_kwargs=kwargs,
        tracer=tracer,
        worker_backend=worker_backend,
        device=device,
    )
    scraper = None
    if prom_scrape_s is not None:
        # Self-attaching: Gateway.close() stops it before the workers,
        # so the harness needs no stop-ordering knowledge of its own.
        scraper = PromScraper(gateway, prom_scrape_s)
    sampler = None
    if timeline_period_s is not None:
        # A live timeline sampler at the given cadence, each tick one
        # metrics round trip per worker. Attached, so close() stops it.
        from ..obs.timeline import Timeline, TimelineSampler

        sampler = gateway.attach_sampler(
            TimelineSampler(
                Timeline(),
                gateway.timeline_sample,
                period_s=timeline_period_s,
                metrics=gateway.metrics,
            )
        )
    try:
        for fleet_id, spec in specs.items():
            gateway.register_fleet(
                fleet_id, make_fleet_from_spec(fleet_id, spec), model
            )
        if scraper is not None:
            scraper.start()
        if sampler is not None:
            sampler.start()
        arm_tok = led.seq() if led is not None else 0
        # Per-CHILD warm baselines on the process backend: each worker
        # subprocess runs its own compile ledger, and the federation
        # zero-recompile gate is per process, not per parent.
        proc_warm_base: Dict[int, Optional[int]] = {}

        def _on_timed_start() -> None:
            # The warmup barrier is BOTH ledgers' warm boundary: compile
            # events after it are warm-phase compiles, allocated growth
            # after it is a leak.
            if led is not None:
                warm_tok["seq"] = led.seq()
            if mled is not None:
                mled.mark_warm()
            if worker_backend == "process":
                for w in gateway.live_workers():
                    c = w.ledger_counters()
                    proc_warm_base[w.worker_id] = (
                        c.get("compiles", 0) if c else None
                    )

        measure_from = {f: warmup_per_fleet for f in specs}
        report = asyncio.run(
            replay_concurrent(
                gateway,
                items,
                measure_from,
                on_timed_start=(
                    None
                    if (
                        led is None
                        and mled is None
                        and worker_backend != "process"
                    )
                    else _on_timed_start
                ),
            )
        )
        snap = gateway.metrics_snapshot()
        report.update(
            {
                "fleets": n_fleets,
                "workers": n_workers,
                "worker_backend": worker_backend,
                "device": str(gateway.device),
                "events_per_fleet": events_per_fleet,
                "warmup_per_fleet": warmup_per_fleet,
                "shard_totals": snap["shard_totals"],
                "worker_events": [
                    snap["counters"].get(f"worker_{i}_events", 0)
                    for i in range(n_workers)
                ],
            }
        )
        if worker_backend == "process":
            # Per-child compile view: total compiles and the timed-phase
            # delta against the warm baseline (None when the child runs
            # without a ledger).
            per_proc: Dict[str, dict] = {}
            for w in gateway.live_workers():
                c = w.ledger_counters()
                base = proc_warm_base.get(w.worker_id)
                total = c.get("compiles", 0) if c else None
                per_proc[f"w{w.worker_id}"] = {
                    "compiles": total,
                    "warm_phase_compiles": (
                        total - base
                        if total is not None and base is not None
                        else None
                    ),
                }
            report["proc_workers"] = per_proc
        if prom_scrape_s is not None:
            report["prom_scrape_errors"] = snap["counters"].get(
                "prom_scrape_error", 0
            )
        if sampler is not None:
            report["timeline_samples"] = snap["counters"].get(
                "timeline_samples", 0
            )
            report["timeline_sample_errors"] = snap["counters"].get(
                "timeline_sample_error", 0
            )
        if led is not None:
            # The arm's compile view, split at the warmup barrier: cold
            # compiles paid during warmup vs compiles during the TIMED
            # phase — the latter is the zero-recompile headline.
            arm_events = led.events_since(arm_tok)
            boundary = warm_tok["seq"]
            warm_events = [
                e for e in arm_events
                if boundary is not None and e["seq"] > boundary
            ]
            report["compile"] = {
                "cold_compiles": len(arm_events) - len(warm_events),
                "warm_phase_compiles": len(warm_events),
                "cache_hits": sum(
                    1 for e in arm_events if e.get("cache") == "hit"
                ),
                "entries": sorted({e["entry"] for e in arm_events}),
                "unregistered": sorted(
                    {
                        e["entry"]
                        for e in arm_events
                        if e["entry"] == "(unregistered)"
                    }
                ),
                "warm_entries": sorted({e["entry"] for e in warm_events}),
            }
        if mled is not None:
            # One forced end-of-arm sample (the gateway is quiescent
            # here: every fleet's last event resolved), so the leak
            # verdict compares the warm baseline against the arm's true
            # final live bytes, not a stale mid-phase throttle hit.
            mled.sample(force=True)
            report["mem"] = {
                "leak": mled.leak_report(),
                "watermarks": mled.summary()["watermarks"],
                "entries_analyzed": sum(
                    1 for r in mled.analyses.values() if r.get("memory")
                ),
            }
        return report
    finally:
        # close() stops the attached scraper first, then the workers —
        # the ordering lives in Gateway.close now, not per harness.
        gateway.close()
        if led_owned is not None:
            from ..obs import compile_ledger as _cl

            _cl.disable()
        if mled_owned is not None:
            from ..obs import memory as _mem

            _mem.disable()


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    p = argparse.ArgumentParser(
        prog="python -m distilp_torch.gateway.loadgen",
        description="replay K synthetic fleets through N gateway workers "
        "and report sustained events/sec + latency quantiles",
    )
    p.add_argument("--fleets", type=int, default=10)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--events", type=int, default=5, help="measured events per fleet")
    p.add_argument("--fleet-size", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", "-p", required=True, help="profile folder (model_profile.json)")
    p.add_argument("--k-candidates", default="8,10")
    p.add_argument("--mip-gap", type=float, default=1e-3)
    p.add_argument("--device", default=None,
                   help="where the shards solve (default: the first CUDA device; "
                   "'cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)

    from ..common import load_model_profile

    folder = Path(args.profile)
    model_path = folder / "model_profile.json" if folder.is_dir() else folder
    if not model_path.is_file():
        print(f"error: no model profile at {model_path}", file=sys.stderr)
        return 2
    model = load_model_profile(model_path)
    ks = [int(x) for x in args.k_candidates.split(",") if x.strip()] or None
    report = run_loadgen(
        model,
        n_fleets=args.fleets,
        n_workers=args.workers,
        events_per_fleet=args.events,
        fleet_size=args.fleet_size,
        seed=args.seed,
        k_candidates=ks,
        mip_gap=args.mip_gap,
        device=args.device,
    )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
