"""Open-loop execution: fire the schedule on time, measure the fallout.

The executor's one rule is the open-loop contract: an event fires at its
scheduled instant whether or not earlier events have completed — lateness
accumulates in the queues instead of throttling the generator. That is
exactly what closed-loop replay cannot do, and it is why these numbers
can show collapse: offered load is an input here, not an emergent
property of service speed.

Latency is measured from the event's SCHEDULED time to placement
publication — the client clock. Under overload that includes dispatch
lateness and queue wait, so p99/p99.9 here degrade the way a user's
would; the solve-only view lives in the gateway's own histograms.

``shed_violations`` is the admission-control accounting contract
(``ChaosReport.violations()`` extended to overload): every shed the
gateway counted must be explained record-by-record by the flight
recorder, per fleet, with monotone shed indices — a shed that is counted
but unrecorded (or vice versa) is a contract violation, exactly like an
unaccounted quarantine in the chaos soak.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Sequence

from ..gateway.gateway import Gateway, QueueFull
from ..sched.metrics import _quantile
from ..sched.sim import generate_trace
from .arrivals import ScheduledEvent


def _view_invalid(view) -> bool:
    """The ChaosReport structural-validity check, minus the L cross-check
    (open-loop traces are drift-only by default; a coalesced or near-match
    serve still must be a well-formed placement). Stub schedulers (the
    process-worker test factory) serve plain dicts — nothing to check."""
    r = getattr(view, "result", None)
    if r is None:
        return False
    return r.k < 1 or len(r.w) != len(r.n) or any(w < 0 for w in r.w)


async def execute_openloop(
    gateway: Gateway,
    items: Sequence[ScheduledEvent],
    time_scale: float = 1.0,
    on_event=None,
    timeline=None,
) -> dict:
    """Fire ``items`` at their (scaled) scheduled times; gather results.

    ``time_scale`` compresses (<1) or dilates (>1) the schedule: the
    committed captures carry a leisurely real-time horizon, and the
    overload smokes replay them at a tiny scale to drive the same event
    sequence past saturation deterministically. Returns the report dict
    (see keys below); per-event outcomes stream through ``on_event(item,
    outcome)`` with outcome one of 'served'/'shed'/'failed'.

    ``timeline`` (an ``obs.timeline.Timeline``) is the per-window latency
    feed: each served event's scheduled-time latency lands as a point on
    ``openloop.latency_ms`` (and each shed as a tick on the cumulative
    ``openloop.sheds``) at the moment it happened — so a latency-tier SLO
    evaluated DURING the flood sees the client clock's window, not just
    the end-of-run percentiles this function returns.
    """
    if time_scale <= 0:
        raise ValueError("time_scale must be > 0")
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    lat_ms: List[float] = []
    dispatch_late_ms: List[float] = []
    sheds: List[dict] = []
    counts = {"offered": 0, "served": 0, "shed": 0, "failed": 0, "invalid": 0}
    max_depth_seen = 0
    tasks: List[asyncio.Task] = []

    async def _fire(item: ScheduledEvent, target: float) -> None:
        try:
            view = await gateway.handle_event_async(item.fleet_id, item.event)
        except QueueFull as e:  # dlint: disable=DLP017 the shed was already counted (events_shed) and flight-recorded INSIDE the gateway before this raise; here it only lands in the report
            counts["shed"] += 1
            sheds.append(
                {
                    "fleet": e.fleet_id,
                    "depth": e.depth,
                    "retry_after_s": e.retry_after_s,
                }
            )
            if timeline is not None:
                timeline.record(
                    "openloop.sheds", loop.time(), counts["shed"]
                )
            if on_event is not None:
                on_event(item, "shed")
            return
        done_ms = (loop.time() - target) * 1e3
        if getattr(view, "events_behind", 0) > 0:
            # The tick produced no fresh placement (solve failed); the
            # served answer is the previous one — an error under open
            # loop just like under replay.
            counts["failed"] += 1
            if on_event is not None:
                on_event(item, "failed")
            return
        if _view_invalid(view):
            counts["invalid"] += 1
        counts["served"] += 1
        lat_ms.append(done_ms)
        if timeline is not None:
            # loop.time() IS time.monotonic() on the default event loop,
            # so these points share the timeline sampler's clock.
            timeline.record("openloop.latency_ms", loop.time(), done_ms)
        if on_event is not None:
            on_event(item, "served")

    for item in sorted(items, key=lambda it: it.at_s):
        target = t0 + item.at_s * time_scale
        delay = target - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        # Negative delay = the dispatcher itself is behind; fire NOW and
        # record the lateness — never skip, never throttle.
        counts["offered"] += 1
        dispatch_late_ms.append(max(0.0, (loop.time() - target) * 1e3))
        for w in gateway.live_workers():
            max_depth_seen = max(max_depth_seen, w.depth())
        tasks.append(asyncio.ensure_future(_fire(item, target)))
    if tasks:
        await asyncio.gather(*tasks)
    wall_s = loop.time() - t0
    srt = sorted(lat_ms)
    horizon_s = (
        max(it.at_s for it in items) * time_scale if items else 0.0
    )
    return {
        **counts,
        "wall_s": round(wall_s, 3),
        "offered_eps": (
            round(counts["offered"] / horizon_s, 2) if horizon_s > 0 else 0.0
        ),
        # Goodput: events actually served per second of wall clock — the
        # plateau-vs-cliff gauge. Sheds and failures are not goodput.
        "goodput_eps": (
            round(counts["served"] / wall_s, 2) if wall_s > 0 else 0.0
        ),
        "p50_ms": round(_quantile(srt, 0.50), 3),
        "p99_ms": round(_quantile(srt, 0.99), 3),
        "p999_ms": round(_quantile(srt, 0.999), 3),
        "max_ms": round(srt[-1], 3) if srt else 0.0,
        "dispatch_p99_late_ms": round(
            _quantile(sorted(dispatch_late_ms), 0.99), 3
        ),
        "max_queue_depth_seen": max_depth_seen,
        "shed_samples": sheds[:5],
    }


def shed_violations(gateway: Gateway, flight) -> List[str]:
    """Record-by-record shed reconciliation (empty = contract held).

    Checks, per fleet: the flight recorder's shed records carry strictly
    increasing ``shed_index`` values whose last equals the gateway's
    per-fleet shed tally, each record names a positive Retry-After, and
    the per-fleet tallies sum to the ``events_shed`` counter. The same
    shape as the chaos soak's quarantine accounting: counters must be
    explained by records.

    Ring-overflow semantics: shed records share the fleet's bounded ring
    with ordinary tick records, and eviction is strictly oldest-first —
    so as long as ANY shed record survives, the youngest (index ==
    tally) survives with it, and the last-index check is sound. A fleet
    whose shed records were ALL pushed out by newer tick records is only
    a violation when eviction cannot explain the absence (the ring never
    filled); otherwise the counter stands un-audited rather than
    falsely condemned — size the recorder's capacity to the audit window
    when the reconciliation matters (the harness and bench do).
    """
    out: List[str] = []
    tallies = gateway.shed_counts()
    counter = gateway.metrics.snapshot()["counters"].get("events_shed", 0)
    if counter != sum(tallies.values()):
        out.append(
            f"shed accounting: events_shed={counter} but per-fleet "
            f"tallies sum to {sum(tallies.values())}"
        )
    if flight is None:
        if counter:
            out.append(
                f"shed accounting: {counter} sheds with no flight "
                "recorder attached (sheds must be flight-recorded)"
            )
        return out
    for fleet_id, tally in sorted(tallies.items()):
        ring = flight.snapshot(fleet_id)
        records = [r for r in ring if r.get("shed")]
        if not records:
            if len(ring) < flight.capacity:
                # Nothing was ever evicted from this ring, so the
                # missing records cannot be an overflow artifact.
                out.append(
                    f"shed accounting: fleet {fleet_id} counted {tally} "
                    "shed(s) but has no shed flight records (and the "
                    "ring never overflowed)"
                )
            continue
        indices = [r.get("shed_index") for r in records]
        if any(
            not isinstance(i, int) or i < 1 for i in indices
        ) or indices != sorted(indices) or len(set(indices)) != len(indices):
            out.append(
                f"shed accounting: fleet {fleet_id} has non-monotone "
                f"shed indices {indices}"
            )
        elif indices[-1] != tally:
            out.append(
                f"shed accounting: fleet {fleet_id} newest shed record "
                f"has index {indices[-1]} but the tally is {tally}"
            )
        for r in records:
            ra = r.get("retry_after_s")
            if not isinstance(ra, (int, float)) or ra <= 0:
                out.append(
                    f"shed accounting: fleet {fleet_id} shed record "
                    f"#{r.get('shed_index')} carries no positive "
                    f"Retry-After ({ra!r})"
                )
    for fleet_id in flight.keys():
        shed_recs = [r for r in flight.snapshot(fleet_id) if r.get("shed")]
        if shed_recs and fleet_id not in tallies:
            out.append(
                f"shed accounting: fleet {fleet_id} has shed flight "
                "records but a zero tally"
            )
    return out


def control_violations(gateway: Gateway, loop) -> List[str]:
    """Closed-loop accounting reconciliation (empty = contract held).

    The autoscaler's version of ``shed_violations``: every action the
    control loop took must be explained by the counters AND — when a
    flight recorder is attached — by a flight record on the ``control``
    ring, in order, kind-for-kind. A counted-but-unrecorded decision (or
    an actuation the fleet state does not reflect) is a violation.
    """
    out: List[str] = []
    counters = gateway.metrics.snapshot()["counters"]
    actions = list(loop.actions)
    n = counters.get("control_actions", 0)
    if n != len(actions):
        out.append(
            f"control accounting: control_actions={n} but the loop "
            f"took {len(actions)} action(s)"
        )
    per_kind: Dict[str, int] = {}
    for a in actions:
        per_kind[a.kind] = per_kind.get(a.kind, 0) + 1
    for kind, ctr in (
        ("scale_out", "control_scale_out"),
        ("scale_in", "control_scale_in"),
        ("degrade_on", "control_degrade_on"),
        ("degrade_off", "control_degrade_off"),
        ("spec_k", "control_spec_k"),
    ):
        if counters.get(ctr, 0) != per_kind.get(kind, 0):
            out.append(
                f"control accounting: {ctr}={counters.get(ctr, 0)} but "
                f"{per_kind.get(kind, 0)} {kind} action(s) were taken"
            )
    # Actuation must be reflected in the fleet counters: every scale_out
    # spawned a worker, every scale_in retired one, and no migration may
    # have failed (a failed flip leaves routing on the source — correct,
    # but the autoscale smoke demands the clean path).
    if counters.get("workers_spawned", 0) != per_kind.get("scale_out", 0):
        out.append(
            f"control accounting: workers_spawned="
            f"{counters.get('workers_spawned', 0)} but "
            f"{per_kind.get('scale_out', 0)} scale_out action(s)"
        )
    if counters.get("workers_retired", 0) != per_kind.get("scale_in", 0):
        out.append(
            f"control accounting: workers_retired="
            f"{counters.get('workers_retired', 0)} but "
            f"{per_kind.get('scale_in', 0)} scale_in action(s)"
        )
    if counters.get("migration_failed", 0):
        out.append(
            f"control accounting: {counters.get('migration_failed', 0)} "
            "migration(s) failed"
        )
    if loop.errors:
        out.append(
            f"control accounting: {loop.errors} control tick(s) raised"
        )
    flight = gateway.flight
    if flight is None:
        if actions:
            out.append(
                f"control accounting: {len(actions)} action(s) with no "
                "flight recorder attached (decisions must be recorded)"
            )
        return out
    ring = (
        list(flight.snapshot("control")) if "control" in flight.keys() else []
    )
    recorded = [(r.get("action") or {}).get("kind") for r in ring]
    expect = [a.kind for a in actions]
    # Same oldest-first eviction semantics as shed records: with no
    # overflow the trail must match exactly; with overflow, the surviving
    # suffix must.
    if len(ring) < flight.capacity:
        if recorded != expect:
            out.append(
                f"control accounting: flight trail {recorded} does not "
                f"match actions {expect}"
            )
    elif recorded != expect[len(expect) - len(recorded):]:
        out.append(
            "control accounting: flight trail (overflowed) does not "
            "match the action suffix"
        )
    for r in ring:
        if "signals" not in r:
            out.append(
                "control accounting: flight record for "
                f"{(r.get('action') or {}).get('kind')} at t={r.get('t')} "
                "carries no signals snapshot"
            )
    return out


async def _warmup(
    gateway: Gateway, specs: Dict[str, dict], per_fleet: int, seed: int
) -> None:
    """Closed-loop warmup: cold solve + warm-layout compile per fleet,
    concurrent across fleets (the loadgen's barrier-phase convention) —
    the open-loop phase must measure serving, not the first ticks' kernel
    loads and graph captures."""
    from ..gateway.traces import make_fleet_from_spec

    async def _drive(fleet_id: str, events: list) -> None:
        for ev in events:
            await gateway.handle_event_async(fleet_id, ev)

    jobs = []
    for i, (fleet_id, spec) in enumerate(specs.items()):
        devices = make_fleet_from_spec(fleet_id, spec)
        events = generate_trace(
            "drift", per_fleet, seed=seed * 104729 + i, base_fleet=devices
        )
        jobs.append(_drive(fleet_id, events))
    await asyncio.gather(*jobs)


def run_openloop(
    model,
    specs: Dict[str, dict],
    items: Sequence[ScheduledEvent],
    n_workers: int,
    *,
    time_scale: float = 1.0,
    warmup_per_fleet: int = 2,
    warmup_seed: int = 0,
    k_candidates: Optional[Sequence[int]] = None,
    mip_gap: float = 1e-3,
    kv_bits: str = "4bit",
    scheduler_kwargs: Optional[dict] = None,
    max_queue_depth: Optional[int] = None,
    coalesce: bool = False,
    combine: bool = False,
    combine_policy=None,
    degrade_depth: Optional[int] = None,
    flight=None,
    tracer=None,
    slo_config=None,
    timeline=None,
    timeline_period_s: float = 0.05,
    settle_s: float = 0.0,
    worker_backend: str = "thread",
    scheduler_factory=None,
    autoscale=None,
    control_period_s: float = 0.25,
    capacity_probe_events: int = 0,
    device=None,
) -> dict:
    """One full open-loop arm: build, warm, fire, report, tear down.

    Admission is configured only AFTER the warmup phase (a cold compile
    behind a bounded queue would shed the warmup itself), then the whole
    schedule executes open-loop. The report merges the executor's numbers
    with the gateway's admission counters and — when a flight recorder is
    attached — the shed reconciliation verdict.

    SLO arm (``slo_config``, an ``obs.slo.SLOConfig``): a timeline
    sampler runs for the arm's whole life (evaluating the SLO engine on
    every tick), the executor feeds per-event scheduled-time latency into
    the timeline, and the report grows an ``slo`` block (status + the
    alert open/close sequence) plus ``timeline_samples``. ``settle_s``
    keeps sampling AFTER the schedule drains — the recovery window a
    burn-rate alert needs to clear, which is exactly what the smoke
    asserts. ``timeline`` alone (no config) just records, no alerting.

    Autoscale arm (``autoscale``, a ``control.ControlPolicy``): the
    gateway is built dynamic (spawn/retire/migrate enabled, backed by
    ``worker_backend`` — "thread" or "process"), a ``ControlLoop`` runs
    for the flood's whole life, and — unless the probe is skipped — a
    post-warmup closed-loop probe of ``capacity_probe_events`` per fleet
    populates the ``/signals`` headroom denominator, refreshed
    deterministically per worker-count change (no live re-probe inside
    the loop). The report grows a ``control`` block with the policy,
    every action taken, and the flight-record reconciliation verdict
    (``control_violations``).

    Every shard solves on ``device`` (None = cuda, raising without a GPU;
    ``'cpu'`` runs the kernels' plain versions), process workers included.
    """
    kwargs = {
        "mip_gap": mip_gap,
        "kv_bits": kv_bits,
        "backend": "torch",
        "k_candidates": list(k_candidates) if k_candidates else None,
    }
    kwargs.update(scheduler_kwargs or {})
    gateway = Gateway(
        n_workers=n_workers, scheduler_kwargs=kwargs,
        scheduler_factory=scheduler_factory,
        flight=flight, tracer=tracer,
        worker_backend=worker_backend,
        dynamic=autoscale is not None,
        device=device,
    )
    engine = None
    sampler = None
    control_loop = None
    capacity_probe = None
    if (slo_config is not None or autoscale is not None) and timeline is None:
        from ..obs.timeline import Timeline

        timeline = Timeline()
    # Per-arm compile-ledger snapshot: when the process ledger is enabled
    # (bench compile section, serve --compile-ledger) every open-loop arm
    # reports its own compile delta — a flood arm that silently paid a
    # recompile storm would otherwise launder it into aggregate wall time.
    from ..obs import compile_ledger as _cl
    from ..obs import memory as _obs_memory

    _led = _cl.current()
    _led_tok = _led.seq() if _led is not None else 0
    # Same per-arm convention for the memory ledger: enabled process-wide
    # (serve --memory-ledger / the bench memory section), every open-loop
    # arm reports its own leak/watermark view.
    _mled = _obs_memory.current()
    try:
        from ..gateway.traces import make_fleet_from_spec

        for fleet_id, spec in specs.items():
            gateway.register_fleet(
                fleet_id, make_fleet_from_spec(fleet_id, spec), model
            )
        if slo_config is not None:
            from ..obs.slo import SLOEngine

            engine = SLOEngine(
                slo_config, timeline, metrics=gateway.metrics,
                tracer=tracer, flight=flight,
            )
        if timeline is not None:
            # engine may be None (timeline-only / autoscale-only arms):
            # the read surface still needs gateway.timeline wired so
            # /signals — and the control loop reading it — can build.
            gateway.attach_slo(engine, timeline)
            from ..obs.timeline import TimelineSampler

            sampler = gateway.attach_sampler(
                TimelineSampler(
                    timeline,
                    gateway.timeline_sample,
                    period_s=timeline_period_s,
                    metrics=gateway.metrics,
                    on_sample=(
                        None if engine is None
                        else (lambda _tl, now: engine.evaluate(now))
                    ),
                )
            )
            # The pre-incident baseline, taken now: the thread's first tick
            # comes a period later, and a warm-up and flood that fit inside
            # one period (the card's warm ticks take milliseconds) would
            # leave every window without the baseline its delta needs.
            sampler.sample_once()
            sampler.start()
        if warmup_per_fleet > 0:
            asyncio.run(
                _warmup(gateway, specs, warmup_per_fleet, warmup_seed)
            )
        if autoscale is not None and capacity_probe_events > 0 and (
            gateway.capacity_eps is None
        ):
            # Satellite: the /signals headroom denominator comes from a
            # closed-loop probe of THIS gateway (same fleets, same
            # workers), run while admission is still open — the probe is
            # warm-phase work, not flood traffic to be shed.
            # note_capacity keeps the per-worker quotient: capacity_eps
            # refreshes deterministically on every spawn/retire.
            capacity_probe = measure_closed_loop(
                gateway, specs, capacity_probe_events, warmup_seed
            )
            gateway.note_capacity(capacity_probe["events_per_sec"])
        gateway.configure_admission(
            max_queue_depth=max_queue_depth,
            coalesce=coalesce,
            combine=combine,
            combine_policy=combine_policy,
            degrade_depth=degrade_depth,
        )
        combine_warm = None
        if combine:
            # Combined traffic has its own capture surface (one graph plan
            # per committed bucket x lane shape): capture all of it
            # BEFORE the warm boundary, or the flood pays it live.
            combine_warm = gateway.warm_combine()
        if autoscale is not None:
            from ..control import Controller, ControlLoop

            control_loop = ControlLoop(
                gateway, Controller(autoscale), period_s=control_period_s
            )
            gateway.attach_controller(control_loop)
            control_loop.start()
        if _mled is not None:
            # The admission flip IS openloop's warm boundary: everything
            # before it (fleet registration, per-fleet warmup solves,
            # combined plans' captures) is allowed to allocate; allocated
            # bytes must stay flat from here. Without this baseline the
            # arm's mem block reports ``leak: null`` forever.
            _mled.mark_warm()
        # Warm-phase compile token: the compile block reports the arm's
        # full delta AND the post-warm-boundary slice — the latter is the
        # zero-recompile gate's number (warmup compiles are the contract;
        # measured-phase compiles are the violation).
        _led_warm_tok = _led.seq() if _led is not None else 0
        report = asyncio.run(
            execute_openloop(
                gateway, items, time_scale=time_scale, timeline=timeline
            )
        )
        if settle_s > 0 and sampler is not None:
            # Recovery window: the schedule drained, the sampler keeps
            # watching — this is where a fired burn-rate alert clears
            # (windowed deltas go to zero once the burst slides out).
            deadline = time.monotonic() + settle_s
            while time.monotonic() < deadline:
                time.sleep(min(timeline_period_s, 0.05))
        snap = gateway.metrics_snapshot()
        totals = snap["shard_totals"]
        report.update(
            {
                "fleets": len(specs),
                "workers": n_workers,
                "time_scale": time_scale,
                "events_shed": snap["counters"].get("events_shed", 0),
                "events_coalesced": totals.get("events_coalesced", 0),
                "spec_near_hits": totals.get("spec_near_hit", 0),
                "shed_counts": gateway.shed_counts(),
                "admission": {
                    "max_queue_depth": max_queue_depth,
                    "coalesce": coalesce,
                    "combine": combine,
                    "degrade_depth": degrade_depth,
                },
            }
        )
        if combine:
            report["combine"] = dict(
                gateway._combiner.snapshot()
                if gateway._combiner is not None else {}
            )
            report["combine"]["warmup"] = combine_warm
            for ctr in (
                "combine_prepared", "combine_local",
                "combine_stale", "combine_fallback",
            ):
                report["combine"][ctr] = totals.get(ctr, 0)
        if flight is not None:
            report["shed_violations"] = shed_violations(gateway, flight)
        if control_loop is not None:
            # The trail is read once the loop's last tick has finished
            # actuating: a scale-out in flight waits for its child's start
            # (up to the worker's 60 s spawn timeout; 8-12 s on the H100's
            # host), and a trail read before it ends would miss actions
            # the counters and the flight records already hold.
            control_loop.stop(timeout=90.0)
            report["control"] = {
                "policy": autoscale.model_dump(),
                "actions": [a.model_dump() for a in control_loop.actions],
                "workers_final": len(gateway.live_workers()),
                "worker_backend": worker_backend,
                "capacity_probe": capacity_probe,
                "capacity_eps": gateway.capacity_eps,
                "counters": {
                    k: int(v)
                    for k, v in sorted(snap["counters"].items())
                    if k.startswith("control_")
                    or k in (
                        "workers_spawned", "workers_retired",
                        "shards_migrated", "migration_parked",
                        "migration_failed",
                    )
                },
                "violations": control_violations(gateway, control_loop),
            }
        if worker_backend == "process":
            # Each live child, once the control loop stopped: its start
            # (spawn to first ping) per generation and its nvcc runs.
            report["process_workers"] = [
                w.child_report() for w in gateway.live_workers()
            ]
        if _led is not None:
            arm_events = _led.events_since(_led_tok)
            warm_events = _led.events_since(_led_warm_tok)
            report["compile"] = {
                "events": len(arm_events),
                "cache_hits": sum(
                    1 for e in arm_events if e.get("cache") == "hit"
                ),
                "storm_flagged": sum(
                    1 for e in arm_events if e.get("storm")
                ),
                "entries": sorted({e["entry"] for e in arm_events}),
                "warm_phase_events": len(warm_events),
                "warm_phase_entries": sorted(
                    {e["entry"] for e in warm_events}
                ),
                # The combine zero-recompile gate's number: warm-phase
                # captures of the batched BUCKET search specifically. A
                # per-shard entry here (e.g. an uncertified lane's local
                # fallback re-solving with escalated search parameters)
                # is attributed under warm_phase_entries but is not a
                # committed-bucket-policy violation.
                "warm_phase_combine_events": sum(
                    1
                    for e in warm_events
                    if e.get("entry") == "solver.solve_batch"
                ),
            }
        if _mled is not None:
            # Per-arm memory view (one forced end-of-arm sample — the
            # schedule has drained, so this is the flood's true residue):
            # a flood whose queued-up ticks silently pinned device memory
            # would otherwise launder the growth into process-level RSS
            # noise.
            _mled.sample(force=True)
            report["mem"] = {
                "leak": _mled.leak_report(),
                "watermarks": _mled.summary()["watermarks"],
                "headroom_bytes": _mled.headroom_bytes(),
            }
        if engine is not None:
            report["slo"] = {
                "alerts_opened": snap["counters"].get("slo_alert_opened", 0),
                "alerts_closed": snap["counters"].get("slo_alert_closed", 0),
                "timeline_samples": snap["counters"].get(
                    "timeline_samples", 0
                ),
                "events": list(engine.events),
                "firing": engine.firing(),
                # The /signals payload as the live gateway would serve it
                # — the bench validates it against SignalsPayload so the
                # federation contract is schema-checked on every capture.
                "signals": gateway.signals(),
            }
        return report
    finally:
        # close() stops the attached sampler before the workers.
        gateway.close()


def measure_closed_loop(
    gateway: Gateway, specs: Dict[str, dict], events_per_fleet: int, seed: int
) -> dict:
    """Closed-loop capacity probe on an ALREADY-WARM gateway: the bench's
    sustainable-rate search needs a capacity estimate from the same
    fleets/workers the open-loop arms will stress, without paying a
    second set of cold solves. Thin wrapper over the loadgen's concurrent
    replayer with no warmup split."""
    from ..gateway.loadgen import replay_concurrent
    from ..gateway.traces import make_fleet_from_spec

    items = []
    per_fleet: Dict[str, list] = {}
    for i, (fleet_id, spec) in enumerate(specs.items()):
        devices = make_fleet_from_spec(fleet_id, spec)
        per_fleet[fleet_id] = generate_trace(
            "drift", events_per_fleet, seed=seed * 15485863 + i,
            base_fleet=devices,
        )
    for j in range(events_per_fleet):
        for fleet_id in specs:
            items.append((fleet_id, per_fleet[fleet_id][j]))
    return asyncio.run(
        replay_concurrent(gateway, items, {f: 0 for f in specs})
    )


def lateness_probe(items: Sequence[ScheduledEvent]) -> float:
    """Total schedule horizon in seconds (the last event's timestamp) —
    a convenience for sizing time_scale against a wall-clock budget."""
    return max((it.at_s for it in items), default=0.0)
