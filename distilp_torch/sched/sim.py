"""Deterministic churn scenarios + trace replay.

``generate_trace`` turns (scenario, seed, n_events) into a reproducible
event list — same seed, same trace, bit for bit — so tests can assert
determinism and benches can compare captures. Scenarios model the churn a
real fleet sees:

- ``drift``  — pure coefficient noise: per-device t_comm jitter + load ticks;
- ``decay``  — gradual bandwidth decay on a subset of links (compounding
  small ``t_comm_scale > 1`` degrades) over a drifting background;
- ``flap``   — one non-head device repeatedly leaves and rejoins (the
  warm-pool cache's reason to exist) over a drifting background;
- ``burst``  — load spikes: occasional large skews (expert loads on MoE
  models, t_comm surges otherwise) that relax back — a surge is undone by
  the next burst event (the inverse jitter), so long replays measure
  spike-and-recover, not compounding degradation;
- ``mixed``  — all of the above plus occasional permanent joins/leaves;
- ``spec_burst`` — correlated multi-device drift spikes: one fixed cohort
  of devices spikes t_comm by per-device factors (drawn once per trace)
  and the next burst event relaxes the spike EXACTLY, over a tiny-drift
  background — the fleet alternates between two nearby states, which is
  the churn shape the speculative replanner (``sched.speculate``) banks;
- ``spec_flap`` — oscillating up/down drift on a channel subset: a fixed
  subset's t_comm multiplies by f, then 1/f, alternating per oscillation
  event (no membership churn, unlike ``flap``) — the bundled
  ``tests/traces/spec_burst.jsonl`` / ``spec_flap.jsonl`` are seeded
  captures of these two (ROADMAP item 3's burst/flap traces).

``replay`` drives a scheduler through a trace and reports event→placement
latency (p50/p99) and sustained events/sec — the numbers ``bench.py``
publishes as the scheduler section.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from ..common import DeviceProfile
from ..utils import make_synthetic_fleet
from .events import DeviceDegrade, DeviceJoin, DeviceLeave, LoadTick, is_structural

SCENARIOS = (
    "drift", "decay", "flap", "burst", "mixed", "spec_burst", "spec_flap"
)


def _joinable_device(idx: int, seed: int) -> DeviceProfile:
    """A deterministic fresh device for join events (never the head)."""
    dev = make_synthetic_fleet(1, seed=seed * 7919 + idx)[0]
    dev.name = f"churn-{seed}-{idx}"
    dev.is_head = False
    return dev


def generate_trace(
    scenario: str,
    n_events: int,
    seed: int,
    base_fleet: Sequence[DeviceProfile],
    n_experts: int = 0,
    max_extra_devices: int = 2,
) -> List:
    """A reproducible event list for one scenario.

    ``base_fleet`` is the fleet the scheduler starts from (the trace only
    references its device NAMES — generation does not mutate profiles).
    ``n_experts > 0`` makes load ticks carry skewed expert loads (MoE
    models); otherwise load shows up as t_comm jitter. The fleet never
    shrinks below 2 devices, never grows past ``len(base_fleet) +
    max_extra_devices``, and the head device is never removed — traces are
    valid by construction (``FleetState.apply`` is strict).
    """
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; pick from {SCENARIOS}")
    rng = np.random.default_rng(seed)
    names = [d.name for d in base_fleet]
    if scenario in ("spec_burst", "spec_flap"):
        return _spec_trace(scenario, n_events, rng, names)
    profiles = {d.name: d.model_copy(deep=True) for d in base_fleet}
    head = names[0]
    live = list(names)  # membership tracking; order irrelevant here
    next_join = 0
    events: List = []
    t = 0.0

    def drift_event():
        """Background coefficient noise: jitter one or two live links."""
        picks = rng.choice(len(live), size=min(2, len(live)), replace=False)
        if rng.random() < 0.5:
            return LoadTick(
                t=t,
                t_comm_jitter={
                    live[int(i)]: float(rng.uniform(0.97, 1.03)) for i in picks
                },
                expert_loads=(
                    _skewed_loads(rng, n_experts, strength=0.15)
                    if n_experts
                    else None
                ),
            )
        return DeviceDegrade(
            name=live[int(picks[0])],
            t=t,
            t_comm_scale=float(rng.uniform(0.96, 1.04)),
        )

    flapper: Optional[str] = None  # name currently flapped OUT
    active_burst: Optional[dict] = None  # surge jitter awaiting its inverse
    decay_targets = [n for n in names[1:]][: max(1, len(names) // 3)]

    def decay_event():
        # Prefer the fixed decay cohort, but never name a device that has
        # left the fleet (mixed traces churn membership; apply() is strict).
        pool = [n for n in decay_targets if n in live] or [
            n for n in live if n != head
        ]
        return DeviceDegrade(
            name=str(rng.choice(pool)),
            t=t,
            t_comm_scale=float(rng.uniform(1.01, 1.05)),
            bandwidth_scale=float(rng.uniform(0.96, 0.995)),
        )

    for i in range(n_events):
        t += float(rng.exponential(1.0))
        roll = rng.random()
        ev = None
        if scenario == "decay" and roll < 0.35:
            ev = decay_event()
        elif scenario == "flap" and roll < 0.25:
            if flapper is None:
                candidates = [n for n in live if n != head]
                flapper = str(rng.choice(candidates))
                live.remove(flapper)
                ev = DeviceLeave(name=flapper, t=t)
            else:
                # Rejoin with the SAME name and profile. The rejoined
                # device lands at the END of the ring, so the first flap
                # cycle mints two new warm-pool keys ("without X" and
                # "X moved last") — every later cycle of the same device
                # hits both keys warm. That recurrence is the placement
                # cache's reason to exist.
                dev = profiles[flapper].model_copy(deep=True)
                dev.is_head = False
                live.append(flapper)
                flapper = None
                ev = DeviceJoin(device=dev, t=t)
        elif scenario == "burst" and roll < 0.3:
            if n_experts:
                ev = LoadTick(
                    t=t, expert_loads=_skewed_loads(rng, n_experts, strength=1.5)
                )
            elif active_burst is not None:
                # Relax: undo the outstanding surge exactly (inverse
                # jitter), so bursts never compound across the replay.
                ev = LoadTick(
                    t=t,
                    t_comm_jitter={
                        n: 1.0 / f
                        for n, f in active_burst.items()
                        if n in live
                    },
                )
                active_burst = None
            else:
                active_burst = {
                    n: float(rng.uniform(1.2, 1.8))
                    for n in live
                    if rng.random() < 0.5
                }
                ev = LoadTick(t=t, t_comm_jitter=dict(active_burst))
        elif scenario == "mixed" and roll < 0.2:
            grow_ok = len(live) < len(names) + max_extra_devices
            shrink_ok = len(live) > max(2, len(names) - 1)
            if grow_ok and (roll < 0.1 or not shrink_ok):
                dev = _joinable_device(next_join, seed)
                next_join += 1
                live.append(dev.name)
                ev = DeviceJoin(device=dev, t=t)
            elif shrink_ok:
                candidates = [n for n in live if n != head]
                gone = str(rng.choice(candidates))
                live.remove(gone)
                ev = DeviceLeave(name=gone, t=t)
        elif scenario == "mixed" and roll < 0.35:
            # "All of the above" includes the decay class: gradual
            # bandwidth decay events, not just t_comm jitter.
            ev = decay_event()
        if ev is None:
            ev = drift_event()
        events.append(ev)
    return events


def _spec_trace(scenario: str, n_events: int, rng, names: List[str]) -> List:
    """Speculation-friendly drift traces: predictable, t_comm-only churn.

    Both scenarios keep membership fixed and drift ONLY t_comm (the
    channel the forecaster models), so the fleet walks between a small
    number of tolerance-bucket states:

    - ``spec_burst``: a large cohort spikes together by per-device
      factors drawn ONCE for the whole trace, and the next burst event
      is the exact inverse — spike-and-recover between two states;
    - ``spec_flap``: a smaller subset oscillates up/down per event at a
      higher rate (the flapping-load shape, without ``flap``'s leaves).

    The non-cohort background drifts by ±0.1% per event — real noise, but
    small against the default 5% speculation tolerance, so background
    ticks rarely change the instance digest (occasional bucket-boundary
    crossings stay in as honest misses).
    """
    head = names[0]
    others = [n for n in names[1:]] or [head]
    if scenario == "spec_flap":
        subset = others[: max(1, (len(others) + 1) // 2)]
        factors = {n: float(rng.uniform(1.25, 1.5)) for n in subset}
        p_osc = 0.7
    else:  # spec_burst
        subset = others[: max(1, (2 * len(others) + 2) // 3)]
        factors = {n: float(rng.uniform(1.3, 1.7)) for n in subset}
        p_osc = 0.5
    background = [n for n in others if n not in subset] or [head]
    events: List = []
    t = 0.0
    up = False  # whether the subset currently sits at its spiked state
    for _ in range(n_events):
        t += float(rng.exponential(1.0))
        if rng.random() < p_osc:
            jitter = (
                {n: 1.0 / f for n, f in factors.items()}
                if up
                else dict(factors)
            )
            up = not up
            events.append(LoadTick(t=t, t_comm_jitter=jitter))
        else:
            events.append(
                DeviceDegrade(
                    name=str(rng.choice(background)),
                    t=t,
                    t_comm_scale=float(rng.uniform(0.999, 1.001)),
                )
            )
    return events


def _skewed_loads(rng, n_experts: int, strength: float) -> List[float]:
    """Mean-1 positive load vector; ``strength`` scales the skew."""
    raw = np.exp(strength * rng.standard_normal(n_experts))
    raw = raw / raw.mean()
    return [float(x) for x in raw]


class ReplayReport(NamedTuple):
    """What a trace replay measured, ready for a bench JSON line."""

    views: list  # one PlacementView per event
    latencies_ms: List[float]  # event -> placement, per event
    events_per_sec: float  # sustained over the whole replay
    p50_ms: float
    p99_ms: float
    structural_uncertified: int  # structural events whose tick missed cert
    failed_ticks: int

    def summary(self) -> dict:
        return {
            "events": len(self.latencies_ms),
            "events_per_sec": round(self.events_per_sec, 2),
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "structural_uncertified": self.structural_uncertified,
            "failed_ticks": self.failed_ticks,
        }


def replay(
    scheduler, events: Sequence, warmup: int = 0, on_event=None
) -> ReplayReport:
    """Drive a scheduler through a trace, measuring per-event latency.

    ``warmup`` events at the head of the trace are handled but excluded
    from the timing stats (jit compilation of a fleet shape's solve
    program belongs to deployment, not to the steady state the p50/p99
    describe; the bench reports both by replaying with and without it).

    ``on_event(event, view, ms)`` is called after each tick — the CLI's
    event log hangs off this hook so there is exactly ONE replay loop.
    """
    lat: List[float] = []
    views = []
    uncert = 0
    failed_before = scheduler.metrics.counters["tick_failed"]
    t_start = time.perf_counter()
    for i, ev in enumerate(events):
        t0 = time.perf_counter()
        view = scheduler.handle(ev)
        ms = (time.perf_counter() - t0) * 1e3
        views.append(view)
        if i >= warmup:
            lat.append(ms)
        if (
            is_structural(ev)
            and view.events_behind == 0
            and not view.result.certified
        ):
            uncert += 1
        if on_event is not None:
            on_event(ev, view, ms)
    total_s = time.perf_counter() - t_start
    srt = sorted(lat)

    def q(p: float) -> float:
        if not srt:
            return 0.0
        return srt[min(len(srt) - 1, max(0, round(p * (len(srt) - 1))))]

    return ReplayReport(
        views=views,
        latencies_ms=lat,
        events_per_sec=len(events) / total_s if total_s > 0 else 0.0,
        p50_ms=q(0.50),
        p99_ms=q(0.99),
        structural_uncertified=uncert,
        failed_ticks=scheduler.metrics.counters["tick_failed"] - failed_before,
    )
