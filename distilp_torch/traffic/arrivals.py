"""Seeded open-loop arrival schedules: Poisson x diurnal x regional bursts.

The arrival model factors into three deterministic pieces:

- **base process** — a Poisson stream at ``base_rate`` events/sec summed
  across the fleet set (independent thin streams per fleet is the same
  process; one stream plus a weighted fleet pick is cheaper and lets the
  burst correlation below fall out naturally);
- **diurnal modulation** — the rate is scaled by
  ``1 + diurnal_amplitude * sin(2*pi*t/period + phase)``: the day/night
  swing every consumer-facing service rides (amplitude 0 turns it off);
- **correlated regional bursts** — fleets are partitioned round-robin
  into ``n_regions`` regions; each region gets its own Poisson process
  of burst onsets, and while a burst is live every fleet in that region
  arrives ``burst_factor`` times more often. Correlation is the point:
  a regional incident hits MANY fleets that hash to the SAME handful of
  workers at once, which is the queue shape shedding and coalescing
  exist for (independent per-fleet spikes average out and never stress
  a bounded queue the same way).

Sampling is inhomogeneous-Poisson thinning against the peak rate, so the
schedule is an exact draw of the composite process and a pure function
of ``(config, n_fleets)`` — same inputs, byte-identical schedule, which
is what lets ``tests/traces/openloop_*.jsonl`` be committed captures
with regeneration tests (the ``spec_burst``/``spec_flap`` pattern).

Event *payloads* ride the existing churn simulator: each fleet's events
come from ``sched.sim.generate_trace`` under ``scenario``, with the
event's trace-time ``t`` rewritten to its scheduled arrival time.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
from pydantic import BaseModel

from ..sched.events import event_from_dict
from ..sched.sim import generate_trace
from ..gateway.traces import make_fleet_from_spec


class ArrivalConfig(BaseModel):
    """One open-loop arrival process, fully seeded.

    ``base_rate`` is the fleet-set aggregate events/sec at the diurnal
    midpoint with no burst live; the peak offered rate is
    ``base_rate * (1 + diurnal_amplitude) * burst_factor`` (every region
    bursting at the diurnal crest). ``duration_s`` is schedule time — the
    executor compresses or dilates it with ``time_scale`` at replay.
    """

    seed: int = 0
    duration_s: float = 60.0
    base_rate: float = 2.0
    diurnal_amplitude: float = 0.0
    diurnal_period_s: float = 86400.0
    diurnal_phase: float = 0.0
    n_regions: int = 1
    burst_rate_per_region: float = 0.0  # burst onsets/sec, per region
    burst_factor: float = 1.0
    burst_duration_s: float = 0.0
    scenario: str = "drift"
    fleet_size: int = 3
    fleet_seed: int = 0


class ScheduledEvent(NamedTuple):
    """One arrival: fire ``event`` at ``at_s`` (schedule time) for
    ``fleet_id`` — whether or not the service has kept up."""

    at_s: float
    fleet_id: str
    event: object


def _fleet_specs(config: ArrivalConfig, n_fleets: int) -> Dict[str, dict]:
    """Deterministic synthetic-fleet specs, the loadgen's naming scheme
    (``f000``..) and spec-line shape, so open-loop and closed-loop arms
    of a bench sweep are built over the identical fleet set."""
    return {
        f"f{i:03d}": {
            "m": config.fleet_size,
            "seed": config.fleet_seed * 1000 + i,
        }
        for i in range(n_fleets)
    }


def _burst_windows(
    config: ArrivalConfig, rng: np.random.Generator
) -> List[List[Tuple[float, float]]]:
    """Per-region burst [start, end) windows over the schedule horizon.

    Drawn up front (one exponential-gap walk per region) so the rate
    function below is a pure lookup — thinning needs rate(t) at arbitrary
    t, and drawing burst onsets lazily would entangle the two streams'
    randomness."""
    windows: List[List[Tuple[float, float]]] = []
    for _region in range(max(1, config.n_regions)):
        region_windows: List[Tuple[float, float]] = []
        if config.burst_rate_per_region > 0 and config.burst_factor > 1:
            t = 0.0
            while True:
                t += float(rng.exponential(1.0 / config.burst_rate_per_region))
                if t >= config.duration_s:
                    break
                region_windows.append((t, t + config.burst_duration_s))
        windows.append(region_windows)
    return windows


def _bursting(windows: List[Tuple[float, float]], t: float) -> bool:
    return any(a <= t < b for a, b in windows)


def generate_openloop_schedule(
    config: ArrivalConfig, n_fleets: int
) -> Tuple[Dict[str, dict], List[ScheduledEvent]]:
    """(fleet specs, timestamped events) — a pure function of its inputs.

    Two-pass: first the arrival process decides WHEN and WHICH FLEET
    (thinning against the peak rate, fleet picked in proportion to its
    live burst weight), then each fleet's event payloads are drawn from
    the churn simulator in one batch of exactly the count that fleet was
    assigned. The per-fleet event stream is therefore the same ordered
    ``generate_trace`` prefix regardless of how arrivals interleave
    across fleets — interleaving and payloads stay independently seeded.
    """
    if n_fleets < 1:
        raise ValueError("need at least one fleet")
    rng = np.random.default_rng(config.seed)
    specs = _fleet_specs(config, n_fleets)
    fleet_ids = list(specs)
    regions = [i % max(1, config.n_regions) for i in range(n_fleets)]
    windows = _burst_windows(config, rng)

    def diurnal(t: float) -> float:
        if config.diurnal_amplitude <= 0:
            return 1.0
        return 1.0 + config.diurnal_amplitude * math.sin(
            2.0 * math.pi * t / config.diurnal_period_s
            + config.diurnal_phase
        )

    peak = (
        config.base_rate
        * (1.0 + max(0.0, config.diurnal_amplitude))
        * max(1.0, config.burst_factor)
    )
    if peak <= 0:
        raise ValueError("arrival config has a non-positive peak rate")

    # Pass 1: arrival instants + fleet assignment (thinning).
    arrivals: List[Tuple[float, int]] = []  # (t, fleet index)
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= config.duration_s:
            break
        weights = np.array(
            [
                config.burst_factor
                if _bursting(windows[regions[i]], t)
                else 1.0
                for i in range(n_fleets)
            ]
        )
        # Aggregate rate at t = mean fleet weight x diurnal x base.
        rate_t = config.base_rate * diurnal(t) * float(weights.mean())
        if rng.random() >= rate_t / peak:
            continue
        fleet_idx = int(rng.choice(n_fleets, p=weights / weights.sum()))
        arrivals.append((t, fleet_idx))

    # Pass 2: per-fleet payloads from the churn simulator, then stitch.
    counts = [0] * n_fleets
    for _, i in arrivals:
        counts[i] += 1
    payloads: List[List] = []
    for i, fleet_id in enumerate(fleet_ids):
        devices = make_fleet_from_spec(fleet_id, specs[fleet_id])
        payloads.append(
            generate_trace(
                config.scenario,
                counts[i],
                seed=config.seed * 7919 + i,
                base_fleet=devices,
            )
            if counts[i]
            else []
        )
    cursor = [0] * n_fleets
    items: List[ScheduledEvent] = []
    for at_s, i in arrivals:
        ev = payloads[i][cursor[i]]
        cursor[i] += 1
        # The payload's trace-time t is the simulator's exponential walk;
        # rewrite it to the scheduled arrival so the one timeline in the
        # file is the one the executor fires on.
        ev = ev.model_copy(update={"t": round(at_s, 6)})
        items.append(ScheduledEvent(round(at_s, 6), fleet_ids[i], ev))
    return specs, items


# -- the JSONL wire format ---------------------------------------------------
#
# A superset of the gateway trace (gateway.traces): spec lines identical,
# event lines additionally carry "at_s". The closed-loop replayers parse
# these files unchanged (read_gateway_trace ignores unknown keys), so one
# committed capture serves both the open-loop harness and a deterministic
# sequential replay.


def write_openloop_trace(
    path, specs: Dict[str, dict], items: List[ScheduledEvent]
) -> None:
    """Write the schedule; spec lines first, then events in fire order."""
    with open(Path(path), "w") as f:
        for fleet_id, spec in specs.items():
            f.write(json.dumps({"fleet": fleet_id, "synthetic": spec}) + "\n")
        for at_s, fleet_id, ev in items:
            data = ev.model_dump(exclude_defaults=True)
            data["kind"] = ev.kind
            f.write(
                json.dumps(
                    {"fleet": fleet_id, "at_s": at_s, "event": data}
                )
                + "\n"
            )


def read_openloop_trace(
    path,
) -> Tuple[Dict[str, dict], List[ScheduledEvent]]:
    """Load a schedule back; raises on event lines without a timestamp
    (a file without them is a closed-loop gateway trace — replay it with
    ``serve``, not the open-loop executor)."""
    specs: Dict[str, dict] = {}
    items: List[ScheduledEvent] = []
    with open(path, "r") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            data = json.loads(line)
            fleet_id = data.get("fleet")
            if not fleet_id:
                raise ValueError(
                    f"{path}:{lineno}: open-loop trace line without a "
                    "fleet tag"
                )
            if "synthetic" in data:
                specs[fleet_id] = dict(data["synthetic"])
            elif "event" in data:
                if "at_s" not in data:
                    raise ValueError(
                        f"{path}:{lineno}: event line without at_s — this "
                        "is a closed-loop gateway trace, not an open-loop "
                        "schedule"
                    )
                if fleet_id not in specs:
                    raise ValueError(
                        f"{path}:{lineno}: event for undeclared fleet "
                        f"{fleet_id!r}"
                    )
                items.append(
                    ScheduledEvent(
                        float(data["at_s"]),
                        fleet_id,
                        event_from_dict(data["event"]),
                    )
                )
            else:
                raise ValueError(
                    f"{path}:{lineno}: open-loop trace line needs a "
                    "'synthetic' spec or an 'event'"
                )
    return specs, items


def is_openloop_trace(path) -> Optional[bool]:
    """True when the file's first event line carries ``at_s``; False when
    it is a plain (closed-loop) trace; None when it has no event lines."""
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                data = json.loads(line)
            except ValueError:  # dlint: disable=DLP017 format probe: a non-JSON line means "not an open-loop trace", not a fault
                return False
            if "event" in data:
                return "at_s" in data
    return None
