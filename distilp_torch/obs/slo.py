"""Declarative SLOs + multi-window multi-burn-rate alerting + signals.

The Google-SRE alerting recipe, applied to the in-process timelines of
``obs.timeline``: an SLO compiles to an error budget (``1 - objective``),
the timeline supplies the error ratio over each alert window, and an
alert fires only when EVERY window of a rule burns past its threshold at
once — the long window proves the burn is sustained, the short window
proves it is still happening (so a long-resolved incident cannot page at
the tail of a 1 h window). Clearing is hysteretic: every window must
fall below ``clear_factor`` x threshold and STAY there for
``clear_hold_s`` before the alert closes, so flapping load cannot flap
alerts.

Three spec kinds cover the serving tier's objectives:

- ``ratio``      — bad-counter delta / total-counter delta per window
                   (availability = 1 − shed ratio, solver health =
                   escalations / ticks);
- ``threshold``  — fraction of gauge samples past a bound per window
                   (latency tiers on ``last_serve_ms`` / p99 series,
                   iters-to-certify ceilings);
- ``rate_above`` — a counter's per-second rate vs a bound, normalized by
                   it (failure-rate floors with no natural total).

Alert transitions are first-class observability: each open/close is
counted (``slo_alert_opened``/``slo_alert_closed``), flight-recorded
(``kind: "slo_alert"`` records on the recorder's ``slo`` ring) and
emitted as a zero-duration ``sched.alert`` span event — so the alert
trail reconciles against the same black box as every other serving
fault.

``SignalsPayload`` is the autoscaling contract (``GET /signals``):
per-worker queue depth + trend, per-SLO burn rates, and headroom vs the
capacity probe's max-sustainable-eps — versioned and pydantic-schema'd
so a federation tier consumes it unchanged.

Specs are JSON-loadable (``SLOConfig.from_json``); evaluation against a
DUMPED timeline (``SLOEngine.replay`` / ``solver slo``) is a pure
function of (timeline, spec) — byte-deterministic, which is what lets
``make smoke-slo`` pin an exact expected alert sequence.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path
from typing import Dict, List, Literal, Optional

from pydantic import BaseModel, Field, model_validator

from .timeline import Timeline

__all__ = [
    "BurnWindow",
    "AlertRule",
    "SLOSpec",
    "SLOConfig",
    "SLOEngine",
    "WorkerSignal",
    "SLOBurnSignal",
    "SignalsPayload",
    "build_signals",
    "HISTORY_TREND_RULES",
    "evaluate_history",
]

# Queue-depth series convention shared by Gateway.timeline_sample and the
# signals builder (one definition so neither side can drift).
QUEUE_DEPTH_PREFIX = "queue_depth.w"

# Series a fixed-cadence sampler keeps feeding while the process lives —
# safe under a threshold-kind SLO with no staleness horizon. Event-fed
# series (openloop.*, anything per-request) stop getting points when
# traffic stops, which is exactly when a fired alert needs data to close.
_GAUGE_SERIES_PREFIXES = ("lat.", "queue_depth.", "conv.")
_GAUGE_SERIES_EXACT = frozenset({"last_serve_ms", "health", "compile_ms"})


def _looks_like_gauge(series: str) -> bool:
    return series in _GAUGE_SERIES_EXACT or any(
        series.startswith(p) for p in _GAUGE_SERIES_PREFIXES
    )
# Trend window for /signals' queue-depth slope, seconds.
SIGNAL_TREND_WINDOW_S = 30.0


class BurnWindow(BaseModel):
    """One window of a multi-window rule: alert pressure exists when the
    measured burn rate over ``window_s`` is >= ``burn_rate`` (burn rate =
    error ratio / error budget, so 1.0 burns the budget exactly at the
    objective's horizon)."""

    window_s: float = Field(gt=0)
    burn_rate: float = Field(gt=0)


class AlertRule(BaseModel):
    """A severity tier: fires when ALL windows burn at once; clears with
    hysteresis (every window below ``clear_factor`` x its threshold for
    ``clear_hold_s`` of consecutive evaluations)."""

    severity: str = "page"
    windows: List[BurnWindow] = Field(min_length=1)
    clear_factor: float = Field(default=0.9, gt=0, le=1.0)
    clear_hold_s: float = Field(default=0.0, ge=0)


def default_alert_rules() -> List[AlertRule]:
    """The Google-SRE default ladder: 14.4x over (1h AND 5m) pages —
    2% of a 30-day budget in an hour; 6x over (6h AND 30m) warns."""
    return [
        AlertRule(
            severity="page",
            windows=[
                BurnWindow(window_s=3600, burn_rate=14.4),
                BurnWindow(window_s=300, burn_rate=14.4),
            ],
        ),
        AlertRule(
            severity="warn",
            windows=[
                BurnWindow(window_s=21600, burn_rate=6.0),
                BurnWindow(window_s=1800, burn_rate=6.0),
            ],
        ),
    ]


class SLOSpec(BaseModel):
    """One declarative objective over timeline series (see module doc)."""

    name: str
    kind: Literal["ratio", "threshold", "rate_above"]
    objective: float = Field(gt=0, lt=1)
    description: str = ""
    # ratio:
    bad_series: Optional[str] = None
    total_series: Optional[str] = None
    # threshold (gauge) / rate_above (counter):
    series: Optional[str] = None
    threshold: Optional[float] = None
    # Staleness horizon for EVENT-FED series (e.g. openloop.latency_ms,
    # which only gets a point per completed event): once the newest
    # sample of the spec's series is older than this, the window is
    # treated as KNOWN-IDLE — error ratio 0.0 instead of None — so the
    # alert's hysteretic close can actually run. Without it a
    # threshold-kind alert over an event feed holds its window-slid
    # "insufficient data" state FOREVER once traffic stops.
    # Continuously-sampled gauge series (lat.*.p99_ms, queue_depth.*)
    # never go stale while the sampler lives, so they don't need this; the validator below steers
    # threshold specs toward them when no horizon is given.
    stale_after_s: Optional[float] = Field(default=None, gt=0)
    alerts: List[AlertRule] = Field(default_factory=default_alert_rules)

    @model_validator(mode="after")
    def _check_kind_fields(self) -> "SLOSpec":
        if self.kind == "ratio":
            if not (self.bad_series and self.total_series):
                raise ValueError(
                    f"SLO {self.name!r}: kind=ratio needs bad_series and "
                    "total_series"
                )
        else:
            if not self.series or self.threshold is None:
                raise ValueError(
                    f"SLO {self.name!r}: kind={self.kind} needs series "
                    "and threshold"
                )
            if (
                self.kind == "threshold"
                and self.stale_after_s is None
                and not _looks_like_gauge(self.series)
            ):
                import warnings

                warnings.warn(
                    f"SLO {self.name!r}: threshold over {self.series!r} "
                    "looks event-fed — once the alert window slides past "
                    "the last point the state machine holds (an open "
                    "alert can never close). Use a continuously-sampled "
                    "gauge series (lat.*.p99_ms, queue_depth.*) or set "
                    "stale_after_s so an idle feed reads as error 0.",
                    stacklevel=2,
                )
        return self

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def error_ratio(
        self, timeline: Timeline, window_s: float, now: Optional[float]
    ) -> Optional[float]:
        """The windowed error ratio in [0, 1]; None = insufficient data
        (which neither fires nor clears — the state machine holds)."""
        if self.kind == "ratio":
            return timeline.ratio(
                self.bad_series, self.total_series, window_s, now
            )
        if self.kind == "threshold":
            frac = timeline.frac_above(
                self.series, self.threshold, window_s, now
            )
            if frac is None:
                return self._stale_zero(timeline, now)
            return frac
        rate = timeline.rate(self.series, window_s, now)
        if rate is None:
            return self._stale_zero(timeline, now)
        # rate_above: normalize the counter's per-second rate by the
        # bound so "budget's worth of badness" keeps one meaning across
        # kinds (rate == threshold -> ratio == budget -> burn == 1).
        return min(1.0, (rate / self.threshold) * self.budget)

    def _stale_zero(
        self, timeline: Timeline, now: Optional[float]
    ) -> Optional[float]:
        """None → 0.0 when the spec's event-fed series went KNOWN-idle:
        the series has recorded at least one point, its newest point is
        older than ``stale_after_s``, and the caller gave a horizon. An
        idle event feed burns nothing (budgets are request-weighted), so
        the windowed None must become a closeable zero — otherwise the
        window slides past the last point and the alert holds open
        forever. A series that never recorded stays None: a sampler that
        never came up is missing data, not idleness."""
        if self.stale_after_s is None or now is None:
            return None
        latest = timeline.latest(self.series)
        if latest is None:
            return None
        if now - latest[0] >= self.stale_after_s:
            return 0.0
        return None

    def burn_rate(
        self, timeline: Timeline, window_s: float, now: Optional[float]
    ) -> Optional[float]:
        ratio = self.error_ratio(timeline, window_s, now)
        if ratio is None:
            return None
        return ratio / self.budget


class SLOConfig(BaseModel):
    """A JSON-loadable set of SLOs (the ``--slo <spec.json>`` payload)."""

    slos: List[SLOSpec] = Field(min_length=1)

    @classmethod
    def from_json(cls, path) -> "SLOConfig":
        return cls.model_validate(
            json.loads(Path(path).read_text(encoding="utf-8"))
        )

    def to_json(self) -> str:
        return json.dumps(self.model_dump(), indent=2, sort_keys=True) + "\n"


class _RuleState:
    """Per (slo, rule) alert state machine (engine-internal)."""

    __slots__ = ("firing", "since", "below_since")

    def __init__(self) -> None:
        self.firing = False
        self.since: Optional[float] = None
        self.below_since: Optional[float] = None


class SLOEngine:
    """Evaluates an ``SLOConfig`` against a timeline; owns alert state.

    Live mode: ``evaluate(now)`` rides the timeline sampler's
    ``on_sample`` hook (no thread of its own). Offline mode:
    ``replay(step_s)`` walks a dumped timeline's own clock — a pure
    function of (timeline, spec, step), which is what the deterministic
    smoke pins.
    """

    def __init__(
        self,
        config: SLOConfig,
        timeline: Timeline,
        metrics=None,
        tracer=None,
        flight=None,
        flight_key: str = "slo",
        events_capacity: int = 4096,
    ):
        self.config = config
        self.timeline = timeline
        self.metrics = metrics
        self.tracer = tracer
        self.flight = flight
        self.flight_key = flight_key
        self._states: Dict[tuple, _RuleState] = {
            (slo.name, rule.severity): _RuleState()
            for slo in config.slos
            for rule in slo.alerts
        }
        # Bounded like every other obs trail (timeline rings, flight
        # rings): a long-lived daemon under flapping load must not grow
        # the transition list — and every GET /slo payload — forever.
        # Oldest transitions fall off; record-by-record reconciliation
        # against counters therefore assumes the audited run fits the
        # capacity (size it to the window, same rule as the flight ring).
        from collections import deque

        self.events: "deque[dict]" = deque(maxlen=max(1, events_capacity))

    # -- evaluation --------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass; returns the transitions it caused."""
        if now is None:
            bounds = self.timeline.bounds()
            if bounds is None:
                return []
            now = bounds[1]
        out: List[dict] = []
        for slo in self.config.slos:
            burns = {
                w.window_s: slo.burn_rate(self.timeline, w.window_s, now)
                for rule in slo.alerts
                for w in rule.windows
            }
            for rule in slo.alerts:
                state = self._states[(slo.name, rule.severity)]
                rule_burns = [burns[w.window_s] for w in rule.windows]
                all_over = all(
                    b is not None and b >= w.burn_rate
                    for b, w in zip(rule_burns, rule.windows)
                )
                all_clear = all(
                    b is not None and b < w.burn_rate * rule.clear_factor
                    for b, w in zip(rule_burns, rule.windows)
                )
                if not state.firing:
                    state.below_since = None
                    if all_over:
                        state.firing = True
                        state.since = now
                        out.append(
                            self._transition(
                                "open", slo, rule, now, rule_burns
                            )
                        )
                    continue
                # Firing: hysteresis — clear only after every window sat
                # below clear_factor x threshold for clear_hold_s. A
                # window with insufficient data holds the state (neither
                # direction), so a sampler gap cannot silently close an
                # incident.
                if not all_clear:
                    state.below_since = None
                    continue
                if state.below_since is None:
                    state.below_since = now
                if now - state.below_since >= rule.clear_hold_s:
                    state.firing = False
                    state.since = None
                    state.below_since = None
                    out.append(
                        self._transition("close", slo, rule, now, rule_burns)
                    )
        return out

    def _transition(
        self, kind: str, slo: SLOSpec, rule: AlertRule, now: float, burns
    ) -> dict:
        event = {
            "kind": "slo_alert",
            "state": kind,  # "open" | "close"
            "slo": slo.name,
            "severity": rule.severity,
            "t": round(now, 6),
            "windows_s": [w.window_s for w in rule.windows],
            "burn": {
                f"{w.window_s:g}s": (None if b is None else round(b, 4))
                for w, b in zip(rule.windows, burns)
            },
        }
        self.events.append(event)
        if self.metrics is not None:
            self.metrics.inc(
                "slo_alert_opened" if kind == "open" else "slo_alert_closed"
            )
        if self.flight is not None:
            self.flight.record(self.flight_key, dict(event))
        if self.tracer is not None and getattr(self.tracer, "enabled", False):
            from .trace import now_ms

            t = now_ms()
            self.tracer.record_span(
                "sched.alert",
                t,
                t,
                attrs={
                    "slo": slo.name,
                    "severity": rule.severity,
                    "state": kind,
                },
            )
        return event

    # -- views -------------------------------------------------------------

    def status(self, now: Optional[float] = None) -> dict:
        """The ``GET /slo`` payload: per-SLO budget, per-window burn
        rates, and the live alert states."""
        if now is None:
            bounds = self.timeline.bounds()
            now = bounds[1] if bounds else None
        slos = []
        for slo in self.config.slos:
            rules = []
            for rule in slo.alerts:
                state = self._states[(slo.name, rule.severity)]
                rules.append(
                    {
                        "severity": rule.severity,
                        "firing": state.firing,
                        "since": state.since,
                        "windows": [
                            {
                                "window_s": w.window_s,
                                "threshold": w.burn_rate,
                                "burn": (
                                    None
                                    if now is None
                                    else slo.burn_rate(
                                        self.timeline, w.window_s, now
                                    )
                                ),
                            }
                            for w in rule.windows
                        ],
                    }
                )
            slos.append(
                {
                    "name": slo.name,
                    "kind": slo.kind,
                    "objective": slo.objective,
                    "budget": slo.budget,
                    "description": slo.description,
                    "alerts": rules,
                }
            )
        return {
            "now": now,
            "slos": slos,
            "alerts_open": sum(
                1 for s in self._states.values() if s.firing
            ),
            "events": list(self.events),
        }

    def firing(self) -> List[dict]:
        return [
            {"slo": name, "severity": sev, "since": st.since}
            for (name, sev), st in sorted(self._states.items())
            if st.firing
        ]

    # -- offline replay ----------------------------------------------------

    def replay(self, step_s: float) -> List[dict]:
        """Walk the timeline's own clock from oldest to newest sample in
        ``step_s`` increments, evaluating at each step. Pure function of
        (timeline, config, step_s): same inputs, same transition list —
        the property ``make smoke-slo`` gates on."""
        if step_s <= 0:
            raise ValueError("replay step must be > 0")
        bounds = self.timeline.bounds()
        if bounds is None:
            return []
        t0, t1 = bounds
        out: List[dict] = []
        steps = int((t1 - t0) / step_s) + 1
        for i in range(steps + 1):
            now = min(t0 + i * step_s, t1)
            out.extend(self.evaluate(now))
            if now >= t1:
                break
        return out


# -- the autoscaling signal surface (GET /signals) ---------------------------


class WorkerSignal(BaseModel):
    """One solve worker's admission-side state."""

    worker: int
    queue_depth: float
    # Least-squares depth slope over the trend window; None until two
    # samples exist. Positive and sustained = the worker is losing.
    queue_depth_trend_per_s: Optional[float] = None


class SLOBurnSignal(BaseModel):
    """One SLO's live burn rates (window -> burn; None = no data yet)."""

    slo: str
    budget: float
    burn: Dict[str, Optional[float]]
    firing: List[str]  # severities currently firing


class CombineSignal(BaseModel):
    """The cross-shard solve combiner's live state (distilp_torch.combine):
    lifetime batch counters plus bucket occupancy — the signal that says
    whether combined dispatches are actually filling their buckets (a
    padding_waste_mean near 1 or occupancy_mean near 1 means the bucket
    policy is mis-sized for the traffic)."""

    batches: int = 0
    instances: int = 0
    flush_full: int = 0
    flush_deadline: int = 0
    errors: int = 0
    pending: int = 0
    buckets: int = 0
    occupancy_mean: Optional[float] = None
    padding_waste_mean: Optional[float] = None


class SignalsPayload(BaseModel):
    """The versioned autoscaling contract.

    Consumers (a federation tier) must key on ``version``
    and validate against THIS schema; new fields are additive, breaking
    changes bump the version. ``headroom_eps`` is the one-number answer:
    how much more offered load fits before the capacity probe's
    max-sustainable rate — negative means shed territory.
    """

    version: Literal[1] = 1
    t: Optional[float] = None
    workers: List[WorkerSignal] = Field(default_factory=list)
    queue_depth_total: float = 0.0
    slos: List[SLOBurnSignal] = Field(default_factory=list)
    alerts_open: int = 0
    # Offered/served rate observed on the timeline (events/second).
    recent_eps: Optional[float] = None
    shed_eps: Optional[float] = None
    # From the closed-loop capacity probe (bench/serve config).
    max_sustainable_eps: Optional[float] = None
    headroom_eps: Optional[float] = None
    # From the memory ledger (obs.memory, serve --memory-ledger): budget
    # minus host RSS, bytes. Additive (None without a ledger or budget),
    # so version stays 1 — old consumers ignore it, the federation tier
    # scales on it the same way it scales on headroom_eps.
    mem_headroom_bytes: Optional[float] = None
    # Cross-shard solve combiner state. Additive (None when the gateway
    # runs per-shard), same versioning argument as mem_headroom_bytes.
    combine: Optional[CombineSignal] = None
    # Crash-recovery posture (Gateway.recovery_status()): crash/respawn/
    # quarantine counters, events replayed vs lost, MTTR quantiles.
    # Additive (None unless the gateway supervises a process tier); the
    # controller's quarantine vote keys on workers_quarantined here.
    recovery: Optional[dict] = None


def build_signals(
    timeline: Timeline,
    engine: Optional[SLOEngine] = None,
    capacity_eps: Optional[float] = None,
    now: Optional[float] = None,
    rate_window_s: float = 30.0,
    combine: Optional[dict] = None,
    recovery: Optional[dict] = None,
) -> SignalsPayload:
    """Assemble the ``/signals`` payload from a timeline (+ optional SLO
    engine and capacity estimate). Pure read — safe on any thread."""
    if now is None:
        bounds = timeline.bounds()
        now = bounds[1] if bounds else None
    workers: List[WorkerSignal] = []
    total_depth = 0.0
    for name in timeline.names():
        if not name.startswith(QUEUE_DEPTH_PREFIX):
            continue
        suffix = name[len(QUEUE_DEPTH_PREFIX):]
        if not suffix.isdigit():
            continue
        if now is None:
            latest = timeline.latest(name)
            depth = latest[1] if latest else 0.0
        else:
            # Point-in-time read: live callers pass now == the newest
            # sample (same answer as latest); an offline controller
            # replay passes a historical t and must not see the future.
            at = timeline.value_at(name, now)
            depth = at if at is not None else 0.0
        total_depth += depth
        workers.append(
            WorkerSignal(
                worker=int(suffix),
                queue_depth=depth,
                queue_depth_trend_per_s=(
                    None
                    if now is None
                    else timeline.trend_per_s(
                        name, SIGNAL_TREND_WINDOW_S, now
                    )
                ),
            )
        )
    workers.sort(key=lambda w: w.worker)
    slos: List[SLOBurnSignal] = []
    alerts_open = 0
    if engine is not None:
        for slo in engine.config.slos:
            windows = sorted(
                {w.window_s for rule in slo.alerts for w in rule.windows}
            )
            firing = [
                sev
                for (name, sev), st in engine._states.items()
                if name == slo.name and st.firing
            ]
            alerts_open += len(firing)
            slos.append(
                SLOBurnSignal(
                    slo=slo.name,
                    budget=slo.budget,
                    burn={
                        f"{w:g}s": (
                            None
                            if now is None
                            else slo.burn_rate(engine.timeline, w, now)
                        )
                        for w in windows
                    },
                    firing=sorted(firing),
                )
            )
    recent = (
        None
        if now is None
        else timeline.rate("c.gateway_events", rate_window_s, now)
    )
    shed = (
        None
        if now is None
        else timeline.rate("c.events_shed", rate_window_s, now)
    )
    headroom = None
    if capacity_eps is not None and recent is not None:
        headroom = capacity_eps - recent
    # Memory headroom rides the same payload when a memory ledger is
    # live: the scale-up signal (headroom_eps says "can take more load",
    # mem_headroom_bytes says "has the memory to take it on").
    from . import memory as _memory

    mled = _memory.current()
    mem_headroom = mled.headroom_bytes() if mled is not None else None
    return SignalsPayload(
        t=now,
        workers=workers,
        queue_depth_total=total_depth,
        slos=slos,
        alerts_open=alerts_open,
        recent_eps=recent,
        shed_eps=shed,
        max_sustainable_eps=capacity_eps,
        headroom_eps=headroom,
        mem_headroom_bytes=mem_headroom,
        combine=CombineSignal(**combine) if combine is not None else None,
        recovery=dict(recovery) if recovery is not None else None,
    )


# -- bench-history trend rules (solver slo --history) ------------------------

# (key, direction, tolerance): the newest committed bench round's value
# may not regress more than `tolerance` against the MEDIAN of the prior
# rounds. Mirrors bench.py's --against gate set, but across the whole
# committed history instead of one reference capture — the machine-
# readable version of "read BENCH_HISTORY.jsonl before trusting a trend".
HISTORY_TREND_RULES = (
    ("value", "lower", 0.25),
    ("warm_tick_ms", "lower", 0.25),
    ("gateway_events_per_sec_100f_4w", "higher", 0.25),
    ("overload_max_sustainable_eps", "higher", 0.25),
    ("spec_hit_rate", "higher", 0.25),
    ("obs_overhead_pct", "lower", None),  # reported only, never gated
    ("slo_overhead_pct", "lower", None),
)


def evaluate_history(rows: List[dict], rules=HISTORY_TREND_RULES):
    """Trend verdicts over BENCH_HISTORY.jsonl rows (oldest first).

    Returns ``(table_rows, violations)``: one table row per rule with the
    prior-median and newest value, and a violation string per gated rule
    whose newest value regressed past its tolerance. Wall-clock keys are
    box-sensitive (the history spans capture machines), so tolerances
    here are looser than --against's same-box gate — this is a trend
    check, not a perf gate.
    """
    table: List[dict] = []
    violations: List[str] = []
    for key, direction, tol in rules:
        vals = [
            r[key] for r in rows if isinstance(r.get(key), (int, float))
        ]
        if len(vals) < 2:
            table.append(
                {"key": key, "n": len(vals), "median": None,
                 "latest": vals[-1] if vals else None, "change": None}
            )
            continue
        median = statistics.median(vals[:-1])
        latest = vals[-1]
        change = (latest - median) / abs(median) if median else None
        table.append(
            {"key": key, "n": len(vals), "median": median,
             "latest": latest, "change": change}
        )
        if tol is None or change is None:
            continue
        regressed = change > tol if direction == "lower" else change < -tol
        if regressed:
            violations.append(
                f"{key}: latest {latest:g} vs prior median {median:g} "
                f"({change:+.1%}, {direction}-is-better, tol {tol:.0%})"
            )
    return table, violations
