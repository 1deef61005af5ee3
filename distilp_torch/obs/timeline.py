"""In-process metrics timelines: bounded time series over the live sinks.

Counters answer "how many, ever"; window histograms answer "how slow,
recently"; neither answers the SLO question "is the burn rate over the
last five minutes 14x the budget?" — that needs HISTORY. This module is
the history: a fixed-cadence sampler (one daemon thread) snapshots the
serving tier's own sinks (``Scheduler.timeline_sample`` /
``Gateway.timeline_sample`` — counters, latency quantiles, per-worker
queue depths, conv_* digests) into bounded per-series rings of
``(t, value)`` points, and rates / ratios / window fractions derive from
the deltas between points — no external scrape infrastructure, no second
metrics system, exactly the flight-recorder philosophy applied to time
series.

Semantics worth knowing:

- **Counters vs gauges are a read-side decision.** The timeline stores
  raw samples; ``delta``/``rate``/``ratio`` treat a series as cumulative
  (first-to-last difference over the window), ``frac_above``/``latest``
  treat it as a gauge. The SLO layer (``obs.slo``) picks per spec.
- **Windows are measured, not assumed.** ``rate()`` divides by the
  actual elapsed time between the two samples it used, so a late sampler
  tick degrades resolution, never correctness.
- **Dump/load is JSONL** like the flight recorder: a header line, then
  one ``{"t", "s", "v"}`` object per point, oldest first per series —
  ``slo --timeline`` replays a dumped run's alert evaluation offline,
  byte-deterministically.

Everything here is stdlib-only and opt-in: a gateway or scheduler with no
sampler attached runs the exact pre-timeline code path. Ported from
``distilp_tpu/obs/timeline.py``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.lockwatch import make_lock

__all__ = [
    "Timeline",
    "TimelineSampler",
    "flatten_metrics_snapshot",
    "synthesize_overload_timeline",
]


class Timeline:
    """Bounded per-series rings of ``(t, value)`` samples.

    ``capacity`` bounds EACH series (oldest falls off); timestamps are
    caller-supplied seconds on one monotonic clock (the sampler uses
    ``time.monotonic``). All reads/writes hold one lock — points land
    from the sampler thread and the open-loop executor while the SLO
    engine reads windows.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 2:
            # One point cannot form a delta; a timeline that can never
            # answer rate() is a misconfiguration, not a small buffer.
            raise ValueError("timeline capacity must be >= 2")
        self.capacity = capacity
        self._series: Dict[str, deque] = {}  # guarded-by: self._lock
        self._lock = make_lock("timeline.series")

    # -- the write side ----------------------------------------------------

    def record(self, name: str, t: float, value: float) -> None:
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                ring = self._series[name] = deque(maxlen=self.capacity)
            ring.append((float(t), float(value)))

    def record_many(self, t: float, values: Dict[str, float]) -> None:
        """One sampler tick: every series gets a point at the same t."""
        with self._lock:
            for name, value in values.items():
                ring = self._series.get(name)
                if ring is None:
                    ring = self._series[name] = deque(maxlen=self.capacity)
                ring.append((float(t), float(value)))

    # -- the read side -----------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, name: str) -> List[Tuple[float, float]]:
        with self._lock:
            ring = self._series.get(name)
            return list(ring) if ring is not None else []

    def latest(self, name: str) -> Optional[Tuple[float, float]]:
        with self._lock:
            ring = self._series.get(name)
            return ring[-1] if ring else None

    def value_at(self, name: str, t: float) -> Optional[float]:
        """The last recorded value at or before ``t`` (None when no
        sample that old exists). On a live timeline ``value_at(now)`` IS
        ``latest``; on a dumped capture it is the point-in-time read that
        keeps an offline replay (SLO engine, controller) honest — a
        replayed decision at t must not see a sample from t+30."""
        with self._lock:
            ring = self._series.get(name)
            if not ring:
                return None
            out = None
            for pt, pv in ring:
                if pt > t:
                    break
                out = pv
            return out

    def bounds(self) -> Optional[Tuple[float, float]]:
        """(oldest, newest) timestamp across every series; None if empty.

        The offline replay clock (``SLOEngine.replay``) walks this range.
        """
        lo = hi = None
        with self._lock:
            for ring in self._series.values():
                if not ring:
                    continue
                if lo is None or ring[0][0] < lo:
                    lo = ring[0][0]
                if hi is None or ring[-1][0] > hi:
                    hi = ring[-1][0]
        return None if lo is None else (lo, hi)

    def window(
        self, name: str, window_s: float, now: Optional[float] = None
    ) -> List[Tuple[float, float]]:
        """Samples of ``name`` with t in ``[now - window_s, now]``."""
        pts = self.series(name)
        if not pts:
            return []
        if now is None:
            now = pts[-1][0]
        t0 = now - window_s
        return [p for p in pts if t0 <= p[0] <= now]

    def _window_with_baseline(
        self, name: str, window_s: float, now: Optional[float]
    ):
        """(baseline_point, in-window points) for counter reads.

        The baseline is the last sample AT OR BEFORE the window start
        (Prometheus increase() semantics): a counter jump that landed
        between a stale pre-window sample and the first in-window one is
        attributed to the window — the only honest choice when the
        sampler itself was delayed by the very overload it is measuring
        (a blocked sampler tick behind a cold solve must not blind the
        alert to the burst it missed the edge of)."""
        pts = self.series(name)
        if not pts:
            return None, []
        if now is None:
            now = pts[-1][0]
        t0 = now - window_s
        baseline = None
        inside = []
        for p in pts:
            if p[0] < t0:
                baseline = p
            elif p[0] <= now:
                inside.append(p)
        return baseline, inside

    def delta(
        self, name: str, window_s: float, now: Optional[float] = None
    ) -> Optional[float]:
        """Counter delta over the window: newest in-window value minus
        the baseline (last sample at or before the window start; falls
        back to the oldest in-window sample). None without a baseline
        pair — no baseline means no honest delta, and the SLO layer
        treats that as "insufficient data", never as zero."""
        baseline, inside = self._window_with_baseline(name, window_s, now)
        if not inside:
            return None
        if baseline is not None:
            return inside[-1][1] - baseline[1]
        if len(inside) < 2:
            return None
        return inside[-1][1] - inside[0][1]

    def rate(
        self, name: str, window_s: float, now: Optional[float] = None
    ) -> Optional[float]:
        """Counter rate per second over the window, using the MEASURED
        elapsed time between the samples the delta came from (a stale
        baseline spreads the jump over the real gap, so a late sampler
        degrades resolution, never inflates the rate)."""
        baseline, inside = self._window_with_baseline(name, window_s, now)
        if not inside:
            return None
        first = baseline if baseline is not None else (
            inside[0] if len(inside) >= 2 else None
        )
        if first is None:
            return None
        elapsed = inside[-1][0] - first[0]
        if elapsed <= 0:
            return None
        return (inside[-1][1] - first[1]) / elapsed

    def ratio(
        self,
        bad: str,
        total: str,
        window_s: float,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """bad-delta / total-delta over one shared window (the SLO error
        ratio). None when either delta is unknown (insufficient samples
        — the alert state machine holds). A window with samples but NO
        events is ratio 0.0: the budget is request-weighted, so an idle
        recovery window burns nothing — which is exactly what lets a
        flood's alert clear once the burst slides out of the window.
        (A fully-shedding service is NOT idle here: sheds are events,
        so size ``total`` as offered = accepted + shed.)"""
        db = self.delta(bad, window_s, now)
        dt = self.delta(total, window_s, now)
        if db is None or dt is None:
            return None
        if dt <= 0:
            return 0.0 if db <= 0 else 1.0
        return max(0.0, min(1.0, db / dt))

    def frac_above(
        self,
        name: str,
        threshold: float,
        window_s: float,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Gauge view: the fraction of in-window samples exceeding
        ``threshold`` (the latency-tier SLO's error ratio)."""
        pts = self.window(name, window_s, now)
        if not pts:
            return None
        return sum(1 for _, v in pts if v > threshold) / len(pts)

    def trend_per_s(
        self, name: str, window_s: float, now: Optional[float] = None
    ) -> Optional[float]:
        """Least-squares slope (units/second) over the window — the
        queue-depth trend the ``/signals`` autoscaling payload carries."""
        pts = self.window(name, window_s, now)
        if len(pts) < 2:
            return None
        n = len(pts)
        mt = sum(t for t, _ in pts) / n
        mv = sum(v for _, v in pts) / n
        den = sum((t - mt) ** 2 for t, _ in pts)
        if den <= 0:
            return None
        num = sum((t - mt) * (v - mv) for t, v in pts)
        return num / den

    # -- persistence (the flight-recorder JSONL convention) ----------------

    def to_jsonl(self) -> str:
        """Header line + one point per line, series in sorted order and
        points oldest-first — byte-stable for a given timeline state, so
        the committed fixture pins regeneration exactly."""
        with self._lock:
            header = {
                "timeline": 1,
                "capacity": self.capacity,
                "series": len(self._series),
            }
            lines = [json.dumps(header, sort_keys=True)]
            # Full float precision on purpose: JSON floats round-trip
            # bit-exactly, so a loaded timeline replays IDENTICALLY to
            # the one that was dumped (rounding t would shift window
            # membership at boundaries and break replay determinism).
            for name in sorted(self._series):
                for t, v in self._series[name]:
                    lines.append(
                        json.dumps({"t": t, "s": name, "v": v}, sort_keys=True)
                    )
        return "\n".join(lines) + "\n"

    def dump(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_jsonl(), encoding="utf-8")
        return path

    @classmethod
    def from_jsonl(cls, text: str) -> "Timeline":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty timeline dump")
        header = json.loads(lines[0])
        if not isinstance(header, dict) or "timeline" not in header:
            raise ValueError("timeline dump missing its header line")
        if header["timeline"] != 1:
            raise ValueError(
                f"unknown timeline dump version {header['timeline']!r}"
            )
        tl = cls(capacity=int(header.get("capacity", 4096)))
        for ln in lines[1:]:
            rec = json.loads(ln)
            tl.record(rec["s"], rec["t"], rec["v"])
        return tl

    @classmethod
    def load(cls, path) -> "Timeline":
        return cls.from_jsonl(Path(path).read_text(encoding="utf-8"))


def flatten_metrics_snapshot(snap: dict, prefix: str = "") -> Dict[str, float]:
    """A ``SchedulerMetrics.snapshot()``-shaped dict as flat timeline
    series: counters as ``c.<name>`` (cumulative), each latency hist as
    ``lat.<name>.{p50_ms,p99_ms,count}`` (quantiles are window gauges,
    count is cumulative). Shared by the scheduler- and gateway-level
    ``timeline_sample`` hooks so series names cannot drift between the
    two serving shapes."""
    out: Dict[str, float] = {}
    for name, value in snap.get("counters", {}).items():
        if isinstance(value, (int, float)):
            out[f"{prefix}c.{name}"] = float(value)
    for name, hist in snap.get("latency", {}).items():
        for key in ("p50_ms", "p99_ms", "count"):
            v = hist.get(key)
            if isinstance(v, (int, float)):
                out[f"{prefix}lat.{name}.{key}"] = float(v)
    return out


def synthesize_overload_timeline(
    duration_s: float = 60.0,
    period_s: float = 0.1,
    burst_start_s: float = 20.0,
    burst_end_s: float = 30.0,
    offered_eps: float = 300.0,
    shed_frac: float = 0.8,
) -> Timeline:
    """A deterministic timeline shaped like a measured overload run:
    steady offered load, a correlated shed burst in the middle
    (queue pinned at the admission depth, p99 blown, escalations
    climbing), then recovery.

    This is the committed-fixture generator behind
    ``tests/traces/slo_timeline_overload.jsonl`` — a pure function of
    its arguments (no clocks, no RNG), pinned byte-exact by the tests
    the same way the traffic captures are, so the offline alert replay
    is reproducible on any box. Series names follow ``Gateway.timeline_sample``'s conventions
    so a spec written against this fixture evaluates unchanged against
    a live gateway's timeline.
    """
    tl = Timeline(capacity=max(2, int(duration_s / period_s) + 1))
    steps = int(duration_s / period_s)
    offered = shed = escal = 0.0
    for i in range(steps + 1):
        t = i * period_s
        in_burst = burst_start_s <= t < burst_end_s
        if i > 0:
            offered += offered_eps * period_s
            shed += (offered_eps * shed_frac * period_s) if in_burst else 0.0
            escal += 2.0 * period_s if in_burst else 0.0
        # p99 spikes during the burst and decays linearly over 5 s after.
        if in_burst:
            p99 = 900.0
        elif burst_end_s <= t < burst_end_s + 5.0:
            p99 = 900.0 - (900.0 - 40.0) * (t - burst_end_s) / 5.0
        else:
            p99 = 40.0
        depth = 8.0 if in_burst else 0.0
        tl.record_many(
            t,
            {
                "c.events_offered": offered,
                "c.events_shed": shed,
                "c.gateway_events": offered - shed,
                "shards.solver_escalations": escal,
                "lat.gateway_event_to_placement.p99_ms": round(p99, 3),
                "queue_depth.w0": depth,
                "queue_depth.w1": depth,
            },
        )
    return tl


class TimelineSampler:
    """Fixed-cadence daemon thread: sample_fn() -> timeline, every tick.

    ``sample_fn`` returns one flat ``{series: value}`` dict (the
    ``timeline_sample`` hooks); ``on_sample(timeline, now)`` runs after
    each recorded tick — the SLO engine's evaluation rides here, so
    alerting needs no thread of its own. Every tick is accounted
    (``timeline_samples`` / ``timeline_sample_error`` on the metrics
    sink) and a failing sample NEVER kills the thread: observability
    outage must be a counted signal, not a silent one.

    ``stop()`` is idempotent and joins the thread — ``Gateway.close()``
    calls it for every attached sampler BEFORE stopping the workers, so
    a sampler mid-probe can never race the teardown.
    """

    def __init__(
        self,
        timeline: Timeline,
        sample_fn: Callable[[], Dict[str, float]],
        period_s: float = 0.1,
        metrics=None,
        on_sample: Optional[Callable[[Timeline, float], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if period_s <= 0:
            raise ValueError("sampler period must be > 0")
        self.timeline = timeline
        self.period_s = period_s
        self._sample_fn = sample_fn
        self._metrics = metrics
        self._on_sample = on_sample
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0
        self.errors = 0

    def sample_once(self, now: Optional[float] = None) -> bool:
        """One sampler tick (also the deterministic-test entry point).
        Returns True when a sample landed, False when it failed."""
        if now is None:
            now = self._clock()
        try:
            values = self._sample_fn()
            self.timeline.record_many(now, values)
        except Exception:
            # Counted, never fatal: the serving path outranks its own
            # observability, and a dead sampler thread would silence the
            # very alerts this layer exists to raise.
            self.errors += 1
            if self._metrics is not None:
                self._metrics.inc("timeline_sample_error")
            return False
        self.samples += 1
        if self._metrics is not None:
            self._metrics.inc("timeline_samples")
        if self._on_sample is not None:
            try:
                self._on_sample(self.timeline, now)
            except Exception:
                self.errors += 1
                if self._metrics is not None:
                    self._metrics.inc("timeline_sample_error")
                return False
        return True

    def start(self) -> "TimelineSampler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="timeline-sampler"
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self.sample_once()

    def stop(self, join: bool = True, timeout: float = 2.0) -> None:
        """Signal and (by default) join; safe to call any number of
        times, from ``Gateway.close()`` or a CLI finally block or both."""
        self._stop.set()
        thread = self._thread
        if join and thread is not None and thread.is_alive():
            thread.join(timeout=timeout)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()
