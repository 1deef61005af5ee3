"""The closed-loop autoscaler: signals in, typed actions out.

Two halves, one brain:

- ``Controller`` is the brain — ``decide(signals, now, n_workers)`` is
  deterministic: the same signal sequence through the same policy
  produces the same action sequence, byte for byte. No clock reads, no
  randomness, no I/O. That determinism is what makes the closed-loop
  contract PINNABLE offline: ``Controller.replay(timeline, policy)``
  walks a dumped timeline exactly like ``SLOEngine.replay`` walks it
  (same step loop, same bounds clamp) and reproduces the live decision
  trail without spawning a process — the ``make smoke-autoscale``
  fixture is that replay's committed output.
- ``ControlLoop`` is the hands — a sampler-shaped thread (``stop()``
  idempotent, gateway ``close()`` stops it before the workers) that
  feeds the live ``/signals`` payload to the same ``decide`` and
  actuates each action on the gateway: spawn/retire process workers
  (ring rebalance migrates shards live), flip forced-degrade admission,
  set ``spec_k``. Every action is counted in ``METRIC_REGISTRY`` and
  flight-recorded on the ``control`` ring WITH the signals snapshot
  that justified it, so the trail reconciles record-by-record against
  counters and against the offline replay.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..obs.slo import SLOEngine, SignalsPayload, build_signals
from ..obs.timeline import Timeline
from .policy import Action, ControlPolicy

# Counter name per action kind — exact METRIC_REGISTRY entries (DLP019).
_KIND_COUNTERS = {
    "scale_out": "control_scale_out",
    "scale_in": "control_scale_in",
    "degrade_on": "control_degrade_on",
    "degrade_off": "control_degrade_off",
    "spec_k": "control_spec_k",
}


class Controller:
    """Pure decision core. State (cooldown clock, calm timer, lever
    positions) lives here and advances only through ``decide`` — single
    writer by contract: the live loop's thread or the replay loop, never
    both on one instance."""

    def __init__(self, policy: ControlPolicy):
        self.policy = policy
        self._last_scale_t: Optional[float] = None
        self._calm_since: Optional[float] = None
        self._degraded = False
        self._spec_k_low = False
        self._holds = 0  # decisions suppressed by cooldown/band edges
        # High-water mark of signals.recovery["workers_quarantined"]:
        # the quarantine vote fires on the INCREASE (a breaker newly
        # opened), not on the standing count — cumulative counters would
        # otherwise re-vote every tick until max_workers.
        self._quarantined_seen = 0

    # -- the decision function --------------------------------------------

    def decide(
        self, signals: SignalsPayload, now: float, n_workers: int
    ) -> List[Action]:
        p = self.policy
        acts: List[Action] = []
        page_open = any("page" in s.firing for s in signals.slos)

        # Degrade lever first: it is instant and reversible, the bridge
        # that keeps serving degraded-but-certified placements while a
        # spawned worker warms.
        if p.degrade_on_page:
            if page_open and not self._degraded:
                self._degraded = True
                acts.append(
                    Action(
                        t=now, kind="degrade_on", reason="page alert open"
                    )
                )
            elif not page_open and self._degraded:
                self._degraded = False
                acts.append(
                    Action(
                        t=now,
                        kind="degrade_off",
                        reason="page alerts clear",
                    )
                )

        # Scale-out: any vote trips (hysteresis is asymmetric on
        # purpose — adding capacity late is an outage, removing it late
        # is a small bill).
        votes: List[str] = []
        if p.scale_out_on_page and page_open:
            votes.append("page alert open")
        if (
            p.headroom_min_frac is not None
            and signals.headroom_eps is not None
            and signals.max_sustainable_eps
        ):
            floor = p.headroom_min_frac * signals.max_sustainable_eps
            if signals.headroom_eps < floor:
                votes.append(
                    f"headroom {signals.headroom_eps:.1f} eps below "
                    f"{floor:.1f} eps floor"
                )
        if p.depth_high_per_worker is not None and n_workers > 0:
            per = signals.queue_depth_total / n_workers
            if per >= p.depth_high_per_worker:
                votes.append(
                    f"queue depth {per:.1f}/worker at or above "
                    f"{p.depth_high_per_worker:g}"
                )
        if p.trend_up_per_s is not None and any(
            w.queue_depth_trend_per_s is not None
            and w.queue_depth_trend_per_s >= p.trend_up_per_s
            for w in signals.workers
        ):
            votes.append("queue depth trending up")
        if p.scale_out_on_quarantine and signals.recovery is not None:
            q = int(signals.recovery.get("workers_quarantined", 0) or 0)
            if q > self._quarantined_seen:
                votes.append(
                    f"crash-loop breaker quarantined "
                    f"{q - self._quarantined_seen} worker(s)"
                )
            self._quarantined_seen = max(self._quarantined_seen, q)

        cooled = (
            self._last_scale_t is None
            or (now - self._last_scale_t) >= p.scale_cooldown_s
        )
        if votes:
            self._calm_since = None
            if n_workers < p.max_workers and cooled:
                self._last_scale_t = now
                acts.append(
                    Action(
                        t=now,
                        kind="scale_out",
                        target_workers=n_workers + 1,
                        reason="; ".join(votes),
                    )
                )
            else:
                self._holds += 1
        else:
            # Scale-in: EVERY calm condition, held for calm_hold_s.
            calm = (
                signals.alerts_open == 0
                and signals.queue_depth_total <= p.depth_low_total
                and (
                    signals.headroom_eps is None
                    or not signals.max_sustainable_eps
                    or signals.headroom_eps
                    >= p.headroom_scale_in_frac
                    * signals.max_sustainable_eps
                )
            )
            if calm and n_workers > p.min_workers:
                if self._calm_since is None:
                    self._calm_since = now
                elif (now - self._calm_since) >= p.calm_hold_s:
                    if cooled:
                        self._last_scale_t = now
                        self._calm_since = None
                        acts.append(
                            Action(
                                t=now,
                                kind="scale_in",
                                target_workers=n_workers - 1,
                                reason=(
                                    f"calm held {p.calm_hold_s:g}s "
                                    "(no alerts, queue drained, "
                                    "headroom recovered)"
                                ),
                            )
                        )
                    else:
                        self._holds += 1
            elif not calm:
                self._calm_since = None

        # spec_k memory lever: shrink the speculation bank under memory
        # squeeze, restore when headroom recovers.
        if (
            p.mem_low_bytes is not None
            and signals.mem_headroom_bytes is not None
        ):
            if (
                signals.mem_headroom_bytes < p.mem_low_bytes
                and not self._spec_k_low
            ):
                self._spec_k_low = True
                acts.append(
                    Action(
                        t=now,
                        kind="spec_k",
                        spec_k=p.spec_k_low,
                        reason=(
                            f"mem headroom "
                            f"{signals.mem_headroom_bytes:.0f}B below "
                            f"{p.mem_low_bytes:.0f}B floor"
                        ),
                    )
                )
            elif (
                signals.mem_headroom_bytes >= p.mem_low_bytes
                and self._spec_k_low
                and p.spec_k_normal is not None
            ):
                self._spec_k_low = False
                acts.append(
                    Action(
                        t=now,
                        kind="spec_k",
                        spec_k=p.spec_k_normal,
                        reason="mem headroom recovered",
                    )
                )
        return acts

    # -- decision accounting (live loop + harness share this) --------------

    def step(
        self,
        signals: SignalsPayload,
        now: float,
        n_workers: int,
        metrics=None,
        flight=None,
    ) -> List[Action]:
        """``decide`` + the accounting contract: every action counted
        (``control_actions`` + its per-kind counter) and flight-recorded
        on the ``control`` ring with the signals snapshot that justified
        it — the record the reconciliation audits."""
        holds_before = self._holds
        actions = self.decide(signals, now, n_workers)
        if metrics is not None:
            held = self._holds - holds_before
            for _ in range(held):
                metrics.inc("control_hold")
            for a in actions:
                metrics.inc("control_actions")
                metrics.inc(_KIND_COUNTERS[a.kind])
        if flight is not None:
            for a in actions:
                flight.record(
                    "control",
                    {
                        "t": now,
                        "action": a.model_dump(),
                        "signals": signals.model_dump(),
                    },
                )
        return actions

    # -- offline replay ----------------------------------------------------

    @classmethod
    def replay(
        cls,
        timeline: Timeline,
        policy: ControlPolicy,
        slo_config=None,
        step_s: float = 0.5,
        capacity_eps: Optional[float] = None,
        n_workers: Optional[int] = None,
    ) -> List[Action]:
        """Pure function of (timeline, policy, slo spec, step): walk the
        dumped timeline's own clock exactly like ``SLOEngine.replay``
        (same step loop, same bounds clamp), feeding the point-in-time
        ``/signals`` payload at each step into a fresh controller. Worker
        count starts from the timeline's ``queue_depth.w*`` series count
        (override via ``n_workers``) and then follows the replayed scale
        actions — the simulated fleet the decisions would have produced.
        No process is spawned, no clock is read: same inputs, same
        actions, byte for byte."""
        if step_s <= 0:
            raise ValueError("replay step must be > 0")
        engine = (
            SLOEngine(slo_config, timeline)
            if slo_config is not None
            else None
        )
        ctl = cls(policy)
        bounds = timeline.bounds()
        if bounds is None:
            return []
        t0, t1 = bounds
        if n_workers is None:
            prefix = "queue_depth.w"
            n_workers = sum(
                1
                for name in timeline.names()
                if name.startswith(prefix)
                and name[len(prefix):].isdigit()
            ) or 1
        n = max(1, int(n_workers))
        out: List[Action] = []
        steps = int((t1 - t0) / step_s) + 1
        for i in range(steps + 1):
            now = min(t0 + i * step_s, t1)
            if engine is not None:
                engine.evaluate(now)
            sig = build_signals(
                timeline,
                engine=engine,
                capacity_eps=capacity_eps,
                now=now,
            )
            for a in ctl.decide(sig, now=now, n_workers=n):
                if a.kind in ("scale_out", "scale_in"):
                    n = int(a.target_workers)
                out.append(a)
            if now >= t1:
                break
        return out


class ControlLoop:
    """The actuation thread: sampler-shaped (``stop()`` idempotent, the
    gateway stops it with the samplers, BEFORE the workers — an
    actuation mid-close must never land on a stopping worker)."""

    def __init__(
        self,
        gateway,
        controller: Controller,
        period_s: float = 0.25,
        clock=time.monotonic,
    ):
        self.gateway = gateway
        self.controller = controller
        self.period_s = period_s
        self.clock = clock
        self.actions: List[Action] = []  # the live trail, arrival order
        self.errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ControlLoop":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="control-loop"
        )
        self._thread.start()
        return self

    def stop(self, join: bool = True, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and join:
            t.join(timeout=timeout)

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.step()
            except Exception:
                # A failed control tick must not kill the loop: the
                # fleet keeps serving on its current topology and the
                # failure is visible in counters.
                self.errors += 1
                self.gateway.metrics.inc("control_errors")

    def step(self, now: Optional[float] = None) -> List[Action]:
        """One control tick: read signals, decide, actuate, account."""
        gw = self.gateway
        if gw.timeline is None:
            return []
        if now is None:
            now = self.clock()
        sig = build_signals(
            gw.timeline,
            engine=gw.slo_engine,
            capacity_eps=gw.capacity_eps,
            combine=None,
            now=now,
        )
        n_live = len(gw.live_workers())
        actions = self.controller.step(
            sig, now=now, n_workers=n_live, metrics=gw.metrics,
            flight=gw.flight,
        )
        for a in actions:
            self._actuate(a)
        self.actions.extend(actions)
        if gw.timeline is not None:
            gw.timeline.record(
                "control.workers", now, float(len(gw.live_workers()))
            )
        return actions

    def _actuate(self, action: Action) -> None:
        gw = self.gateway
        if action.kind == "scale_out":
            gw.spawn_worker()
        elif action.kind == "scale_in":
            gw.retire_worker()
        elif action.kind == "degrade_on":
            gw.force_degrade(True)
        elif action.kind == "degrade_off":
            gw.force_degrade(False)
        elif action.kind == "spec_k":
            gw.set_spec_k(int(action.spec_k))
