"""Seeded fault injection + the chaos-replay harness for the scheduler.

A *fault plan* is a composable list of fault specs — solver exceptions,
solve-latency spikes (which overrun a configured deadline), NaN/Inf
poisoning of device/model coefficients, malformed or contradictory churn
events, and device-dropout bursts — each active on an explicit tick list or
as a seeded per-tick Bernoulli draw inside a window. Everything is
deterministic: the schedule for (plan, tick) comes from
``np.random.default_rng([seed, spec_index, tick])``, so the injected fault
sequence is a pure function of the plan, independent of call order, and two
replays of the same trace under the same plan inject — and, faults being
the only nondeterminism, serve — exactly the same things.

``chaos_replay`` drives a (fault-hardened) ``Scheduler`` through a trace
under a plan: solver-channel faults fire inside the solve attempt via the
scheduler's ``fault_hook`` seam, event-channel faults are injected as extra
churn events the quarantine gate must reject, and dropout bursts
leave/rejoin real devices through the normal event path. After the trace it
keeps ticking clean events until the scheduler reports healthy (bounded),
then ``ChaosReport.violations()`` checks the soak contract:

- every tick (faulted or not) served a structurally valid placement;
- every poisoned/malformed injected event was quarantined — the fleet
  state never absorbed a poison, and the counters account for each one;
- the service returned to ``healthy`` within the recovery budget.

``make smoke-chaos`` runs exactly this over the bundled churn trace.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Literal, NamedTuple, Optional, Sequence, Tuple

import numpy as np
from pydantic import BaseModel, Field

from .events import DeviceDegrade, DeviceJoin, DeviceLeave, LoadTick
from .metrics import HEALTH_HEALTHY

FAULT_KINDS = (
    "solver_exception",
    "latency_spike",
    "nan_poison",
    "malformed_event",
    "dropout_burst",
    "child_kill",
    "rpc_torn",
    "rpc_delay",
)

# Fault channels that fire inside the solve attempt (via fault_hook) vs
# ones injected as churn events ahead of the trace event vs ones aimed at
# the PROCESS boundary (SIGKILL, torn RPC frames, RPC delay) through the
# gateway's ``chaos_process_hook`` — only meaningful against a
# process-backed worker tier, rejected otherwise.
SOLVER_CHANNEL = frozenset({"solver_exception", "latency_spike"})
EVENT_CHANNEL = frozenset({"nan_poison", "malformed_event", "dropout_burst"})
PROCESS_CHANNEL = frozenset({"child_kill", "rpc_torn", "rpc_delay"})


class InjectedSolverFault(RuntimeError):
    """The exception the injector raises inside a solve attempt."""


class FaultSpec(BaseModel):
    """One composable fault source.

    Active on ``at_ticks`` when given, else as a Bernoulli(``p``) draw per
    tick inside ``[start, end)`` (``end=None`` = unbounded). The remaining
    fields parameterize individual kinds and are ignored by the others.
    """

    kind: Literal[
        "solver_exception",
        "latency_spike",
        "nan_poison",
        "malformed_event",
        "dropout_burst",
        "child_kill",
        "rpc_torn",
        "rpc_delay",
    ]
    at_ticks: Optional[List[int]] = None
    p: float = 0.0
    start: int = 0
    end: Optional[int] = None
    # latency_spike: seconds slept inside the solve attempt.
    spike_s: float = 0.05
    # solver_exception / latency_spike: fire on the first attempt only, so
    # a retry ladder can save the tick (False = every attempt fails).
    transient: bool = False
    # dropout_burst: devices dropped at once, and ticks until they rejoin.
    burst_size: int = 1
    rejoin_after: int = 2
    # rpc_delay: seconds the owning worker stalls its next RPC dispatch.
    delay_s: float = 0.05


class FaultPlan(BaseModel):
    """A seed plus the fault specs composed over one replay."""

    seed: int = 0
    faults: List[FaultSpec] = Field(default_factory=list)

    @classmethod
    def from_json(cls, path) -> "FaultPlan":
        return cls.model_validate(json.loads(Path(path).read_text()))

    def empty(self) -> bool:
        return not self.faults


class FaultInjector:
    """Deterministic executor of one ``FaultPlan`` over one replay.

    ``metrics`` (a ``SchedulerMetrics``) receives ``fault_injected_<kind>``
    on every scheduled fault and ``fault_fired_<kind>`` each time a
    solver-channel fault actually fires inside an attempt (a non-transient
    exception fires once per retry attempt; an armed fault on a
    breaker-skipped tick never fires at all). ``self.counters`` mirrors
    both without needing a metrics sink.
    """

    def __init__(self, plan: FaultPlan, metrics=None):
        self.plan = plan
        self.metrics = metrics
        self.counters: Dict[str, int] = defaultdict(int)
        self._armed: List[FaultSpec] = []
        self._tick = -1
        # tick -> device profiles due to rejoin (dropout bursts).
        self._rejoins: Dict[int, list] = {}

    # -- the deterministic schedule ---------------------------------------

    def _rng(self, spec_idx: int, tick: int) -> np.random.Generator:
        return np.random.default_rng([self.plan.seed, spec_idx, tick])

    def faults_at(self, tick: int) -> List[Tuple[int, FaultSpec]]:
        """(spec_index, spec) pairs active at this tick — pure in (plan,
        tick), so any replay of the plan sees the identical schedule."""
        out: List[Tuple[int, FaultSpec]] = []
        for i, spec in enumerate(self.plan.faults):
            if spec.at_ticks is not None:
                if tick in spec.at_ticks:
                    out.append((i, spec))
            elif (
                spec.p > 0.0
                and tick >= spec.start
                and (spec.end is None or tick < spec.end)
                and self._rng(i, tick).random() < spec.p
            ):
                out.append((i, spec))
        return out

    def schedule(self, n_ticks: int) -> List[Tuple[int, str]]:
        """The full (tick, kind) schedule over a replay of ``n_ticks`` —
        the object the determinism tests compare across injectors."""
        return [
            (t, spec.kind)
            for t in range(n_ticks)
            for _, spec in self.faults_at(t)
        ]

    # -- solver channel (scheduler.fault_hook) ----------------------------

    def arm(self, tick: int, specs: Sequence[Tuple[int, FaultSpec]]) -> None:
        """Install this tick's solver-channel faults; event-channel specs
        are ignored here (they go through ``event_faults``)."""
        self._tick = tick
        self._armed = [s for _, s in specs if s.kind in SOLVER_CHANNEL]
        for spec in self._armed:
            self._count("injected", spec.kind)

    def disarm(self) -> None:
        self._armed = []

    def solver_hook(self, attempt: int) -> None:
        """The scheduler's pre-attempt seam: sleep spikes, raise exceptions."""
        for spec in self._armed:
            if spec.transient and attempt > 0:
                continue
            if spec.kind == "latency_spike":
                self._count("fired", spec.kind)
                time.sleep(spec.spike_s)
            else:
                self._count("fired", spec.kind)
                raise InjectedSolverFault(
                    f"injected solver exception (tick {self._tick}, "
                    f"attempt {attempt})"
                )

    # -- event channel ----------------------------------------------------

    def event_faults(self, tick: int, specs, fleet) -> List[Tuple[str, object]]:
        """(label, event) pairs to push through ``scheduler.handle`` ahead
        of the trace event: poisoned profiles, malformed/contradictory
        events, and dropout-burst leaves. ``fleet`` is the scheduler's live
        ``FleetState`` (read-only here: victims must exist *now*)."""
        out: List[Tuple[str, object]] = []
        for idx, spec in specs:
            if spec.kind not in EVENT_CHANNEL:
                continue
            rng = self._rng(idx, tick)
            if spec.kind == "nan_poison":
                out.append(("nan_poison", self._poison_event(rng, tick, fleet)))
                self._count("injected", spec.kind)
            elif spec.kind == "malformed_event":
                out.append(
                    ("malformed_event", self._malformed_event(rng, tick, fleet))
                )
                self._count("injected", spec.kind)
            elif spec.kind == "dropout_burst":
                leaves = self._burst_events(rng, tick, spec, fleet)
                out.extend(("dropout_burst", ev) for ev in leaves)
                if leaves:
                    self._count("injected", spec.kind)
        return out

    # -- process channel (gateway.chaos_process_hook) ---------------------

    def process_faults(self, tick: int, specs) -> List[Tuple[int, FaultSpec]]:
        """The process-channel specs active this tick, counted as
        injected; ``chaos_replay`` fires each through the gateway's
        process hook (SIGKILL, torn frame, RPC delay)."""
        out = [(i, s) for i, s in specs if s.kind in PROCESS_CHANNEL]
        for _, spec in out:
            self._count("injected", spec.kind)
        return out

    def count_fired(self, kind: str) -> None:
        """Record that a process-channel fault actually fired (the hook
        returned — the kill/torn-frame/delay landed on the child)."""
        self._count("fired", kind)

    def pop_rejoins(self, tick: int) -> list:
        """Device profiles due to rejoin at (or before) this tick."""
        due = []
        for t in sorted(self._rejoins):
            if t <= tick:
                due.extend(self._rejoins.pop(t))
        return due

    def pending_rejoins(self) -> int:
        return sum(len(v) for v in self._rejoins.values())

    def _victims(self, fleet, rng, count: int = 1) -> List[str]:
        """Non-head live devices, never shrinking the fleet below 2."""
        names = list(fleet.devices)
        pool = names[1:]  # head is names[0] by the _ensure_head invariant
        count = min(count, len(pool), max(0, len(names) - 2))
        if count <= 0 or not pool:
            return []
        picks = rng.choice(len(pool), size=count, replace=False)
        return [pool[int(i)] for i in picks]

    def _poison_event(self, rng, tick: int, fleet):
        """A NaN/Inf-poisoned churn event the quarantine gate must reject."""
        victims = self._victims(fleet, rng)
        flavor = int(rng.integers(0, 2)) if victims else 1
        if flavor == 0 and victims:
            # Coefficient poisoning of a live device: NaN would flow
            # straight into build_coeffs' t_comm channel if accepted.
            return DeviceDegrade(name=victims[0], t_comm_scale=float("nan"))
        # A joining device advertising an infinite throughput scalar.
        src = next(iter(fleet.devices.values()))
        dev = src.model_copy(deep=True)
        dev.name = f"poison-{self.plan.seed}-{tick}"
        dev.is_head = False
        dev.T_cpu = float("inf")
        return DeviceJoin(device=dev)

    def _malformed_event(self, rng, tick: int, fleet):
        """A structurally contradictory event (strict apply must reject)."""
        flavor = int(rng.integers(0, 3))
        if flavor == 0:
            return DeviceLeave(name=f"ghost-{self.plan.seed}-{tick}")
        if flavor == 1:
            # Duplicate join: a name already live in the fleet.
            src = next(iter(fleet.devices.values()))
            return DeviceJoin(device=src.model_copy(deep=True))
        victims = self._victims(fleet, rng)
        name = victims[0] if victims else next(iter(fleet.devices))
        return DeviceDegrade(name=name, t_comm_scale=-1.0)  # contradictory

    def _burst_events(self, rng, tick: int, spec: FaultSpec, fleet) -> list:
        """Leave events for a dropout burst; victims rejoin (same profile)
        ``rejoin_after`` ticks later via ``pop_rejoins``."""
        victims = self._victims(fleet, rng, count=spec.burst_size)
        if not victims:
            return []
        saved = []
        for name in victims:
            dev = fleet.devices[name].model_copy(deep=True)
            dev.is_head = False
            saved.append(dev)
        self._rejoins.setdefault(tick + spec.rejoin_after, []).extend(saved)
        return [DeviceLeave(name=n) for n in victims]

    def _count(self, phase: str, kind: str) -> None:
        self.counters[f"{phase}_{kind}"] += 1
        if phase == "injected":
            self.counters["injected_total"] += 1
        # hasattr, not None-check: a process-backed shard's facade hands
        # a read-only _MetricsView (child-side counters over RPC) with no
        # inc(); the injector's own self.counters still mirror everything.
        if self.metrics is not None and hasattr(self.metrics, "inc"):
            self.metrics.inc(f"fault_{phase}_{kind}")
            if phase == "injected":
                self.metrics.inc("faults_injected_total")


# -- the chaos soak --------------------------------------------------------


class ChaosRecord(NamedTuple):
    """One handled event during a chaos replay."""

    tick: int  # trace tick the event belongs to (recovery ticks continue)
    source: str  # 'trace' | 'injected:<kind>' | 'recovery'
    kind: str  # event kind handled
    quarantined: bool  # the event did not advance the fleet seq
    view: object  # the PlacementView served after the event
    ms: float
    L: int = 0  # the model's layer count in force when the view was served
    # Fleet-seq advance across the handle: 1 = applied exactly once, 0 =
    # quarantined, >1 = DOUBLE-APPLIED (a crash-recovery replay applied
    # the event on top of the dead child's application — the exactly-once
    # contract's per-record reconciliation key).
    seq_delta: int = 1


class ChaosReport(NamedTuple):
    """What a chaos replay did, plus the soak-contract checker."""

    records: List[ChaosRecord]
    views: list  # one served view per TRACE event (the replay contract)
    injected: Dict[str, int]  # injector counters (injected_*/fired_*)
    ticks_to_healthy: Optional[int]  # clean ticks until healthy (0 = already)
    final_health: str
    metrics: dict  # scheduler metrics snapshot at the end
    # The supervision tier's audit at soak end (Gateway.recovery_status,
    # via chaos_replay's recovery_probe) — None on a soak that injected
    # no process faults / ran without a supervised gateway. Feeds the
    # crash-contract section of violations().
    recovery: Optional[dict] = None

    def summary(self) -> dict:
        out = {
            "events": len(self.views),
            "handled": len(self.records),
            "injected": {
                k: v for k, v in sorted(self.injected.items())
                if k.startswith("injected_")
            },
            "quarantined": sum(1 for r in self.records if r.quarantined),
            "ticks_to_healthy": self.ticks_to_healthy,
            "final_health": self.final_health,
        }
        if self.recovery is not None:
            out["recovery"] = {
                k: self.recovery.get(k)
                for k in (
                    "worker_crashes",
                    "child_respawns",
                    "workers_quarantined",
                    "shards_recovered",
                    "events_replayed",
                    "events_lost",
                    "warm_resumes",
                    "cold_resumes",
                    "identity_resumes",
                    "mttr_p50_ms",
                    "mttr_p99_ms",
                )
                if k in self.recovery
            }
        return out

    def violations(self, L: Optional[int] = None) -> List[str]:
        """Soak-contract violations (empty = the chaos soak passed).

        ``L`` is a fallback for records captured before the per-record
        layer count existed; each record carries the model L in force when
        its view was served, so a trace with a ``model_swap`` checks every
        placement against the right architecture. A STALE view (a served
        last-known-good from before a swap) is checked for internal
        consistency only — it was checked against its own L when fresh.
        """
        out: List[str] = []
        for r in self.records:
            res = r.view.result
            want_L = r.L or L
            bad = (
                res.k < 1
                or len(res.w) != len(res.n)
                or any(w < 0 for w in res.w)
            )
            if (
                not bad
                and want_L
                and r.view.events_behind == 0
                and sum(res.w) * res.k != want_L
            ):
                bad = True
            if bad:
                out.append(
                    f"tick {r.tick} ({r.source}): structurally invalid "
                    f"placement k={res.k} w={res.w}"
                )
        must_quarantine = ("injected:nan_poison", "injected:malformed_event")
        for r in self.records:
            if r.source in must_quarantine and not r.quarantined:
                out.append(
                    f"tick {r.tick}: {r.source} event was ACCEPTED into the "
                    "fleet state instead of quarantined"
                )
        # Quarantine accounting: every quarantined record (injected
        # poison/malformed, plus collateral — e.g. a trace event naming a
        # device a dropout burst currently has out of the fleet) must be
        # counted, and nothing counted that the records cannot explain.
        counters = self.metrics.get("counters", {})
        expect_q = sum(1 for r in self.records if r.quarantined)
        got_q = counters.get("events_quarantined", 0)
        if got_q != expect_q:
            out.append(
                f"quarantine accounting: {expect_q} handled events were "
                f"quarantined but events_quarantined={got_q}"
            )
        injected_q = self.injected.get("injected_nan_poison", 0) + (
            self.injected.get("injected_malformed_event", 0)
        )
        if got_q < injected_q:
            out.append(
                f"quarantine accounting: {injected_q} poisoned/malformed "
                f"events injected but only {got_q} quarantined"
            )
        # Speculation accounting (active only when the scheduler ran with
        # --speculate): every bank probe was counted exactly once (hit or
        # miss) on a non-quarantined handle, every mode='spec' serve in
        # the records maps to a counted hit, and no hit exists without a
        # banked entry to have come from (a presolved instance or a real
        # solved tick). A drifting reconciliation here means served
        # placements and counters disagree about what speculation did.
        spec_hits = counters.get("spec_hit", 0)
        spec_probes = spec_hits + counters.get("spec_miss", 0)
        if spec_probes or counters.get("spec_presolve", 0):
            non_q = sum(1 for r in self.records if not r.quarantined)
            if spec_probes > non_q:
                out.append(
                    f"speculation accounting: {spec_probes} bank probes "
                    f"counted but only {non_q} non-quarantined events "
                    "were handled"
                )
            spec_served = sum(
                1
                for r in self.records
                # Re-serves of an older spec-published view must not
                # count: a quarantined event re-serves latest() with the
                # mode it was published under, and a FAILED solve does
                # the same with the fleet seq already advanced — only a
                # fresh serve (events_behind == 0, event accepted) is a
                # hit the counter should match.
                if not r.quarantined
                and getattr(r.view, "mode", None) == "spec"
                and getattr(r.view, "events_behind", 1) == 0
            )
            if counters.get("risk_eval", 0) == 0 and spec_served != spec_hits:
                out.append(
                    f"speculation accounting: {spec_served} mode='spec' "
                    f"serves in the records but spec_hit={spec_hits}"
                )
            solved = sum(
                counters.get(f"tick_{m}", 0)
                for m in ("cold", "warm", "margin")
            )
            # NOT `hits <= presolves + solved`: one banked entry serves
            # arbitrarily many hits (an oscillating trace re-hits the same
            # entry every cycle — the probe never consumes it). The sound
            # invariant is existential: a hit needs the bank to have been
            # populated by SOMETHING, a presolve or a banked solved tick.
            if spec_hits and not (
                counters.get("spec_presolve", 0) or solved
            ):
                out.append(
                    f"speculation accounting: spec_hit={spec_hits} but "
                    "nothing was ever banked (no presolves, no solved "
                    "ticks)"
                )
        # Admission-control accounting: a sequential soak drives one event
        # at a time, so the bounded-queue gate can never legitimately fire
        # (depth is always 0 at ingest) and coalescing can never fold
        # events (each tick completes before the next is submitted). A
        # nonzero shed or coalesce counter here means the serving path
        # rejected or folded trace events it had no overload reason to —
        # the same "counters must be explained by records" contract the
        # quarantine accounting enforces. The record-by-record shed
        # reconciliation under REAL overload (counter vs per-fleet flight
        # records) lives in traffic.shed_violations, which the overload
        # smoke and bench run.
        for c_name in ("events_shed", "events_coalesced"):
            stray = counters.get(c_name, 0)
            if stray:
                out.append(
                    f"admission accounting: {c_name}={stray} in a "
                    "sequential chaos soak (nothing was concurrently "
                    "queued, so nothing could be shed or coalesced)"
                )
        # Crash contract (process-level chaos against a supervised
        # gateway): every accepted event applied exactly once or shed,
        # respawns restore WARM, every crash actually recovered, and the
        # reconciliation the recovery tier reports agrees with the
        # record-by-record seq deltas above.
        if self.recovery is not None:
            rec = self.recovery
            lost = rec.get("events_lost", 0)
            if lost:
                out.append(
                    f"crash recovery: events_lost={lost} (every accepted "
                    "event must be applied exactly once or shed; positive "
                    "= lost, negative = double-applied)"
                )
            dbl = sum(
                1 for r in self.records
                if getattr(r, "seq_delta", 1) > 1
            )
            if dbl:
                out.append(
                    f"crash recovery: {dbl} record(s) advanced the fleet "
                    "seq more than once (a recovery replay re-applied an "
                    "event the dead child had already applied)"
                )
            cold = rec.get("cold_resumes", 0)
            if cold:
                out.append(
                    f"crash recovery: cold_resumes={cold} (a respawned "
                    "shard must restore WARM from its micro-snapshot — "
                    "zero post-recovery cold ticks)"
                )
            crashes = rec.get("worker_crashes", 0)
            recovered = rec.get("child_respawns", 0) + rec.get(
                "workers_quarantined", 0
            )
            if crashes and not recovered:
                out.append(
                    f"crash recovery: {crashes} worker crash(es) but "
                    "nothing respawned or quarantined"
                )
            shards = rec.get("shards_recovered", 0)
            warm = rec.get("warm_resumes", 0)
            # A first post-restore tick that changed identity (structural
            # event replayed first) proves nothing about warmth and
            # legitimately counts as neither warm nor cold. The resume
            # tally is checked one-sided: resume classifications from an
            # epoch BETWEEN two crashes are lost whenever no micro-
            # snapshot captured them before the next kill (the fold
            # carries the last snapshot's counters; events still
            # reconcile because WAL replay re-applies the tail), so
            # equality would flake on kill timing. More resumes than
            # recoveries, or none at all, cannot be explained that way.
            ident = rec.get("identity_resumes", 0)
            if warm + ident > shards:
                out.append(
                    f"crash recovery: warm_resumes={warm} + "
                    f"identity_resumes={ident} exceeds "
                    f"{shards} shard recover(ies) "
                    "(a restored shard resumed more than once)"
                )
            if shards and warm + ident == 0:
                out.append(
                    f"crash recovery: {shards} shard recover(ies) but no "
                    "resume was ever observed (restored shards never "
                    "proved warm — warm_resumes and "
                    "resume_identity_changed both zero)"
                )
        if self.ticks_to_healthy is None:
            out.append(
                f"service did not return to healthy (final state: "
                f"{self.final_health})"
            )
        elif self.final_health != HEALTH_HEALTHY:
            # Recovered mid-replay but re-degraded before the end (e.g. a
            # rejoin flushed during recovery failed its solve): 'returned
            # to healthy' means ENDED healthy, not touched it once.
            out.append(
                f"service re-degraded after recovering (final state: "
                f"{self.final_health})"
            )
        return out


def chaos_replay(
    scheduler,
    events: Sequence,
    plan: FaultPlan,
    recovery_tick_budget: int = 25,
    on_event=None,
    process_hook=None,
    recovery_probe=None,
) -> ChaosReport:
    """Drive a scheduler through a trace under a fault plan, then recover.

    Trace events are handled in order; each tick first fires the tick's
    PROCESS-channel faults through ``process_hook`` (SIGKILL the owning
    child, tear an RPC frame, delay the next RPC — only meaningful when
    the scheduler fronts a supervised process-backed gateway, see
    ``Gateway.chaos_process_hook``), then flushes due dropout-burst
    rejoins, injects the tick's event-channel faults (which the
    quarantine gate must reject), arms the solver-channel faults on the
    scheduler's ``fault_hook``, and finally handles the real trace event.
    After the trace, clean no-op load ticks run until the scheduler
    reports healthy, bounded by ``recovery_tick_budget``.

    ``recovery_probe`` (e.g. ``Gateway.recovery_status``) is called once
    at soak end; its dict rides the report as ``.recovery`` and arms the
    crash-contract section of ``violations()``.

    ``on_event(event, view, ms)`` fires for every handled event (the serve
    CLI's log hook). The scheduler's ``fault_hook`` is overwritten for the
    duration and cleared afterwards.
    """
    injector = FaultInjector(plan, metrics=scheduler.metrics)
    scheduler.fault_hook = injector.solver_hook
    records: List[ChaosRecord] = []
    trace_views = []

    def _fleet_seq() -> int:
        # getattr with a default also absorbs an AttributeError raised
        # INSIDE a facade's ``fleet`` property (factory-built schedulers
        # may expose no fleet); seq 0 then disables seq reconciliation
        # for that record rather than killing the soak.
        fleet = getattr(scheduler, "fleet", None)
        return getattr(fleet, "seq", 0) if fleet is not None else 0

    def _fleet_L() -> int:
        # Defensive: a factory-built scheduler (stub harnesses) may carry
        # no model; the per-record L then falls back to violations(L=...).
        fleet = getattr(scheduler, "fleet", None)
        return getattr(getattr(fleet, "model", None), "L", 0) or 0

    def _handle(ev, tick: int, source: str):
        seq_before = _fleet_seq()
        t0 = time.perf_counter()
        view = scheduler.handle(ev)
        ms = (time.perf_counter() - t0) * 1e3
        delta = _fleet_seq() - seq_before
        records.append(
            ChaosRecord(
                tick=tick,
                source=source,
                kind=getattr(ev, "kind", type(ev).__name__),
                quarantined=delta == 0,
                view=view,
                ms=ms,
                L=_fleet_L(),
                seq_delta=delta,
            )
        )
        if on_event is not None:
            on_event(ev, view, ms)
        return view

    try:
        for tick, ev in enumerate(events):
            # Arm FIRST: everything handled during this tick — rejoins,
            # injected events, the trace event — runs under this tick's
            # solver-channel faults, and nothing leaks from the previous
            # tick's arming.
            specs = injector.faults_at(tick)
            injector.arm(tick, specs)
            procs = injector.process_faults(tick, specs)
            if procs and process_hook is None:
                raise ValueError(
                    f"fault plan schedules process fault "
                    f"{procs[0][1].kind!r} at tick {tick} but no "
                    "process_hook was provided (process faults need a "
                    "supervised process-backed gateway)"
                )
            for _idx, spec in procs:
                # Fire BEFORE the tick's handles: the kill/torn frame
                # lands mid-stream and the very next dispatch walks into
                # the dead child — the recovery path under test.
                process_hook(spec.kind, spec)
                injector.count_fired(spec.kind)
            for dev in injector.pop_rejoins(tick):
                _handle(DeviceJoin(device=dev), tick, "injected:rejoin")
            for label, bad in injector.event_faults(tick, specs, scheduler.fleet):
                _handle(bad, tick, f"injected:{label}")
            trace_views.append(_handle(ev, tick, "trace"))
        injector.disarm()

        # Recovery: clean ticks (rejoins first, then a no-op drift tick)
        # until the health state machine closes the loop. The exit test is
        # the LIVE health, not the first-healthy marker: a rejoin flushed
        # here can re-degrade the service, and 'returned to healthy' means
        # ENDED healthy within the budget.
        ticks_to_healthy: Optional[int] = (
            0 if scheduler.health == HEALTH_HEALTHY else None
        )
        tick = len(events)
        for i in range(recovery_tick_budget):
            if (
                scheduler.health == HEALTH_HEALTHY
                and not injector.pending_rejoins()
            ):
                break
            for dev in injector.pop_rejoins(tick + i):
                _handle(DeviceJoin(device=dev), tick + i, "injected:rejoin")
            _handle(LoadTick(t_comm_jitter={}), tick + i, "recovery")
            if (
                ticks_to_healthy is None
                and scheduler.health == HEALTH_HEALTHY
            ):
                ticks_to_healthy = i + 1
    finally:
        scheduler.fault_hook = None

    return ChaosReport(
        records=records,
        views=trace_views,
        injected=dict(injector.counters),
        ticks_to_healthy=ticks_to_healthy,
        final_health=scheduler.health,
        metrics=scheduler.metrics_snapshot(),
        recovery=dict(recovery_probe()) if recovery_probe is not None else None,
    )
