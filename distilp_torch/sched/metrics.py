"""Scheduler observability: counters + latency histograms, plain dicts out.

One ``SchedulerMetrics`` instance funnels everything: the scheduler counts
events, pool traffic and per-event latency; every pooled
``StreamingReplanner`` reports its tick mode (cold / warm / margin),
certification outcome and fallback-ladder escalations through the same
object (``solver.streaming`` calls ``record_tick`` when a metrics sink is
attached — duck-typed, so the solver package does not import this one).

``snapshot()`` returns nothing but plain ints/floats in dicts — safe to
``json.dumps`` straight into a bench line or a /metrics endpoint.

Thread safety: the gateway tier (``distilp_torch.gateway``) funnels every
shard worker thread into ONE gateway-level sink, and an HTTP ``/metrics``
read can land mid-``observe`` — so ``inc``/``observe``/``snapshot`` (and
the hist's ``record``) hold a lock. Uncontended, that is one
``threading.Lock`` acquire per counter bump (tens of nanoseconds) — noise
next to a solve tick; contended, it is exactly what keeps a concurrent
snapshot from reading a half-updated hist buffer (count bumped, value not
yet appended).
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, List

from ..utils.lockwatch import make_lock

TICK_MODES = ("cold", "warm", "margin")

# Service health, coarsest first. The scheduler owns the transitions
# (scheduler._note_fault / _on_clean_tick); this module owns the vocabulary
# so metrics consumers and the serve CLI agree on the strings.
#
# - ``healthy``  — recent ticks solved fresh, no outstanding faults;
# - ``degraded`` — serving, but on stale/fallback answers (quarantined
#   input, deadline miss, failed or retried solves) until a clean streak
#   clears it;
# - ``broken``   — the circuit breaker is open: solves are suspended and
#   every tick serves the last-known-good placement until the half-open
#   probe succeeds.
HEALTH_HEALTHY = "healthy"
HEALTH_DEGRADED = "degraded"
HEALTH_BROKEN = "broken"
HEALTH_STATES = (HEALTH_HEALTHY, HEALTH_DEGRADED, HEALTH_BROKEN)

# Counter names the fault-hardened serving path increments; listed here so
# dashboards (and the chaos harness's accounting pass) can enumerate them
# without grepping the scheduler. Injection-side ``fault_injected_*`` /
# ``fault_fired_*`` counters come from sched.faults with the kind appended.
FAULT_COUNTERS = (
    "events_quarantined",  # events rejected before touching the fleet
    "quarantine_fleet",  # non-finite fleet state refused a solve
    "deadline_missed",  # solve abandoned at the wall-clock deadline
    "deadline_backlog",  # tick skipped: an abandoned solve still running
    "abandoned_solves_drained",  # overrun solves that finished and were discarded
    "solve_retries",  # retry attempts after a solve exception
    "solve_retry_success",  # ticks saved by a retry
    "breaker_open",  # breaker transitions to open
    "breaker_short_circuit",  # ticks served degraded with the breaker open
    "breaker_half_open_probe",  # probe solves attempted from half-open
    "breaker_close",  # probe succeeded; breaker closed
    "breaker_reopen",  # probe failed; breaker re-opened
    "served_stale",  # views served as mode='stale'
    "served_degraded",  # views served as mode='degraded'
    "health_recovered",  # degraded/broken -> healthy transitions
)

# The ONE enumeration of every metric name the sched/gateway/obs layers
# emit, name -> Prometheus `# HELP` text. Three consumers keep each other
# honest: the Prometheus exposition (obs.export.render_prometheus) takes
# its HELP lines from here, dashboards enumerate from here instead of
# grepping call sites, and dlint DLP019 fails the gate on any
# string-literal ``metrics.inc("...")`` in those layers whose name is NOT
# an exact entry — so a new counter cannot ship without its help text.
# Dynamically composed names (f-strings over event kinds, tick modes,
# fault kinds, worker ids) resolve through METRIC_FAMILIES by longest
# prefix instead; ``registry_help`` is the lookup both exposition and
# tests use.
METRIC_REGISTRY = {
    # -- event routing (scheduler.handle) ---------------------------------
    "events_total": "Events accepted into the fleet state",
    "structural_events": "Accepted events that changed the problem identity",
    "drift_events": "Accepted events that kept the problem identity",
    "events_quarantined": "Events rejected before touching the fleet",
    "quarantine_fleet": "Ticks refused because the fleet state went non-finite",
    "init_solve": "Eventless solves at construction (solve_on_init)",
    # -- tick outcomes (SchedulerMetrics.record_tick + scheduler) ---------
    "tick_cold": "Solver ticks that solved from scratch",
    "tick_warm": "Solver ticks warm-started from the previous placement",
    "tick_margin": "Solver ticks served by the MoE margin fast path",
    "tick_certified": "Ticks whose placement carried an optimality certificate",
    "tick_uncertified": "Ticks whose placement missed its certificate",
    "tick_failed": "Ticks that produced no placement at all",
    "tick_failed_structural": "Failed ticks routed as structural events",
    "tick_failed_drift": "Failed ticks routed as drift events",
    "fallback_escalations": "Certification-ladder escalations across ticks",
    "solver_escalations": "In-solver budget escalations (timings['escalated'])",
    "structural_uncertified": "Structural events whose tick missed its certificate",
    # -- warm pool --------------------------------------------------------
    "pool_hit": "Warm-pool lookups that found a live replanner",
    "pool_miss": "Warm-pool lookups that minted a fresh replanner",
    "pool_evict": "Warm replanners dropped by the LRU bound",
    # -- fault-hardened serving (see FAULT_COUNTERS comments) -------------
    "deadline_missed": "Solves abandoned at the wall-clock deadline",
    "deadline_backlog": "Ticks skipped behind a still-running abandoned solve",
    "abandoned_solves_drained": "Overrun solves that finished and were discarded",
    "solve_retries": "Retry attempts after a failed solve attempt",
    "solve_attempt_failed": "Individual solve attempts that raised",
    "solve_retry_success": "Ticks saved by a retry",
    "breaker_open": "Circuit-breaker transitions to open",
    "breaker_short_circuit": "Ticks served degraded with the breaker open",
    "breaker_half_open_probe": "Probe solves attempted from half-open",
    "breaker_close": "Half-open probes that closed the breaker",
    "breaker_reopen": "Half-open probes that re-opened the breaker",
    "served_stale": "Views re-served as mode='stale'",
    "served_degraded": "Views re-served as mode='degraded'",
    "health_recovered": "degraded/broken -> healthy transitions",
    "faults_injected_total": "Faults injected by the chaos harness (all kinds)",
    # -- risk-aware serving ----------------------------------------------
    "risk_eval": "Ticks that ran the twin's risk-aware candidate scoring",
    "risk_candidates": "Candidates scored by the risk-aware selector",
    "risk_switch": "Ticks that served a candidate over the fresh solve",
    "risk_error": "Risk scorings that failed (fresh solve served instead)",
    "risk_per_k_failed": "Per-k candidate enumerations that failed",
    # -- speculative replanning (sched.forecast + sched.speculate) --------
    "spec_hit": "Ticks served from the speculation bank (pre-solved placement)",
    "spec_miss": "Bank probes that found no matching pre-solved placement",
    "spec_stale": "Bank entries invalidated by a problem-identity change",
    "spec_presolve": "Forecast instances pre-solved into the speculation bank",
    "spec_presolve_failed": "Speculative presolve dispatches that failed",
    # -- admission control / overload (gateway + traffic) -----------------
    "events_shed": "Events rejected at the admission gate (429 + Retry-After)",
    "events_coalesced": "Queued drift events folded into a newer tick's solve",
    "spec_near_hit": "Pressure ticks served a banked near-match (mode='spec_near')",
    "spec_near_miss": "Pressure ticks that found no banked near-match to serve",
    # -- cross-shard solve combiner (distilp_torch.combine) -----------------
    "combine_prepared": "Ticks packed for a cross-shard batched solve",
    "combine_local": "Combine-eligible ticks solved per-shard instead "
    "(structural / MoE / probe / post-restore)",
    "combine_stale": "Combined results discarded: the fleet advanced past "
    "the packed seq before adoption",
    "combine_fallback": "Combined ticks that re-solved per-shard "
    "(uncertified lane or combiner dispatch failure)",
    "combine_batches": "Batched solve dispatches executed by the combiner",
    "combine_instances": "Shard instances solved inside combined batches",
    "combine_flush_full": "Combiner flushes triggered by a full bucket",
    "combine_flush_deadline": "Combiner flushes triggered by the max-wait deadline",
    "combine_bucket_occupancy": "Instances per combined batch (histogram)",
    "combine_padding_waste": "Phantom-device fraction of combined batches "
    "(padded lanes' pad share, histogram)",
    "combine_batch_ms": "Combined batch dispatch latency (pack to decode), ms",
    "combine_static_hit": "Fraction of a combined batch's lanes whose static "
    "half was already device-resident (histogram; 1.0 = zero static bytes "
    "re-shipped)",
    "combine_dispatch_error": "Batched solve dispatches that raised; every "
    "lane fell back to a per-shard solve",
    "drift_tick_combine": "Drift ticks served via a cross-shard batched "
    "solve (mode='combine')",
    # -- snapshot / restore ----------------------------------------------
    "state_restored": "Scheduler warm-state restores (load_state)",
    "warm_resumes": "First post-restore ticks that rode warm (the proof)",
    "cold_resumes": "First post-restore ticks that paid a cold solve",
    "resume_identity_changed": "First post-restore ticks on a changed identity",
    # -- gateway tier -----------------------------------------------------
    "shards_registered": "Shards registered with the gateway",
    "shards_restored": "Shards registered from a snapshot blob",
    "gateway_events": "Events ingested through the gateway",
    "worker_events": "Events routed, by worker (worker label)",
    "worker_queue_depth": "Commands queued on a shard worker, by worker "
    "(gauge; the admission-control input)",
    "snapshots_taken": "Gateway warm-state snapshots taken",
    "worker_exception": "Closures that raised on a shard worker thread",
    "worker_callback_error": "Completion callbacks that raised (dead loop)",
    "prom_scrape_error": "Background Prometheus scrapes that failed",
    "http_client_gone": "HTTP clients gone before request/response finished",
    "http_bad_request": "HTTP 400s (malformed request or body)",
    "http_not_found": "HTTP 404s (unknown route or fleet)",
    "http_conflict": "HTTP 409s (shard exists but nothing servable yet)",
    "http_too_many_requests": "HTTP 429s (queue full; Retry-After returned)",
    "http_internal_error": "HTTP 500s (unexpected server-side failure)",
    # -- dynamic fleet / live migration (gateway) -------------------------
    "workers_spawned": "Workers added live to a dynamic gateway",
    "workers_retired": "Workers drained and stopped live",
    "shards_migrated": "Shards moved between workers (warm, zero cold ticks)",
    "migration_parked": "Events parked during a migration flip and replayed "
    "onto the destination (none lost, none doubled)",
    "migration_failed": "Migration flips that failed (routing unchanged, "
    "source kept serving)",
    # -- crash-tolerant process tier (gateway supervision) ----------------
    "worker_crashes": "Process-worker child deaths the supervisor classified",
    "child_respawns": "Crashed children respawned (fresh socket, same worker)",
    "shards_recovered": "Shards rebuilt onto a respawned child (warm)",
    "events_replayed": "WAL-tail events replayed during crash recovery",
    "wal_appends": "Accepted events journaled to the per-shard WAL",
    "micro_snapshots": "Per-shard micro-snapshots taken (WAL truncated)",
    "micro_snapshot_failed": "Micro-snapshot attempts that hit a dead child",
    "workers_quarantined": "Workers taken out of the ring by the crash-loop "
    "breaker (slice rebalanced away; surfaced in /signals)",
    "http_worker_crashed": "HTTP 503s (child died mid-request; shard "
    "recovering, Retry-After returned)",
    # -- closed-loop autoscaler (distilp_torch.control) ---------------------
    "control_actions": "Controller actions emitted (all kinds)",
    "control_scale_out": "Scale-out actions (spawn one worker + rebalance)",
    "control_scale_in": "Scale-in actions (retire one worker after drain)",
    "control_degrade_on": "Forced-degrade admissions switched ON",
    "control_degrade_off": "Forced-degrade admissions switched OFF",
    "control_spec_k": "spec_k adaptations applied fleet-wide",
    "control_hold": "Decisions suppressed by cooldown or band edges",
    "control_errors": "Control ticks that raised (loop survived; counted)",
    # -- observability layer ----------------------------------------------
    "flight_dumps": "Flight-recorder post-mortem dumps written",
    "health_state": "Shard health as a gauge (0 healthy, 1 degraded, 2 broken)",
    # -- compile ledger (obs.compile_ledger) ------------------------------
    "compiles": "Kernel builds and graph captures attributed to this "
    "scheduler's ticks",
    "compile_cache_hits": "Kernel builds served by the on-disk library cache",
    "recompile_storms": "Recapture-storm alarms (N same-plan graph captures "
    "in a window)",
    # -- memory ledger (obs.memory) ---------------------------------------
    "mem_samples": "Ticks that recorded a fresh memory-ledger watermark sample",
    "mem_pressure": "Ticks marked under pressure by low memory headroom "
    "(gateway degrade-on-low-headroom)",
    # -- SLO engine / metrics timelines (obs.timeline + obs.slo) ----------
    "timeline_samples": "Timeline sampler ticks that recorded a sample",
    "timeline_sample_error": "Timeline sampler ticks that failed (counted, never fatal)",
    "slo_alert_opened": "SLO burn-rate alerts opened (multi-window AND fired)",
    "slo_alert_closed": "SLO burn-rate alerts closed (hysteresis cleared)",
    # -- latency histograms (exposed as Prometheus summaries, ms) ---------
    "event_to_placement": "Event to published placement, ms (per shard)",
    "structural_tick": "Structural-event tick latency, ms",
    "drift_tick": "Drift-event tick latency, ms",
    "ipm_iters_executed": "LP iterations the tick's solve actually executed",
    "twin_p95": "Twin p95 latency of the served placement, ms",
    "gateway_event_to_placement": "Gateway ingest to placement (queue wait included), ms",
    "spec_hit_ms": "Speculative-hit serve latency (bank probe to publish), ms",
    "recovery_mttr_ms": "Crash detection to shard(s) serving again "
    "(respawn+replay or quarantine+rebalance), ms",
    "spec_presolve_ms": "Speculative presolve batch latency (off the serving path), ms",
    "compile_ms": "Kernel build and graph capture time a tick paid "
    "(ledger-attributed), ms",
    "mem_live_mb": "Megabytes the CUDA caching allocator holds in live "
    "tensors at tick end (memory-ledger watermark; gauge-like, exposed as "
    "a summary)",
    "mem_rss_mb": "Host RSS megabytes at tick end (memory-ledger "
    "watermark; gauge-like, exposed as a summary)",
}

# Longest-prefix fallback for dynamically composed names. Every f-string
# ``inc``/``observe`` site in sched/gateway/obs must be covered by one of
# these (or be an exact entry above).
METRIC_FAMILIES = (
    ("event_", "Accepted events, by event kind"),
    ("quarantine_", "Quarantined events, by event kind"),
    ("structural_tick_", "Structural-event ticks, by tick mode"),
    ("drift_tick_", "Drift-event ticks, by tick mode"),
    ("tick_", "Solver ticks, by mode or outcome"),
    ("lp_backend_", "Ticks by the LP relaxation engine that actually ran"),
    ("served_", "Degraded-mode serves, by published mode"),
    ("fault_injected_", "Chaos faults scheduled, by kind"),
    ("fault_fired_", "Solver/process-channel chaos faults that fired, by kind"),
    ("worker_", "Gateway per-worker counters (worker_<i>_events)"),
)


def registry_help(name: str):
    """``# HELP`` text for a metric name: exact entry first, then the
    longest matching family prefix; None when nothing covers it (the
    Prometheus round-trip test treats that as registry drift)."""
    if name in METRIC_REGISTRY:
        return METRIC_REGISTRY[name]
    best = None
    for prefix, help_txt in METRIC_FAMILIES:
        if name.startswith(prefix) and (
            best is None or len(prefix) > len(best[0])
        ):
            best = (prefix, help_txt)
    return best[1] if best else None


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile on an already-sorted list (no numpy needed)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class LatencyHist:
    """Latency recorder with p50/p99 snapshots.

    Keeps raw samples (traces are thousands of events, not millions); the
    snapshot sorts once. ``cap`` bounds memory for genuinely long-lived
    daemons by keeping the most recent window.

    Snapshot semantics after the window overflows: ``count``/``mean_ms``
    are ALL-TIME (every sample ever recorded), while the quantiles, the
    max and the ``window_count``/``window_mean_ms`` pair describe only the
    ``cap``-bounded recent window. Both views are reported explicitly so a
    long-lived daemon's snapshot is never an incoherent mix of the two
    (the old snapshot paired an all-time mean with windowed quantiles).
    """

    def __init__(self, cap: int = 100_000):
        # deque(maxlen=...) keeps the recent-window trim O(1) per record;
        # the snapshot (rare) pays the sort.
        self._vals: "deque[float]" = deque(maxlen=cap)  # guarded-by: self._lock
        self.count = 0  # guarded-by: self._lock
        self.total = 0.0  # guarded-by: self._lock
        # record() is a three-field update; a snapshot between the count
        # bump and the append would see count != len(values) and report a
        # torn (count, mean, quantile) triple. One lock covers both.
        self._lock = make_lock("metrics.hist")

    def record(self, ms: float) -> None:
        with self._lock:
            self.count += 1
            self.total += ms
            self._vals.append(float(ms))

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._vals)
            count, total = self.count, self.total
        return {
            # All-time: survives the window overflowing. total_ms is the
            # exact running sum (the Prometheus summary `_sum` — derived
            # from the rounded mean it could DECREASE between scrapes).
            "count": count,
            "total_ms": round(total, 3),
            "mean_ms": round(total / count, 3) if count else 0.0,
            # Recent window (at most `cap` samples): the same population
            # the quantiles and max are computed from.
            "window_count": len(vals),
            "window_mean_ms": (
                round(sum(vals) / len(vals), 3) if vals else 0.0
            ),
            "p50_ms": round(_quantile(vals, 0.50), 3),
            "p99_ms": round(_quantile(vals, 0.99), 3),
            "max_ms": round(vals[-1], 3) if vals else 0.0,
        }


class SchedulerMetrics:
    """Counters + histograms for one scheduler (or one replanner)."""

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)  # guarded-by: self._lock
        self.hists: Dict[str, LatencyHist] = {}  # guarded-by: self._lock
        # Guards the counter dict and hist-map mutation; each hist guards
        # its own buffer (record/snapshot above), so observe() holds this
        # lock only for the get-or-create, never across the record.
        self._lock = make_lock("metrics.counters")

    # -- generic sinks ----------------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def observe(self, name: str, ms: float) -> None:
        with self._lock:
            hist = self.hists.get(name)
            if hist is None:
                hist = self.hists[name] = LatencyHist()
        hist.record(ms)

    # -- the replanner hook (see StreamingReplanner.metrics) --------------

    def record_tick(self, mode: str, certified: bool, escalations: int = 0) -> None:
        """One solver tick: its mode, certificate, and ladder escalations."""
        if mode not in TICK_MODES:
            mode = "cold"
        self.inc(f"tick_{mode}")
        self.inc("tick_certified" if certified else "tick_uncertified")
        if escalations:
            self.inc("fallback_escalations", escalations)

    # -- derived views ----------------------------------------------------

    def tick_total(self) -> int:
        with self._lock:
            return sum(self.counters[f"tick_{m}"] for m in TICK_MODES)

    def pool_hit_rate(self) -> float:
        with self._lock:
            hits = self.counters["pool_hit"]
            total = hits + self.counters["pool_miss"]
        return hits / total if total else 0.0

    def snapshot(self) -> dict:
        """Plain-dict view: counters, derived rates, histogram quantiles."""
        with self._lock:
            counters = dict(self.counters)
            hists = list(self.hists.items())
        tick_total = sum(counters.get(f"tick_{m}", 0) for m in TICK_MODES)
        hits = counters.get("pool_hit", 0)
        pool_total = hits + counters.get("pool_miss", 0)
        return {
            "counters": counters,
            "pool_hit_rate": round(hits / pool_total, 4) if pool_total else 0.0,
            "tick_total": tick_total,
            "latency": {name: h.snapshot() for name, h in hists},
        }
