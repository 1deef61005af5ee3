"""The replanning core: events in, certified placements out, warm state kept.

``Scheduler`` owns a ``FleetState`` and a bounded LRU **warm pool** of
``StreamingReplanner`` instances keyed by (fleet_digest, model_digest).
Routing follows the event classes:

- **drift** events (degrade / load) keep the key, so the tick lands on the
  same warm replanner — a warm re-solve (dense) or a margin tick (MoE
  chains), exactly the solver's streaming fast paths;
- **structural** events (join / leave / model swap) change the key. A key
  seen before gets its replanner — and its warm incumbent, duals and
  margin anchor — back from the pool (a device flapping out and back in
  replans warm: this is the placement cache); a brand-new key starts cold.

Serving never blocks on solving: ``latest()`` returns the most recently
*published* placement plus staleness metadata (events behind, age). A tick
that fails (e.g. the fleet drifted infeasible) increments a counter and
leaves the last placement served; certification is the replanner's
escalation ladder's job and its outcome is recorded per tick.

Ported from ``distilp_tpu/sched/scheduler.py`` onto the port's engine: every
replanner, speculation batch and per-k risk enumeration solves on
``device`` (None = cuda, raises without a GPU; ``'cpu'`` runs the kernels'
plain versions) with ``backend='torch'`` (default) or the HiGHS oracle
(``'cpu'``). A tick's compile attribution (``obs.compile_ledger``) counts
the kernel-library loads and CUDA-graph captures it paid; its memory
watermark (``obs.memory``) reads the CUDA caching allocator.
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

from ..common import DeviceProfile, ModelProfile
from ..obs import compile_ledger as _compile_ledger
from ..obs import memory as _memory
from ..obs.trace import NOOP_SPAN, NOOP_TRACER
from ..solver.result import HALDAResult
from ..solver.streaming import StreamingReplanner
from .events import validate_event
from .fleet import FleetState
from .forecast import ChurnForecaster
from .metrics import (
    HEALTH_BROKEN,
    HEALTH_DEGRADED,
    HEALTH_HEALTHY,
    SchedulerMetrics,
)
from .speculate import (
    DEFAULT_SPEC_K,
    DEFAULT_SPEC_TOLERANCE,
    BankEntry,
    SpeculationBank,
    bucket_vector,
    candidate_digest,
    presolve_candidates,
)

# Default near-match radius for degraded-mode serving, in tolerance
# buckets: a banked placement may serve an instance up to this many
# tolerance steps away on its worst drift channel (~(1+tol)^radius
# relative — ~22% at the default 5% tolerance). Wide enough to cover a
# burst's excursion from the pre-burst instance the bank holds; narrow
# enough that the served placement was certified on a genuinely nearby
# problem.
DEFAULT_SPEC_NEAR_RADIUS = 4

# Solver-timings keys worth attaching to the solve span: the wall-clock
# breakdown plus the work/engine counters that attribute a slow tick, plus
# the solver-diagnostics digest (Scheduler(diagnostics=True) / `serve
# --solver-diagnostics`; present in timings only when the tick solved with
# convergence tracing on). The digest key set is imported from its one
# source of truth next to SearchTrace.digest() — a field added there
# reaches the span and the flight records without touching this module.
from ..obs.convergence import CONV_DIGEST_KEYS as _CONV_DIGEST_KEYS  # noqa: E402

_SOLVE_SPAN_KEYS = (
    "build_ms", "pack_ms", "upload_ms", "solve_ms", "static_hit",
    "lp_backend", "bnb_rounds", "ipm_iters_executed", "escalated",
) + _CONV_DIGEST_KEYS


class _DeadlineMiss(Exception):
    """Internal: the tick's solve overran its wall-clock deadline (or an
    earlier abandoned solve is still occupying the worker)."""


class CombineTicket(NamedTuple):
    """A prepared-but-unsolved combined tick (``Scheduler.prepare_combine``
    → the gateway's ``SolveCombiner`` → ``Scheduler.adopt_combine``). The
    packed instance rides ``prep.instance``; ``seq`` pins the fleet state
    the pack described, so adopt can detect (and discard) a result a
    structural barrier raced past."""

    key: tuple
    planner: StreamingReplanner
    prep: object  # solver.streaming.CombinePrep
    seq: int
    t0: float
    event: object  # last event of the coalesced run, for flight records


class _SolveWorker:
    """One DAEMON thread executing solve attempts for the deadline path.

    A deadline-abandoned solve cannot be interrupted (it is deep inside
    device code); it keeps running here and is discarded. The thread
    is a daemon precisely so an abandoned solve never blocks process exit
    (a ThreadPoolExecutor's non-daemon workers are joined at interpreter
    shutdown — a CLI would 'finish' and then hang for the rest of the
    abandoned compile). Single worker on purpose: solves on one scheduler
    are serialized, so an abandoned solve has always COMPLETED before the
    next one starts and the planner's warm state is never written by two
    solves at once.
    """

    def __init__(self) -> None:
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue()
        # The worker's thread ident, read by the compile-ledger capture:
        # a deadline-path solve compiles on THIS thread, and the tick's
        # compile attribution must include it (set in _run; reads before
        # the thread publishes it just see None and skip the filter hit).
        self.ident = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="sched-solve"
        )
        self._thread.start()

    def _run(self) -> None:
        import threading

        self.ident = threading.get_ident()
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, box, done = item
            try:
                box["result"] = fn()
            except BaseException as e:  # dlint: disable=DLP017 not swallowed: re-raised by _attempt_deadline from the box
                box["exc"] = e
            finally:
                done.set()

    def submit(self, fn):
        """-> (box, done): ``done.wait(timeout)`` then read the box."""
        import threading

        box: dict = {}
        done = threading.Event()
        self._q.put((fn, box, done))
        return box, done

    def stop(self) -> None:
        self._q.put(None)


# Serving-side perturbation model for risk-aware candidate scoring: modest
# symmetric jitter on compute/link/disk plus a straggler scenario (each
# device has a 5% chance per draw of running 8x slower — the GC-pause /
# thermal-throttle / contended-host class of event on consumer swarms).
# The straggler channel is what separates candidates: a deeper pipeline
# multiplies the straggled bottleneck cycle (k-1) times, so the twin's p95
# regularly prefers a shallower runner-up k the mean-objective ranking
# puts second; pure symmetric jitter rarely reorders close candidates.
DEFAULT_RISK_MC = {
    "sigma_compute": 0.10,
    "sigma_comm": 0.15,
    "sigma_disk": 0.10,
    "sigma_mem": 0.0,
    "dropout_p": 0.05,
    "dropout_slowdown": 8.0,
}


class PlacementView(NamedTuple):
    """One served placement + how stale it is relative to the event stream."""

    result: HALDAResult
    seq: int  # fleet seq the placement was solved at
    fleet_seq: int  # fleet seq at read time
    events_behind: int  # fleet_seq - seq (0 = fresh)
    age_s: float  # wall-clock seconds since publication
    # 'cold' | 'warm' | 'margin' tick that produced it; 'spec' when the
    # speculation bank served a PRE-solved placement (certified on a
    # forecast instance within the bank's tolerance of this one — no solve
    # ran this tick); 'spec_near' when a PRESSURE tick (gateway admission
    # control, shard behind) served the bank's nearest certified match
    # within spec_near_radius tolerance buckets — approximate by
    # construction, not merely stale; 'risk' when the risk-aware selector
    # served a candidate OTHER than that tick's fresh solve (a cached
    # incumbent or per-k alternative). Under degraded serving the field is
    # REWRITTEN on the published view: 'stale' when a deadline miss (or
    # poisoned fleet state) re-served the last-known-good placement,
    # 'degraded' while the open circuit breaker skips solves.
    mode: str
    # Problem identity at publication time. For mode == 'risk' the served
    # placement may have been SOLVED under an earlier identity/tick — the
    # twin re-priced it against this one before serving.
    key: Tuple[str, str]
    # Risk-aware mode only: the served placement's twin p95 latency and
    # whether the twin preferred a candidate over the fresh solve.
    twin_p95_s: Optional[float] = None
    risk_selected: bool = False


class WarmPool:
    """Bounded LRU of warm replanners, keyed by problem identity.

    Eviction drops the warm state (incumbent, duals, margin anchor) — the
    next solve under that key is cold but still correct; the pool trades
    re-solve speed for bounded memory, never answers.
    """

    def __init__(
        self,
        capacity: int,
        factory: Callable[[], StreamingReplanner],
        metrics: Optional[SchedulerMetrics] = None,
    ):
        if capacity < 1:
            raise ValueError("warm pool capacity must be >= 1")
        self.capacity = capacity
        self._factory = factory
        self._metrics = metrics
        self._pool: "OrderedDict[tuple, StreamingReplanner]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._pool)

    def __contains__(self, key: tuple) -> bool:
        return key in self._pool

    def get(self, key: tuple) -> Tuple[StreamingReplanner, bool]:
        """(replanner, was_a_hit) for the key, creating + evicting LRU-style."""
        planner = self._pool.get(key)
        hit = planner is not None
        if hit:
            self._pool.move_to_end(key)
        else:
            planner = self._factory()
            self._pool[key] = planner
            while len(self._pool) > self.capacity:
                self._pool.popitem(last=False)
                if self._metrics is not None:
                    self._metrics.inc("pool_evict")
        if self._metrics is not None:
            self._metrics.inc("pool_hit" if hit else "pool_miss")
        return planner, hit

    def items(self):
        """(key, replanner) pairs, LRU order — the risk-aware candidate scan
        reads cached incumbents without touching recency or hit counters."""
        return list(self._pool.items())

    def peek(self, key: tuple) -> Optional[StreamingReplanner]:
        """The key's live replanner, or None — no counters, no minting, no
        recency bump. The speculative hit path donates warm state through
        this: serving from the bank must not skew pool accounting, and it
        must never mint (or LRU-evict) a planner for a tick that solves
        nothing."""
        return self._pool.get(key)

    def adopt(self, key: tuple, planner: StreamingReplanner) -> None:
        """Install a restored replanner under its key (snapshot restore).

        Counts as neither a hit nor a miss — the pool never routed an
        event to it; capacity is still enforced (restoring onto a smaller
        pool evicts LRU-style, warm state lost but correctness kept).
        """
        self._pool[key] = planner
        self._pool.move_to_end(key)
        while len(self._pool) > self.capacity:
            self._pool.popitem(last=False)
            if self._metrics is not None:
                self._metrics.inc("pool_evict")


class Scheduler:
    """Event-driven replanning daemon over one fleet + model.

    >>> sched = Scheduler(devs, model, k_candidates=[4, 8])
    >>> view = sched.handle(DeviceDegrade(name="synth-android-3",
    ...                                   t_comm_scale=1.2))
    >>> view.result.certified, view.mode
    (True, 'warm')
    >>> sched.latest().events_behind
    0
    """

    def __init__(
        self,
        devices: Sequence[DeviceProfile],
        model: ModelProfile,
        mip_gap: float = 1e-3,
        kv_bits: str = "4bit",
        backend: str = "torch",
        moe: Optional[bool] = None,
        k_candidates: Optional[Sequence[int]] = None,
        warm_pool_size: int = 4,
        solve_on_init: bool = False,
        metrics: Optional[SchedulerMetrics] = None,
        cold_start: bool = False,
        lp_backend: str = "auto",
        pdhg_iters: Optional[int] = None,
        pdhg_restart_tol: Optional[float] = None,
        mesh_shards: Optional[int] = None,
        pdhg_dtype: Optional[str] = None,
        risk_aware: bool = False,
        risk_samples: int = 256,
        risk_seed: int = 0,
        risk_mc: Optional[dict] = None,
        solve_deadline_s: Optional[float] = None,
        max_retries: int = 0,
        retry_backoff_s: float = 0.05,
        retry_backoff_max_s: float = 1.0,
        breaker_threshold: int = 5,
        breaker_cooldown: int = 3,
        healthy_after: int = 3,
        fault_hook: Optional[Callable[[int], None]] = None,
        speculative: bool = False,
        spec_k: int = DEFAULT_SPEC_K,
        spec_tolerance: float = DEFAULT_SPEC_TOLERANCE,
        spec_bank_size: Optional[int] = None,
        spec_near_radius: int = DEFAULT_SPEC_NEAR_RADIUS,
        tracer=None,
        flight=None,
        flight_key: str = "default",
        profile_dir: Optional[str] = None,
        diagnostics: bool = False,
        device=None,
    ):
        if backend not in ("torch", "cpu"):
            raise ValueError(f"Unknown backend {backend!r}; expected 'torch' or 'cpu'")
        self.fleet = FleetState(list(devices), model)
        self.mip_gap = mip_gap
        self.kv_bits = kv_bits
        self.backend = backend
        # Where every solve of this scheduler runs (backend 'torch'): None
        # = cuda, raising without a GPU; 'cpu' = the kernels' plain versions.
        self.device = device
        self.moe = moe
        # A/B switch (`solver serve --cold-start`): the pool still routes
        # events, but every tick solves from scratch — the baseline against
        # which warm/margin/iterate reuse is measured.
        self.cold_start = cold_start
        # LP relaxation engine (`serve --lp-backend`): 'auto' stays on the
        # IPM for the small fleets this daemon historically served and
        # flips to matrix-free PDHG at fleet scale; every minted replanner
        # inherits it, and the engine each tick actually ran is counted
        # (`lp_backend_ipm`/`lp_backend_pdhg`) next to the tick modes.
        self.lp_backend = lp_backend
        self.pdhg_iters = pdhg_iters
        self.pdhg_restart_tol = pdhg_restart_tol
        # Row-mesh + iterate-precision knobs (`serve --mesh-shards
        # --pdhg-dtype`): inherited by every minted replanner's tick
        # solves; speculation and the per-k risk enumeration keep their
        # lane composition (mesh_shards is a per-solve knob there).
        self.mesh_shards = mesh_shards
        self.pdhg_dtype = pdhg_dtype
        # Solver-interior diagnostics (`serve --solver-diagnostics`): every
        # tick solves with convergence tracing on; the conv_* digest rides
        # the timings dict onto the sched.solve span and the flight
        # recorder's tick records. Off (default) = the exact untraced
        # device program — counters and placements byte-identical.
        self.diagnostics = diagnostics
        # Risk-aware serving (`serve --risk-aware`): every tick scores the
        # fresh solve AND the warm pool's cached incumbents on the digital
        # twin (Monte-Carlo p95 + feasibility-violation penalty, seeded so
        # replays are deterministic) and publishes the lowest-risk
        # candidate — instead of serving the freshest placement on
        # staleness alone. Solver warm state is untouched: risk selection
        # changes what is SERVED, never what seeds the next solve.
        self.risk_aware = risk_aware
        self.risk_samples = risk_samples
        self.risk_seed = risk_seed
        # Perturbation-model overrides forwarded to the twin (sigma_*,
        # dropout_p, dropout_slowdown, degrade). The serving default leans
        # on the straggler channel: DEFAULT_RISK_MC's dropout scenario is
        # what separates placements that concentrate layers from ones that
        # spread them — symmetric small jitter alone rarely reorders.
        self.risk_mc = dict(DEFAULT_RISK_MC if risk_mc is None else risk_mc)
        # Per-k candidate cache: the enumeration is a COLD per-k sweep, so
        # drift ticks reuse the placements enumerated at the current
        # problem identity (the twin re-prices them against the live
        # profiles anyway); only an identity change re-enumerates.
        self._risk_per_k: list = []
        self._risk_per_k_key: Optional[tuple] = None
        self.k_candidates = list(k_candidates) if k_candidates else None
        self.metrics = metrics if metrics is not None else SchedulerMetrics()
        self.pool = WarmPool(
            warm_pool_size, self._make_replanner, metrics=self.metrics
        )
        # -- fault-hardened serving (see README "Degraded-mode semantics").
        # All knobs default OFF/neutral: with no deadline, no retries and no
        # injected faults the tick path below is bit-for-bit the old one —
        # the chaos machinery must be zero-cost when disabled.
        self.solve_deadline_s = solve_deadline_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_max_s = retry_backoff_max_s
        # Breaker: opens after `breaker_threshold` CONSECUTIVE solve
        # failures (exceptions after retries, or deadline misses); while
        # open, `breaker_cooldown` ticks serve degraded without solving at
        # all, then one half-open probe solve decides close vs re-open.
        # threshold <= 0 disables the breaker entirely.
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.healthy_after = healthy_after
        # Test/chaos seam: called (with the 0-based attempt index) before
        # every solve attempt; raising injects a solve failure, sleeping
        # injects a latency spike. None in production.
        self.fault_hook = fault_hook
        # -- speculative replanning (sched.forecast + sched.speculate),
        # default OFF = byte-identical serving: no forecaster, no bank, no
        # probe, no presolve — every site below is behind `if speculative`.
        # When on: applied events feed the forecaster, each solved tick
        # pre-solves the K most likely futures as one scenario batch (the
        # lanes of one search), and the next event's bank probe runs BEFORE the solve
        # ladder — a hit serves the pre-solved placement (mode='spec') at
        # cache-hit latency, an honest miss falls through unchanged.
        self.speculative = speculative
        self.spec_k = spec_k
        self.spec_tolerance = spec_tolerance
        # Degraded-mode serving: how far (in tolerance buckets, worst
        # channel) a banked placement may be from the live instance and
        # still be served under queue pressure (gateway admission control
        # passes pressure=True; mode='spec_near'). Only consulted on
        # pressure ticks — plain serving never near-matches.
        self.spec_near_radius = spec_near_radius
        self.forecaster = ChurnForecaster() if speculative else None
        self.spec_bank = (
            SpeculationBank(
                capacity=(
                    spec_bank_size
                    if spec_bank_size is not None
                    else max(4, 4 * spec_k)
                ),
                tolerance=spec_tolerance,
            )
            if speculative
            else None
        )
        # Event->published-placement latency of the most recent tick, ms
        # (presolve excluded — it runs after publish, off the serving
        # path). The bench's speculation arms read this instead of timing
        # handle(), which would bill background presolve work to serving.
        self.last_serve_ms: float = 0.0
        self.health = HEALTH_HEALTHY
        self.quarantined: "deque[tuple]" = deque(maxlen=100)
        self._consec_failures = 0
        self._clean_streak = 0
        self._breaker_open = False
        self._breaker_cooldown_left = 0
        self._executor = None  # lazy; only a deadline needs the worker
        self._abandoned = None  # future of a deadline-abandoned solve
        self._published: Optional[PlacementView] = None
        self._published_at: float = 0.0
        # Snapshot-restore accounting: set by load_state(); the FIRST tick
        # after a restore proves whether the warm state survived the round
        # trip (counter `warm_resumes`) or the service paid a cold re-solve
        # it was promised not to (`cold_resumes`). One tick only — later
        # cold ticks are ordinary identity changes, not restore failures.
        # A first tick whose identity was NOT in the restored pool (e.g. a
        # structural event landed first) proves nothing about the restore
        # and counts as neither (`resume_identity_changed`).
        self._restore_pending = False
        self._restored_keys: frozenset = frozenset()
        # -- observability (distilp_torch.obs), all opt-in. The tracer falls
        # back to the shared NOOP twin so every instrumentation site below
        # is a constant-cost no-op when tracing is off; the flight recorder
        # and the profiler hook stay None/dormant unless configured —
        # the default tick path must remain byte-identical (pinned by the
        # smoke gates' counter assertions).
        self.tracer = NOOP_TRACER if tracer is None else tracer
        self._span = NOOP_SPAN  # the in-flight tick's span (handle())
        self._flight = flight
        self._flight_key = flight_key
        self._flight_prev_counters: dict = {}
        self._flight_pending: Optional[str] = None
        self._last_lp_backend: Optional[str] = None
        # Per-tick diagnostics for the flight record: the exception CLASS
        # behind this tick's solve_attempt_failed / spec_presolve_failed
        # counters (a bare counter bump is invisible post-mortem), and the
        # conv_* digest when solver diagnostics ran. Reset per handle().
        self._tick_exc: dict = {}
        self._tick_conv: Optional[dict] = None
        # This tick's compile-ledger delta (obs.compile_ledger): set by
        # _note_compiles when a process ledger is enabled AND the tick's
        # own threads paid at least one kernel build or graph capture;
        # rides the flight
        # record so a slow tick's post-mortem says WHY it was slow.
        self._tick_compile: Optional[dict] = None
        # This tick's memory watermark (obs.memory): set by _note_memory
        # on ticks where the throttled ledger actually took a FRESH
        # sample (live-array walks are ~3 us/array — unthrottled per-tick
        # walks would blow the obs overhead budget); rides the tick span
        # and the flight record. _mem_prev_live is the previous fresh
        # sample's live bytes — the per-tick delta the leak gate's
        # post-mortem reads.
        self._tick_mem: Optional[dict] = None
        self._mem_prev_live: Optional[int] = None
        # Whether THIS tick applied a structural (identity-changing)
        # event — the memory ledger re-pins its leak baseline there
        # (structural re-allocation is provisioning, not a leak).
        self._tick_structural = False
        self.profile_dir = profile_dir
        self._profiled = False
        if solve_on_init:
            self.metrics.inc("init_solve")
            self._tick(structural=None)

    def _make_replanner(self) -> StreamingReplanner:
        search = {"lp_backend": self.lp_backend}
        if self.pdhg_iters is not None:
            search["pdhg_iters"] = self.pdhg_iters
        if self.pdhg_restart_tol is not None:
            search["pdhg_restart_tol"] = self.pdhg_restart_tol
        if self.mesh_shards is not None:
            search["mesh_shards"] = self.mesh_shards
        if self.pdhg_dtype is not None:
            search["pdhg_dtype"] = self.pdhg_dtype
        planner = StreamingReplanner(
            mip_gap=self.mip_gap,
            kv_bits=self.kv_bits,
            backend=self.backend,
            moe=self.moe,
            cold_start=self.cold_start,
            search=search,
            diagnostics=self.diagnostics,
            device=self.device,
        )
        planner.metrics = self.metrics  # tick modes funnel into one snapshot
        return planner

    # -- the event loop body ----------------------------------------------

    def handle(self, event, pressure: bool = False) -> PlacementView:
        """Apply one event and replan; returns the freshly published view.

        ``pressure`` is the admission-control hint (gateway ingest sets it
        when the owning worker's queue is past its degrade threshold): a
        pressure tick whose exact speculation probe misses may serve a
        banked NEAR-match (``mode='spec_near'``, see ``_spec_near_probe``)
        instead of queueing a solve it is already late for. False (the
        default, and the only value non-gateway callers pass) leaves the
        tick path byte-identical.

        Structural events route through the warm pool under their new key;
        drift events tick the current key's replanner warm. A failed solve
        (no feasible placement for the mutated fleet) keeps the previous
        placement published and is visible as ``tick_failed`` + a growing
        ``events_behind`` on ``latest()``.

        Input quarantine: an event carrying non-finite or contradictory
        values (``events.validate_event``), or one the strict
        ``FleetState.apply`` rejects (unknown device, duplicate join, ...),
        never mutates the fleet — it is counted, recorded on
        ``self.quarantined``, and the last-known-good placement stays
        served. Before any placement exists a poisoned event is still an
        error: there is nothing safe to serve instead.

        Observability wrapper: the whole handle runs inside a ``sched.tick``
        span (the root of the trace in single-scheduler serving; a child of
        the gateway ingest span when a worker attached its context), and —
        when a flight recorder is attached — appends one tick record (mode,
        health, counter deltas, span ids) to the shard's ring on every
        exit path, raising ones included.
        """
        span = self.tracer.span(
            "sched.tick",
            attrs={"kind": getattr(event, "kind", type(event).__name__)},
        )
        with span:
            self._span = span
            self._tick_exc = {}
            self._tick_conv = None
            self._tick_compile = None
            self._tick_mem = None
            self._tick_structural = False
            led = _compile_ledger.current()
            tok = led.seq() if led is not None else 0
            view: Optional[PlacementView] = None
            try:
                view = self._handle(event, pressure=pressure)
                return view
            finally:
                if led is not None:
                    # BEFORE the flight note: the compile counters must be
                    # in this tick's counter delta, not the next one's.
                    self._note_compiles(led, tok, span)
                mled = _memory.current()
                if mled is not None:
                    # No-solve ticks (spec hits, breaker short-circuits,
                    # quarantines) still watermark at tick exit; solved
                    # ticks already sampled on the sched.solve span. Same
                    # ordering contract as the compile note: the memory
                    # counters/attrs land in THIS tick's record. A
                    # structural tick then re-pins the leak baseline —
                    # its allocation is provisioning, not a leak.
                    if self._tick_mem is None:
                        self._note_memory(mled, span)
                    if self._tick_structural:
                        mled.note_structural()
                span.set_attr("mode", view.mode if view is not None else "error")
                if self._flight is not None:
                    self._flight_note(event, view, span)
                self._span = NOOP_SPAN

    def handle_coalesced(
        self, events: Sequence, pressure: bool = False
    ) -> PlacementView:
        """Apply a run of queued events and solve ONCE, at the newest state.

        The gateway's admission-control coalescing hook: when several
        drift events for the same shard are queued behind one solve, each
        is still validated, quarantined-or-applied and counted exactly as
        ``handle`` would (fleet ``seq`` advances per applied event — the
        per-shard seq accounting the shed contract audits), but only the
        final state pays a solve; the folded events are counted
        ``events_coalesced``. All waiters are served the one resulting
        view. A single-event batch IS ``handle`` — same path, same spans.

        Callers coalesce drift runs (the gateway treats structural events
        as barriers); a structural event in the batch is still handled
        correctly — it just makes the one solve a structural tick.
        """
        events = list(events)
        if not events:
            raise ValueError("handle_coalesced needs at least one event")
        if len(events) == 1:
            return self.handle(events[0], pressure=pressure)
        last = events[-1]
        span = self.tracer.span(
            "sched.tick",
            attrs={
                "kind": getattr(last, "kind", type(last).__name__),
                "coalesced": len(events),
            },
        )
        with span:
            self._span = span
            self._tick_exc = {}
            self._tick_conv = None
            self._tick_compile = None
            self._tick_mem = None
            self._tick_structural = False
            led = _compile_ledger.current()
            tok = led.seq() if led is not None else 0
            view: Optional[PlacementView] = None
            try:
                view = self._handle_coalesced(events, pressure)
                return view
            finally:
                if led is not None:
                    self._note_compiles(led, tok, span)
                mled = _memory.current()
                if mled is not None:
                    if self._tick_mem is None:
                        self._note_memory(mled, span)
                    if self._tick_structural:
                        mled.note_structural()
                span.set_attr("mode", view.mode if view is not None else "error")
                if self._flight is not None:
                    self._flight_note(last, view, span)
                self._span = NOOP_SPAN

    # -- cross-shard combine path (distilp_torch.combine) --------------------
    #
    # A combined tick splits handle_coalesced's one synchronous solve into
    # prepare (apply events, pack this shard's instance) and adopt (redeem
    # the shard's lane of the batched solve) so the gateway's SolveCombiner
    # can execute many shards' solves as ONE batched search in between.
    # Everything around the solve — event validation/quarantine, the gate
    # short-circuits, breaker accounting, publish, speculation refill — is
    # the per-shard code, shared, not copied.

    def prepare_combine(self, events: Sequence, pressure: bool = False,
                        M_pad: Optional[int] = None):
        """Apply a coalesced run of drift events and PACK the resulting
        solve instead of executing it. Returns ``(ticket, view)`` — exactly
        one is non-None. A view means the tick was fully served here: a
        gate short-circuit (spec hit, breaker, quarantine) or a local
        fallback solve for ticks the combiner cannot batch (structural,
        MoE, half-open probe, first post-restore tick — counted
        ``combine_local``). A ticket means the solve is deferred: hand
        ``ticket.prep.instance`` to the combiner and redeem the lane with
        ``adopt_combine``."""
        events = list(events)
        if not events:
            raise ValueError("prepare_combine needs at least one event")
        last = events[-1]
        span = self.tracer.span(
            "sched.tick",
            attrs={
                "kind": getattr(last, "kind", type(last).__name__),
                "coalesced": len(events),
                "combine": True,
            },
        )
        with span:
            self._span = span
            self._tick_exc = {}
            self._tick_conv = None
            self._tick_compile = None
            self._tick_mem = None
            self._tick_structural = False
            led = _compile_ledger.current()
            tok = led.seq() if led is not None else 0
            view: Optional[PlacementView] = None
            ticket = None
            try:
                applied = 0
                structural = False
                for ev in events:
                    reason = validate_event(ev)
                    if reason is not None:
                        self._quarantine_note(ev, reason)
                        continue
                    try:
                        s = self.fleet.apply(ev)
                    except (ValueError, TypeError) as e:
                        self._quarantine_note(ev, f"{type(e).__name__}: {e}")
                        continue
                    self._absorbed(ev, s)
                    if applied:
                        self.metrics.inc("events_coalesced")
                    applied += 1
                    structural = structural or s
                if not applied:
                    if self._published is None:
                        raise ValueError(
                            "every coalesced event was quarantined before "
                            "any placement was published; nothing safe to "
                            "serve"
                        )
                    view = self.latest()
                    return None, view
                self._tick_structural = structural
                gview, key, planner, probing = self._tick_gate(
                    structural, pressure
                )
                if gview is not None:
                    view = gview
                    return None, view
                # Ticks the combiner cannot batch solve locally, now:
                # structural ticks re-shape the instance (and are barriers
                # at the gateway anyway), the half-open breaker probe must
                # prove recovery with a real solve it owns, and the first
                # post-restore tick IS the warm-resume proof.
                if structural or probing or self._restore_pending:
                    self.metrics.inc("combine_local")
                    view = self._tick_solve(structural, key, planner, probing)
                    return None, view
                t0 = time.perf_counter()
                try:
                    # This shard's k grid, as its per-shard tick solves it
                    # (the reference packs every factor of L here).
                    prep = planner.prepare(
                        self.fleet.device_list(), self.fleet.model,
                        k_candidates=self.k_candidates, M_pad=M_pad,
                    )
                except (RuntimeError, ValueError, NotImplementedError) as e:
                    self.metrics.inc("tick_failed")
                    self.metrics.inc("tick_failed_drift")
                    self._last_error = f"{type(e).__name__}: {e}"
                    self._solve_failed(probing)
                    if self._published is None:
                        raise
                    view = self.latest()
                    return None, view
                if prep is None:
                    # MoE shard (load-factor fixed point / margin ladder
                    # are iterative) or non-torch backend: per-shard path.
                    self.metrics.inc("combine_local")
                    view = self._tick_solve(structural, key, planner, probing)
                    return None, view
                self.metrics.inc("combine_prepared")
                ticket = CombineTicket(
                    key=key, planner=planner, prep=prep,
                    seq=self.fleet.seq, t0=t0, event=last,
                )
                return ticket, None
            finally:
                if led is not None:
                    self._note_compiles(led, tok, span)
                mled = _memory.current()
                if mled is not None:
                    if self._tick_mem is None:
                        self._note_memory(mled, span)
                    if self._tick_structural:
                        mled.note_structural()
                span.set_attr(
                    "mode",
                    view.mode if view is not None
                    else ("combine_pending" if ticket is not None else "error"),
                )
                if self._flight is not None and view is not None:
                    self._flight_note(last, view, span)
                self._span = NOOP_SPAN

    def adopt_combine(self, ticket, decoded=None,
                      error: Optional[BaseException] = None) -> PlacementView:
        """Redeem one lane of a batched solve — the deferred second half of
        a ``prepare_combine`` tick. ``decoded`` is this shard's
        ``(per_k_results, best)`` from ``batchlayout.solve_batch``;
        ``error`` (a combiner-level dispatch failure) falls back to a full
        local tick, counted ``combine_fallback``. A ticket whose fleet has
        advanced past the packed ``seq`` (a structural barrier raced in
        between) is discarded as ``combine_stale`` — the newer published
        view already covers this ticket's events."""
        span = self.tracer.span(
            "sched.tick",
            attrs={"kind": "combine_adopt", "combine": True},
        )
        with span:
            self._span = span
            self._tick_exc = {}
            self._tick_conv = None
            self._tick_compile = None
            self._tick_mem = None
            self._tick_structural = False
            led = _compile_ledger.current()
            tok = led.seq() if led is not None else 0
            view: Optional[PlacementView] = None
            try:
                if error is not None:
                    self.metrics.inc("combine_fallback")
                    self._span.add_event(
                        "combine_fallback",
                        error=f"{type(error).__name__}: {error}",
                    )
                    view = self._tick(structural=False)
                    return view
                if self.fleet.seq != ticket.seq:
                    # The packed instance no longer describes the live
                    # fleet; whoever advanced it published past us.
                    self.metrics.inc("combine_stale")
                    if self._published is not None:
                        view = self.latest()
                    else:
                        view = self._tick(structural=False)
                    return view
                tick_tm: dict = {}
                try:
                    result = ticket.planner.adopt(
                        ticket.prep, decoded, timings=tick_tm
                    )
                except (RuntimeError, ValueError, NotImplementedError) as e:
                    self.metrics.inc("tick_failed")
                    self.metrics.inc("tick_failed_drift")
                    self._last_error = f"{type(e).__name__}: {e}"
                    self._solve_failed(False)
                    if self._published is None:
                        raise
                    view = self.latest()
                    return view
                self._on_clean_solve(False)
                ms = (time.perf_counter() - ticket.t0) * 1e3
                self.metrics.observe("event_to_placement", ms)
                if "lp_backend" in tick_tm:
                    self.metrics.inc(f"lp_backend_{tick_tm['lp_backend']}")
                    self._last_lp_backend = tick_tm["lp_backend"]
                if ticket.planner.last_tick_escalations:
                    # An uncertified lane re-solved per-shard inside
                    # adopt(): the combined path's certification rung.
                    self.metrics.inc("solver_escalations")
                    self.metrics.inc("combine_fallback")
                self.metrics.observe("drift_tick", ms)
                self.metrics.inc("drift_tick_combine")
                view = self._publish(
                    result, "combine", ticket.key, ticket.planner,
                    ticket.prep.devs, ms,
                )
                if self.speculative and self.health == HEALTH_HEALTHY:
                    self._spec_presolve(ticket.key, ticket.planner, result)
                return view
            finally:
                if led is not None:
                    self._note_compiles(led, tok, span)
                mled = _memory.current()
                if mled is not None:
                    if self._tick_mem is None:
                        self._note_memory(mled, span)
                span.set_attr(
                    "mode", view.mode if view is not None else "error"
                )
                if self._flight is not None:
                    self._flight_note(ticket.event, view, span)
                self._span = NOOP_SPAN

    def _handle(self, event, pressure: bool = False) -> PlacementView:
        reason = validate_event(event)
        if reason is not None:
            return self._quarantine(event, reason)
        try:
            structural = self.fleet.apply(event)
        except (ValueError, TypeError) as e:
            return self._quarantine(event, f"{type(e).__name__}: {e}")
        self._tick_structural = structural
        self._absorbed(event, structural)
        return self._tick(structural=structural, pressure=pressure)

    def _handle_coalesced(self, events, pressure: bool) -> PlacementView:
        applied = 0
        structural = False
        for ev in events:
            reason = validate_event(ev)
            if reason is not None:
                self._quarantine_note(ev, reason)
                continue
            try:
                s = self.fleet.apply(ev)
            except (ValueError, TypeError) as e:
                self._quarantine_note(ev, f"{type(e).__name__}: {e}")
                continue
            self._absorbed(ev, s)
            if applied:
                # Every applied event beyond the first folds into the one
                # solve below instead of paying its own.
                self.metrics.inc("events_coalesced")
            applied += 1
            structural = structural or s
        if not applied:
            if self._published is None:
                raise ValueError(
                    "every coalesced event was quarantined before any "
                    "placement was published; nothing safe to serve"
                )
            return self.latest()
        self._tick_structural = structural
        return self._tick(structural=structural, pressure=pressure)

    def _absorbed(self, event, structural: bool) -> None:
        """Post-apply bookkeeping shared by the single and coalesced
        paths: routing counters, bank invalidation, forecaster feed."""
        self.metrics.inc("events_total")
        self.metrics.inc(f"event_{event.kind}")
        self.metrics.inc("structural_events" if structural else "drift_events")
        if self.speculative:
            if structural:
                # Identity changed: drop stale bank entries HERE, on the
                # event path — the probe may be suppressed (unhealthy,
                # half-open, post-restore) exactly when a structural
                # event lands, and stale entries must not squat the LRU.
                stale = self.spec_bank.invalidate(self.fleet.key())
                if stale:
                    self.metrics.inc("spec_stale", stale)
                    self._span.add_event("spec_stale", dropped=stale)
            # APPLIED events only: the quarantine gates already returned
            # for poisoned/contradictory input, so a NaN drift can never
            # corrupt the forecaster's EWMA state silently.
            self.forecaster.observe(self.fleet)

    def _quarantine_note(self, event, reason: str) -> None:
        """Count and record a rejected event (the fleet stays untouched)."""
        kind = getattr(event, "kind", type(event).__name__)
        self.metrics.inc("events_quarantined")
        self.metrics.inc(f"quarantine_{kind}")
        self._span.add_event("quarantined", kind=kind, reason=reason)
        self.quarantined.append((self.fleet.seq, kind, reason))
        self._last_error = f"quarantined {kind}: {reason}"
        self._note_fault()

    def _quarantine(self, event, reason: str) -> PlacementView:
        """Record a rejected event and keep serving the last-known-good."""
        self._quarantine_note(event, reason)
        if self._published is None:
            kind = getattr(event, "kind", type(event).__name__)
            raise ValueError(
                f"poisoned {kind} event before any placement was published "
                f"({reason}); nothing safe to serve"
            )
        return self.latest()

    def _tick(
        self, structural: Optional[bool], pressure: bool = False
    ) -> PlacementView:
        """One replan; ``structural=None`` marks the eventless init solve
        (it times and mode-counts like any tick but belongs to neither
        routing class, so the per-class counters keep summing to events).
        ``pressure`` widens a missed speculation probe to the bank's
        nearest certified match (degraded-mode serving under overload)."""
        view, key, planner, probing = self._tick_gate(structural, pressure)
        if view is not None:
            return view
        return self._tick_solve(structural, key, planner, probing)

    def _tick_gate(self, structural, pressure: bool):
        """The no-solve short-circuits of a tick, factored so the combine
        path (``prepare_combine``) shares them verbatim with ``_tick``:
        fleet quarantine, circuit breaker, speculation-bank probes, then
        the planner-pool fetch. Returns ``(view, key, planner, probing)``
        — a non-None view means the tick is already served."""
        # Second quarantine layer: a poisoned fleet state (however it got
        # here) must never reach build_coeffs. Cheap O(M) scalar scan.
        # Both short-circuits run BEFORE pool.get: a tick that will not
        # solve must not mint (or LRU-evict) warm planners, nor skew the
        # pool hit-rate counters.
        bad = self.fleet.non_finite_reason()
        if bad is not None:
            self.metrics.inc("quarantine_fleet")
            self._span.add_event("quarantine_fleet", reason=bad)
            self._last_error = f"fleet state quarantined: {bad}"
            self._note_fault()
            if self._published is None:
                raise ValueError(f"fleet state is poisoned: {bad}")
            return self._serve_stale("stale"), None, None, False
        # Circuit breaker: while open, cooldown ticks serve degraded with
        # no solve at all; the tick after cooldown falls through as the
        # half-open probe.
        probing = False
        if self._breaker_open:
            if self._breaker_cooldown_left > 0:
                self._breaker_cooldown_left -= 1
                self.metrics.inc("breaker_short_circuit")
                self._span.add_event("breaker_short_circuit")
                return self._serve_stale("degraded"), None, None, False
            probing = True
            self.metrics.inc("breaker_half_open_probe")
            self._span.add_event("breaker_half_open_probe")
        key = self.fleet.key()
        # Speculation bank probe, BEFORE the solve ladder (and before
        # pool.get — a hit must not skew pool hit-rate counters any more
        # than a quarantined tick does). Suppressed on the half-open
        # breaker probe and while unhealthy (a degraded service must
        # actually solve to prove recovery — a bank that kept hitting
        # would stall the clean streak forever), and on the first
        # post-restore tick (that tick IS the warm-resume proof).
        if (
            self.speculative
            and structural is not None
            and not probing
            and not self._restore_pending
            and self.health == HEALTH_HEALTHY
        ):
            view = self._spec_probe(key, structural)
            if view is not None:
                return view, None, None, False
            if pressure:
                # Behind under load: a certified placement from a NEARBY
                # instance beats queueing this solve past its deadline.
                view = self._spec_near_probe(key, structural)
                if view is not None:
                    return view, None, None, False
        planner, _hit = self.pool.get(key)
        return None, key, planner, probing

    def _tick_solve(self, structural, key, planner, probing) -> PlacementView:
        """The solve-and-publish half of a tick (everything after
        ``_tick_gate``), shared by ``_tick`` and the combine path's local
        fallback."""
        devs = self.fleet.device_list()
        t0 = time.perf_counter()
        tick_tm: dict = {}
        solve_span = self.tracer.start_span("sched.solve")
        # Outer try/finally so the solve span is ended on EVERY exit — the
        # handled failure classes below, and any exception type outside
        # them (which would otherwise leak the span right out of the trace
        # a post-mortem needs most). end() is idempotent.
        try:
            try:
                result = self._maybe_profiled_solve(planner, devs, tick_tm)
            except _DeadlineMiss:
                solve_span.add_event("deadline_missed")
                self.metrics.inc("deadline_missed")
                self._last_error = (
                    f"solve deadline ({self.solve_deadline_s:.3f}s) missed"
                )
                self._solve_failed(probing)
                return self._serve_stale("stale")
            except (RuntimeError, ValueError, NotImplementedError) as e:
                solve_span.add_event(
                    "solve_failed", error=f"{type(e).__name__}: {e}"
                )
                self.metrics.inc("tick_failed")
                if structural is not None:
                    self.metrics.inc(
                        "tick_failed_structural" if structural
                        else "tick_failed_drift"
                    )
                self._last_error = f"{type(e).__name__}: {e}"
                self._solve_failed(probing)
                if self._published is None:
                    raise
                return self.latest()
            for k in _SOLVE_SPAN_KEYS:
                if k in tick_tm:
                    solve_span.set_attr(k, tick_tm[k])
            conv = {k: tick_tm[k] for k in _CONV_DIGEST_KEYS if k in tick_tm}
            self._tick_conv = conv or None
            mled = _memory.current()
            if mled is not None:
                # The solve is where allocation happens: the watermark
                # sampled HERE rides the sched.solve span (and, via
                # _tick_mem, the flight record). No-solve ticks (spec
                # hits, short-circuits) fall back to the handle()-exit
                # note instead.
                self._note_memory(mled, solve_span)
        finally:
            solve_span.end()
        self._on_clean_solve(probing)
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics.observe("event_to_placement", ms)
        # Device-program work accounting (JAX backend): how many Mehrotra
        # iterations the tick actually executed — the warm-start health
        # gauge next to the tick-mode counters (a drift tick burning the
        # cold budget means the iterate chain broke).
        if "ipm_iters_executed" in tick_tm:
            self.metrics.observe(
                "ipm_iters_executed", tick_tm["ipm_iters_executed"]
            )
        # LP engine echo: which relaxation engine the tick's solve actually
        # ran ('auto' resolves per fleet size) — the observable for the
        # ipm/pdhg crossover in production, next to the tick-mode counters.
        if "lp_backend" in tick_tm:
            self.metrics.inc(f"lp_backend_{tick_tm['lp_backend']}")
            self._last_lp_backend = tick_tm["lp_backend"]
        # The in-solver certification ladder (halda_solve retrying an
        # uncertified dense solve at the MoE-class budget) reports through
        # the timings dict; count it so escalation storms are visible.
        if tick_tm.get("escalated"):
            self.metrics.inc("solver_escalations")
        mode = getattr(planner, "last_tick_mode", None) or "cold"
        if self._restore_pending:
            self._restore_pending = False
            if key not in self._restored_keys:
                # The first post-restore tick changed identity (structural
                # event); a cold solve here is ordinary routing, not a
                # restore failure — flagging it as cold_resumes would page
                # on a perfectly healthy drain/restore cycle.
                self.metrics.inc("resume_identity_changed")
            else:
                self.metrics.inc(
                    "warm_resumes"
                    if mode in ("warm", "margin")
                    else "cold_resumes"
                )
        if structural is not None:
            self.metrics.observe(
                "structural_tick" if structural else "drift_tick", ms
            )
            # Mode per routing class: the acceptance gauge (drift should
            # ride warm/margin, structural may cold-solve) reads these.
            self.metrics.inc(
                f"{'structural' if structural else 'drift'}_tick_{mode}"
            )
        if structural and not result.certified:
            self.metrics.inc("structural_uncertified")
        view = self._publish(result, mode, key, planner, devs, ms)
        if self.speculative and self.health == HEALTH_HEALTHY:
            # AFTER publish: presolving likely futures is background work
            # and must never sit between an event and its placement. Same
            # health gate as the probe: while the service recovers, the
            # bank cannot be served from, so presolving would only delay
            # the recovery ticks it rides behind.
            self._spec_presolve(key, planner, result)
        return view

    def _publish(
        self, result: HALDAResult, mode: str, key, planner, devs, ms: float
    ) -> PlacementView:
        """Publish a tick's served placement — the ONE publication path
        (solved ticks and speculative hits both land here, so risk
        scoring, the publish span and the serve clock cannot diverge).
        ``planner`` may be None (a spec hit whose pooled planner was
        LRU-evicted): risk scoring then prices without load factors.
        """
        with self.tracer.span("sched.publish") as pspan:
            served, twin_p95, switched = result, None, False
            if self.risk_aware:
                served, twin_p95, switched = self._risk_select(
                    devs, result, planner
                )
            self._published = PlacementView(
                result=served,
                seq=self.fleet.seq,
                fleet_seq=self.fleet.seq,
                events_behind=0,
                age_s=0.0,
                # A switched tick serves a placement this tick did NOT
                # produce; 'risk' keeps the mode field honest (see
                # PlacementView).
                mode="risk" if switched else mode,
                key=key,
                twin_p95_s=twin_p95,
                risk_selected=switched,
            )
            pspan.set_attr("mode", self._published.mode)
            pspan.set_attr("certified", served.certified)
        self._published_at = time.monotonic()
        self.last_serve_ms = ms
        return self._published

    # -- speculative replanning (sched.forecast + sched.speculate) ---------

    def _spec_probe(self, key, structural) -> Optional[PlacementView]:
        """Serve a pre-solved placement if the post-event fleet digests to
        a banked entry; None = honest miss, fall through to the ladder.

        A hit donates the scenario solve (incumbent, duals, LP iterates)
        as the pooled replanner's warm seed — the next REAL tick starts
        from the future that actually happened. A miss touches nothing:
        speculative work never writes warm state it did not serve.
        """
        t0 = time.perf_counter()
        digest = self.spec_bank.digest(self.fleet)
        entry = self.spec_bank.probe(digest, key)
        if entry is None or not entry.result.certified:
            # Only certified placements are banked; the certificate guard
            # is belt-and-braces against a blob restored from elsewhere.
            self.metrics.inc("spec_miss")
            return None
        self.metrics.inc("spec_hit")
        self._span.add_event(
            "spec_hit", digest=digest, weight=round(entry.weight, 4)
        )
        devs = self.fleet.device_list()
        # Warm donation: seed the next tick from the served scenario's
        # iterates (shape recomputed the way StreamingReplanner.step
        # would, so the seed engages instead of being shape-rejected).
        # peek, not get: serving from the bank must neither skew the pool
        # hit-rate counters nor mint/evict planners — a key whose planner
        # was LRU-evicted simply forgoes the donation.
        planner = self.pool.peek(key)
        if planner is not None:
            from ..solver.moe import model_has_moe_components

            use_moe = (
                model_has_moe_components(self.fleet.model)
                if planner.moe is None
                else bool(planner.moe)
            )
            planner.last = entry.result
            planner._last_shape = (len(devs), self.fleet.model.L, use_moe)
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics.observe("event_to_placement", ms)
        self.metrics.observe("spec_hit_ms", ms)
        self.metrics.observe(
            "structural_tick" if structural else "drift_tick", ms
        )
        self.metrics.inc(
            f"{'structural' if structural else 'drift'}_tick_spec"
        )
        return self._publish(entry.result, "spec", key, planner, devs, ms)

    def _spec_near_probe(self, key, structural) -> Optional[PlacementView]:
        """Degraded-mode serving: the bank's nearest certified match.

        Runs ONLY on pressure ticks whose exact probe missed. A hit serves
        a placement certified on an instance within ``spec_near_radius``
        tolerance buckets of the live one (worst channel), published as
        ``mode='spec_near'`` so readers can see the answer is approximate
        by construction, not merely stale. No warm-state donation: the
        entry's iterates belong to a nearby-but-different instance, and
        the next unpressured solve should seed from the incumbent chain
        as usual. A miss (nothing close enough banked) falls through to
        the normal solve — the queue is behind either way, and solving is
        the only remaining answer.
        """
        t0 = time.perf_counter()
        devs = self.fleet.device_list()
        found = self.spec_bank.nearest(
            devs, self.fleet.model, key, max_radius=self.spec_near_radius
        )
        if found is None:
            self.metrics.inc("spec_near_miss")
            return None
        entry, dist = found
        self.metrics.inc("spec_near_hit")
        self._span.add_event(
            "spec_near_hit", distance=dist, weight=round(entry.weight, 4)
        )
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics.observe("event_to_placement", ms)
        self.metrics.observe(
            "structural_tick" if structural else "drift_tick", ms
        )
        self.metrics.inc(
            f"{'structural' if structural else 'drift'}_tick_spec_near"
        )
        return self._publish(
            entry.result, "spec_near", key, self.pool.peek(key), devs, ms
        )

    def _spec_presolve(self, key, planner, result: HALDAResult) -> None:
        """Refill the bank after a solved tick: bank the fresh solve under
        its own digest (oscillating churn returns to it), then pre-solve
        the forecaster's K candidate futures in ONE scenario batch (the
        lanes of one search), warm-seeded from the incumbent.

        Best-effort by design: any failure (out-of-class drift splitting
        the static half, an infeasible future, a CPU-only build) costs
        only this tick's speculation, never the serving path — and reads
        the replanner's warm state without ever writing it.
        """
        bank = self.spec_bank
        # Certified placements only, incumbents included: a banked entry
        # is served verbatim later, with no ladder to escalate it — an
        # uncertified one would silently bypass --fail-uncertified.
        if result.certified:
            bank.put(
                bank.digest(self.fleet),
                BankEntry(
                    result=result, key=key, weight=1.0,
                    solved_seq=self.fleet.seq,
                    buckets=bucket_vector(
                        self.fleet.device_list(), self.fleet.model,
                        bank.tolerance,
                    ),
                ),
            )
        if self.backend != "torch":
            return  # scenario batching is a torch-backend path
        candidates = self.forecaster.forecast(self.fleet, self.spec_k)
        fresh = []
        for devs_c, w in candidates:
            d = candidate_digest(
                devs_c, self.fleet.model, key, bank.tolerance
            )
            if d not in bank:
                fresh.append((d, devs_c, w))
        if not fresh:
            return
        t0 = time.perf_counter()
        with self.tracer.span(
            "sched.speculate", attrs={"batch": len(fresh)}
        ) as span:
            try:
                results = presolve_candidates(
                    [(devs_c, w) for _, devs_c, w in fresh],
                    self.fleet.model,
                    k_candidates=self.k_candidates,
                    mip_gap=self.mip_gap,
                    kv_bits=self.kv_bits,
                    moe=self.moe,
                    warm=result,
                    load_factors=getattr(planner, "_load_factors", None),
                    lp_backend=self.lp_backend,
                    pdhg_iters=self.pdhg_iters,
                    pdhg_restart_tol=self.pdhg_restart_tol,
                    pdhg_dtype=self.pdhg_dtype,
                    device=self.device,
                )
            except (RuntimeError, ValueError, NotImplementedError) as e:
                self.metrics.inc("spec_presolve_failed")
                # Flight-record attribution: the known row-scale-crossing
                # ValueError class of presolve failure must be visible in
                # the post-mortem, not just a counter bump.
                self._tick_exc["spec_presolve_failed"] = type(e).__name__
                span.add_event(
                    "presolve_failed", error=f"{type(e).__name__}: {e}"
                )
                return
            banked = 0
            for (d, devs_c, w), res in zip(fresh, results):
                if not res.certified:
                    continue  # never bank what --fail-uncertified rejects
                banked += 1
                bank.put(
                    d,
                    BankEntry(
                        result=res, key=key, weight=w,
                        solved_seq=self.fleet.seq,
                        buckets=bucket_vector(
                            devs_c, self.fleet.model, bank.tolerance
                        ),
                    ),
                )
            if banked:
                self.metrics.inc("spec_presolve", banked)
            span.set_attr("banked", banked)
        self.metrics.observe(
            "spec_presolve_ms", (time.perf_counter() - t0) * 1e3
        )

    def speculation_snapshot(self) -> dict:
        """Plain-dict speculation view (serve summary / tests)."""
        c = self.metrics.counters
        hits = c.get("spec_hit", 0)
        misses = c.get("spec_miss", 0)
        probes = hits + misses
        return {
            "enabled": self.speculative,
            "hits": hits,
            "misses": misses,
            "near_hits": c.get("spec_near_hit", 0),
            "presolved": c.get("spec_presolve", 0),
            "presolve_failed": c.get("spec_presolve_failed", 0),
            "stale": c.get("spec_stale", 0),
            "bank_size": len(self.spec_bank) if self.speculative else 0,
            "hit_rate": round(hits / probes, 4) if probes else 0.0,
        }

    # -- fault-hardened solve path ----------------------------------------

    def _solve_with_guards(self, planner, devs, tick_tm: dict):
        """One tick's solve under the reliability policy: optional fault
        hook, bounded exponential-backoff retries, wall-clock deadline.

        With every knob at its default (no deadline, no retries, no hook)
        this is exactly ``planner.step(...)`` — one call, no threads, no
        copies. The first-ever solve is exempt from the deadline: with
        nothing published there is no last-known-good to serve instead,
        so abandoning the solve could only turn a slow start into an
        outage.
        """
        deadline = self.solve_deadline_s if self._published is not None else None
        attempts = max(1, self.max_retries + 1)
        last_exc: Optional[Exception] = None
        for attempt in range(attempts):
            if attempt:
                self.metrics.inc("solve_retries")
                self._span.add_event("solve_retry", attempt=attempt)
                time.sleep(
                    min(
                        self.retry_backoff_s * (2 ** (attempt - 1)),
                        self.retry_backoff_max_s,
                    )
                )
            try:
                if deadline is None:
                    result = self._attempt(planner, devs, self.fleet.model,
                                           tick_tm, attempt)
                else:
                    result = self._attempt_deadline(planner, devs, tick_tm,
                                                    attempt, deadline)
            except _DeadlineMiss:
                raise  # a miss is a tick-level outcome, not retryable
            except (RuntimeError, ValueError, NotImplementedError) as e:
                self.metrics.inc("solve_attempt_failed")
                # The exception CLASS rides into the tick's flight record
                # (the counter alone is a bare bump post-mortem).
                self._tick_exc["solve_attempt_failed"] = type(e).__name__
                self._span.add_event(
                    "solve_attempt_failed",
                    attempt=attempt,
                    error=f"{type(e).__name__}: {e}",
                )
                last_exc = e
                continue
            if attempt:
                self.metrics.inc("solve_retry_success")
            return result
        raise last_exc  # every attempt failed

    def _maybe_profiled_solve(self, planner, devs, tick_tm: dict):
        """The solve, optionally wrapped in a ``torch.profiler`` trace.

        ``profile_dir`` (``serve --profile-dir``) captures the FIRST solve
        tick only (the cold solve, with its kernel builds and its graph
        capture) as ``<profile_dir>/solve_profile.json``, Chrome
        trace-event JSON, then steps aside. The card's activity is traced
        process-wide (CUPTI), so the capture covers the solve even when
        the deadline path runs it on the worker thread.
        """
        if self.profile_dir is not None and not self._profiled:
            self._profiled = True
            from pathlib import Path

            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            path = Path(self.profile_dir) / "solve_profile.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            self._span.add_event("torch_profile", path=str(path))
            with torch.profiler.profile(activities=activities) as prof:
                result = self._solve_with_guards(planner, devs, tick_tm)
            prof.export_chrome_trace(str(path))
            return result
        return self._solve_with_guards(planner, devs, tick_tm)

    def _attempt(self, planner, devs, model, tick_tm: dict, attempt: int):
        if self.fault_hook is not None:
            self.fault_hook(attempt)
        return planner.step(
            devs, model, k_candidates=self.k_candidates, timings=tick_tm
        )

    def _attempt_deadline(self, planner, devs, tick_tm, attempt, deadline):
        """Run the attempt on the daemon worker, bounded by the deadline.

        An overrun solve cannot be interrupted (it is deep inside a
        device solve); it is *abandoned*: the service serves stale and the
        worker finishes in the background (daemon thread — it can never
        block process exit). The next tick first drains the abandoned
        attempt (bounded by one more deadline) before dispatching fresh
        work — one solve in flight, ever, so planner warm state is never
        written by two solves at once. Device/model profiles are
        deep-copied for the worker because later events mutate them in
        place while an abandoned solve may still be reading them. Known
        skew, accepted: an abandoned solve that eventually finishes still
        reports its tick through the shared metrics sink (record_tick)
        even though its result is discarded — the drain counter
        (``abandoned_solves_drained``) bounds how many ticks that can be.
        """
        if self._executor is None:
            self._executor = _SolveWorker()
        if self._abandoned is not None:
            box, done = self._abandoned
            if not done.wait(timeout=deadline):
                self.metrics.inc("deadline_backlog")
                raise _DeadlineMiss()
            # Finished (result or failure): either way it was already
            # billed as a deadline miss; discard and move on.
            self.metrics.inc("abandoned_solves_drained")
            self._abandoned = None
        devs_snap = [d.model_copy(deep=True) for d in devs]
        model_snap = self.fleet.model.model_copy(deep=True)
        box, done = self._executor.submit(
            lambda: self._attempt(planner, devs_snap, model_snap, tick_tm,
                                  attempt)
        )
        if not done.wait(timeout=deadline):
            self._abandoned = (box, done)
            raise _DeadlineMiss()
        if "exc" in box:
            raise box["exc"]
        return box["result"]

    def _solve_failed(self, probing: bool) -> None:
        """Consecutive-failure + breaker bookkeeping after a failed tick."""
        self._consec_failures += 1
        self._note_fault()
        if probing:
            # Half-open probe failed: straight back to open, full cooldown.
            self.metrics.inc("breaker_reopen")
            self._span.add_event("breaker_reopen")
            self._breaker_cooldown_left = self.breaker_cooldown
            return
        if (
            self.breaker_threshold > 0
            and not self._breaker_open
            and self._consec_failures >= self.breaker_threshold
        ):
            self._breaker_open = True
            self._breaker_cooldown_left = self.breaker_cooldown
            self.metrics.inc("breaker_open")
            self._span.add_event("breaker_open")
            self._set_health(HEALTH_BROKEN)
            if self._flight is not None:
                # Post-mortem moment: the dump happens at the END of this
                # handle (after the tick's own record lands in the ring),
                # so the breaker-open tick is IN its own post-mortem.
                self._flight_pending = "breaker_open"

    def _on_clean_solve(self, probing: bool) -> None:
        """A solve succeeded: close the breaker (if probing) and advance
        the recovery streak toward healthy."""
        self._consec_failures = 0
        if probing:
            self._breaker_open = False
            self._breaker_cooldown_left = 0
            self.metrics.inc("breaker_close")
            self._span.add_event("breaker_close")
            self._set_health(HEALTH_DEGRADED)  # until the streak clears it
        self._clean_streak += 1
        if (
            self.health != HEALTH_HEALTHY
            and not self._breaker_open
            and self._clean_streak >= self.healthy_after
        ):
            self._set_health(HEALTH_HEALTHY)
            self.metrics.inc("health_recovered")

    def _note_fault(self) -> None:
        """Any fault (quarantine, miss, failure) degrades health and resets
        the clean streak; an open breaker pins health at broken."""
        self._clean_streak = 0
        self._set_health(
            HEALTH_BROKEN if self._breaker_open else HEALTH_DEGRADED
        )

    def _set_health(self, state: str) -> None:
        """Health assignment with the transition recorded as a span event
        (only actual CHANGES — repeated faults at the same state are
        already visible as their own events)."""
        if state != self.health:
            self.health = state
            self._span.add_event("health", state=state)

    def _serve_stale(self, mode: str) -> PlacementView:
        """Re-serve the last-known-good placement under a degraded mode.

        The published view's ``mode`` is rewritten ('stale' | 'degraded')
        so readers of ``latest()`` see HOW the current answer is being
        served, not how it was once produced; ``seq``/``events_behind``
        already carry how far behind it is.
        """
        if self._published is None:
            raise RuntimeError(
                "no placement published yet; cannot serve a stale answer"
            )
        if self._published.mode != mode:
            self._published = self._published._replace(mode=mode)
        self.metrics.inc(f"served_{mode}")
        self._span.add_event("served_stale", mode=mode)
        return self.latest()

    def _solve_threads(self) -> set:
        """Thread idents this tick's solves (and presolves) may compile
        on: the handling thread itself plus the deadline worker. The
        compile-ledger capture filters on these so concurrent shards'
        compiles are never cross-billed to this scheduler's tick."""
        import threading

        threads = {threading.get_ident()}
        if self._executor is not None and self._executor.ident is not None:
            threads.add(self._executor.ident)
        return threads

    def _note_compiles(self, led, token: int, span) -> None:
        """Attribute this tick's compile-ledger events: counters
        (``compiles``/``compile_cache_hits``/``recompile_storms`` +
        the ``compile_ms`` hist) ride the shared metrics sink — and
        therefore ``timeline_sample``'s ``c.*`` series and the gateway's
        shard aggregation — while the event detail lands on the tick
        span and the flight record. Zero events = zero work, and with no
        ledger enabled this is never called (the byte-identical pin)."""
        events = led.events_since(token, threads=self._solve_threads())
        if not events:
            return
        n = len(events)
        hits = sum(1 for e in events if e.get("cache") == "hit")
        ms = sum(e.get("compile_ms") or 0.0 for e in events)
        # Episode TRANSITIONS only (ev["storm_start"]), never the per-
        # event storm flags: the counter must agree with the ledger's
        # `storms` total and the c.recompile_storms timeline series —
        # one alarm per episode, however many compiles it contains.
        storms = sum(1 for e in events if e.get("storm_start"))
        causes: dict = {}
        for e in events:
            causes[e["cause"]] = causes.get(e["cause"], 0) + 1
        self.metrics.inc("compiles", n)
        if hits:
            self.metrics.inc("compile_cache_hits", hits)
        if storms:
            self.metrics.inc("recompile_storms", storms)
        self.metrics.observe("compile_ms", ms)
        span.set_attr("compiles", n)
        span.set_attr("compile_ms", round(ms, 3))
        span.set_attr(
            "compile_causes",
            ",".join(f"{k}:{v}" for k, v in sorted(causes.items())),
        )
        self._tick_compile = {
            "count": n,
            "ms": round(ms, 3),
            "cache_hits": hits,
            "causes": causes,
            "entries": sorted({e["entry"] for e in events}),
        }
        if storms:
            self._tick_compile["storms"] = storms
            span.add_event("recompile_storm", count=storms)
            if self._flight is not None and self._flight_pending is None:
                # A storm is a post-mortem moment of its own class: dump
                # the ring after this tick's record lands (same deferred
                # shape as breaker_open, never clobbering one).
                self._flight_pending = "recompile_storm"

    def _note_memory(self, mled, span) -> None:
        """Attribute this tick's memory watermark (obs.memory): one
        throttled ledger sample; on ticks where a FRESH sample landed the
        live/RSS bytes (+ the live-byte delta vs the previous fresh
        sample — the leak gate's per-tick view) ride the tick span, the
        ``mem_live_mb``/``mem_rss_mb`` hists and the flight record. A
        cached (throttled) sample records nothing — attaching a stale
        watermark to this tick would claim a measurement that did not
        happen. With no ledger enabled this is never called (the
        byte-identical pin)."""
        rec = mled.sample()
        if not rec.get("fresh"):
            return
        self.metrics.inc("mem_samples")
        live = rec.get("live_bytes")
        rss = rec.get("rss_bytes")
        tick_mem: dict = {}
        if live is not None:
            self.metrics.observe("mem_live_mb", live / 1e6)
            span.set_attr("mem_live_bytes", live)
            tick_mem["live_bytes"] = live
            prev = self._mem_prev_live
            if prev is not None:
                span.set_attr("mem_live_delta", live - prev)
                tick_mem["live_delta"] = live - prev
            self._mem_prev_live = live
        if rss is not None:
            self.metrics.observe("mem_rss_mb", rss / 1e6)
            span.set_attr("mem_rss_bytes", rss)
            tick_mem["rss_bytes"] = rss
        if tick_mem:
            self._tick_mem = tick_mem

    def _flight_note(self, event, view: Optional[PlacementView], span) -> None:
        """Append this tick's flight record; fire any pending post-mortem.

        Counter DELTAS, not totals: the record answers "what did THIS tick
        do" (one quarantine? a retry plus a breaker transition?) without
        the reader diffing snapshots. The span ids tie the record to the
        trace when tracing is on (None otherwise). Runs only with a
        recorder attached — the default path never builds the dicts.
        """
        counters = dict(self.metrics.counters)
        prev = self._flight_prev_counters
        delta = {
            k: v - prev.get(k, 0)
            for k, v in counters.items()
            if v != prev.get(k, 0)
        }
        self._flight_prev_counters = counters
        ctx = span.context()
        rec = {
            "seq": self.fleet.seq,
            "kind": getattr(event, "kind", type(event).__name__),
            "mode": view.mode if view is not None else "error",
            "health": self.health,
            "lp_backend": self._last_lp_backend,
            "trace_id": ctx.trace_id if ctx is not None else None,
            "span_id": ctx.span_id if ctx is not None else None,
            "counters_delta": delta,
        }
        if self._tick_exc:
            # Exception classes behind this tick's failure counters
            # (solve_attempt_failed / spec_presolve_failed): the counter
            # says a solve raised, this says WHAT raised.
            rec["exc"] = dict(self._tick_exc)
        if self._tick_conv is not None:
            # Solver-diagnostics digest (Scheduler(diagnostics=True)): the
            # tick's convergence facts next to its mode/health/deltas.
            rec["convergence"] = dict(self._tick_conv)
        if self._tick_compile is not None:
            # A tick that paid a kernel build or a graph capture says so —
            # and why (cause
            # taxonomy + which entry points): the multi-second span a
            # post-mortem would otherwise call 'unexplained'.
            rec["compile"] = dict(self._tick_compile)
        if self._tick_mem is not None:
            # The tick's memory watermark (fresh samples only): a leak's
            # post-mortem reads which tick the live bytes stepped on.
            rec["mem"] = dict(self._tick_mem)
        if self.speculative:
            # The post-mortem question speculation adds: was THIS tick a
            # hit or a miss, and how full was the bank when it happened?
            rec["spec"] = {
                "hit": delta.get("spec_hit", 0) > 0,
                "miss": delta.get("spec_miss", 0) > 0,
                "bank": len(self.spec_bank),
            }
        self._flight.record(self._flight_key, rec)
        if self._flight_pending is not None:
            reason, self._flight_pending = self._flight_pending, None
            path = self._flight.trigger(self._flight_key, reason, rec)
            if path is not None:
                self.metrics.inc("flight_dumps")

    def health_snapshot(self) -> dict:
        """Plain-dict health view for the serve CLI / metrics endpoint."""
        return {
            "state": self.health,
            "breaker_open": self._breaker_open,
            "breaker_cooldown_left": self._breaker_cooldown_left,
            "consecutive_failures": self._consec_failures,
            "clean_streak": self._clean_streak,
            "quarantined_events": len(self.quarantined),
            "last_error": self._last_error,
        }

    def close(self) -> None:
        """Release the deadline worker (no-op when never used). The worker
        is a daemon thread, so even without close() an abandoned solve
        cannot block process exit."""
        if self._executor is not None:
            self._executor.stop()
            self._executor = None
            self._abandoned = None

    def _risk_select(self, devs, fresh: HALDAResult, planner):
        """Score the fresh solve + cached pool incumbents on the twin.

        Candidates are every pooled replanner's last placement that is
        structurally executable on the CURRENT fleet (right device count,
        window sums, offload/expert cover — ``twin.placement_applicable``);
        each is priced by Monte-Carlo p95 plus a feasibility-violation
        penalty under one seeded perturbation model, so the comparison is
        paired (same draws) and deterministic per tick. Load-aware MoE
        ticks score at the replanner's realized per-device load factors —
        the same prices the fresh solve's y-units were solved at. Returns
        ``(served, twin_p95_s, switched)``; any twin failure falls back to
        the fresh placement (serving must never break on scoring).
        """
        from ..solver.backend_torch import resolve_device

        # Outside the advisory try: the twin runs on ``device``, and a run
        # without the card it asked for raises instead of scoring nothing.
        resolve_device(self.device)
        try:
            from ..twin import (
                applicable_candidates,
                build_twin_arrays,
                twin_p95_score,
            )

            factors = getattr(planner, "_load_factors", None)
            if factors is not None and len(factors) != len(devs):
                factors = None
            arrays = build_twin_arrays(
                devs, self.fleet.model, kv_bits=self.kv_bits, moe=self.moe,
                load_factors=factors,
            )
            seen = {self._placement_key(fresh)}
            candidates = [fresh]
            for cached in self._risk_candidates(devs, factors):
                pk = self._placement_key(cached)
                if pk in seen:
                    continue
                seen.add(pk)
                candidates.append(cached)
            candidates = applicable_candidates(arrays, candidates)
            if fresh not in candidates:  # paranoia: fresh must stay eligible
                candidates.insert(0, fresh)
            self.metrics.inc("risk_eval")
            self.metrics.inc("risk_candidates", len(candidates))
            scores = [
                twin_p95_score(
                    devs,
                    self.fleet.model,
                    c,
                    samples=self.risk_samples,
                    seed=self.risk_seed,
                    kv_bits=self.kv_bits,
                    moe=self.moe,
                    arrays=arrays,
                    device=self.device,
                    **self.risk_mc,
                )
                for c in candidates
            ]
            best = min(range(len(candidates)), key=lambda i: scores[i]["score"])
            served = candidates[best]
            switched = served is not fresh
            if switched:
                self.metrics.inc("risk_switch")
            self.metrics.observe("twin_p95", scores[best]["p95_s"] * 1e3)
            return served, scores[best]["p95_s"], switched
        except Exception as e:  # scoring is advisory; serving must survive
            self.metrics.inc("risk_error")
            self._last_error = f"risk_select {type(e).__name__}: {e}"
            return fresh, None, False

    def _risk_candidates(self, devs, load_factors=None):
        """Alternative placements worth scoring against the fresh solve.

        Two sources: (1) every pooled replanner's cached incumbent — a
        fleet identity seen before keeps its placement alive in the warm
        pool, and risk scoring is what justifies serving it over the
        fresh one; (2) the solver-enumerated k-candidates of the current
        problem identity (``halda_solve_per_k``): the objective ranks
        pipeline depths within mip-gap-scale margins, but their risk
        profiles differ structurally (deeper pipelines ride the bottleneck
        cycle (k-1) times; shallower ones concentrate layers), so the twin
        regularly prefers a runner-up k. The per-k sweep is COLD and
        therefore cached per identity: drift ticks reuse the enumeration
        (the twin re-prices every candidate against the live profiles;
        ``placement_applicable`` drops any that stop fitting), only a
        structural identity change re-enumerates. torch-backend only and
        best-effort: a failure costs candidates, never the tick.
        """
        out = []
        for _, planner in self.pool.items():
            if planner.last is not None:
                out.append(planner.last)
        if self.backend != "torch":
            return out
        # Cache key is the drift-invariant problem identity: load factors
        # may drift between ticks, but stale per-k placements stay valid
        # CANDIDATES (the twin re-prices them at the live factors).
        key = self.fleet.key()
        if key != self._risk_per_k_key:
            from ..solver import halda_solve_per_k

            try:
                self._risk_per_k = halda_solve_per_k(
                    devs,
                    self.fleet.model,
                    k_candidates=self.k_candidates,
                    mip_gap=self.mip_gap,
                    kv_bits=self.kv_bits,
                    moe=self.moe,
                    load_factors=load_factors,
                    # The enumeration honors the same engine pin as the
                    # tick solves — an operator who pinned away from an
                    # engine must not get candidates from it.
                    lp_backend=self.lp_backend,
                    pdhg_iters=self.pdhg_iters,
                    pdhg_restart_tol=self.pdhg_restart_tol,
                    mesh_shards=self.mesh_shards,
                    pdhg_dtype=self.pdhg_dtype,
                    device=self.device,
                )
                self._risk_per_k_key = key
            except (RuntimeError, ValueError, NotImplementedError):
                self.metrics.inc("risk_per_k_failed")
                self._risk_per_k = []
                self._risk_per_k_key = None
        out.extend(self._risk_per_k)
        return out

    @staticmethod
    def _placement_key(result: HALDAResult) -> tuple:
        """Assignment identity for candidate dedup (pool keys alias)."""
        return (
            result.k,
            tuple(result.w),
            tuple(result.n),
            tuple(result.y) if result.y is not None else None,
        )

    # -- the read side -----------------------------------------------------

    def latest(self) -> PlacementView:
        """The most recent published placement, with live staleness fields.

        Never solves, never blocks: readers pay a tuple copy. Raises
        ``RuntimeError`` only when nothing has ever been published.
        """
        if self._published is None:
            raise RuntimeError(
                "no placement published yet; handle an event first (or "
                "construct with solve_on_init=True)"
            )
        return self._published._replace(
            fleet_seq=self.fleet.seq,
            events_behind=self.fleet.seq - self._published.seq,
            age_s=time.monotonic() - self._published_at,
        )

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def timeline_sample(self) -> dict:
        """One flat ``{series: value}`` sample for the metrics timeline
        (``obs.timeline.TimelineSampler``'s sample_fn on the
        single-scheduler serving path).

        Carries the SLO inputs the spec layer names: every counter
        (``c.<name>``, cumulative), latency quantiles (``lat.<hist>.*``
        — iters-to-certify rides ``lat.ipm_iters_executed``), the serve
        clock (``last_serve_ms``), the health rank, and — when solver
        diagnostics are on — the latest tick's ``conv_*`` digest
        (``conv.<key>``). Pure read; no timeline knob engaged means this
        is simply never called.
        """
        from ..obs.timeline import flatten_metrics_snapshot

        out = flatten_metrics_snapshot(self.metrics.snapshot())
        out["last_serve_ms"] = float(self.last_serve_ms)
        out["health"] = float(
            {HEALTH_HEALTHY: 0, HEALTH_DEGRADED: 1, HEALTH_BROKEN: 2}[
                self.health
            ]
        )
        if self._tick_conv:
            for k, v in self._tick_conv.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[f"conv.{k}"] = float(v)
        led = _compile_ledger.current()
        if led is not None:
            # Process-wide compile telemetry (timeline_series is the one
            # definition, shared with Gateway.timeline_sample): an SLO
            # over c.compiles / c.recompile_storms sees a storm's full
            # delta, and the feature-off sample stays byte-identical.
            out.update(led.timeline_series())
        mled = _memory.current()
        if mled is not None:
            # mem.* watermark gauges (obs.memory.timeline_series, the one
            # definition shared with Gateway.timeline_sample): absent —
            # never zeroed — when a value is unavailable, and emitted
            # only while a ledger is enabled (feature-off byte-identical).
            out.update(mled.timeline_series())
        return out

    # -- warm snapshot / restore (the gateway's drain/restore cycle) -------

    def dump_state(self) -> dict:
        """The scheduler's full warm state as one JSON-able blob.

        Everything a restored scheduler needs to resume serving mid-trace
        with warm ticks: the live fleet snapshot (devices + model + event
        seq), the published placement (so ``latest()`` serves immediately),
        the health/breaker machine, and the warm pool — every replanner's
        incumbent, duals, LP iterates and margin anchor via
        ``StreamingReplanner.dump_warm_state`` (bit-exact round trip).
        Metrics counters are NOT included: a restored process starts fresh
        observability, and the ``warm_resumes``/``cold_resumes`` counters
        are what audit the restore itself. The risk-aware per-k candidate
        cache is also dropped — it is re-enumerated on demand (a cold
        *enumeration*, never a cold serving tick).
        """
        # A deadline-abandoned solve still runs on the sched-solve daemon
        # thread and writes the planner's warm state (last/_margin_state)
        # when it finally finishes — dumping concurrently could pair an
        # incumbent and LP iterates from different ticks (or crash
        # encoding a dict mutated mid-walk). Drain it first: the solve is
        # finite device work, and a snapshot's consistency outranks its
        # latency. On the card the drained solve's graph ran on the worker
        # thread's stream: synchronize the device before its state is read.
        if self._abandoned is not None:
            _box, done = self._abandoned
            done.wait()
            self.metrics.inc("abandoned_solves_drained")
            self._abandoned = None
            if self.backend == "torch":
                import torch

                from ..solver.backend_torch import resolve_device

                dev = resolve_device(self.device)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        published = None
        if self._published is not None:
            v = self._published
            published = {
                "result": v.result.model_dump(),
                "seq": v.seq,
                "mode": v.mode,
                "key": list(v.key),
                "twin_p95_s": v.twin_p95_s,
                "risk_selected": v.risk_selected,
            }
        state_spec = None
        if self.speculative:
            # Speculation state rides the snapshot (additive, versioned by
            # the blob's top-level version): forecaster EWMA/trend plus the
            # bank's entries with their LP iterates bit-exact, so a
            # restored shard's first matching event still hits. Old blobs
            # without the block restore clean — an empty bank refills from
            # the first post-restore solved tick.
            state_spec = {
                "forecaster": self.forecaster.dump_state(),
                "bank": self.spec_bank.dump_state(),
            }
        return {
            "version": 1,
            "spec": state_spec,
            "devices": [d.model_dump() for d in self.fleet.device_list()],
            "model": self.fleet.model.model_dump(),
            "seq": self.fleet.seq,
            "health": self.health,
            "breaker_open": self._breaker_open,
            "breaker_cooldown_left": self._breaker_cooldown_left,
            "consec_failures": self._consec_failures,
            "clean_streak": self._clean_streak,
            "last_error": self._last_error,
            "published": published,
            # LRU order preserved oldest-first so adoption re-creates it.
            "pool": [
                {"key": list(key), "warm": planner.dump_warm_state()}
                for key, planner in self.pool.items()
            ],
        }

    def load_state(self, state: dict) -> None:
        """Restore a ``dump_state`` blob into this scheduler.

        The scheduler must have been constructed with the same solver
        configuration (gap, backend, engine pins — the blob carries state,
        not config); fleet and model are taken from the blob, so the
        constructor's devices only seeded routing. The first tick after a
        restore self-reports through ``warm_resumes``/``cold_resumes``.
        """
        if state.get("version") != 1:
            raise ValueError(
                f"unknown scheduler state version {state.get('version')!r}"
            )
        from ..common import DeviceProfile, ModelProfile

        devices = [DeviceProfile.model_validate(d) for d in state["devices"]]
        model = ModelProfile.model_validate(state["model"])
        self.fleet = FleetState(devices, model)
        self.fleet.seq = state["seq"]
        self.health = state["health"]
        self._breaker_open = state["breaker_open"]
        self._breaker_cooldown_left = state["breaker_cooldown_left"]
        self._consec_failures = state["consec_failures"]
        self._clean_streak = state["clean_streak"]
        self._last_error = state.get("last_error")
        for entry in state["pool"]:
            planner = self._make_replanner()
            planner.load_warm_state(entry["warm"])
            self.pool.adopt(tuple(entry["key"]), planner)
        self._restored_keys = frozenset(
            tuple(entry["key"]) for entry in state["pool"]
        )
        pub = state.get("published")
        if pub is not None:
            self._published = PlacementView(
                result=HALDAResult.model_validate(pub["result"]),
                seq=pub["seq"],
                fleet_seq=self.fleet.seq,
                events_behind=self.fleet.seq - pub["seq"],
                age_s=0.0,
                mode=pub["mode"],
                key=tuple(pub["key"]),
                twin_p95_s=pub.get("twin_p95_s"),
                risk_selected=bool(pub.get("risk_selected", False)),
            )
            self._published_at = time.monotonic()
        if self.speculative:
            spec = state.get("spec") or {}
            self.forecaster.load_state(spec.get("forecaster"))
            self.spec_bank.load_state(spec.get("bank"))
        self._risk_per_k = []
        self._risk_per_k_key = None
        self._restore_pending = True
        self.metrics.inc("state_restored")

    _last_error: Optional[str] = None


def drift_warm_share(metrics: SchedulerMetrics) -> float:
    """Fraction of drift events served by warm, margin or speculative ticks.

    The streaming north star's health gauge: pure coefficient drift should
    essentially never pay a cold solve (the acceptance bar is >= 0.6; in
    practice it is ~1.0 — cold drift ticks mean the pool is thrashing).
    A speculative bank hit counts as fast — it is the fastest serve there
    is — otherwise enabling --speculate would collapse the gauge exactly
    when the feature works. Failed drift ticks count against the share; a
    tick the escalation ladder restarted cold still counts by its ENTRY
    mode, since the entry mode is what the event routing chose.
    """
    c = metrics.counters
    # .get everywhere, for two reasons: a bracket read on the live
    # defaultdict would MINT a speculation counter into the default
    # (spec-off) path's summary output — breaking the byte-identical
    # contract — and a process-backed shard's counters arrive as a PLAIN
    # dict snapshotted over RPC, where a missing key is a KeyError.
    drift = c.get("drift_events", 0)
    if not drift:
        return 1.0
    fast = (
        c.get("drift_tick_warm", 0)
        + c.get("drift_tick_margin", 0)
        + c.get("drift_tick_spec", 0)
        + c.get("drift_tick_spec_near", 0)
    )
    return fast / drift
