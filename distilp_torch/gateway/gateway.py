"""The gateway: N solve workers behind consistent-hash shard ownership.

The port's copy of ``distilp_tpu/gateway/gateway.py``: every shard's
scheduler, the combiner's batched solves and ``warm_combine`` run on the
gateway's ``device`` (None = cuda, raising without a GPU; ``'cpu'`` runs
the kernels' plain versions), worker processes included (the device rides
their build spec). ``distilp_torch.sched.Scheduler`` is one fleet's replanning daemon; this
tier owns MANY of them. Each (fleet_id, model_id) shard maps to exactly
one ``ShardWorker`` (``router.ConsistentHashRouter``), which runs that
shard's ``Scheduler`` unchanged on its own thread — so independent fleets
solve concurrently while any single shard's ticks stay strictly
serialized, and every hardening knob (quarantine, deadlines,
retries, breaker, per-shard HealthState) rides along for free. A broken
fleet degrades ITS shard's health; the others never see it.

Ingest is synchronous (``handle_event`` — the trace replay path) or
asyncio (``handle_event_async`` — the HTTP tier): both enqueue on the
owning worker, so ordering per fleet is the submission order either way.

``snapshot()`` drains every worker (a queued barrier — queued events
finish first) and serializes each shard's warm state into a
``GatewaySnapshot``; ``load_snapshot`` restores shards — re-routed by the
CURRENT worker count — with their incumbents, duals, LP iterates and
margin anchors intact, so the first tick after a restore rides warm
(``warm_resumes`` counts the proof, ``cold_resumes`` the violations).
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import TYPE_CHECKING, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

if TYPE_CHECKING:
    from ..obs.flight import FlightRecorder

from ..common import DeviceProfile, ModelProfile
from ..obs.trace import NOOP_TRACER
from ..sched.events import STRUCTURAL_KINDS
from ..sched.metrics import (
    HEALTH_BROKEN,
    HEALTH_DEGRADED,
    HEALTH_HEALTHY,
    SchedulerMetrics,
)
from ..sched.scheduler import PlacementView, Scheduler
from ..utils.lockwatch import make_lock
from .procworker import WorkerCrashed
from .recovery import RecoveryStore, Supervisor
from .router import ConsistentHashRouter, shard_key
from .snapshot import GatewaySnapshot, ShardSnapshot
from .worker import ShardWorker, WorkerQueueFull

# Counters aggregated across shards into the gateway metrics snapshot —
# the serving-tier dashboard without grepping per-shard dumps.
_AGGREGATED_SHARD_COUNTERS = (
    "events_total",
    "events_quarantined",
    "tick_cold",
    "tick_warm",
    "tick_margin",
    "tick_failed",
    "tick_certified",
    "tick_uncertified",
    "warm_resumes",
    "cold_resumes",
    "deadline_missed",
    "breaker_open",
    "solver_escalations",
    "spec_hit",
    "spec_miss",
    "spec_stale",
    "spec_presolve",
    "spec_presolve_failed",
    "spec_near_hit",
    "spec_near_miss",
    "events_coalesced",
    # Cross-shard combine path (distilp_torch.combine): per-shard routing
    # outcomes; the combiner's own batch counters live on the gateway
    # metrics directly.
    "combine_prepared",
    "combine_local",
    "combine_stale",
    "combine_fallback",
    # Compile-ledger tick attribution (obs.compile_ledger): which shards'
    # ticks paid kernel loads or graph captures, aggregated for the
    # serving-tier dashboard.
    "compiles",
    "compile_cache_hits",
    "recompile_storms",
)


class QueueFull(Exception):
    """An event was shed at the admission gate (the HTTP tier's 429).

    Raised by ingest when the owning worker's bounded queue is full.
    ``retry_after_s`` is the backoff hint a client should honor (HTTP
    ``Retry-After``): the observed queue depth times the gateway's recent
    mean event-to-placement latency — roughly when the present backlog
    will have drained. Every raise was already counted (``events_shed``)
    and flight-recorded before it left the gateway.
    """

    def __init__(
        self, fleet_id: str, depth: int, retry_after_s: float
    ):
        super().__init__(
            f"fleet {fleet_id!r}: worker queue full ({depth} queued); "
            f"retry after {retry_after_s:.3f}s"
        )
        self.fleet_id = fleet_id
        self.depth = depth
        self.retry_after_s = retry_after_s


class FleetReadView(NamedTuple):
    """A shard fleet's state captured in ONE worker-side closure.

    What ``ShardFacade.fleet`` hands to sequential harnesses: membership,
    model and seq observed at a tick boundary of the owning worker's
    timeline (never mid-tick), plus the published placement's seq from
    the same instant — so a reader can assert tick-boundary consistency
    (``seq == published_seq`` on a clean trace) even under live ingest.
    Device profiles are the live objects (chaos injection deep-copies
    before mutating); the dict itself is a snapshot copy.
    """

    seq: int
    model: object
    devices: Dict[str, object]
    published_seq: Optional[int]

    def device_list(self) -> list:
        return list(self.devices.values())


class Gateway:
    """Horizontally scalable serving tier over sharded solve workers.

    ``scheduler_kwargs`` is the shared solver configuration every shard's
    ``Scheduler`` is built with (mip_gap, kv_bits, backend, k_candidates,
    lp_backend, risk_aware, deadline/retry/breaker knobs, ...);
    ``scheduler_factory(devices, model)`` overrides construction entirely
    (tests inject failing schedulers through it). ``device`` is where every
    shard solves (None = cuda; ``scheduler_kwargs['device']`` when given
    there); it is written into ``scheduler_kwargs`` so that worker
    processes get it in their build spec.
    """

    def __init__(
        self,
        n_workers: int = 1,
        replicas: int = 64,
        scheduler_kwargs: Optional[dict] = None,
        scheduler_factory: Optional[Callable] = None,
        metrics: Optional[SchedulerMetrics] = None,
        tracer=None,
        flight: Optional["FlightRecorder"] = None,
        max_queue_depth: Optional[int] = None,
        coalesce: bool = False,
        degrade_depth: Optional[int] = None,
        mem_degrade_headroom_bytes: Optional[float] = None,
        combine: bool = False,
        combine_policy=None,
        worker_backend: str = "thread",
        dynamic: bool = False,
        supervise: bool = False,
        recovery_dir=None,
        snapshot_every: int = 8,
        crash_loop_threshold: int = 3,
        crash_loop_window_s: float = 30.0,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        device=None,
    ):
        from ..kernels import resolve_device

        if n_workers < 1:
            raise ValueError("gateway needs at least one worker")
        self.n_workers = n_workers
        self.scheduler_kwargs = dict(scheduler_kwargs or {})
        if device is None:
            device = self.scheduler_kwargs.get("device")
        self.device = resolve_device(device, "Gateway")
        self.scheduler_kwargs["device"] = str(self.device)
        self._factory = scheduler_factory
        self.metrics = metrics if metrics is not None else SchedulerMetrics()
        # Observability (distilp_torch.obs), opt-in: ONE tracer and ONE
        # flight recorder shared by the gateway and every shard scheduler
        # it builds — span parenting crosses the worker-queue boundary by
        # attaching the ingest span's context on the worker thread, and
        # flight rings are keyed per fleet. With neither configured the
        # NOOP tracer makes every instrumentation site a constant-cost
        # no-op and schedulers are built exactly as before.
        self.tracer = NOOP_TRACER if tracer is None else tracer
        self.flight = flight
        # -- worker backend + dynamic fleet ----------------------------------
        # worker_backend='process' hosts each worker's schedulers in a
        # dedicated subprocess (own GIL, own CUDA context) behind the same
        # ShardWorker contract; it excludes the cross-shard combiner,
        # chaos fault_hook injection and CALLABLE scheduler factories —
        # none of those cross a process boundary (a 'module:callable'
        # factory string works on both backends).
        if worker_backend not in ("thread", "process"):
            raise ValueError(
                f"worker_backend must be 'thread' or 'process', "
                f"got {worker_backend!r}"
            )
        if worker_backend == "process":
            if combine:
                raise ValueError(
                    "combine needs in-process shard access; use thread "
                    "workers or disable combine"
                )
            if scheduler_factory is not None and not isinstance(
                scheduler_factory, str
            ):
                raise ValueError(
                    "process workers need a 'module:callable' factory "
                    "string (a callable cannot cross a process boundary)"
                )
        self.worker_backend = worker_backend
        if worker_backend == "process" and self.device.type == "cuda":
            # Build (or find) every kernel library BEFORE a child exists:
            # the children load the same content-hashed libraries and
            # compile nothing (never fork after CUDA is initialised: the
            # children are fresh interpreters, see procworker).
            from ..kernels.build import load_all

            load_all()
        # dynamic=True arms live topology changes (spawn/retire/migrate).
        # Default OFF: the static gateway's ingest path takes no
        # migration gate — byte-identical to the pre-autoscaler serving
        # path, pinned by test.
        self._dynamic = bool(dynamic)
        # -- crash tolerance (supervised process tier) ---------------------
        # supervise=True arms the per-worker supervisor: child death is
        # detected (WorkerCrashed), classified, respawned under bounded
        # exponential backoff with a crash-loop breaker, and every
        # accepted event rides a per-fleet WAL + periodic micro-snapshots
        # so a respawned child restores warm and replays only the tail.
        # Default OFF: ingest takes no WAL append, no snapshot cadence,
        # no routing re-check — byte-identical to unsupervised serving
        # (pinned by test). Thread workers share the gateway's own crash
        # domain, so supervision is the process backend's feature.
        self._supervise = bool(supervise)
        if self._supervise and worker_backend != "process":
            raise ValueError(
                "supervise=True needs worker_backend='process' (thread "
                "workers live in the gateway's own crash domain — there "
                "is no child to respawn)"
            )
        self.snapshot_every = max(1, int(snapshot_every))
        self._recovery_store: Optional[RecoveryStore] = None
        self._recovery_tmpdir: Optional[str] = None
        # worker_id -> crash-loop policy; worker_id -> per-worker recovery
        # serialization (recovery always runs on the crashed worker's own
        # thread in steady state; the lock covers rare direct off-thread
        # proxy reads). Per-worker, NOT global: a global lock would let
        # two simultaneously-crashed workers deadlock through a
        # quarantine's cross-worker rebuild round trips.
        self._supervisors: Dict[int, Supervisor] = {}
        self._recover_locks: Dict[int, object] = {}
        self._quarantined_workers: List[int] = []
        # shard key -> picklable child build spec, retained so a respawn
        # (or quarantine re-home) can rebuild the shard from scratch.
        self._specs: Dict[str, dict] = {}
        # fleet -> cursor of the micro-snapshot whose counters were last
        # folded. A snapshot's counters fold exactly ONCE — on the first
        # crash after it was taken: a respawned child's counters cover
        # only its own lifetime (post-restore), so a second crash off
        # the SAME snapshot has nothing new below the cursor to fold,
        # and re-folding would double count.  # guarded-by: self._migration_lock
        self._snap_folded: Dict[str, int] = {}
        self._sup_kwargs = dict(
            threshold=crash_loop_threshold,
            window_s=crash_loop_window_s,
            backoff_base_s=backoff_base_s,
            backoff_max_s=backoff_max_s,
        )
        if self._supervise:
            if recovery_dir is None:
                import tempfile

                self._recovery_tmpdir = tempfile.mkdtemp(
                    prefix="distilp-recovery-"
                )
                recovery_dir = self._recovery_tmpdir
            self._recovery_store = RecoveryStore(recovery_dir)
        self.router = ConsistentHashRouter(n_workers, replicas=replicas)
        # Worker SLOTS: a retired worker leaves None at its index so
        # worker ids stay stable ring labels; iterate live_workers() —
        # never this list directly — everywhere that touches all workers.
        self.workers: List[Optional[ShardWorker]] = [
            self._make_worker(i) for i in range(n_workers)
        ]
        # In-flight migrations: shard key -> {'parked': [waiter tuples]}.
        # Ingest for a migrating shard PARKS under this lock; the flip
        # closure replays parked events onto the destination before the
        # entry is cleared, so no event is lost or double-applied.
        self._migration_lock = make_lock("gateway.migration")
        self._migrating: Dict[str, dict] = {}  # guarded-by: self._migration_lock
        # Scheduler metrics are live-copy-only by contract (dump_state
        # drops them); when a migration retires a source copy its
        # counters fold in here so per-fleet shard_totals stay
        # cumulative across moves (warm_resumes == shards migrated).
        self._folded_counters: Dict[str, Dict[str, int]] = {}
        # Serializes whole migrations (and spawn/retire rebalances):
        # two concurrent flips in opposite directions would deadlock
        # their worker threads on each other's load round trips.
        self._migrate_serial = make_lock("gateway.migrate_serial")
        # Autoscaler admission actuation: force_degrade(True) marks every
        # tick under PRESSURE (spec_near serving) regardless of depth —
        # the controller's fast, reversible lever while scale-out warms.
        self._forced_pressure = False
        # Per-worker sustainable eps from the capacity probe; capacity_eps
        # refreshes deterministically as worker count changes.
        self._capacity_per_worker: Optional[float] = None
        self._controller = None  # attach_controller(); /control reads it
        # shard_key -> (fleet_id, model_id, worker index); fleet -> key.
        # Written at registration (under the migration lock, for the
        # lock-discipline audit) and by a live migration's owner flip;
        # dynamic-mode ingest re-reads the entry under the same lock.
        self._shards: Dict[str, Tuple[str, str, int]] = {}
        self._fleet_key: Dict[str, str] = {}
        # Per-fleet handled-event cursor (quarantines included): the
        # resume point a trace replay skips to after a restore.
        self._handled: Dict[str, int] = {}
        self._closed = False
        # -- admission control (README "Overload & admission control").
        # All knobs default OFF: ingest below then routes through the
        # exact pre-admission path — no depth reads, no new counters, no
        # pending buffers (byte-identical serving, pinned by test).
        #
        #   max_queue_depth — bound on a worker's command queue; an event
        #       arriving at a full queue is SHED: counted, flight-recorded
        #       and raised as QueueFull (HTTP 429 + Retry-After);
        #   coalesce       — drift events queued for the same shard fold
        #       into ONE solve at the newest state (structural events are
        #       barriers); the queue holds at most one tick closure per
        #       shard, so bursts compress instead of queueing;
        #   degrade_depth  — depth at which ingest marks the tick as
        #       under PRESSURE: a speculative shard whose exact bank probe
        #       misses may serve a certified near-match (mode='spec_near')
        #       instead of queueing a solve past its deadline;
        #   mem_degrade_headroom_bytes — memory-headroom floor (needs a
        #       live obs.memory ledger): when budget - RSS drops below
        #       it, ingest marks ticks under the SAME pressure flag —
        #       composing with degrade_depth, so a memory-squeezed
        #       gateway degrades to spec_near serving before the OOM
        #       killer degrades it to nothing.
        self.max_queue_depth = max_queue_depth
        #   combine        — route coalesce batches through the cross-shard
        #       solve combiner (distilp_torch.combine): each shard's pending
        #       drift run is PACKED instead of solved, bucketed by shape,
        #       and one batched search prices every bucket member at
        #       once. Implies coalesce (the combiner consumes coalesce
        #       batches). ``combine_policy`` is the committed BucketPolicy
        #       (padding ladder, lane cap, flush deadline).
        self.coalesce = coalesce or combine
        self.degrade_depth = degrade_depth
        self.mem_degrade_headroom_bytes = mem_degrade_headroom_bytes
        self.combine = combine
        self._combine_policy = None
        self._combiner = None
        # Shard keys with a combine ticket in flight: a shard's next
        # coalesce batch PARKS (queues no closure) until its lane is
        # adopted, so the worker never interleaves a newer solve between
        # prepare and adopt.
        self._combine_inflight: Dict[str, bool] = {}  # guarded-by: self._admission_lock
        if combine:
            from ..combine import BucketPolicy, SolveCombiner

            self._combine_policy = (
                combine_policy if combine_policy is not None else BucketPolicy()
            )
            self._combiner = SolveCombiner(
                self._combine_policy, metrics=self.metrics,
                device=self.device,
            )
        self._admission = bool(
            max_queue_depth is not None
            or self.coalesce
            or degrade_depth is not None
            or mem_degrade_headroom_bytes is not None
        )
        # Pending coalesce batches: shard key -> the batch dict its queued
        # drain closure will consume. Guarded by one lock (ingest may come
        # from the asyncio loop AND sync callers on other threads).
        self._admission_lock = make_lock("gateway.admission")
        self._pending: Dict[str, dict] = {}  # guarded-by: self._admission_lock
        # Per-fleet shed counters + monotone per-fleet shed index: the
        # record-by-record reconciliation key (each shed flight record
        # carries its index, so counter vs records can be audited even
        # after the bounded ring overflowed). Own lock — _shed runs inside
        # _submit_coalesced's admission-lock hold, so it cannot share it.
        self._shed_lock = make_lock("gateway.shed")
        self._shed_counts: Dict[str, int] = {}  # guarded-by: self._shed_lock
        # EWMA of event->placement ms, the Retry-After estimate's input.
        self._serve_ewma_ms: Optional[float] = None
        # Attached background observers (timeline samplers, prom
        # scrapers): anything with a .stop(join=True) that reads this
        # gateway on its own thread. close() stops them BEFORE the
        # workers so a probe mid-round-trip can never land on a stopping
        # worker (the ordering lives here, not in each harness).
        self._samplers: List = []
        # SLO layer (obs.timeline + obs.slo), opt-in via attach_slo():
        # None everywhere by default — /slo and /signals 404, no sampler
        # thread, no new counters (byte-identical serving, pinned).
        self.timeline = None
        self.slo_engine = None
        # Max-sustainable events/sec from the closed-loop capacity
        # probe (serve --capacity-eps / the bench's measured value): the
        # denominator of /signals' headroom computation. Written by
        # note_capacity and by the per-worker refresh inside a
        # spawn/retire, both under the migrate-serial lock.
        self.capacity_eps: Optional[float] = None
        # Every recovery of the supervised tier: worker, action, MTTR (ms).
        self._recoveries: List[dict] = []

    # -- worker fleet ------------------------------------------------------

    def _make_worker(self, worker_id: int) -> ShardWorker:
        if self.worker_backend == "process":
            from ..obs import compile_ledger as _cl
            from .procworker import ProcShardWorker

            # The child mirrors the parent's compile-ledger enablement:
            # a ledgered run gets per-process compile attribution (read
            # back through ledger_counters()); an unledgered run pays
            # nothing.
            w = ProcShardWorker(
                worker_id,
                metrics=self.metrics,
                compile_ledger=_cl.current() is not None,
            )
            if self._supervise:
                self._supervisors[worker_id] = Supervisor(**self._sup_kwargs)
                self._recover_locks[worker_id] = make_lock("gateway.recover")
                # Read paths retry once after this hook recovers the
                # worker in place (mutating calls never route through it).
                w.recovery_hook = (
                    lambda worker: self._recover_worker(worker)[0]
                    == "respawned"
                )
            return w
        return ShardWorker(worker_id, metrics=self.metrics)

    def live_workers(self) -> List[ShardWorker]:
        """Current worker fleet, retired slots excluded."""
        return [w for w in self.workers if w is not None]

    def live_worker_ids(self) -> List[int]:
        return [w.worker_id for w in self.workers if w is not None]

    # -- shard lifecycle ---------------------------------------------------

    def _build_scheduler(
        self,
        devices: Sequence[DeviceProfile],
        model: ModelProfile,
        fleet_id: str = "default",
    ) -> Scheduler:
        if self._factory is not None:
            # Factory signature stays (devices, model): tests inject
            # failing schedulers through it and obs plumbing is theirs.
            # A 'module:callable' string resolves to the same shape (the
            # form process workers require — the child imports it too).
            if isinstance(self._factory, str):
                from .procworker import resolve_factory

                return resolve_factory(self._factory)(devices, model)
            return self._factory(devices, model)
        kw = dict(self.scheduler_kwargs)
        if self.tracer is not NOOP_TRACER:
            kw["tracer"] = self.tracer
        if self.flight is not None:
            kw["flight"] = self.flight
            kw["flight_key"] = fleet_id
        return Scheduler(devices, model, **kw)

    def _shard_spec(self, devices, model, fleet_id: str) -> Optional[dict]:
        """Picklable build instructions for a process worker's child
        (None on the thread backend — it builds via the closure)."""
        if self.worker_backend != "process":
            return None
        return {
            "devices": [
                d.model_dump() if hasattr(d, "model_dump") else d
                for d in devices
            ],
            "model": (
                model.model_dump()
                if hasattr(model, "model_dump")
                else model
            ),
            "fleet_id": fleet_id,
            "kwargs": dict(self.scheduler_kwargs),
            "factory": (
                self._factory if isinstance(self._factory, str) else None
            ),
        }

    def register_fleet(
        self,
        fleet_id: str,
        devices: Sequence[DeviceProfile],
        model: ModelProfile,
        model_id: str = "default",
        state: Optional[dict] = None,
        events_handled: int = 0,
    ) -> int:
        """Create (or restore) a shard; returns the owning worker index.

        ``state`` is a ``Scheduler.dump_state`` blob: the shard resumes
        with its warm pool, published placement and health machine intact
        (the blob's fleet/model override ``devices``/``model`` — they are
        still required so a registration without state is well-formed).
        """
        key = shard_key(fleet_id, model_id)
        if key in self._shards:
            raise ValueError(f"shard {key!r} is already registered")
        if fleet_id in self._fleet_key:
            # The ingest/snapshot directory is keyed by fleet_id; a second
            # shard under the same fleet would silently clobber the first's
            # routing and resume cursor. One live model per fleet — a model
            # change is a ModelSwap EVENT on the existing shard, not a
            # second registration.
            raise ValueError(
                f"fleet {fleet_id!r} is already registered (under model "
                f"{self._shards[self._fleet_key[fleet_id]][1]!r}); swap "
                "models via a model_swap event, or use a distinct fleet id"
            )
        widx = self.router.owner(key)
        worker = self.workers[widx]
        spec = self._shard_spec(devices, model, fleet_id)
        worker.create_shard(
            key,
            build=lambda: self._build_scheduler(devices, model, fleet_id),
            state=state,
            spec=spec,
        )
        if spec is not None:
            # Retained for crash recovery: a respawned (or re-homed)
            # child rebuilds the shard from this spec before restoring
            # its micro-snapshot and replaying the WAL tail.
            self._specs[key] = spec
        if self._supervise and state is not None:
            # A shard registered FROM a snapshot blob is warm before its
            # first micro-snapshot lands; seed the recovery store with
            # that blob so a crash in the gap still restores warm.
            self._recovery_store.save_micro_snapshot(
                fleet_id, events_handled, state, {}
            )
        with self._migration_lock:
            self._shards[key] = (fleet_id, model_id, widx)
        self._fleet_key[fleet_id] = key
        self._handled[fleet_id] = events_handled
        self.metrics.inc("shards_registered")
        if state is not None:
            self.metrics.inc("shards_restored")
        return widx

    def fleet_ids(self) -> List[str]:
        return list(self._fleet_key)

    def _lookup(self, fleet_id: str) -> Tuple[str, ShardWorker]:
        key = self._fleet_key.get(fleet_id)
        if key is None:
            raise KeyError(f"unknown fleet {fleet_id!r}; register it first")
        return key, self.workers[self._shards[key][2]]

    def scheduler(self, fleet_id: str) -> Scheduler:
        """Direct handle on a shard's live scheduler.

        Main-thread reads are only sound while the owning worker is
        quiescent (sequential replay, post-drain inspection, chaos
        arming) — event ticks always go through the worker queue. For
        reads that must be sound under LIVE ingest, use ``read_shard``.
        """
        key, worker = self._lookup(fleet_id)
        return worker.shards[key]

    def read_shard(self, fleet_id: str, fn: Callable):
        """Run ``fn(scheduler)`` as a queued closure ON the owning worker.

        The sound way to read a shard under live ingest: the closure runs
        behind every queued tick, so whatever ``fn`` computes is observed
        at a tick boundary of that shard's timeline — never mid-tick.
        (``ShardFacade``'s ``.fleet``/``.metrics`` reads route through
        here; a caller-side read would only be sound while
        the worker was quiescent.) Blocks for the round trip.
        """
        key, worker = self._lookup(fleet_id)
        return worker.call(lambda: fn(worker.shards[key]))

    # -- ingest ------------------------------------------------------------

    def configure_admission(
        self,
        max_queue_depth: Optional[int] = None,
        coalesce: bool = False,
        degrade_depth: Optional[int] = None,
        mem_degrade_headroom_bytes: Optional[float] = None,
        combine: bool = False,
        combine_policy=None,
    ) -> None:
        """Reconfigure the admission knobs (see ``__init__``).

        Call on a quiescent gateway only (between arms of a bench sweep,
        after a warmup phase): ingest reads the knobs without a lock, and
        flipping them mid-flight would split one burst across two
        policies. All-default arguments turn admission OFF — back to the
        byte-identical pre-admission ingest path.
        """
        if combine and self.worker_backend == "process":
            raise ValueError(
                "combine needs in-process shard access; use thread "
                "workers or disable combine"
            )
        old_combiner = None
        with self._admission_lock:
            if self._pending or self._combine_inflight:
                raise RuntimeError(
                    "cannot reconfigure admission with coalesce batches "
                    "or combine tickets pending (the gateway is not "
                    "quiescent)"
                )
            self.max_queue_depth = max_queue_depth
            self.coalesce = coalesce or combine
            self.degrade_depth = degrade_depth
            self.mem_degrade_headroom_bytes = mem_degrade_headroom_bytes
            if combine != self.combine or combine_policy is not None:
                old_combiner = self._combiner
                self._combiner = None
                self._combine_policy = None
                self.combine = combine
                if combine:
                    from ..combine import BucketPolicy, SolveCombiner

                    self._combine_policy = (
                        combine_policy if combine_policy is not None
                        else BucketPolicy()
                    )
                    self._combiner = SolveCombiner(
                        self._combine_policy, metrics=self.metrics,
                        device=self.device,
                    )
            self._admission = bool(
                max_queue_depth is not None
                or self.coalesce
                or degrade_depth is not None
                or mem_degrade_headroom_bytes is not None
            )
        if old_combiner is not None:
            # Outside the lock: stop() joins the flush thread, whose
            # deliveries take worker queues — never while holding the
            # admission lock an ingest path also needs.
            old_combiner.stop()

    def _mem_pressure(self) -> bool:
        """True when the memory-headroom floor is configured AND the live
        memory ledger reports headroom below it. Cost: a cached-or-/proc
        RSS read (~0.1 ms worst case, no device read) — cheap enough per
        ingest. No ledger (or no readable RSS) means no verdict:
        degrade-on-low-headroom degrades on EVIDENCE, never on absence.
        """
        if self.mem_degrade_headroom_bytes is None:
            return False
        from ..obs import memory as _mem

        led = _mem.current()
        if led is None:
            return False
        headroom = led.headroom_bytes()
        if headroom is None or headroom >= self.mem_degrade_headroom_bytes:
            return False
        self.metrics.inc("mem_pressure")
        return True

    def warm_combine(self, fleet_ids: Optional[Sequence[str]] = None) -> dict:
        """Capture every combined graph the committed policy can reach.

        For each registered combinable shard, packs its CURRENT fleet
        state at the policy's padded size (through ``read_shard``, so the
        pack observes a tick boundary), groups the packs by bucket
        signature, and runs one throwaway ``solve_batch`` per committed
        lane shape (``BucketPolicy.lane_shapes``) per signature. Results
        are discarded: this exists to build, and on the card capture, the
        graph plan of every batch shape the serving phase can dispatch
        (``solver.device_loop``). With both shape axes committed (padded M
        by ``pad_for``, lane count by ``quantize_lanes``) the reachable set
        is exactly what this method enumerates, and the plans it builds are
        PINNED: the plan cache's LRU never evicts them, so the serving
        phase captures no graph. Call after the per-shard warmup (packs
        reuse each shard's warm signature) and before the serving phase.
        Also pre-positions every combinable shard's static half in the
        per-lane device cache (``lane_static_to_device``) so serving-phase
        flushes re-ship only dynamic bytes. Returns ``{"buckets": ...,
        "shapes_traced": ..., "statics_primed": ..., "plans_built": ...,
        "captures": ..., "wall_ms": ...}`` (captures happen on the card).
        """
        if self._combiner is None:
            raise RuntimeError(
                "warm_combine requires the combine admission path "
                "(configure_admission(combine=True) first)"
            )
        from ..solver import device_loop
        from ..solver.batchlayout import lane_static_to_device, solve_batch

        t0 = time.perf_counter()
        built0 = sum(device_loop.PLANS_BUILT.values())
        caps0 = sum(device_loop.CAPTURES.values())
        policy = self._combine_policy
        ids = list(fleet_ids) if fleet_ids is not None else self.fleet_ids()
        by_sig: Dict[tuple, tuple] = {}  # sig -> (fleet_id, instance)
        primed = 0
        for fid in ids:

            def _pack(s, warm_override=None):
                planner = s.pool.peek(s.fleet.key())
                if planner is None:
                    return None
                devs = s.fleet.device_list()
                return planner.prepare(
                    devs, s.fleet.model, k_candidates=s.k_candidates,
                    M_pad=policy.pad_for(len(devs)), warm_override=warm_override,
                )

            prep = self.read_shard(fid, _pack)
            if prep is None:
                continue  # MoE / non-torch / cold shard: not combinable
            # Pre-position this shard's drift-invariant half on the device
            # now: serving-phase flushes then assemble their static stacks
            # from cache, with no static re-uploads.
            _, uploaded = lane_static_to_device(
                prep.instance.static_np, self.device
            )
            primed += 1 if uploaded else 0
            by_sig.setdefault(prep.instance.signature, (fid, prep.instance))
        shapes = 0
        seen = set(by_sig)
        with device_loop.pinning_plans():
            for fid, inst in list(by_sig.values()):
                best = None
                for lanes in policy.lane_shapes(inst.M_pad):
                    decoded = solve_batch(
                        [inst], lane_pad=lanes, device=self.device
                    )
                    best = decoded[0][1]
                    shapes += 1
                # Round two: the STEADY-STATE signature. A shard's second
                # and later combined ticks warm-seed from an adopted
                # batched result, whose root-IPM iterates carry the padded
                # family's shapes — that flips ``has_root_warm`` (and the
                # dynamic blob's size) relative to the per-shard-seeded
                # pack solved above, so its plan is another signature.
                if best is None or best.ipm_state is None:
                    continue
                prep2 = self.read_shard(
                    fid, lambda s, b=best: _pack(s, warm_override=b)
                )
                if prep2 is None or prep2.instance.signature in seen:
                    continue
                seen.add(prep2.instance.signature)
                for lanes in policy.lane_shapes(prep2.instance.M_pad):
                    solve_batch(
                        [prep2.instance], lane_pad=lanes, device=self.device
                    )
                    shapes += 1
        return {
            "buckets": len(seen),
            "shapes_traced": shapes,
            "statics_primed": primed,
            "plans_built": sum(device_loop.PLANS_BUILT.values()) - built0,
            "captures": sum(device_loop.CAPTURES.values()) - caps0,
            "wall_ms": (time.perf_counter() - t0) * 1e3,
        }

    def _tick_closure(
        self, fleet_id: str, key: str, worker, event, parent=None,
        t_enq=None, pressure: bool = False, depth: Optional[int] = None,
    ):
        """The queued unit of ingest: tick the shard AND advance the
        fleet's resume cursor, both ON the worker thread. The cursor must
        move inside the closure — a snapshot is a later closure on the
        same queue, so it always observes a cursor consistent with the
        shard state it dumps (bumping the cursor caller-side after the
        wait would let a snapshot read state covering event n with a
        cursor still at n-1, and a resume would double-apply event n).

        ``parent``/``t_enq`` carry the ingest span's context and enqueue
        timestamp (ms) across the queue: the closure's first act on the
        worker thread is recording the **queue-wait span** — submit to
        pickup, the number that diagnoses worker thrash — and attaching
        the ingest context so the tick's own spans parent under it. With
        tracing off both are shared no-ops (parent is None). ``depth`` is
        the queue depth observed at enqueue (the admission-control input),
        attached to the queue-wait span when tracing is on; ``pressure``
        rides through to the scheduler's degraded-serving seam.
        """

        def _do() -> PlacementView:
            if self._supervise:
                # Crash-tolerant path: WAL append before dispatch, crash
                # detection + recovery around it. Kept out of line so the
                # unsupervised closure below stays byte-identical.
                return self._supervised_tick(
                    fleet_id, key, worker, event, parent, t_enq,
                    pressure, depth,
                )
            attrs = {"worker": worker.worker_id}
            if depth is not None:
                attrs["depth"] = depth
            self.tracer.record_span(
                "gateway.queue_wait",
                t_enq if t_enq is not None else 0.0,
                None,
                parent=parent,
                attrs=attrs,
            )
            with self.tracer.attach(parent):
                # finally, not on success: a raising handle() may still
                # have mutated the fleet (seq advances before the solve
                # fails), and a cursor one behind the seq would make a
                # resume double-apply that event. Counting a
                # rejected-and-raised event too only skips a repeat
                # rejection on resume — always safe.
                try:
                    if pressure:
                        return worker.shards[key].handle(
                            event, pressure=True
                        )
                    return worker.shards[key].handle(event)
                finally:
                    self._handled[fleet_id] = (
                        self._handled.get(fleet_id, 0) + 1
                    )

        return _do

    def _supervised_tick(
        self, fleet_id: str, key: str, worker, event, parent, t_enq,
        pressure: bool, depth: Optional[int],
    ) -> PlacementView:
        """One supervised tick, ON a worker thread: journal the event,
        dispatch it, and on child death recover (respawn or quarantine)
        before answering the waiter.

        A quarantine may have re-homed this shard after the closure was
        queued — the drain of a dead worker's queue runs on its (still
        live) parent thread. Re-resolve the owner first and FORWARD to
        its queue when it moved: the inner closure does its own WAL
        append and cursor bump, so the forwarding frame must return
        before the caller's bump region (it is inside ``_tick_closure``'s
        ``_do`` body, before any bump of this frame's own).
        """
        with self._migration_lock:
            cur = self.workers[self._shards[key][2]]
        if cur is not worker:
            box, done = self._submit_tick(
                fleet_id, key, cur, event, parent, t_enq
            )
            done.wait()
            if "exc" in box:
                raise box["exc"]
            return box["result"]
        attrs = {"worker": worker.worker_id}
        if depth is not None:
            attrs["depth"] = depth
        self.tracer.record_span(
            "gateway.queue_wait",
            t_enq if t_enq is not None else 0.0,
            None,
            parent=parent,
            attrs=attrs,
        )
        with self.tracer.attach(parent):
            cursor = self._handled.get(fleet_id, 0) + 1
            # Journal BEFORE dispatch: a child that dies holding this
            # event leaves it replayable from the WAL tail.
            self._recovery_store.wal(fleet_id).append(cursor, event)
            self.metrics.inc("wal_appends")
            try:
                try:
                    if pressure:
                        view = worker.shards[key].handle(
                            event, pressure=True
                        )
                    else:
                        view = worker.shards[key].handle(event)
                except WorkerCrashed:  # dlint: disable=DLP017 accounted inside _recover_worker (worker_crashes inc + recovery_mttr_ms observe per attempt)
                    # The RPC died mid-flight: whether the child applied
                    # the event is UNKNOWABLE, so its partial state is
                    # discarded entirely — recovery restores the last
                    # micro-snapshot and replays the WAL tail, which
                    # includes this event (appended above). Exactly-once
                    # holds by construction, not by guessing.
                    verdict, views = self._recover_worker(worker)
                    view = views.get(fleet_id)
                    if view is None:
                        owner = self.workers[self._shards[key][2]]
                        view = owner.shards[key].latest()
                self._maybe_micro_snapshot(fleet_id, key, cursor)
                return view
            finally:
                self._handled[fleet_id] = (
                    self._handled.get(fleet_id, 0) + 1
                )

    def _maybe_micro_snapshot(self, fleet_id: str, key: str, cursor: int) -> None:
        """Persist a micro-snapshot when ``cursor`` lands on a boundary
        (the first event always snapshots — a kill before the first
        boundary must still respawn warm). Runs on the owning worker's
        thread; a crash DURING the dump is survivable (the previous
        snapshot + WAL tail still cover everything), so failure here
        only counts, never raises."""
        if cursor != 1 and cursor % self.snapshot_every != 0:
            return
        self._maybe_micro_snapshot_at(fleet_id, key, cursor)

    def _submit_tick(
        self, fleet_id: str, key: str, worker: ShardWorker, event, parent, t_enq,
        on_done=None,
    ):
        """Route one event to its worker, migration-aware when dynamic.

        Static gateways (``dynamic=False``, the default) fall straight
        through to the admission path below — no extra lock, no new code
        on the hot path. Dynamic gateways take the migration gate: an
        event for a shard whose flip is in flight PARKS (no closure is
        queued anywhere) and is replayed onto the destination worker by
        the flip itself, in arrival order, before the gate clears — so a
        live migration loses no event, double-applies no event, and
        serves every tick. The gate also re-resolves the owning worker
        under the lock: the caller's ``worker`` argument may predate a
        completed flip.
        """
        if self._dynamic:
            with self._migration_lock:
                mig = self._migrating.get(key)
                if mig is not None:
                    box: dict = {}
                    done = threading.Event()
                    mig["parked"].append(
                        (event, parent, t_enq, on_done, box, done)
                    )
                    self.metrics.inc("migration_parked")
                    return box, done
                worker = self.workers[self._shards[key][2]]
                return self._submit_tick_routed(
                    fleet_id, key, worker, event, parent, t_enq, on_done
                )
        return self._submit_tick_routed(
            fleet_id, key, worker, event, parent, t_enq, on_done
        )

    def _submit_tick_routed(
        self, fleet_id: str, key: str, worker: ShardWorker, event, parent, t_enq,
        on_done=None,
    ):
        """Route one event through the admission gate onto its worker.

        Returns the ``(box, done)`` pair the waiter resolves on. With
        admission OFF this is exactly the pre-admission submit — no depth
        reads beyond the traced span's, no new code paths. With it on:

        - a full queue (``max_queue_depth``) sheds the event — counted,
          flight-recorded, raised as ``QueueFull`` (the bound itself is
          enforced inside ``ShardWorker.submit`` under its lock, so racing
          submitters cannot overshoot it);
        - past ``degrade_depth`` the tick is marked under pressure
          (degraded-mode serving from the speculation bank);
        - with ``coalesce`` on, drift events for a shard that already has
          a queued-but-unstarted tick closure JOIN that closure's batch
          instead of queueing their own — the shard solves once, at the
          newest state, and every waiter gets that view. Structural
          events are barriers: they detach the open batch (its closure
          still drains exactly the events that joined before the barrier)
          and queue behind it, preserving per-fleet order.
        """
        # force_degrade(True) routes through the admission branch even
        # when no static knob is set: the forced flag IS the pressure
        # verdict. With it off (always, on static gateways) this line is
        # exactly the old precomputed check.
        admission = self._admission or self._forced_pressure
        depth: Optional[int] = None
        if admission or self.tracer.enabled:
            depth = worker.depth()
        if not admission:
            return worker.submit(
                self._tick_closure(
                    fleet_id, key, worker, event,
                    parent=parent, t_enq=t_enq, depth=depth,
                ),
                on_done,
            )
        pressure = (
            (self.degrade_depth is not None and depth >= self.degrade_depth)
            or self._forced_pressure
            or self._mem_pressure()
        )
        structural = getattr(event, "kind", None) in STRUCTURAL_KINDS
        if self.coalesce and not structural:
            return self._submit_coalesced(
                fleet_id, key, worker, event, parent, t_enq,
                pressure, depth, on_done,
            )
        if self.coalesce and structural:
            # Barrier: later drift must not join a batch whose closure
            # was enqueued BEFORE this structural event — that would
            # reorder it ahead. Pop AND submit under ONE lock hold: with
            # the lock released in between, a racing drift ingest could
            # open (and submit) a fresh batch that lands in the worker
            # FIFO ahead of this structural closure — exactly the
            # reordering the barrier exists to rule out. The detached
            # batch still drains exactly the events that joined it.
            closure = self._tick_closure(
                fleet_id, key, worker, event,
                parent=parent, t_enq=t_enq, pressure=pressure, depth=depth,
            )
            with self._admission_lock:
                batch = self._pending.get(key)
                if batch is not None and batch.get("parked"):
                    # A PARKED batch (combine ticket in flight) has no
                    # queued closure to drain ahead of us, so popping it
                    # would strand its waiters. Append the structural
                    # event instead: order within the batch is arrival
                    # order, and a mixed batch drains through the local
                    # per-shard path (prepare_combine never sees it).
                    box: dict = {}
                    done = threading.Event()
                    batch["events"].append(event)
                    batch["waiters"].append((box, done, on_done))
                    batch["pressure"] = batch["pressure"] or pressure
                    return box, done
                self._pending.pop(key, None)
                try:
                    return worker.submit(
                        closure, on_done, bound=self.max_queue_depth
                    )
                except WorkerQueueFull as e:
                    raise self._shed(
                        fleet_id, event, worker, e.depth
                    ) from None
        closure = self._tick_closure(
            fleet_id, key, worker, event,
            parent=parent, t_enq=t_enq, pressure=pressure, depth=depth,
        )
        try:
            return worker.submit(closure, on_done, bound=self.max_queue_depth)
        except WorkerQueueFull as e:
            raise self._shed(fleet_id, event, worker, e.depth) from None

    def _submit_coalesced(
        self, fleet_id, key, worker: ShardWorker, event, parent, t_enq,
        pressure, depth, on_done,
    ):
        box: dict = {}
        done = threading.Event()
        with self._admission_lock:
            batch = self._pending.get(key)
            if batch is not None:
                # Joining an open batch queues NOTHING: the burst
                # compresses into the one already-queued solve (this is
                # why a coalescing gateway's queue depth stays ~#shards
                # under a same-shard flood).
                batch["events"].append(event)
                batch["waiters"].append((box, done, on_done))
                batch["pressure"] = batch["pressure"] or pressure
                return box, done
            batch = {
                "events": [event],
                "waiters": [(box, done, on_done)],
                "pressure": pressure,
                "parked": False,
            }
            self._pending[key] = batch
            if self.combine and self._combine_inflight.get(key):
                # The shard's previous batch is mid-combine (prepare done,
                # adopt pending): queueing a drain now would let the worker
                # solve NEWER state before the older lane lands. Park the
                # batch — it keeps absorbing joiners — and let the adopt
                # closure submit the drain when the lane is redeemed.
                batch["parked"] = True
                batch["args"] = (parent, t_enq, depth)
                return box, done
            closure = self._batch_closure(
                fleet_id, key, worker, batch, parent, t_enq, depth
            )
            # Submit INSIDE the admission lock: once the batch is in
            # _pending another ingest thread may join it, and a joined
            # waiter must never be stranded by this submit shedding —
            # under the lock, join and shed cannot interleave. (Lock
            # order admission->submit is taken nowhere in reverse;
            # _shed's own counting uses the separate _shed_lock.)
            try:
                worker.submit(closure, bound=self.max_queue_depth)
            except WorkerQueueFull as e:
                del self._pending[key]
                raise self._shed(
                    fleet_id, event, worker, e.depth
                ) from None
        return box, done

    def _batch_closure(
        self, fleet_id, key, worker, batch, parent, t_enq, depth
    ):
        """The queued drain of one coalesce batch: runs on the worker
        thread, detaches the batch (late joiners up to this instant are
        included — maximal coalescing), ticks the shard ONCE via the
        scheduler's coalescing hook, and resolves every waiter with the
        one resulting view. The resume cursor advances by the whole batch
        inside the closure, same consistency argument as
        ``_tick_closure``."""

        def _do() -> None:
            with self._admission_lock:
                if self._pending.get(key) is batch:
                    del self._pending[key]
                events = list(batch["events"])
                waiters = list(batch["waiters"])
                pressure = batch["pressure"]
            attrs = {"worker": worker.worker_id, "batch": len(events)}
            if depth is not None:
                attrs["depth"] = depth
            self.tracer.record_span(
                "gateway.queue_wait",
                t_enq if t_enq is not None else 0.0,
                None,
                parent=parent,
                attrs=attrs,
            )
            shared: dict = {}
            with self.tracer.attach(parent):
                combiner = self._combiner
                if combiner is not None and not any(
                    getattr(ev, "kind", None) in STRUCTURAL_KINDS
                    for ev in events
                ):
                    # Combine path: PACK this shard's tick instead of
                    # solving it; the batched dispatch happens on the
                    # combiner thread and the lane is redeemed by an
                    # adopt closure queued back onto this worker. A
                    # short-circuit view (spec hit, breaker, local
                    # fallback) resolves the waiters right here.
                    from ..combine import CombineEntry

                    with self._admission_lock:
                        if self._combine_inflight.get(key):
                            # This closure was queued in the window
                            # between the previous batch's detach and its
                            # inflight mark — the ingest-side parking
                            # check could not see the lane. Applying our
                            # events now would advance the fleet past the
                            # packed seq and turn that lane stale, so
                            # RE-PARK instead: the adopt closure drains
                            # us when the lane is redeemed.
                            open_batch = self._pending.get(key)
                            if open_batch is not None:
                                # A newer batch opened behind us; our
                                # events are OLDER — merge at the front
                                # so per-fleet order is preserved.
                                open_batch["events"][:0] = events
                                open_batch["waiters"][:0] = waiters
                                open_batch["pressure"] = (
                                    open_batch["pressure"] or pressure
                                )
                            else:
                                batch["events"] = list(events)
                                batch["waiters"] = list(waiters)
                                batch["pressure"] = pressure
                                batch["parked"] = True
                                batch["args"] = (parent, t_enq, depth)
                                self._pending[key] = batch
                            return

                    ticket = None
                    try:
                        sched = worker.shards[key]
                        m_pad = self._combine_policy.pad_for(
                            len(sched.fleet.device_list())
                        )
                        ticket, view = sched.prepare_combine(
                            events, pressure=pressure, M_pad=m_pad
                        )
                        if view is not None:
                            shared["result"] = view
                    except BaseException as e:
                        self.metrics.inc("worker_exception")
                        shared["exc"] = e
                    finally:
                        self._handled[fleet_id] = (
                            self._handled.get(fleet_id, 0) + len(events)
                        )
                    if ticket is not None:
                        with self._admission_lock:
                            self._combine_inflight[key] = True
                        combiner.submit(
                            CombineEntry(
                                ticket,
                                self._combine_deliver(
                                    fleet_id, key, worker, ticket, waiters
                                ),
                            )
                        )
                        return
                    self._resolve_waiters(waiters, shared)
                    return
                try:
                    if self._supervise:
                        shared["result"] = self._supervised_batch(
                            fleet_id, key, worker, events, pressure
                        )
                    else:
                        shared["result"] = worker.shards[key].handle_coalesced(
                            events, pressure=pressure
                        )
                except BaseException as e:
                    # Counted here (not re-raised to the worker loop): the
                    # waiters below are the real consumers and each gets
                    # the exception; the worker's own box has no reader.
                    self.metrics.inc("worker_exception")
                    shared["exc"] = e
                finally:
                    self._handled[fleet_id] = (
                        self._handled.get(fleet_id, 0) + len(events)
                    )
                    self._resolve_waiters(waiters, shared)

        return _do

    def _supervised_batch(
        self, fleet_id: str, key: str, worker, events, pressure: bool
    ) -> PlacementView:
        """The coalesced-drain analogue of ``_supervised_tick``: journal
        every event of the batch before the one dispatch, recover on
        child death, micro-snapshot when the batch crosses a boundary.
        The CALLER's finally still bumps the cursor by ``len(events)``
        — this method only journals and dispatches."""
        with self._migration_lock:
            cur = self.workers[self._shards[key][2]]
        if cur is not worker:
            # Shard re-homed by a quarantine after this drain was queued:
            # run the whole supervised batch on the new owner's thread
            # (serialized behind its queue) and hand back its view. The
            # caller's cursor bump covers these events exactly once —
            # this forwarded frame bumps nothing.
            return cur.call(
                lambda: self._supervised_batch(
                    fleet_id, key, cur, events, pressure
                )
            )
        base = self._handled.get(fleet_id, 0)
        wal = self._recovery_store.wal(fleet_id)
        for i, ev in enumerate(events):
            wal.append(base + 1 + i, ev)
        self.metrics.inc("wal_appends", len(events))
        try:
            view = worker.shards[key].handle_coalesced(
                events, pressure=pressure
            )
        except WorkerCrashed:  # dlint: disable=DLP017 accounted inside _recover_worker (worker_crashes inc + recovery_mttr_ms observe per attempt)
            verdict, views = self._recover_worker(worker)
            view = views.get(fleet_id)
            if view is None:
                owner = self.workers[self._shards[key][2]]
                view = owner.shards[key].latest()
        cursor = base + len(events)
        if base == 0 or cursor // self.snapshot_every > base // self.snapshot_every:
            self._maybe_micro_snapshot_at(fleet_id, key, cursor)
        return view

    def _maybe_micro_snapshot_at(self, fleet_id: str, key: str, cursor: int) -> None:
        """Unconditional micro-snapshot at ``cursor`` (the batch path
        computed the boundary crossing itself — a batch can straddle one
        without any member landing exactly on it)."""
        owner = self.workers[self._shards[key][2]]
        sched = owner.shards[key]
        try:
            state = sched.dump_state()
            counters = dict(sched.metrics.counters)
        except WorkerCrashed:
            self.metrics.inc("micro_snapshot_failed")
            return
        self._recovery_store.save_micro_snapshot(
            fleet_id, cursor, state, counters
        )
        self.metrics.inc("micro_snapshots")

    # -- crash recovery ----------------------------------------------------

    def _recover_worker(self, worker) -> Tuple[str, Dict[str, PlacementView]]:
        """Bring a crashed process worker's shards back: respawn with
        bounded backoff (retrying through double-crashes — snapshot
        restore + WAL replay is idempotent, each attempt rebuilds from
        scratch) or, when the crash-loop breaker opens, quarantine the
        worker and re-home its slice onto the surviving ring.

        Returns ``(verdict, views)`` where views maps each recovered
        fleet_id to the placement view its replayed tail produced —
        the supervised tick answers its waiter from this map.

        Locking: per-WORKER recover locks, never one global lock — a
        quarantine re-homes shards via round trips through OTHER workers'
        queues, and two workers quarantining simultaneously under one
        global lock would deadlock on each other's rebuild round trips.
        Recovery otherwise runs inline on the dead worker's own (still
        live) parent thread, so per-worker work is naturally serialized.
        """
        wid = worker.worker_id
        lock = self._recover_locks.get(wid)
        if lock is None:
            raise RuntimeError(
                f"worker {wid} crashed with supervision off"
            )
        with lock:
            if wid in self._quarantined_workers:
                return "quarantined", {}
            if self._closed:
                # Clean shutdown, not a crash: the gateway closed the
                # child under us. Nothing to respawn.
                return "stopped", {}
            if worker.child_alive():
                try:
                    worker.rpc({"op": "ping"})
                    # A racing caller on this thread already recovered it.
                    return "respawned", {}
                except WorkerCrashed:  # dlint: disable=DLP017 probe only: a dead ping falls through to the recovery loop below, whose record_crash/worker_crashes account every attempt
                    pass
            sup = self._supervisors[wid]
            t0 = time.perf_counter()
            views: Dict[str, PlacementView] = {}
            while True:
                verdict = sup.record_crash()
                self.metrics.inc("worker_crashes")
                if verdict == "quarantine" and len(self.live_worker_ids()) > 1:
                    views = self._quarantine_worker(worker)
                    mttr = (time.perf_counter() - t0) * 1000.0
                    self.metrics.observe("recovery_mttr_ms", mttr)
                    self._record_recovery(worker, "quarantine", mttr, views)
                    return "quarantined", views
                # A single-worker gateway has nowhere to re-home: keep
                # respawning past the breaker (documented; the breaker
                # still surfaces via crashes_in_window in /signals).
                time.sleep(sup.backoff_s())
                try:
                    worker.respawn_child()
                    self.metrics.inc("child_respawns")
                    views = self._rebuild_worker_shards(worker)
                    break
                except WorkerCrashed:  # dlint: disable=DLP017 the loop's next record_crash() increments worker_crashes — every failed attempt is counted, none swallowed
                    # Crash DURING recovery (respawn died, or replay
                    # killed the fresh child): loop — the next attempt
                    # restores the same snapshot and replays the same
                    # tail. The abandoned attempt's counters die
                    # unfolded, which is correct: attempt N+1 replays
                    # the whole tail and regenerates them.
                    continue
            mttr = (time.perf_counter() - t0) * 1000.0
            self.metrics.observe("recovery_mttr_ms", mttr)
            self._record_recovery(worker, "respawn", mttr, views)
            return "respawned", views

    def _fold_snapshot_counters(self, fid: str, snap: Optional[dict]) -> None:
        """Fold a dead child's micro-snapshot counters into the fleet's
        running totals — at most ONCE per snapshot (see ``_snap_folded``):
        the replay regenerates only the tail's counters, so the fold
        covers exactly the prefix the restoring child will not recount,
        and a repeat crash off the same snapshot folds nothing new."""
        if not snap or not snap.get("counters"):
            return
        cursor = int(snap.get("cursor", 0))
        with self._migration_lock:
            if self._snap_folded.get(fid) == cursor:
                return
            self._snap_folded[fid] = cursor
            acc = self._folded_counters.setdefault(fid, {})
            for name, v in snap["counters"].items():
                if v:
                    acc[name] = acc.get(name, 0) + int(v)

    def _rebuild_worker_shards(self, worker) -> Dict[str, PlacementView]:
        """Rebuild every shard a freshly-respawned child owns: build from
        the retained spec, restore the micro-snapshot (warm — load_state
        rides the bit-exact chain), replay the WAL tail record by
        record. Raises ``WorkerCrashed`` if the child dies mid-rebuild
        (the caller's retry loop handles it)."""
        from .procworker import SchedulerProxy

        with self._migration_lock:
            owned = [
                (key, fid)
                for key, (fid, _mid, widx) in self._shards.items()
                if widx == worker.worker_id
            ]
        views: Dict[str, PlacementView] = {}
        for key, fid in owned:
            spec = self._specs.get(key)
            snap, records = self._recovery_store.recovery_plan(fid)
            worker.rpc({
                "op": "build",
                "key": key,
                "spec": spec,
                "state": snap["state"] if snap is not None else None,
            })
            # Installed directly (not via create_shard's queued closure):
            # recovery already runs ON this worker's thread.
            worker.shards[key] = SchedulerProxy(worker, key)
            self._fold_snapshot_counters(fid, snap)
            for _cursor, ev in records:
                views[fid] = worker.shards[key].handle(ev)
                self.metrics.inc("events_replayed")
            self.metrics.inc("shards_recovered")
        return views

    def _quarantine_worker(self, worker) -> Dict[str, PlacementView]:
        """Crash-loop breaker open: retire the worker from the ring and
        re-home its shards onto the survivors (consistent hashing moves
        ONLY the dead worker's keys), restoring each from its
        micro-snapshot + WAL tail on the new owner's thread.

        Stale closures already queued on the dead worker's drain forward
        themselves: supervised paths re-resolve the owner at their top
        and round-trip through the new owner's queue."""
        wid = worker.worker_id
        # Ring/worker-list rewrites share _migrate_serial with the
        # autoscaler's spawn/retire (no _migrate_serial holder ever
        # takes a recover lock, so the nesting is acyclic). The lock
        # covers ONLY the attribute flips — the per-shard rebuilds are
        # blocking round trips through other workers' queues and must
        # not park a concurrent scale action behind them; shard entry
        # ownership stays consistent under _migration_lock per entry.
        with self._migrate_serial:
            self._quarantined_workers.append(wid)
            self.metrics.inc("workers_quarantined")
            remaining = [i for i in self.live_worker_ids() if i != wid]
            self.router = ConsistentHashRouter(
                replicas=self.router.replicas, worker_ids=remaining
            )
        with self._migration_lock:
            owned = [
                (key, fid, mid)
                for key, (fid, mid, widx) in self._shards.items()
                if widx == wid
            ]
        views: Dict[str, PlacementView] = {}
        for key, fid, mid in owned:
            spec = self._specs.get(key)
            snap, records = self._recovery_store.recovery_plan(fid)
            tidx = self.router.owner(key)
            target = self.workers[tidx]
            target.create_shard(
                key,
                build=None,
                state=snap["state"] if snap is not None else None,
                spec=spec,
            )
            self._fold_snapshot_counters(fid, snap)

            def _replay(target=target, key=key, recs=records, fid=fid):
                out = None
                for _cursor, ev in recs:
                    out = target.shards[key].handle(ev)
                    self.metrics.inc("events_replayed")
                return out

            v = target.call(_replay)
            if v is not None:
                views[fid] = v
            self.metrics.inc("shards_recovered")
            with self._migration_lock:
                self._shards[key] = (fid, mid, tidx)
        # Retire the slot from the worker's OWN thread (a stop() would
        # join ourselves); queued closures still drain past the sentinel
        # and forward themselves to the new owners.
        worker.retire_crashed()
        with self._migrate_serial:
            self.workers[wid] = None
            self.n_workers = len(remaining)
        return views

    def _record_recovery(self, worker, kind: str, mttr_ms: float, views) -> None:
        """Flight-record the recovery trail with the signals snapshot
        that accompanied it (the chaos contract: every kill's recovery
        is reconstructible from the flight recorder alone)."""
        sup = self._supervisors.get(worker.worker_id)
        self._recoveries.append({
            "worker": worker.worker_id,
            "action": kind,
            "generation": worker.generation,
            "mttr_ms": round(mttr_ms, 3),
            "fleets": sorted(views),
        })
        if self.flight is None:
            return
        sig = None
        if self.timeline is not None:
            try:
                sig = self.signals()
            except Exception:  # dlint: disable=DLP017 the recovery record must land even when signals cannot be built mid-crash (e.g. a second worker down); sig=None records that fact
                sig = None
        self.flight.record(
            "recovery",
            {
                "t": time.time(),
                "worker": worker.worker_id,
                "action": kind,
                "generation": worker.generation,
                "pid": worker.child_pid,
                "mttr_ms": round(mttr_ms, 3),
                "fleets": sorted(views),
                "crashes_in_window": (
                    sup.crashes_in_window if sup is not None else None
                ),
                "signals": sig,
            },
        )

    def recovery_status(self) -> dict:
        """The supervision tier's audit surface (merged into ``/signals``
        as the ``recovery`` block and probed by chaos_replay).

        ``events_lost`` is the reconciliation: per fleet, the handled
        cursor minus (live + folded) ``events_total`` — every accepted
        event must be accounted for by exactly one application. Zero is
        the contract; positive means lost events, negative double-apply.
        """
        c = self.metrics.counters
        status = {
            "supervised": self._supervise,
            "worker_crashes": c.get("worker_crashes", 0),
            "child_respawns": c.get("child_respawns", 0),
            "shards_recovered": c.get("shards_recovered", 0),
            "events_replayed": c.get("events_replayed", 0),
            "wal_appends": c.get("wal_appends", 0),
            "micro_snapshots": c.get("micro_snapshots", 0),
            "workers_quarantined": c.get("workers_quarantined", 0),
            "quarantined_workers": list(self._quarantined_workers),
        }
        per_fleet = self._per_worker(
            lambda s, _fid: dict(s.metrics.counters)
        )
        lost = 0
        warm = cold = ident = 0
        for fid, cursor in self._handled.items():
            live = per_fleet.get(fid, {})
            folded = self._folded_counters.get(fid, {})
            applied = (
                live.get("events_total", 0)
                + folded.get("events_total", 0)
            )
            lost += cursor - applied
            warm += live.get("warm_resumes", 0) + folded.get("warm_resumes", 0)
            cold += live.get("cold_resumes", 0) + folded.get("cold_resumes", 0)
            # A restore whose first tick changed identity (structural
            # event replayed first) proves nothing about warmth and
            # counts as neither warm nor cold — surfaced so the crash
            # contract can still reconcile one resume per recovery.
            ident += live.get("resume_identity_changed", 0) + folded.get(
                "resume_identity_changed", 0
            )
        status["events_lost"] = lost
        status["warm_resumes"] = warm
        status["cold_resumes"] = cold
        status["identity_resumes"] = ident
        # Each recovery in order (worker, respawn or quarantine, MTTR).
        status["recoveries"] = [dict(r) for r in self._recoveries]
        lat = self.metrics.snapshot().get("latency", {})
        mttr = lat.get("recovery_mttr_ms")
        if mttr:
            status["mttr_p50_ms"] = mttr.get("p50_ms")
            status["mttr_p99_ms"] = mttr.get("p99_ms")
        return status

    def chaos_process_hook(self, fleet_id: str):
        """The ``chaos_replay`` bridge for process-level faults: returns
        ``hook(kind, spec)`` that aims each fault at the CURRENT owner
        of ``fleet_id``'s shard (a kill may have re-homed it since the
        last fault)."""
        def hook(kind: str, spec) -> None:
            key = self._fleet_key[fleet_id]
            with self._migration_lock:
                worker = self.workers[self._shards[key][2]]
            if kind == "child_kill":
                worker.kill_child()
            elif kind == "rpc_torn":
                worker.inject_torn_frame()
            elif kind == "rpc_delay":
                worker.inject_rpc_delay(
                    getattr(spec, "delay_s", 0.05) or 0.05
                )
            else:
                raise ValueError(f"unknown process fault kind {kind!r}")

        return hook

    def _resolve_waiters(self, waiters, shared: dict) -> None:
        """Resolve a batch's waiters with one shared outcome (result or
        exc); a dead completion callback must not kill the caller's
        thread (same contract as ``ShardWorker._run``)."""
        for w_box, w_done, w_on_done in waiters:
            w_box.update(shared)
            w_done.set()
            if w_on_done is not None:
                try:
                    w_on_done(w_box)
                except Exception:
                    self.metrics.inc("worker_callback_error")

    def _combine_deliver(self, fleet_id, key, worker: ShardWorker, ticket, waiters):
        """The combiner's per-lane delivery callback: queue the shard's
        ``adopt_combine`` back onto its OWN worker (scatter), resolve the
        batch's waiters with the adopted view, then un-park the batch
        that accumulated behind the in-flight lane."""

        def deliver(decoded, err) -> None:
            def _adopt() -> None:
                shared: dict = {}
                try:
                    shared["result"] = worker.shards[key].adopt_combine(
                        ticket, decoded, error=err
                    )
                except BaseException as e:
                    self.metrics.inc("worker_exception")
                    shared["exc"] = e
                finally:
                    self._release_combine(fleet_id, key, worker)
                    self._resolve_waiters(waiters, shared)

            try:
                worker.submit(_adopt)
            except BaseException as e:
                # Worker already stopping (shutdown race): the lane
                # cannot be adopted; resolve the waiters with the error
                # so nothing blocks forever.
                self.metrics.inc("worker_exception")
                with self._admission_lock:
                    self._combine_inflight.pop(key, None)
                self._resolve_waiters(
                    waiters, {"exc": err if err is not None else e}
                )

        return deliver

    def _release_combine(self, fleet_id, key, worker: ShardWorker) -> None:
        """Clear a shard's in-flight combine marker and submit the drain
        of any batch that parked behind it (runs on the worker thread at
        the end of the adopt closure)."""
        parked_waiters = None
        shed_shared = None
        with self._admission_lock:
            self._combine_inflight.pop(key, None)
            batch = self._pending.get(key)
            if batch is None or not batch.get("parked"):
                return
            batch["parked"] = False
            parent, t_enq, depth = batch.pop("args")
            closure = self._batch_closure(
                fleet_id, key, worker, batch, parent, t_enq, depth
            )
            try:
                worker.submit(closure, bound=self.max_queue_depth)
            except WorkerQueueFull as e:  # dlint: disable=DLP017 accounted inside _shed (events_shed + per-fleet tally + flight record); the QueueFull is handed back to every parked waiter, not swallowed
                del self._pending[key]
                parked_waiters = list(batch["waiters"])
                shed_shared = {
                    "exc": self._shed(
                        fleet_id, batch["events"][-1], worker, e.depth
                    )
                }
        if parked_waiters is not None:
            self._resolve_waiters(parked_waiters, shed_shared)

    def _shed(self, fleet_id: str, event, worker: ShardWorker, depth: int) -> QueueFull:
        """Account one shed, then hand back the exception to raise.

        Every shed is (1) counted — ``events_shed`` plus the per-fleet
        tally ``shed_counts()`` — and (2) flight-recorded with a monotone
        per-fleet ``shed_index``, so counters and records reconcile
        record by record even after the bounded ring overflows (the
        contract ``traffic.shed_violations`` audits). ``retry_after_s``
        estimates when the backlog drains: depth x the EWMA of recent
        event-to-placement latency.
        """
        self.metrics.inc("events_shed")
        with self._shed_lock:
            idx = self._shed_counts.get(fleet_id, 0) + 1
            self._shed_counts[fleet_id] = idx
        ewma_ms = self._serve_ewma_ms
        retry_after = min(
            30.0, max(0.05, depth * ((ewma_ms or 1000.0) / 1e3))
        )
        if self.flight is not None:
            self.flight.record(
                fleet_id,
                {
                    "shed": True,
                    "shed_index": idx,
                    "fleet": fleet_id,
                    "kind": getattr(event, "kind", type(event).__name__),
                    "worker": worker.worker_id,
                    "depth": depth,
                    "retry_after_s": round(retry_after, 4),
                },
            )
        return QueueFull(fleet_id, depth, retry_after)

    def shed_counts(self) -> Dict[str, int]:
        """Per-fleet shed tallies (reconciled against flight records)."""
        with self._shed_lock:
            return dict(self._shed_counts)

    # -- dynamic fleet: spawn / retire / live migration --------------------
    #
    # All three verbs require dynamic=True (the static hot path takes no
    # migration gate) and are serialized by one lock: two in-flight
    # flips in opposite directions would deadlock their worker threads
    # on each other's load round trips, and the autoscaler is
    # single-threaded anyway.

    def _require_dynamic(self) -> None:
        if not self._dynamic:
            raise RuntimeError(
                "live topology changes need a dynamic gateway "
                "(Gateway(..., dynamic=True))"
            )
        if self.combine:
            raise RuntimeError(
                "live topology changes are unsupported with the "
                "cross-shard combiner on"
            )

    def spawn_worker(self) -> Tuple[int, List[str]]:
        """Add one worker; rebalance the ring onto it via live migration.

        Returns ``(worker_id, moved shard keys)``. The new worker takes
        ~1/N of the ring (consistent hashing), and every moved shard
        arrives warm: its pool and published placement ride the
        bit-exact snapshot blob through ``migrate_shard``.
        """
        self._require_dynamic()
        with self._migrate_serial:
            widx = len(self.workers)
            self.workers.append(self._make_worker(widx))
            self.n_workers = len(self.live_worker_ids())
            self.router = ConsistentHashRouter(
                replicas=self.router.replicas,
                worker_ids=self.live_worker_ids(),
            )
            self.metrics.inc("workers_spawned")
            moved = self._rebalance()
            self._refresh_capacity()
            return widx, moved

    def retire_worker(self, widx: Optional[int] = None) -> Tuple[int, List[str]]:
        """Drain one worker (default: highest id) and stop it.

        Its ring slices — and only its — move to the survivors first
        (live migrations, warm), then the worker stops. The slot stays
        ``None`` so remaining worker ids keep their stable ring labels.
        """
        self._require_dynamic()
        with self._migrate_serial:
            live = self.live_worker_ids()
            if len(live) <= 1:
                raise RuntimeError("cannot retire the last worker")
            if widx is None:
                widx = live[-1]
            worker = self.workers[widx] if 0 <= widx < len(self.workers) else None
            if worker is None:
                raise ValueError(f"worker {widx} is not live")
            remaining = [w for w in live if w != widx]
            self.router = ConsistentHashRouter(
                replicas=self.router.replicas, worker_ids=remaining
            )
            moved = self._rebalance()
            worker.stop(join=True)
            self.workers[widx] = None
            self.n_workers = len(remaining)
            self.metrics.inc("workers_retired")
            self._refresh_capacity()
            return widx, moved

    def _rebalance(self) -> List[str]:
        """Migrate every shard whose ring owner changed. Caller holds
        ``_migrate_serial``."""
        moved: List[str] = []
        for key, (fid, _mid, cur) in list(self._shards.items()):
            target = self.router.owner(key)
            if target != cur:
                self._migrate_shard_locked(fid, target)
                moved.append(key)
        return moved

    def migrate_shard(self, fleet_id: str, dst_widx: int) -> None:
        """Move one fleet's shard to another worker with zero cold ticks.

        Two phases. **Prefetch** (source keeps serving): snapshot the
        shard behind whatever is queued, build + warm-load the
        destination copy — the expensive part (scheduler build, first
        capture) happens entirely off the serving path. **Flip**: mark
        the shard migrating (ingest parks — no closure queued anywhere),
        queue the flip on the source; it runs after every tick admitted
        before parking, dumps the now-quiescent final state, loads it
        into the destination (re-arming the warm-resume audit: the blob
        is the authority, the prefetch was advisory), flips routing, and
        replays parked events onto the destination in arrival order
        before the gate clears. No event is lost, none applies twice,
        and the destination's first tick is warm — ``warm_resumes``
        advances by exactly one per migrated shard, ``cold_resumes`` and
        ``tick_cold`` by zero.

        On a flip failure the gate clears with routing unchanged and
        parked events replay onto the still-intact source — the
        migration failed, serving did not.
        """
        self._require_dynamic()
        with self._migrate_serial:
            self._migrate_shard_locked(fleet_id, dst_widx)

    def _migrate_shard_locked(self, fleet_id: str, dst_widx: int) -> None:
        key = self._fleet_key.get(fleet_id)
        if key is None:
            raise KeyError(f"unknown fleet {fleet_id!r}")
        fid, mid, src_widx = self._shards[key]
        if dst_widx == src_widx:
            return
        src = self.workers[src_widx]
        dst = (
            self.workers[dst_widx]
            if 0 <= dst_widx < len(self.workers)
            else None
        )
        if dst is None:
            raise ValueError(f"worker {dst_widx} is not live")

        # Phase 1 — prefetch: base snapshot + destination build, source
        # still serving every tick. The source's cumulative counters ride
        # along: if the flip later aborts because the source CHILD died,
        # this prefetch is the last readable copy of them (counters are
        # live-copy-only — they do not ride the dump blob).
        def _prefetch(w=src, k=key):
            s = w.shards[k]
            return s.dump_state(), dict(s.metrics.counters)

        base, pre_counters = src.call(_prefetch)
        spec = self._spec_from_blob(base, fid)
        dst.create_shard(
            key,
            build=lambda: self._build_from_blob(base, fid),
            state=base,
            spec=spec,
        )

        # Phase 2 — park and flip.
        with self._migration_lock:
            self._migrating[key] = {"parked": []}
        abort = {"src_lost": False}

        def _flip():
            ok = False
            try:
                try:
                    state = src.shards[key].dump_state()
                except WorkerCrashed:
                    # The SOURCE child died under the flip dump: its
                    # counters are gone with it — the abort path below
                    # folds the prefetched copy so the fleet's totals
                    # survive the crash. (A dst-side failure must NOT
                    # set this: the source still serves, and folding a
                    # still-counting copy would double count.)
                    abort["src_lost"] = True
                    raise
                dst.load_shard(key, state)
                ok = True
            finally:
                with self._migration_lock:
                    mig = self._migrating.pop(key, None)
                    if ok:
                        self._shards[key] = (fid, mid, dst_widx)
                    target = self.workers[self._shards[key][2]]
                    parked = mig["parked"] if mig else []
                    for rec in parked:
                        self._submit_parked(fid, key, target, rec)
                if ok:
                    # The source copy is inert (nothing routes to it);
                    # fold its counters into the fleet's running totals
                    # (they do not ride the blob), then drop it off the
                    # gate, still on the source thread.
                    stale = src.shards.pop(key)
                    counters = dict(stale.metrics.counters)
                    with self._migration_lock:
                        acc = self._folded_counters.setdefault(fid, {})
                        for name, v in counters.items():
                            if v:
                                acc[name] = acc.get(name, 0) + v
                    stale.close()
            return len(parked)

        try:
            parked_n = src.call(_flip)
        except BaseException:
            # Failed flip: best-effort drop of the prefetched copy.
            self.metrics.inc("migration_failed")
            if abort["src_lost"]:
                # Source child crashed mid-migration: fold the Phase-1
                # prefetched counters so the fleet's cumulative totals
                # are not silently dropped with the dead child. (Events
                # ticked between prefetch and crash are covered by the
                # supervision tier's own snapshot fold when it is on.)
                with self._migration_lock:
                    acc = self._folded_counters.setdefault(fid, {})
                    for name, v in pre_counters.items():
                        if v:
                            acc[name] = acc.get(name, 0) + v
            try:
                dst.drop_shard(key)
            except Exception:  # dlint: disable=DLP017 the flip failure was counted (migration_failed) and re-raises below; this drop is best-effort cleanup of the never-published prefetch copy
                pass
            raise
        self.metrics.inc("shards_migrated")
        if spec is not None:
            # The shard moved: future crash recovery rebuilds it on the
            # destination from this (identical) spec.
            self._specs[key] = spec
        if self.flight is not None:
            self.flight.record(
                "migration",
                {
                    "t": time.time(),
                    "fleet": fid,
                    "shard": key,
                    "src": src_widx,
                    "dst": dst_widx,
                    "parked": parked_n,
                },
            )

    def _submit_parked(self, fleet_id, key, worker, rec) -> None:
        """Replay one parked event onto the post-flip owner, resolving
        the waiter that has been parked since ingest."""
        event, parent, t_enq, on_done, box, done = rec
        inner = self._tick_closure(
            fleet_id, key, worker, event, parent=parent, t_enq=t_enq
        )

        def _do():
            shared: dict = {}
            try:
                shared["result"] = inner()
            except BaseException as e:
                self.metrics.inc("worker_exception")
                shared["exc"] = e
            finally:
                self._resolve_waiters([(box, done, on_done)], shared)

        worker.submit(_do)

    def _build_from_blob(self, blob: dict, fleet_id: str):
        """Rebuild a shard's scheduler from its snapshot's own fleet
        profile (migration has no caller-supplied devices/model)."""
        if self._factory is not None:
            # A factory owns its own devices/model contract — the blob's
            # values pass through exactly as dump_state recorded them.
            return self._build_scheduler(
                blob["devices"], blob.get("model"), fleet_id
            )
        devices = [
            DeviceProfile.model_validate(d) for d in blob["devices"]
        ]
        model = (
            ModelProfile.model_validate(blob["model"])
            if blob.get("model") is not None
            else None
        )
        return self._build_scheduler(devices, model, fleet_id)

    def _spec_from_blob(self, blob: dict, fleet_id: str) -> Optional[dict]:
        if self.worker_backend != "process":
            return None
        return {
            "devices": list(blob["devices"]),
            "model": blob.get("model"),
            "fleet_id": fleet_id,
            "kwargs": dict(self.scheduler_kwargs),
            "factory": (
                self._factory if isinstance(self._factory, str) else None
            ),
        }

    # -- controller actuation seams ----------------------------------------

    def force_degrade(self, on: bool) -> None:
        """Mark every tick under PRESSURE (spec_near serving) regardless
        of queue depth — the autoscaler's fast, reversible lever while a
        spawned worker warms. Off restores the static admission verdict
        exactly."""
        self._forced_pressure = bool(on)

    def set_spec_k(self, k: int) -> None:
        """Set ``spec_k`` on every live shard (ON each worker thread; a
        process worker forwards per shard over its RPC)."""
        for w in self.live_workers():
            def _do(w=w):
                for sched in w.shards.values():
                    sched.spec_k = k

            w.call(_do)

    def note_capacity(self, eps: float, n_workers: Optional[int] = None) -> None:
        """Record the closed-loop capacity probe: ``eps`` sustainable at
        ``n_workers`` (default: current live count). The per-worker
        quotient is kept so ``capacity_eps`` refreshes deterministically
        on every spawn/retire — no live re-probe inside the control loop
        (replay must stay a pure function of timeline + policy)."""
        n = n_workers if n_workers is not None else len(self.live_workers())
        with self._migrate_serial:
            self._capacity_per_worker = eps / max(1, n)
            self.capacity_eps = eps

    def _refresh_capacity(self) -> None:
        if self._capacity_per_worker is not None:
            self.capacity_eps = self._capacity_per_worker * len(
                self.live_workers()
            )

    def attach_controller(self, loop) -> None:
        """Attach a running ControlLoop; stopped with the samplers on
        close() (before the workers — an actuation mid-close must not
        land on a stopping worker)."""
        self._controller = loop
        self.attach_sampler(loop)

    def control_status(self) -> dict:
        """The /control payload: live topology + the decision trail."""
        actions: List[dict] = []
        if self.flight is not None and "control" in self.flight.keys():
            actions = [dict(r) for r in self.flight.snapshot("control")]
        return {
            "enabled": self._controller is not None,
            "dynamic": self._dynamic,
            "worker_backend": self.worker_backend,
            "workers": self.live_worker_ids(),
            "capacity_eps": self.capacity_eps,
            "forced_degrade": self._forced_pressure,
            "migrations": int(
                self.metrics.counters.get("shards_migrated", 0)
            ),
            "supervised": self._supervise,
            "quarantined_workers": list(self._quarantined_workers),
            "actions": actions,
        }

    def handle_event(self, fleet_id: str, event) -> PlacementView:
        """Apply one event to its fleet's shard; blocks for the view.

        Latency observed here (``gateway_event_to_placement``) includes
        the queue wait on the owning worker — the number a client sees,
        not just the solve. Raises ``QueueFull`` when admission control
        sheds the event (already counted and flight-recorded).
        """
        span = self.tracer.start_span(
            "gateway.ingest", parent=None, attrs={"fleet": fleet_id}
        )
        try:
            t0 = time.perf_counter()
            key, worker = self._lookup(fleet_id)
            self.tracer.record_span(
                "gateway.route",
                t0 * 1e3,
                None,
                parent=span.context(),
                attrs={"shard": key, "worker": worker.worker_id},
            )
            box, done = self._submit_tick(
                fleet_id, key, worker, event,
                parent=span.context(), t_enq=t0 * 1e3,
            )
            done.wait()
            if "exc" in box:
                raise box["exc"]
            view = box["result"]
            self._note_handled(worker, t0)
            return view
        finally:
            span.end()

    async def handle_event_async(
        self, fleet_id: str, event, parent=None
    ) -> PlacementView:
        """Asyncio ingest: enqueue on the owning worker, await the view.

        Completion resolves a loop future via ``call_soon_threadsafe`` —
        no executor thread parked per in-flight event, so thousands of
        fleets can await concurrently over a handful of workers.

        ``parent`` is an optional ``SpanContext`` (the HTTP tier's request
        span). Parenting here is EXPLICIT — on the shared loop thread a
        thread-local "current span" would leak between interleaved
        coroutines and mis-parent concurrent fleets' spans.
        """
        span = self.tracer.start_span(
            "gateway.ingest", parent=parent, attrs={"fleet": fleet_id}
        )
        try:
            # t0 BEFORE the lookup, like the sync path: the route span
            # must actually time the shard resolution, not measure ~0.
            t0 = time.perf_counter()
            key, worker = self._lookup(fleet_id)
            self.tracer.record_span(
                "gateway.route",
                t0 * 1e3,
                None,
                parent=span.context(),
                attrs={"shard": key, "worker": worker.worker_id},
            )
            loop = asyncio.get_running_loop()
            fut: "asyncio.Future" = loop.create_future()

            def _resolve(box: dict) -> None:
                if fut.cancelled():
                    return
                if "exc" in box:
                    fut.set_exception(box["exc"])
                else:
                    fut.set_result(box["result"])

            self._submit_tick(
                fleet_id, key, worker, event,
                parent=span.context(), t_enq=t0 * 1e3,
                on_done=lambda box: loop.call_soon_threadsafe(_resolve, box),
            )
            view = await fut
            self._note_handled(worker, t0)
            return view
        finally:
            span.end()

    def _note_handled(self, worker: ShardWorker, t0: float) -> None:
        """Caller-side observability only (the resume cursor moved on the
        worker thread, inside the tick closure)."""
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics.inc("gateway_events")
        self.metrics.inc(f"worker_{worker.worker_id}_events")
        self.metrics.observe("gateway_event_to_placement", ms)
        if self._admission:
            # Retry-After's input: a cheap EWMA of what one event costs
            # end to end. Racy float write, deliberately unlocked — it is
            # a backoff hint, not an accounting counter.
            prev = self._serve_ewma_ms
            self._serve_ewma_ms = (
                ms if prev is None else 0.9 * prev + 0.1 * ms
            )

    def latest(self, fleet_id: str) -> PlacementView:
        """The fleet's most recent published placement (via its worker, so
        it never races a tick in flight)."""
        key, worker = self._lookup(fleet_id)
        return worker.call(lambda: worker.shards[key].latest())

    # -- observability -----------------------------------------------------

    def _per_worker(self, extract) -> Dict[str, dict]:
        """Run ``extract(scheduler, fleet_id)`` for every shard, ONE
        queued round trip per worker (not per shard — with hundreds of
        shards a per-shard loop would pay hundreds of FIFO waits behind
        in-flight solves for a single observability probe). The closure
        runs ON the worker thread, behind everything already queued, so
        anything it reads (shard state, the resume cursor that tick
        closures bump) is observed at one consistent point of that
        worker's timeline. Returns fleet_id -> value.
        """
        by_worker: Dict[int, List[Tuple[str, str]]] = {}
        for key, (fleet_id, _mid, widx) in self._shards.items():
            by_worker.setdefault(widx, []).append((key, fleet_id))
        out: Dict[str, dict] = {}
        for widx, members in by_worker.items():
            worker = self.workers[widx]

            def _collect(w=worker, ms=members) -> dict:
                return {fid: extract(w.shards[k], fid) for k, fid in ms}

            if threading.current_thread() is worker._thread:
                # Re-entrant probe FROM a worker thread (the recovery
                # trail snapshots /signals mid-closure): a queued round
                # trip to ourselves would deadlock — run inline; the
                # read is mid-closure rather than at a tick boundary,
                # which is exactly what a crash-time snapshot wants.
                out.update(_collect())
            else:
                out.update(worker.call(_collect))
        return out

    def healthz(self) -> dict:
        """Per-shard health + the worst state as the overall verdict."""
        rank = {HEALTH_HEALTHY: 0, HEALTH_DEGRADED: 1, HEALTH_BROKEN: 2}
        worst = HEALTH_HEALTHY
        shards = self._per_worker(lambda s, _fid: s.health_snapshot())
        for key, (fleet_id, model_id, widx) in self._shards.items():
            snap = shards[fleet_id]
            snap["worker"] = widx
            snap["model_id"] = model_id
            if rank.get(snap["state"], 2) > rank[worst]:
                worst = snap["state"]
        return {
            "status": worst,
            "workers": self.n_workers,
            "shards": shards,
            "queue_depths": [w.depth() for w in self.live_workers()],
        }

    def metrics_snapshot(self) -> dict:
        """Gateway counters/latency + per-shard aggregates, plain dicts."""
        agg: Dict[str, int] = {}
        per_shard: Dict[str, dict] = {}
        all_counters = self._per_worker(
            lambda s, _fid: dict(s.metrics.counters)
        )
        with self._migration_lock:
            folded = {
                f: dict(c) for f, c in self._folded_counters.items()
            }
        for fleet_id, counters in all_counters.items():
            # Counters of copies this fleet's migrations retired: the
            # live copy starts fresh, the totals stay cumulative.
            for name, v in folded.get(fleet_id, {}).items():
                counters[name] = counters.get(name, 0) + v
            per_shard[fleet_id] = {
                c: counters.get(c, 0)
                for c in _AGGREGATED_SHARD_COUNTERS
                if counters.get(c, 0)
            }
            for c in _AGGREGATED_SHARD_COUNTERS:
                agg[c] = agg.get(c, 0) + counters.get(c, 0)
        snap = self.metrics.snapshot()
        snap["shard_totals"] = agg
        snap["per_shard"] = per_shard
        snap["workers"] = self.n_workers
        snap["shards"] = len(self._shards)
        return snap

    def shard_metrics_snapshot(self, fleet_id: str) -> dict:
        """One shard's metrics snapshot with the fleet's FOLDED counters
        merged in: migrations and crash recoveries retire scheduler
        copies whose counters fold gateway-side, and a per-shard audit
        (chaos reconciliation, the walkthrough's counter reads) needs
        the cumulative view, not just the live copy's. A fleet that
        never migrated or crashed merges nothing — byte-identical."""
        snap = self.read_shard(fleet_id, lambda s: s.metrics_snapshot())
        with self._migration_lock:
            folded = dict(self._folded_counters.get(fleet_id, {}))
        if folded:
            counters = snap.get("counters", {})
            for name, v in folded.items():
                counters[name] = counters.get(name, 0) + v
        return snap

    def prometheus_text(self) -> str:
        """Prometheus v0.0.4 text: per-shard metrics with
        ``{fleet,shard,worker,health}`` labels + gateway-level counters.

        The ``GET /metrics`` content-negotiated rendering: per-shard
        counters surface as labeled samples instead of being summed away
        (the JSON snapshot's ``shard_totals`` loses exactly the per-shard
        split a dashboard needs to see ONE broken fleet). One queued round
        trip per worker, same consistency argument as ``_per_worker``.
        """
        from ..obs.export import render_prometheus

        per_shard = self._per_worker(
            lambda s, _fid: (s.metrics.snapshot(), s.health)
        )
        entries = []
        for key, (fleet_id, _mid, widx) in self._shards.items():
            snap, health = per_shard[fleet_id]
            entries.append(
                {
                    "fleet": fleet_id,
                    "shard": key,
                    "worker": widx,
                    "health": health,
                    "counters": snap["counters"],
                    "latency": snap["latency"],
                }
            )
        gw = self.metrics.snapshot()
        return render_prometheus(
            entries,
            gateway_counters=gw["counters"],
            gateway_latency=gw["latency"],
            # Live queue depth per worker: THE admission-control input as
            # a labeled gauge, next to the counters it explains (a scrape
            # that sees events_shed climbing reads the depth that caused
            # it in the same exposition).
            worker_gauges={
                "worker_queue_depth": {
                    str(w.worker_id): w.depth()
                    for w in self.live_workers()
                }
            },
        )

    def attach_sampler(self, sampler):
        """Register a background observer thread (timeline sampler, prom
        scraper — anything with ``.stop(join=True)``) for teardown:
        ``close()`` stops every attached sampler before the workers, so
        the observer can never probe a stopping worker. Returns the
        sampler for chaining."""
        self._samplers.append(sampler)
        return sampler

    def attach_slo(
        self, engine, timeline, capacity_eps: Optional[float] = None
    ) -> None:
        """Install the SLO engine + timeline this gateway serves on
        ``GET /slo`` / ``GET /signals`` (see ``obs.slo``). The caller
        owns sampler construction (and usually attaches it via
        ``attach_sampler``); this only wires the read surface."""
        self.slo_engine = engine
        self.timeline = timeline
        if capacity_eps is not None:
            # Route through note_capacity: same lock, and the per-worker
            # quotient stays consistent if the fleet later goes dynamic.
            self.note_capacity(capacity_eps)

    def timeline_sample(self) -> Dict[str, float]:
        """One flat ``{series: value}`` sample for the metrics timeline:
        gateway counters (``c.<name>``), per-shard aggregate counters
        (``shards.<name>``), gateway latency quantiles (``lat.<hist>.*``)
        and the live per-worker queue depths (``queue_depth.w<i>`` — the
        admission-control input the /signals trend derives from). One
        ``metrics_snapshot`` round trip per worker per tick; that cost
        is exactly what the bench's slo section gates at <= 5%."""
        from ..obs.timeline import flatten_metrics_snapshot

        snap = self.metrics_snapshot()
        out = flatten_metrics_snapshot(snap)
        for name, value in snap.get("shard_totals", {}).items():
            out[f"shards.{name}"] = float(value)
        # The availability SLO's inputs always exist, zero-valued before
        # the first event: a counter minted mid-incident would otherwise
        # have no pre-incident baseline sample, and the burst's delta
        # would be invisible to every window that needs it most.
        out.setdefault("c.gateway_events", 0.0)
        out.setdefault("c.events_shed", 0.0)
        # Offered = accepted + shed: the availability SLO's denominator
        # (a shed never reaches gateway_events, and an error ratio over
        # accepted-only would understate a shedding gateway's burn).
        out["c.events_offered"] = out["c.gateway_events"] + out["c.events_shed"]
        depths = []
        for w in self.live_workers():
            d = w.depth()
            depths.append(d)
            out[f"queue_depth.w{w.worker_id}"] = float(d)
        out["queue_depth.max"] = float(max(depths) if depths else 0)
        if self._dynamic:
            # The controller's own series, only on dynamic gateways so
            # static samples stay byte-identical: live worker count is
            # the signal a replayed decision trail is audited against.
            out["control.workers"] = float(len(depths))
        if self._supervise:
            # Recovery series, only on supervised gateways (same
            # byte-identical argument): zero-valued from the first
            # sample so a kill's delta has a pre-incident baseline.
            for name in (
                "c.worker_crashes",
                "c.child_respawns",
                "c.events_replayed",
                "c.shards_recovered",
                "c.workers_quarantined",
            ):
                out.setdefault(name, 0.0)
        from ..obs import compile_ledger as _cl

        led = _cl.current()
        if led is not None:
            # Process-wide compile telemetry (the ledger sees every
            # worker thread's kernel loads and captures, attributed or
            # not); the series set is timeline_series's one definition,
            # shared with Scheduler.timeline_sample so the two serving
            # shapes' names cannot drift.
            out.update(led.timeline_series())
        from ..obs import memory as _mem

        mled = _mem.current()
        if mled is not None:
            # mem.* watermark gauges (obs.memory.timeline_series — same
            # one-definition contract as the compile series): allocated
            # bytes by device, RSS/HWM, headroom. Absent when
            # unavailable, never zeroed; feature-off byte-identical.
            out.update(mled.timeline_series())
        return out

    def slo_status(self) -> dict:
        """The ``GET /slo`` payload (KeyError -> HTTP 404 when no SLO
        engine is attached — same contract as the flight endpoint)."""
        if self.slo_engine is None:
            raise KeyError("SLO engine not enabled (serve --slo <spec>)")
        return self.slo_engine.status()

    def signals(self) -> dict:
        """The ``GET /signals`` autoscaling payload (versioned, schema'd
        by ``obs.slo.SignalsPayload``)."""
        if self.timeline is None:
            raise KeyError(
                "signals need a metrics timeline (serve --slo <spec> "
                "or --timeline-dir; burn rates need --slo)"
            )
        from ..obs.slo import build_signals

        return build_signals(
            self.timeline,
            engine=self.slo_engine,
            capacity_eps=self.capacity_eps,
            combine=(
                self._combiner.snapshot()
                if self._combiner is not None
                else None
            ),
            recovery=(
                self.recovery_status() if self._supervise else None
            ),
        ).model_dump()

    def flight_snapshot(self, fleet_id: str) -> List[dict]:
        """The fleet's live flight-recorder ring (``GET /debug/flight/<fleet>``)."""
        if self.flight is None:
            raise KeyError(
                "flight recorder not enabled (serve --flight-dir)"
            )
        if fleet_id not in self._fleet_key:
            raise KeyError(f"unknown fleet {fleet_id!r}")
        return self.flight.snapshot(fleet_id)

    # -- snapshot / restore ------------------------------------------------

    def snapshot(self) -> GatewaySnapshot:
        """Drain every worker and serialize every shard's warm state.

        The dump runs ON each worker thread behind whatever events are
        already queued — a natural barrier: the snapshot observes each
        shard after its last accepted event, never mid-tick. New events
        submitted while snapshotting land after the dump and are NOT in
        the snapshot (their replay is the restore side's job).
        """
        # State AND resume cursor are captured in ONE worker-thread
        # closure: the cursor moves inside queued tick closures, so
        # reading both on the worker guarantees they describe the same
        # point of the shard's timeline even while async ingest keeps
        # submitting (a caller-side cursor read could observe a tick the
        # dump did not, and a resume would then skip an uncovered event).
        states = self._per_worker(
            lambda s, fid: (s.dump_state(), self._handled.get(fid, 0))
        )
        shards: List[ShardSnapshot] = []
        for key, (fleet_id, model_id, _widx) in self._shards.items():
            state, cursor = states[fleet_id]
            shards.append(
                ShardSnapshot(
                    fleet_id=fleet_id,
                    model_id=model_id,
                    shard_key=key,
                    events_handled=cursor,
                    state=state,
                )
            )
        self.metrics.inc("snapshots_taken")
        return GatewaySnapshot(
            n_workers=self.n_workers,
            shards=shards,
            counters=self.metrics.snapshot()["counters"],
        )

    def load_snapshot(self, snap: GatewaySnapshot) -> None:
        """Restore every shard from a snapshot into THIS gateway.

        Worker count may differ from the producing gateway's: shards
        re-route by the current consistent-hash ring, warm state riding
        the blob to the new owner. Must be called before any events are
        ingested (restore is a boot-time operation, not a live merge).
        """
        if self._shards:
            raise RuntimeError(
                "load_snapshot needs a fresh gateway (shards already "
                "registered)"
            )
        for shard in snap.shards:
            if self._factory is not None:
                # A factory owns its own devices/model contract — the
                # blob's raw values pass through (mirrors
                # ``_build_from_blob``; no profile validation).
                devices = shard.state["devices"]
                model = shard.state["model"]
            else:
                devices = [
                    DeviceProfile.model_validate(d)
                    for d in shard.state["devices"]
                ]
                model = ModelProfile.model_validate(shard.state["model"])
            self.register_fleet(
                shard.fleet_id,
                devices,
                model,
                model_id=shard.model_id,
                state=shard.state,
                events_handled=shard.events_handled,
            )

    def events_handled(self, fleet_id: str) -> int:
        """This fleet's resume cursor (events handled, quarantines
        included) — restored from the snapshot on the other side."""
        return self._handled.get(fleet_id, 0)

    def uncovered(self, items: Sequence[Tuple[str, object]]):
        """The suffix of a trace the resume cursors do NOT cover.

        THE one implementation of the resume-skip contract (CLI,
        walkthrough and tests all route through it): for each fleet, skip
        its first ``events_handled(fleet)`` items — handled counts
        quarantined events too (they advanced the cursor without the
        fleet seq, and replaying them would only repeat the rejection).
        """
        seen: Dict[str, int] = {}
        out: List[Tuple[str, object]] = []
        for fleet_id, ev in items:
            seen[fleet_id] = seen.get(fleet_id, 0) + 1
            if seen[fleet_id] > self._handled.get(fleet_id, 0):
                out.append((fleet_id, ev))
        return out

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Stop attached samplers, then every worker (graceful: queued
        work drains first). Idempotent — CLI finally blocks, harness
        teardowns and ``with`` exits may all call it.

        Sampler order matters: an attached prom scraper or timeline
        sampler probes the workers on its own thread, and a probe landing
        after a worker stopped would count a scrape error on a perfectly
        clean shutdown (the gateway owns the ordering, not each
        harness). ``stop()`` on a sampler is
        required idempotent, so a harness that already stopped its own
        sampler is fine."""
        if self._closed:
            return
        self._closed = True
        for sampler in self._samplers:
            try:
                sampler.stop()
            except Exception:
                # A sampler that fails to stop must not leak workers; the
                # failure is counted, teardown continues.
                self.metrics.inc("timeline_sample_error")
        if self._combiner is not None:
            # Before the workers: the drain's deliveries queue adopt
            # closures on still-running workers, and the workers' own
            # graceful stop then drains those.
            self._combiner.stop()
        for w in self.live_workers():
            w.stop()
        if self._recovery_store is not None:
            self._recovery_store.close()
        if self._recovery_tmpdir is not None:
            import shutil

            shutil.rmtree(self._recovery_tmpdir, ignore_errors=True)

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ShardFacade:
    """A single gateway shard masquerading as a bare ``Scheduler``.

    The serve CLI's replay and chaos harnesses (``sched.sim.replay``,
    ``sched.faults.chaos_replay``) drive a scheduler-shaped object:
    ``handle``/``latest``/``metrics``/``fleet``/``health``/``fault_hook``.
    This facade routes ``handle`` through the owning worker's queue (so
    the multi-worker path is what is actually exercised) and — fixing the
    quiescence hazard — routes every READ through a queued
    worker-side closure too (``Gateway.read_shard``), so harness reads
    are sound under live ingest, not only while the worker is quiescent:
    a read lands behind every queued tick and observes the shard at a
    tick boundary. ``.fleet`` returns a ``FleetReadView`` captured in one
    closure (seq, model, membership AND the published seq from the same
    instant — the consistency the concurrent-ingest test pins);
    ``.metrics`` returns the live thread-safe sink, the round trip being
    the sequencing point.
    """

    def __init__(self, gateway: Gateway, fleet_id: str):
        object.__setattr__(self, "_gw", gateway)
        object.__setattr__(self, "_fleet", fleet_id)

    def _read(self, fn):
        return self._gw.read_shard(self._fleet, fn)

    def handle(self, event) -> PlacementView:
        return self._gw.handle_event(self._fleet, event)

    def latest(self) -> PlacementView:
        return self._gw.latest(self._fleet)

    def metrics_snapshot(self) -> dict:
        # Routed through the gateway so counters folded from retired
        # scheduler copies (migrations, crash recoveries) stay in the
        # fleet's totals; without folds this is the plain shard read.
        return self._gw.shard_metrics_snapshot(self._fleet)

    def health_snapshot(self) -> dict:
        return self._read(lambda s: s.health_snapshot())

    def close(self) -> None:
        """No-op: the gateway owns worker/scheduler lifecycle."""

    @property
    def metrics(self):
        return self._read(lambda s: s.metrics)

    @property
    def fleet(self) -> FleetReadView:
        def _capture(s) -> FleetReadView:
            if hasattr(s, "fleet_view"):
                # Process-backed shard: the scheduler lives in a child
                # and ``s`` is a SchedulerProxy — ``s._published`` would
                # read the proxy, not the scheduler. One RPC captures
                # the whole view child-side instead.
                wire = s.fleet_view()
                if wire is None:
                    raise AttributeError(
                        "shard scheduler exposes no fleet"
                    )
                model = wire["model"]
                if isinstance(model, dict):
                    model = ModelProfile.model_validate(model)
                devices = {
                    did: (
                        DeviceProfile.model_validate(d)
                        if isinstance(d, dict)
                        else d
                    )
                    for did, d in wire["devices"].items()
                }
                return FleetReadView(
                    seq=wire["seq"],
                    model=model,
                    devices=devices,
                    published_seq=wire["published_seq"],
                )
            pub = s._published
            return FleetReadView(
                seq=s.fleet.seq,
                model=s.fleet.model,
                devices=dict(s.fleet.devices),
                published_seq=None if pub is None else pub.seq,
            )

        return self._read(_capture)

    @property
    def health(self):
        return self._read(lambda s: s.health)

    @property
    def quarantined(self):
        return self._read(lambda s: list(s.quarantined))

    @property
    def fault_hook(self):
        return self._read(lambda s: s.fault_hook)

    def __setattr__(self, name, value):
        # chaos_replay installs its injector via `scheduler.fault_hook =`;
        # forward that one write to the live scheduler as a queued
        # closure (serialized behind in-flight ticks, like the reads) —
        # everything else stays local.
        if name == "fault_hook":
            self._read(lambda s: setattr(s, "fault_hook", value))
        else:
            object.__setattr__(self, name, value)


def view_to_dict(view) -> dict:
    """A served placement as the JSON the HTTP tier returns.

    Stub scheduler factories serve plain-dict views (already JSON);
    those pass through untouched so the HTTP tier works over a
    stub-backed gateway (crash-taxonomy tests, process smokes).
    """
    if isinstance(view, dict):
        return view
    r = view.result
    return {
        "k": r.k,
        "w": r.w,
        "n": r.n,
        "y": r.y,
        "obj_value": r.obj_value,
        "certified": r.certified,
        "gap": r.gap,
        "mode": view.mode,
        "seq": view.seq,
        "fleet_seq": view.fleet_seq,
        "events_behind": view.events_behind,
        "age_s": round(view.age_s, 6),
        "twin_p95_s": view.twin_p95_s,
        "risk_selected": view.risk_selected,
    }
